"""AudioLDM mel-latent VAE (AutoencoderKL): the decoder path.

Key names follow the reference (`decoder.conv_in`, `decoder.mid.block_1`,
`decoder.mid.attn_1`, `decoder.up.{i}.block.{j}`, `decoder.up.{i}.upsample`,
`decoder.norm_out`, `decoder.conv_out`, `post_quant_conv`). The public
`decode_first_stage` takes the scaled latent NHWC [B, t, f, c] and returns
the mel image NHWC [B, T, F, 1], as the JAX package does; inside it runs
NCHW. The mid-block attention goes through `ops.attention.
flash_self_attention` (kernel K2 on the card). The encoder is not part of
this package yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch.configs import VAEConfig
from consistencytta_torch.nn.layers import GroupNorm, nearest_upsample_2d, swish
from consistencytta_torch.ops.attention import flash_self_attention


class ResnetBlock(nn.Module):
    """GN(eps 1e-6) -> swish -> conv1 -> GN -> swish -> conv2 (+ 1x1
    nin_shortcut on a channel change)."""

    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the H*W tokens."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, ch, eps=1e-6)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.norm(x).flatten(2).transpose(1, 2)  # [B, H*W, C]
        # the three 1x1 projections as one matmul; q/k/v are views of it
        w_qkv = torch.cat([self.q.weight, self.k.weight, self.v.weight]).reshape(3 * c, c)
        b_qkv = torch.cat([self.q.bias, self.k.bias, self.v.bias])
        q, k, v = F.linear(tokens, w_qkv, b_qkv).split(c, dim=-1)
        out = flash_self_attention(q, k, v, c ** -0.5)
        out = F.linear(out, self.proj_out.weight.reshape(c, c), self.proj_out.bias)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class _Level(nn.Module):
    def __init__(self, blocks, upsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if upsample is not None:
            self.upsample = upsample


class _Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_upsample_2d(x))


class Decoder(nn.Module):
    """Latent NCHW -> mel image NCHW."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.base_channels, cfg.norm_num_groups
        block_in = ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, g)
        self.mid.attn_1 = AttnBlock(block_in, g)
        self.mid.block_2 = ResnetBlock(block_in, block_in, g)
        levels = [None] * len(cfg.ch_mult)
        for i in reversed(range(len(cfg.ch_mult))):
            block_out = ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, g))
                block_in = block_out
            levels[i] = _Level(blocks, _Upsample(block_in) if i != 0 else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(g, block_in, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(block_in, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for blk in level.block:
                h = blk(h)
            if i != 0:
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


class AutoencoderKLDecoder(nn.Module):
    """post_quant_conv + Decoder of AutoencoderKL."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.embed_dim, config.z_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """unscaled latent NCHW -> mel image NCHW."""
        return self.decoder(self.post_quant_conv(z))

    def decode_first_stage(self, z_scaled: torch.Tensor) -> torch.Tensor:
        """scaled latent NHWC [B, t, f, c] -> mel image NHWC [B, T, F, 1]."""
        dtype = self.post_quant_conv.weight.dtype
        z = (z_scaled / self.config.scale_factor).permute(0, 3, 1, 2).to(dtype)
        return self.decode(z).permute(0, 2, 3, 1)
