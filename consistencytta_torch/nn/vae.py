"""AudioLDM mel-latent VAE (AutoencoderKL): encoder, posterior and decoder.

Key names follow the reference (`encoder.conv_in`, `encoder.down.{i}.block.{j}`,
`encoder.down.{i}.downsample.conv`, `encoder.mid.*`, `quant_conv`;
`decoder.conv_in`, `decoder.mid.block_1`, `decoder.mid.attn_1`,
`decoder.up.{i}.block.{j}`, `decoder.up.{i}.upsample`, `decoder.norm_out`,
`decoder.conv_out`, `post_quant_conv`). The public methods take and return
NHWC as the JAX package does (mel image [B, T, F, 1], latent [B, t, f, c]);
inside the networks run NCHW. Both mid-block attentions go through
`ops.attention.flash_self_attention` (kernel K2 on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch import graphs
from consistencytta_torch.configs import VAEConfig
from consistencytta_torch.nn.layers import (
    GroupNorm,
    asymmetric_pad_downsample,
    nearest_upsample_2d,
)
from consistencytta_torch.ops._packs import Pack
from consistencytta_torch.ops.attention import flash_self_attention
from consistencytta_torch.utils import span


class ResnetBlock(nn.Module):
    """GN(eps 1e-6) + SiLU -> conv1 -> GN + SiLU -> conv2 (+ 1x1
    nin_shortcut on a channel change)."""

    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        with span("resnet"):
            h = self.conv1(self.norm1(x, silu=True))
            h = self.conv2(self.norm2(h, silu=True))
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
        self.qkv_pack = Pack()

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.norm(x).flatten(2).transpose(1, 2)  # [B, H*W, C]
        # the three 1x1 projections as one matmul; q/k/v are views of it
        ws = (self.q.weight, self.k.weight, self.v.weight)
        bs = (self.q.bias, self.k.bias, self.v.bias)
        w_qkv, b_qkv = self.qkv_pack.get(
            (*ws, *bs), lambda: (torch.cat(ws).reshape(3 * c, c), torch.cat(bs)))
        q, k, v = F.linear(tokens, w_qkv, b_qkv).split(c, dim=-1)
        out = flash_self_attention(q, k, v, c ** -0.5)
        out = F.linear(out, self.proj_out.weight.reshape(c, c), self.proj_out.bias)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class _Level(nn.Module):
    """`block` plus an optional `upsample` or `downsample` submodule."""

    def __init__(self, blocks, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, resample_name, resample)


class _Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_upsample_2d(x))


class _Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(asymmetric_pad_downsample(x))


class Encoder(nn.Module):
    """Mel image NCHW -> posterior moments NCHW (before quant_conv)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, g = cfg.base_channels, cfg.norm_num_groups
        n = len(cfg.ch_mult)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch, 3, padding=1)
        block_in = ch
        levels = []
        for i, mult in enumerate(cfg.ch_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, ch * mult, g))
                block_in = ch * mult
            levels.append(_Level(blocks, "downsample",
                                 _Downsample(block_in) if i != n - 1 else None))
        self.down = nn.ModuleList(levels)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, g)
        self.mid.attn_1 = AttnBlock(block_in, g)
        self.mid.block_2 = ResnetBlock(block_in, block_in, g)
        self.norm_out = GroupNorm(g, block_in, eps=cfg.norm_eps)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i, level in enumerate(self.down):
            for blk in level.block:
                h = blk(h)
            if i != len(self.down) - 1:
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h, silu=True))


class DiagonalGaussian:
    """Posterior over latents from moments [..., 2z] (channels last): mean,
    logvar clamped to [-30, 20], std; sample / mode / kl."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise=None, generator=None) -> torch.Tensor:
        """mean + std * noise; `noise` is a standard-normal tensor of the
        mean's shape, drawn from `generator` when not given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * torch.as_tensor(noise).to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        var = torch.exp(self.logvar)
        return 0.5 * torch.sum(self.mean**2 + var - 1.0 - self.logvar,
                               dim=tuple(range(1, self.mean.ndim)))


class Decoder(nn.Module):
    """Latent NCHW -> mel image NCHW. A frozen inference call replays a CUDA
    graph (graphs.py); `post_quant_conv` before it stays eager."""

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
            levels[i] = _Level(blocks, "upsample", _Upsample(block_in) if i != 0 else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(g, block_in, eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(block_in, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        return graphs.run(self, "vae_decode", self._forward, z)

    def _forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for blk in level.block:
                h = blk(h)
            if i != 0:
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKLDecoder(nn.Module):
    """post_quant_conv + Decoder of AutoencoderKL (the decoder pair that an
    EMA decoder checkpoint holds)."""

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


class AutoencoderKL(AutoencoderKLDecoder):
    """The whole autoencoder: the decoder pair plus Encoder and quant_conv."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__(config)
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.z_channels, 2 * config.embed_dim, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """mel image NHWC [B, T, F, 1] -> posterior moments NHWC
        [B, T/4, F/4, 2*embed], float32."""
        dtype = self.quant_conv.weight.dtype
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2).to(dtype)))
        return h.permute(0, 2, 3, 1).float()

    def encode_to_latent(self, x: torch.Tensor, noise=None, generator=None) -> torch.Tensor:
        """mel image -> scaled sampled latent NHWC [B, t, f, c], float32."""
        posterior = DiagonalGaussian(self.encode_moments(x))
        return self.config.scale_factor * posterior.sample(noise, generator)
