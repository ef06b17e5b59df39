"""CFG-guidance-conditioned 2-D cross-attention UNet (diffusers
UNet2DConditionGuided; `config.guided=False` gives the plain teacher UNet
with no guidance term), with diffusers state-dict key names.

The public call takes and returns NHWC latents [B, T, F, C], as the JAX
package does; inside, the network runs NCHW in the dtype of its weights. A
frozen inference call replays a CUDA graph (graphs.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch import graphs
from consistencytta_torch.configs import UNetConfig
from consistencytta_torch.nn.attention import Transformer2D
from consistencytta_torch.nn.embeddings import (
    GaussianFourierProjection,
    TimestepEmbedding,
    sinusoidal_embedding,
)
from consistencytta_torch.nn.layers import GroupNorm, nearest_upsample_2d
from consistencytta_torch.utils import span


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv1 -> + temb_proj -> GN -> silu -> conv2, plus a 1x1
    shortcut on a channel change."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb):
        with span("resnet"):
            h = self.conv1(self.norm1(x, silu=True))
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
            h = self.conv2(self.norm2(h, silu=True))
            if self.conv_shortcut is not None:
                x = self.conv_shortcut(x)
            return x + h


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_upsample_2d(x))


class _Block(nn.Module):
    """A down or up block: `resnets`, optional `attentions`, optional
    `downsamplers` / `upsamplers` (diffusers key layout)."""

    def __init__(self, resnets, attentions, sampler_name, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.sampler_name = sampler_name
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class UNet2DConditionGuided(nn.Module):
    """forward(sample NHWC, timestep [B] or scalar, encoder_hidden_states
    [B, K, cross], encoder_attention_mask [B, K] (1 = keep), guidance [B] or
    scalar) -> prediction NHWC float32."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb = ch0 * 4
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        if cfg.guided:
            self.guidance_proj = GaussianFourierProjection(
                ch0 * 2, flip_sin_to_cos=cfg.flip_sin_to_cos
            )
            self.guidance_embedding = TimestepEmbedding(temb, temb)

        n = cfg.num_levels
        skip_ch = [ch0]
        self.down_blocks = nn.ModuleList()
        prev = ch0
        for i, kind in enumerate(cfg.down_block_types):
            out = cfg.block_out_channels[i]
            attn = kind == "CrossAttnDownBlock2D"
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(prev if j == 0 else out, out, temb, g, eps))
                if attn:
                    attns.append(Transformer2D(
                        out, cfg.attention_head_dim[i], cfg.cross_attention_dim, g
                    ))
                skip_ch.append(out)
            down = Downsample2D(out) if i != n - 1 else None
            if down is not None:
                skip_ch.append(out)
            self.down_blocks.append(_Block(resnets, attns, "downsamplers", down))
            prev = out

        mid = cfg.block_out_channels[-1]
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(mid, mid, temb, g, eps) for _ in range(2)]
        )
        self.mid_block.attentions = nn.ModuleList([Transformer2D(
            mid, cfg.attention_head_dim[-1], cfg.cross_attention_dim, g
        )])

        rev_ch = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(cfg.attention_head_dim))
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.up_block_types):
            out = rev_ch[i]
            attn = kind == "CrossAttnUpBlock2D"
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(prev + skip_ch.pop(), out, temb, g, eps))
                prev = out
                if attn:
                    attns.append(Transformer2D(
                        out, rev_heads[i], cfg.cross_attention_dim, g
                    ))
            up = Upsample2D(out) if i != n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, "upsamplers", up))

        self.conv_norm_out = GroupNorm(g, ch0, eps=eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        guidance=None,
    ) -> torch.Tensor:
        return graphs.run(self, "unet", self._forward, sample, timestep,
                          encoder_hidden_states, encoder_attention_mask, guidance)

    def _forward(self, sample, timestep, encoder_hidden_states, encoder_attention_mask,
                 guidance):
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        dev = sample.device
        b = sample.shape[0]
        timestep = torch.as_tensor(timestep, dtype=torch.float32, device=dev)
        timestep = timestep.reshape(-1).expand(b)

        mask_bias = None
        if encoder_attention_mask is not None:
            mask_bias = ((1.0 - encoder_attention_mask.float()) * -10000.0)[:, None, :]

        t_proj = sinusoidal_embedding(
            timestep, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift
        ).to(dtype)
        emb = self.time_embedding(t_proj)
        if cfg.guided:
            if guidance is None:
                raise ValueError("guided UNet requires a guidance value")
            guidance = torch.as_tensor(guidance, dtype=torch.float32, device=dev)
            g_proj = self.guidance_proj(guidance.reshape(-1).expand(b)).to(dtype)
            emb = emb + self.guidance_embedding(g_proj)

        text = encoder_hidden_states.to(dtype)
        h = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype))

        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, emb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, text, mask_bias)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, emb)
        h = self.mid_block.attentions[0](h, text, mask_bias)
        h = self.mid_block.resnets[1](h, emb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), emb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, text, mask_bias)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        h = self.conv_out(self.conv_norm_out(h, silu=True))
        return h.permute(0, 2, 3, 1).float()
