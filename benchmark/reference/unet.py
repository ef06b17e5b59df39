"""The guidance-conditioned 2-D cross-attention UNet of ConsistencyTTA
(diffusers' UNet2DConditionModel with linear projections, plus a Fourier
guidance embedding; `guided: false` gives the teacher's UNet) in float32,
with diffusers' key names. Takes and returns NHWC latents [B, T, F, C].
Self-attention runs at the true head width (channels // heads), unpadded."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Quantized, Conv2d, Linear, attention


def timestep_embedding(t, dim: int, flip_sin_to_cos: bool, shift: float):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / (half - shift))
    emb = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return torch.cat([emb[:, half:], emb[:, :half]], dim=-1) if flip_sin_to_cos else emb


class FourierProjection(nn.Module):
    def __init__(self, size: int, flip_sin_to_cos: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(size), requires_grad=False)
        self.flip = flip_sin_to_cos

    def forward(self, x):
        p = x[:, None] * self.weight[None] * 2 * math.pi
        return torch.cat([torch.cos(p), torch.sin(p)] if self.flip
                         else [torch.sin(p), torch.cos(p)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, d_in: int, d: int):
        super().__init__()
        self.linear_1 = Linear(d_in, d)
        self.linear_2 = Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int, eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(Quantized, nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, kv_dim: int):
        super().__init__()
        self.heads, self.d = heads, head_dim
        self.to_q = Linear(dim, heads * head_dim, bias=False)
        self.to_k = Linear(kv_dim, heads * head_dim, bias=False)
        self.to_v = Linear(kv_dim, heads * head_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(heads * head_dim, dim)])

    def forward(self, x, context=None, bias=None):
        context = x if context is None else context
        b = x.shape[0]
        split = lambda t: t.view(b, t.shape[1], self.heads, self.d).transpose(1, 2)
        out = attention(split(self.to_q(x)), split(self.to_k(context)),
                        split(self.to_v(context)), self.d ** -0.5, bias, self.quant)
        return self.to_out[0](out.transpose(1, 2).reshape(b, x.shape[1], -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = Linear(dim, 2 * out)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, cross: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, cross)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, text, bias):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), text, bias)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, heads: int, cross: int, groups: int):
        super().__init__()
        d = ch // heads
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Linear(ch, heads * d)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(heads * d, heads, d, cross)])
        self.proj_out = Linear(heads * d, ch)

    def forward(self, x, text, bias):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for blk in self.transformer_blocks:
            t = blk(t, text, bias)
        return self.proj_out(t).transpose(1, 2).reshape(b, c, h, w) + x


class Sampler(nn.Module):
    def __init__(self, ch: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = Conv2d(ch, ch, 3, stride=2 if down else 1, padding=1)

    def forward(self, x):
        return self.conv(x if self.down else F.interpolate(x, scale_factor=2, mode="nearest"))


class Level(nn.Module):
    def __init__(self, resnets, attentions, name, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        if sampler is not None:
            setattr(self, name, nn.ModuleList([sampler]))


class UNet(nn.Module):
    """forward(sample NHWC, t [B], text [B, K, cross], mask [B, K], guidance
    [B] or None) -> prediction NHWC."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        chs, heads = c["block_out_channels"], c["attention_head_dim"]
        ch0, g, eps, cross = chs[0], c["norm_num_groups"], c["norm_eps"], c["cross_attention_dim"]
        temb = 4 * ch0
        n, per = len(chs), c["layers_per_block"]
        self.conv_in = Conv2d(c["in_channels"], ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        if c["guided"]:
            self.guidance_proj = FourierProjection(2 * ch0, c["flip_sin_to_cos"])
            self.guidance_embedding = TimestepEmbedding(temb, temb)
        skips, prev = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(c["down_block_types"]):
            attn = kind == "CrossAttnDownBlock2D"
            res, att = [], []
            for j in range(per):
                res.append(Resnet(prev if j == 0 else chs[i], chs[i], temb, g, eps))
                if attn:
                    att.append(Transformer2D(chs[i], heads[i], cross, g))
                skips.append(chs[i])
            prev = chs[i]
            down = Sampler(prev, True) if i != n - 1 else None
            if down is not None:
                skips.append(prev)
            self.down_blocks.append(Level(res, att, "downsamplers", down))
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([Resnet(prev, prev, temb, g, eps) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([Transformer2D(prev, heads[-1], cross, g)])
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(c["up_block_types"]):
            out = chs[n - 1 - i]
            attn = kind == "CrossAttnUpBlock2D"
            res, att = [], []
            for _ in range(per + 1):
                res.append(Resnet(prev + skips.pop(), out, temb, g, eps))
                prev = out
                if attn:
                    att.append(Transformer2D(out, heads[n - 1 - i], cross, g))
            up = Sampler(out, False) if i != n - 1 else None
            self.up_blocks.append(Level(res, att, "upsamplers", up))
        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=eps)
        self.conv_out = Conv2d(ch0, c["out_channels"], 3, padding=1)

    def forward(self, sample, t, text, mask, guidance=None):
        c = self.c
        b = sample.shape[0]
        bias = ((1.0 - mask.float()) * -10000.0)[:, None, None, :]
        emb = self.time_embedding(timestep_embedding(
            t.reshape(-1).expand(b), c["block_out_channels"][0], c["flip_sin_to_cos"],
            c["freq_shift"]))
        if c["guided"]:
            emb = emb + self.guidance_embedding(self.guidance_proj(guidance.reshape(-1).expand(b)))
        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, emb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, text, bias)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, emb)
        h = self.mid_block.attentions[0](h, text, bias)
        h = self.mid_block.resnets[1](h, emb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), emb)
                if blk.attentions is not None:
                    h = blk.attentions[j](h, text, bias)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h))).permute(0, 2, 3, 1)
