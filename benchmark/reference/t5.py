"""T5 v1.1 encoder (FLAN-T5) in float32: RMSNorm, bidirectional relative
position buckets on the first block, gated tanh-gelu feed-forward, no
attention scaling, a -1e9 bias on padded keys. Key names as HF's
`T5EncoderModel` (and the port's)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Quantized, Linear, attention


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def position_buckets(length: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """[L, L] bucket of key j for query i (relative position j - i)."""
    pos = torch.arange(length, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.float() / exact + 1e-6) / math.log(max_distance / exact)
                     * (half - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=half - 1))


class SelfAttention(Quantized, nn.Module):
    def __init__(self, c: dict, first: bool):
        super().__init__()
        inner = c["num_heads"] * c["d_kv"]
        self.heads, self.d = c["num_heads"], c["d_kv"]
        self.q = Linear(c["d_model"], inner, bias=False)
        self.k = Linear(c["d_model"], inner, bias=False)
        self.v = Linear(c["d_model"], inner, bias=False)
        self.o = Linear(inner, c["d_model"], bias=False)
        if first:
            self.relative_attention_bias = nn.Embedding(c["relative_attention_num_buckets"],
                                                        c["num_heads"])

    def forward(self, x, bias):
        b, n, _ = x.shape
        split = lambda t: t.view(b, n, self.heads, self.d).transpose(1, 2)
        out = attention(split(self.q(x)), split(self.k(x)), split(self.v(x)), 1.0, bias, self.quant)
        return self.o(out.transpose(1, 2).reshape(b, n, -1))


class LayerSelfAttention(nn.Module):
    def __init__(self, c: dict, first: bool):
        super().__init__()
        self.SelfAttention = SelfAttention(c, first)
        self.layer_norm = RMSNorm(c["d_model"], c["layer_norm_epsilon"])

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class DenseGatedGelu(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.wi_0 = Linear(c["d_model"], c["d_ff"], bias=False)
        self.wi_1 = Linear(c["d_model"], c["d_ff"], bias=False)
        self.wo = Linear(c["d_ff"], c["d_model"], bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class LayerFF(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.DenseReluDense = DenseGatedGelu(c)
        self.layer_norm = RMSNorm(c["d_model"], c["layer_norm_epsilon"])

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class Block(nn.Module):
    def __init__(self, c: dict, first: bool):
        super().__init__()
        self.layer = nn.ModuleList([LayerSelfAttention(c, first), LayerFF(c)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class Stack(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.block = nn.ModuleList([Block(c, i == 0) for i in range(c["num_layers"])])
        self.final_layer_norm = RMSNorm(c["d_model"], c["layer_norm_epsilon"])


class T5Encoder(nn.Module):
    """ids [B, L], mask [B, L] (1 = keep) -> hidden states [B, L, d]."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.shared = nn.Embedding(c["vocab_size"], c["d_model"])
        self.encoder = Stack(c)

    def forward(self, ids, mask):
        c = self.c
        x = self.shared(ids)
        buckets = position_buckets(ids.shape[1], c["relative_attention_num_buckets"],
                                   c["relative_attention_max_distance"], ids.device)
        rel = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        bias = rel(buckets).permute(2, 0, 1)[None] + torch.where(
            mask[:, None, None, :] > 0, 0.0, -1e9)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
