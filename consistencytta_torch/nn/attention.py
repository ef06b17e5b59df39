"""Spatial transformer for the UNet: attention, GEGLU FF, transformer blocks
(diffusers Attention / BasicTransformerBlock / Transformer2DModel with
linear projections), with diffusers state-dict key names.

The transformer inner dim is heads * (channels // heads): 255/510/1020 for
the light config, head width 51. Self-attention is unmasked and always
goes through `ops.attention.flash_mha_packed` (kernel K1 on the card): the
head width is padded to 64 with zero columns of the fused QKV projection
weight, and `to_out` takes the padded activation through zero rows at the
pad positions, so the padded features are exact zeros and contribute
nothing. Cross-attention (K = text length, with the -10000 padding bias)
stays on plain tensor ops.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch.nn.layers import GroupNorm, LayerNorm
from consistencytta_torch.ops.attention import flash_mha_packed, head_pad
from consistencytta_torch.utils import span


class Attention(nn.Module):
    """Multi-head attention; to_q/to_k/to_v have no bias, to_out does.
    Softmax scale head_dim ** -0.5, logits and softmax in float32."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 cross_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        kv_dim = cross_dim if cross_dim is not None else query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def _self_attention(self, x: torch.Tensor) -> torch.Tensor:
        h, hd = self.heads, self.head_dim
        dp = head_pad(hd)
        c = x.shape[-1]

        def pad_rows(w):  # [H*hd, C] -> [H*dp, C], zero rows at the pads
            return F.pad(w.reshape(h, hd, c), (0, 0, 0, dp - hd)).reshape(h * dp, c)

        w_qkv = torch.cat(
            [pad_rows(self.to_q.weight), pad_rows(self.to_k.weight),
             pad_rows(self.to_v.weight)], dim=0,
        )
        q, k, v = F.linear(x, w_qkv).split(h * dp, dim=-1)
        out = flash_mha_packed(q, k, v, h, hd ** -0.5)
        proj = self.to_out[0]
        w_out = F.pad(proj.weight.reshape(-1, h, hd), (0, dp - hd)).reshape(-1, h * dp)
        return F.linear(out, w_out, proj.bias)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, Q, C]
        encoder_hidden_states: Optional[torch.Tensor] = None,  # [B, K, C_enc]
        mask_bias: Optional[torch.Tensor] = None,  # [B, 1, K] additive
    ) -> torch.Tensor:
        if encoder_hidden_states is None:
            return self._self_attention(hidden_states)
        b, qlen, _ = hidden_states.shape
        klen = encoder_hidden_states.shape[1]
        h, hd = self.heads, self.head_dim
        q = self.to_q(hidden_states).view(b, qlen, h, hd).transpose(1, 2)
        k = self.to_k(encoder_hidden_states).view(b, klen, h, hd).transpose(1, 2)
        v = self.to_v(encoder_hidden_states).view(b, klen, h, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        if mask_bias is not None:
            logits = logits + mask_bias[:, None].to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, qlen, h * hd)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """x W -> (h, gate) -> h * gelu(gate), exact gelu in float32."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate.float()).to(h.dtype)


class FeedForward(nn.Module):
    """GEGLU(dim -> 4 dim) -> linear(4 dim -> dim); keys net.0.proj, net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)]
        )

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attn -> LayerNorm -> cross-attn -> LayerNorm -> FF,
    each with a residual."""

    def __init__(self, dim: int, heads: int, head_dim: int, cross_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, cross_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, encoder_hidden_states, encoder_mask_bias):
        with span("transformer"):
            x = x + self.attn1(self.norm1(x))
            x = x + self.attn2(self.norm2(x), encoder_hidden_states, encoder_mask_bias)
            return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm(eps 1e-6) -> tokens -> proj_in(C -> inner) -> blocks ->
    proj_out(inner -> C) -> + residual, on NCHW maps."""

    def __init__(self, channels: int, heads: int, cross_dim: int,
                 groups: int = 32, num_layers: int = 1):
        super().__init__()
        head_dim = channels // heads
        inner = heads * head_dim
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, head_dim, cross_dim)
             for _ in range(num_layers)]
        )
        self.proj_out = nn.Linear(inner, channels)

    def forward(self, x, encoder_hidden_states, encoder_mask_bias):
        b, c, h, w = x.shape
        tokens = self.norm(x).flatten(2).transpose(1, 2)  # [B, H*W, C]
        tokens = self.proj_in(tokens)
        for blk in self.transformer_blocks:
            tokens = blk(tokens, encoder_hidden_states, encoder_mask_bias)
        tokens = self.proj_out(tokens)
        return tokens.transpose(1, 2).reshape(b, c, h, w) + x
