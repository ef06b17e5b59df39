"""Spatial transformer for the UNet: attention, GEGLU FF, transformer blocks
(diffusers Attention / BasicTransformerBlock / Transformer2DModel with
linear projections), with diffusers state-dict key names.

The transformer inner dim is heads * (channels // heads): 255/510/1020 for
the light config, head width 51. A bf16 row of 255 or 510 elements is not a
multiple of 16 bytes, and on such rows cuBLAS falls back to its sm75 / sm80
`align1` / `align2` GEMMs. So `Transformer2D` carries its tokens at
`aligned(inner)` features, 256/512/1024, the extra ones exact zeros, and
every GEMM of the block reads zero-padded copies of the weights, which keep
their published shapes and state-dict keys:

- `proj_in` gets zero output rows and bias up to the token width;
  `proj_out` reads the tokens through zero columns;
- self-attention is unmasked and always goes through
  `ops.attention.flash_mha_packed` (kernel K1 on the card): each head of
  the fused QKV projection is padded from 51 to 64 with zero rows, and its
  input columns to the token width; `to_out` reads the 64-wide heads
  through zero columns and writes zero rows and bias at the token pads;
- cross-attention (K = text length, with the -10000 padding bias, on plain
  tensor ops) pads its heads to 64 the same way, so its logits and value
  products run at a head width of 64 (the pads' logits terms are 0, and
  their output features 0); the softmax scale stays 51 ** -0.5;
- the GEGLU `proj` pads each half to aligned(4 * inner) rows (1024 for
  1020; a pad's h is 0, so h * gelu(gate) is 0 there), and `net.2` reads
  them through zero columns and writes zero rows at the token pads;
- the three LayerNorms take their statistics over the true features and
  write 0 at the pads (`nn.layers.LayerNorm`).

Each padding is a zero extension, so every product and sum is the unpadded
one plus exact zeros. The padding follows what a module observes, the token
width it is handed and its head width: where the inner dim and the head
width are multiples of 8 elements already (the tiny configurations,
tango-full's 320/640/1280 at head width 64) nothing is padded but K1's
heads, and the modules run the unpadded formulation. The padded copies are
held by the module whose weights they are (`Transformer2D`: proj_in and
proj_out; `Attention`, `GEGLU`, `FeedForward`: net.2), in an
`ops._packs.Pack`, which says when a copy is made anew.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch.nn.layers import GroupNorm, LayerNorm
from consistencytta_torch.ops._packs import Pack
from consistencytta_torch.ops.attention import flash_mha_packed, head_pad
from consistencytta_torch.ops.geglu import geglu
# ALIGN elements are 16 bytes of bf16, the row alignment cuBLAS's Hopper GEMMs
# take; the LayerNorms take rows padded to it
from consistencytta_torch.ops.norm import PAD_ALIGN as ALIGN
from consistencytta_torch.utils import span


def aligned(n: int) -> int:
    """n rounded up to a multiple of ALIGN."""
    return -(-n // ALIGN) * ALIGN


def _pad(t: torch.Tensor, rows: Optional[int] = None, cols: Optional[int] = None):
    """t ([R, C] or [R]) with zero rows appended up to `rows` and zero
    columns up to `cols`; t itself where it has that shape."""
    rows = t.shape[0] if rows is None else rows
    if t.dim() == 1:
        return t if rows == t.shape[0] else F.pad(t, (0, rows - t.shape[0]))
    cols = t.shape[1] if cols is None else cols
    if (rows, cols) == tuple(t.shape):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _pad_heads(w: torch.Tensor, heads: int, width: int, to: int, dim: int) -> torch.Tensor:
    """w with each head's `width` rows (dim 0) or columns (dim 1) followed by
    to - width zero ones; w itself where to == width."""
    if to == width:
        return w
    if dim == 0:
        return F.pad(w.reshape(heads, width, -1), (0, 0, 0, to - width)).reshape(heads * to, -1)
    return F.pad(w.reshape(-1, heads, width), (0, to - width)).reshape(-1, heads * to)


def padded_linear(lin: nn.Linear, rows: int, cols: int, pack: Pack):
    """(weight, bias) of `lin` with zero output rows and bias up to `rows`
    and zero input columns up to `cols`, kept in `pack`; its own where no
    padding is needed."""
    w, b = lin.weight, lin.bias
    if tuple(w.shape) == (rows, cols):
        return w, b
    return pack.get((w, b), lambda: (_pad(w, rows, cols), _pad(b, rows)))


class Attention(nn.Module):
    """Multi-head attention; to_q/to_k/to_v have no bias, to_out does.
    Softmax scale head_dim ** -0.5, logits and softmax in float32. Takes
    and returns tokens of any width from query_dim up, zeros after
    query_dim in and out."""

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
        self.pack = Pack()

    def _weights(self, width: int, pad_to: int, fused: bool):
        """(QKV weight(s), to_out weight, to_out bias, head width) for tokens
        `width` wide and heads padded to `pad_to`: one fused QKV weight
        [3 H pad_to, width] for self-attention (`fused`), else q [H pad_to,
        width], k and v [H pad_to, cross_dim]."""
        h, hd = self.heads, self.head_dim
        q, k, v = self.to_q.weight, self.to_k.weight, self.to_v.weight
        wo, bo = self.to_out[0].weight, self.to_out[0].bias
        if not fused and pad_to == hd and width == q.shape[1]:
            return (q, k, v), wo, bo, hd

        def make():
            heads = [_pad_heads(w, h, hd, pad_to, 0) for w in (q, k, v)]
            qkv = (_pad(torch.cat(heads), cols=width),) if fused else (
                _pad(heads[0], cols=width), *heads[1:])
            return (*qkv, _pad(_pad_heads(wo, h, hd, pad_to, 1), rows=width), _pad(bo, width))

        *qkv, w_out, b_out = self.pack.get((q, k, v, wo, bo), make)
        return tuple(qkv), w_out, b_out, pad_to

    def _self_attention(self, x: torch.Tensor) -> torch.Tensor:
        (w_qkv,), w_out, b_out, dp = self._weights(x.shape[-1], head_pad(self.head_dim), True)
        q, k, v = F.linear(x, w_qkv).split(self.heads * dp, dim=-1)
        out = flash_mha_packed(q, k, v, self.heads, self.head_dim ** -0.5)
        return F.linear(out, w_out, b_out)

    def forward(
        self,
        hidden_states: torch.Tensor,  # [B, Q, C]
        encoder_hidden_states: Optional[torch.Tensor] = None,  # [B, K, C_enc]
        mask_bias: Optional[torch.Tensor] = None,  # [B, 1, K] additive
    ) -> torch.Tensor:
        if encoder_hidden_states is None:
            return self._self_attention(hidden_states)
        b, qlen, width = hidden_states.shape
        klen = encoder_hidden_states.shape[1]
        h, hd = self.heads, self.head_dim
        (wq, wk, wv), w_out, b_out, dp = self._weights(
            width, hd if hd % ALIGN == 0 else head_pad(hd), False)
        q = F.linear(hidden_states, wq).view(b, qlen, h, dp).transpose(1, 2)
        k = F.linear(encoder_hidden_states, wk).view(b, klen, h, dp).transpose(1, 2)
        v = F.linear(encoder_hidden_states, wv).view(b, klen, h, dp).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        if mask_bias is not None:
            logits = logits + mask_bias[:, None].to(logits.dtype)
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, qlen, h * dp)
        return F.linear(out, w_out, b_out)


class GEGLU(nn.Module):
    """x W -> (h, gate) -> h * gelu(gate), exact gelu in float32 rounded to
    the input's dtype before the product (`ops.geglu.geglu`: one kernel
    launch on the card); each half zero-padded to aligned(dim_out)
    features."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)
        self.pack = Pack()

    def _weights(self, width: int):
        """`proj`'s weight and bias, each half (h, gate) padded like a head."""
        w, b = self.proj.weight, self.proj.bias
        half = w.shape[0] // 2
        out = aligned(half)
        if (out, width) == (half, w.shape[1]):
            return w, b
        return self.pack.get((w, b), lambda: (
            _pad(_pad_heads(w, 2, half, out, 0), cols=width),
            _pad_heads(b[None], 2, half, out, 1)[0]))

    def forward(self, x):
        return geglu(F.linear(x, *self._weights(x.shape[-1])))


class FeedForward(nn.Module):
    """GEGLU(dim -> 4 dim) -> linear(4 dim -> dim); keys net.0.proj, net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)]
        )
        self.pack = Pack()  # net.2's

    def forward(self, x):
        h = self.net[0](x)
        return F.linear(h, *padded_linear(self.net[2], x.shape[-1], h.shape[-1], self.pack))


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
    proj_out(inner -> C) -> + residual, on NCHW maps; the tokens carry
    aligned(inner) features, zeros after inner."""

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
        self.proj_in_pack, self.proj_out_pack = Pack(), Pack()

    def forward(self, x, encoder_hidden_states, encoder_mask_bias):
        b, c, h, w = x.shape
        tokens = self.norm(x).flatten(2).transpose(1, 2)  # [B, H*W, C]
        width = aligned(self.proj_in.out_features)
        tokens = F.linear(tokens, *padded_linear(self.proj_in, width, c, self.proj_in_pack))
        for blk in self.transformer_blocks:
            tokens = blk(tokens, encoder_hidden_states, encoder_mask_bias)
        tokens = F.linear(tokens, *padded_linear(self.proj_out, c, width, self.proj_out_pack))
        return tokens.transpose(1, 2).reshape(b, c, h, w) + x
