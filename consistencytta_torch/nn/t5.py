"""T5 v1.1 text encoder (FLAN-T5-Large by default).

RMSNorm, bidirectional relative-position buckets, gated-gelu FF and no
attention scaling, with HF `T5EncoderModel` state-dict key names
(`shared`, `encoder.block.{i}.layer.{0,1}...`, `encoder.final_layer_norm`).
The relative-position table lives on block 0 only, as in HF. Attention
logits and softmax run in float32; the padding mask is a -1e9 additive bias.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch import graphs
from consistencytta_torch.configs import T5Config
from consistencytta_torch.ops import norm
from consistencytta_torch.utils import span


class RMSNorm(nn.Module):
    """T5 LayerNorm: no mean subtraction, no bias; float32 statistics
    (`ops.norm.rms_norm`)."""

    keep_fp32 = True

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            return norm.rms_norm(x.contiguous(), self.weight, self.eps)


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int = 32, max_distance: int = 128
) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int64)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads
            )

    def forward(self, x, bias):
        b, L, _ = x.shape
        split = lambda t: t.view(b, L, self.heads, self.d_kv).transpose(1, 2)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        # T5 does not scale by sqrt(d): the scale is folded into its init
        logits = q.float() @ k.float().transpose(-1, -2) + bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(b, L, self.heads * self.d_kv)
        return self.o(out)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5SelfAttention(cfg, has_relative_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        # tanh-approximated gelu in float32 (HF NewGELUActivation)
        gate = F.gelu(self.wi_0(h).float(), approximate="tanh").to(h.dtype)
        return self.wo(gate * self.wi_1(h))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        if cfg.feed_forward_proj != "gated-gelu":
            raise ValueError(f"unsupported feed_forward_proj {cfg.feed_forward_proj!r}")
        self.DenseReluDense = T5DenseGatedGelu(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList(
            [T5LayerSelfAttention(cfg, has_relative_bias), T5LayerFF(cfg)]
        )

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(
            [T5Block(cfg, i == 0) for i in range(cfg.num_layers)]
        )
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """input_ids [B, L], attention_mask [B, L] -> hidden states [B, L, d]
    in float32. A frozen inference call replays a CUDA graph (graphs.py)."""

    def __init__(self, config: T5Config = T5Config()):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        return graphs.run(self, "t5", self._forward, input_ids, attention_mask)

    def _forward(self, input_ids, attention_mask):
        cfg = self.config
        x = self.shared(input_ids.long())
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance,
        )
        rel = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
        position_bias = rel(buckets).float().permute(2, 0, 1)[None]  # [1, H, L, L]
        mask_bias = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, -1e9
        ).float()
        bias = position_bias + mask_bias
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x).float()
