"""Plain building blocks of the reference: float32 linears and convolutions
whose inputs and weights may be put through a fake quantizer (the control),
normalizations, and softmax attention over whole rows."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def float8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with one scale for the tensor (its absolute
    maximum onto the format's largest value), back in x's dtype."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(FP8).to(x.dtype) * scale


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class Quantized:
    """Mixin: `quant`, when set, rounds what a product reads and writes: a
    layer's input, weight and output, an attention's q, k, v, probabilities
    and output."""

    quant: Optional[Callable] = None

    def _q(self, t):
        return t if self.quant is None else self.quant(t)


class Linear(Quantized, nn.Linear):
    def forward(self, x):
        return self._q(F.linear(self._q(x), self._q(self.weight), self.bias))


class Conv1d(Quantized, nn.Conv1d):
    def forward(self, x):
        return self._q(self._conv_forward(self._q(x), self._q(self.weight), self.bias))


class Conv2d(Quantized, nn.Conv2d):
    def forward(self, x):
        return self._q(self._conv_forward(self._q(x), self._q(self.weight), self.bias))


class ConvTranspose1d(Quantized, nn.ConvTranspose1d):
    def forward(self, x):
        return self._q(F.conv_transpose1d(self._q(x), self._q(self.weight), self.bias,
                                          self.stride, self.padding, self.output_padding,
                                          self.groups, self.dilation))


def fake_quant(model: nn.Module, quant: Optional[Callable] = float8_round) -> nn.Module:
    """Set (or with None clear) the quantizer of every linear and conv."""
    for m in model.modules():
        if isinstance(m, Quantized):
            m.quant = quant
    return model


def attention(q, k, v, scale: float, bias=None, quant: Optional[Callable] = None):
    """softmax(q k^T * scale + bias) v over [..., S, D]; `quant` rounds the
    products' operands and the output."""
    r = quant or (lambda t: t)
    logits = torch.matmul(r(q), r(k).transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    return r(torch.matmul(r(torch.softmax(logits, dim=-1)), r(v)))


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
