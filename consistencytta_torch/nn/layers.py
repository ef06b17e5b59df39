"""Shared building blocks in PyTorch's natural layouts (NCHW, NCL).

The normalization modules keep their affine parameters in float32
(`keep_fp32`, see utils.cast_module) and take float32 statistics whatever
the compute dtype, with the two-pass formula, rounding the result to the
input dtype once. On the card a call launches one kernel of `csrc/norm.cu`
(`ops/norm.py`: bf16 or float32 in, the statistics, the affine and, where
the caller asks, the SiLU after a GroupNorm in registers, the output
written once); on the CPU it runs the plain float32 code. Their whole
forward is one `norm` span (utils.span).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch.ops import norm
from consistencytta_torch.utils import span


class GroupNorm(nn.GroupNorm):
    """torch GroupNorm (consecutive channel groups) with float32 statistics
    and affine, output cast back to the input dtype; `silu` applies a SiLU
    to the float32 result before that cast."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        with span("norm"):
            return norm.group_norm(x.contiguous(), self.num_groups, self.weight, self.bias,
                                   self.eps, silu)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with float32 statistics and affine. A
    row padded past `normalized_shape` to the next multiple of 8 features
    (the UNet transformer's zero-padded tokens) takes its statistics over
    the true features, and its padding comes out 0; a row of any other
    width is refused."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            return norm.layer_norm(x.contiguous(), self.weight, self.bias, self.eps,
                                   self.normalized_shape[-1])


def nearest_upsample_2d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NCHW map."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def asymmetric_pad_downsample(x: torch.Tensor) -> torch.Tensor:
    """The VAE encoder's (0, 1) x (0, 1) zero pad of an NCHW map before its
    stride-2 unpadded conv."""
    return F.pad(x, (0, 1, 0, 1))
