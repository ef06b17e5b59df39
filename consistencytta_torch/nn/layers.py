"""Shared building blocks in PyTorch's natural layouts (NCHW, NCL).

Normalization statistics are taken in float32 whatever the compute dtype,
with the two-pass formula, and the result is cast back to the input dtype.
The normalization modules keep their affine parameters in float32
(`keep_fp32`, see utils.cast_module). Their whole forward, casts included,
is one `norm` span (utils.span).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch.utils import span


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class GroupNorm(nn.GroupNorm):
    """torch GroupNorm (consecutive channel groups) with float32 statistics
    and affine, output cast back to the input dtype."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            return F.group_norm(
                x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                self.eps,
            ).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with float32 statistics and affine."""

    keep_fp32 = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm"):
            return F.layer_norm(
                x.float(), self.normalized_shape, self.weight.float(),
                self.bias.float(), self.eps,
            ).to(x.dtype)


def nearest_upsample_2d(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NCHW map."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def asymmetric_pad_downsample(x: torch.Tensor) -> torch.Tensor:
    """The VAE encoder's (0, 1) x (0, 1) zero pad of an NCHW map before its
    stride-2 unpadded conv."""
    return F.pad(x, (0, 1, 0, 1))
