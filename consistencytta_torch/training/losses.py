"""Distillation losses with per-instance reduction: each returns a vector
[B], so that the min-SNR weights multiply before the mean. Only the latent
MSE is ported; the `mel`, `stft` and CLAP losses are not."""

from __future__ import annotations

import torch


def mse_instance(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-instance MSE [B], taken in float32."""
    d = (pred.float() - target.float()) ** 2
    return d.mean(dim=tuple(range(1, d.ndim)))
