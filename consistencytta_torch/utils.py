"""Device and precision helpers shared by the port's entry points."""

from __future__ import annotations

import torch
from torch import nn


def resolve_device(device="cuda") -> torch.device:
    """The device a caller asked for. Asking for CUDA where no card is
    present raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions"
        )
    return dev


def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast a module's parameters to the compute dtype, except those of
    submodules flagged `keep_fp32` (normalization affines, the frozen
    Fourier projection): the JAX package applies those in float32 under
    bf16 compute, and so does the port."""
    module.to(dtype)
    for m in module.modules():
        if getattr(m, "keep_fp32", False):
            m.float()
    return module
