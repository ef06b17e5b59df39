"""Exponential moving averages over module parameters. The consistency
recipe keeps two shadows of the student: the target network (decay 0.95) and
the inference EMA (decay 0.999)."""

from __future__ import annotations

import torch
from torch import nn

from consistencytta_torch.parallel.mesh import ShadowShard


@torch.no_grad()
def ema_update(shadow, module: nn.Module, decay: float) -> None:
    """shadow <- shadow + (1 - decay) * (module - shadow), in place over the
    two modules' parameters (same architecture, same order); a ZeRO-1
    `ShadowShard` over the rank's range of them."""
    if isinstance(shadow, ShadowShard):
        s, p = shadow.pieces, shadow.views_of(module)
    else:
        s, p = list(shadow.parameters()), list(module.parameters())
    if len(s) != len(p):
        raise ValueError("ema_update: the modules differ in their parameters")
    torch._foreach_lerp_(s, p, 1.0 - decay)
    # on CUDA the fused lerp leaves the tensors' version counters as they were
    # (torch 2.11); the weight copies read them (ops/_packs.py), and so do
    # the CUDA graphs (graphs.py)
    torch.autograd.graph.increment_version(s)
