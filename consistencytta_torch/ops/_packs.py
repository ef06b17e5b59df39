"""Kernel-layout copies of weights, held by the module whose weights they are.

A kernel that reads its weights in a layout of its own (K3 in `ops/mrf.py`,
K5 in `ops/dilated_conv.py`), the UNet transformer's zero-padded weights
(`nn/attention.py`) and the VAE attention's fused q/k/v (`nn/vae.py`) read a
copy of the published-shape weights. Each copy sits in a `Pack` that its
owner, the module whose weights it copies, holds as a plain attribute (not a
parameter or buffer, so state dicts do not see it); it lives and dies with
that module. The rule, the one place it is written:

- where any source tensor requires grad, the copy is made at every call and
  kept by nobody, so the gradient reaches the published-shape parameters and
  an optimizer step is read whether or not it moves a version counter (the
  fused AdamW does not, torch 2.11);
- where the sources are other tensors than last time (another data pointer,
  or another tensor object at the same one), a new copy is made, detached;
- where only their in-place version counters moved (a load_state_dict into
  the same tensors, an EMA step), the copy is made anew into the same
  storage, so a CUDA graph that reads that storage reads the new values;
- else the kept copy is returned.

An in-place update must move the version counter: on CUDA
`torch._foreach_lerp_` does not (torch 2.11), so `training/ema.py:ema_update`
moves it itself. A deepcopy or pickle of the owner gives an empty `Pack`.
"""

from __future__ import annotations

import weakref
from typing import Callable, Sequence

import torch


def _flat(copy) -> list:
    return [copy] if isinstance(copy, torch.Tensor) else list(copy)


class Pack:
    """One kernel-layout copy of a set of tensors (see the module docstring)."""

    __slots__ = ("ptrs", "refs", "versions", "copy")

    def __init__(self):
        self.ptrs, self.refs, self.versions, self.copy = (), (), (), None

    def __reduce__(self):
        return Pack, ()

    def get(self, tensors: Sequence[torch.Tensor], make: Callable[[], object]):
        """The copy that `make()` gives of `tensors` (a tensor or a tuple of
        them), made or kept as the module docstring says."""
        if any(t.requires_grad for t in tensors):
            return make()
        ptrs = tuple(t.data_ptr() for t in tensors)
        versions = tuple(t._version for t in tensors)
        if ptrs != self.ptrs or any(r() is not t for r, t in zip(self.refs, tensors)):
            copy = make()
            self.copy = copy.detach() if isinstance(copy, torch.Tensor) else tuple(
                t.detach() for t in copy)
            self.ptrs, self.refs = ptrs, tuple(weakref.ref(t) for t in tensors)
        elif versions != self.versions:
            for dst, src in zip(_flat(self.copy), _flat(make())):
                if dst.data_ptr() != src.data_ptr():  # a copy that is its source is current
                    dst.copy_(src)
        self.versions = versions
        return self.copy
