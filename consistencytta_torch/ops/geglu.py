"""The UNet transformer's GEGLU activation: one CUDA source with its plain
version.

`geglu(y)` takes the `proj` GEMM's output y [..., 2N], h its first N
features and gate its last N, and returns h * gelu(gate) [..., N]: the
gelu exact (erf) in float32, rounded to y's dtype before the product, as
the module computed it before the kernel (`geglu_plain`). On a CPU tensor it
runs the plain version. On a CUDA tensor it launches `csrc/geglu.cu`
(`ctta_geglu_kernel`: h and gate read once, the product written once) and
raises on anything that kernel does not take: a dtype other than bfloat16,
N not a multiple of 8 elements (16 bytes), a non-contiguous y or one not
16-byte aligned. It never falls back. A call with a gradient goes through
`_Geglu`, whose backward is autograd through the plain version recomputed
from the saved y. `geglu.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from consistencytta_torch.ops import _build

VEC = 8  # bf16 elements in the kernel's 16-byte vectors; N must be a multiple of it
LAUNCH_NAME = "ctta_geglu"  # in the kernel's name, and in no kernel of torch's


def geglu_plain(y: torch.Tensor) -> torch.Tensor:
    h, gate = y.chunk(2, dim=-1)
    return h * F.gelu(gate.float()).to(h.dtype)


def _geglu_cuda(y: torch.Tensor) -> torch.Tensor:
    if y.dtype != torch.bfloat16:
        raise TypeError(f"geglu: the kernel takes bfloat16, got {y.dtype}")
    width = y.shape[-1]
    n = width // 2
    if width % 2 or n % VEC or y.numel() == 0:
        raise ValueError(f"geglu: y of shape {tuple(y.shape)}: the kernel takes two halves of "
                         f"a multiple of {VEC} features each")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("geglu: the kernel takes a contiguous, 16-byte aligned y")
    out = torch.empty((*y.shape[:-1], n), dtype=y.dtype, device=y.device)
    fn = _build.load("geglu").geglu_fwd
    fn.restype = ctypes.c_int
    code = fn(ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(out.data_ptr()),
              ctypes.c_longlong(y.numel() // width), ctypes.c_int(n),
              _build.stream_ptr(y.device))
    _build.check(code, "geglu")
    geglu.launches += 1
    return out


class _Geglu(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd through the plain version."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return _geglu_cuda(y)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        with torch.enable_grad():
            leaf = y.detach().requires_grad_()
            return torch.autograd.grad(geglu_plain(leaf), leaf, g)[0]


def geglu(y: torch.Tensor) -> torch.Tensor:
    """h * gelu(gate) of y's two halves along its last axis."""
    if not y.is_cuda:
        return geglu_plain(y)
    if torch.is_grad_enabled() and y.requires_grad:
        return _Geglu.apply(y)
    return _geglu_cuda(y)


geglu.launches = 0
