"""Fused HiFi-GAN MRF level: kernel K3 with its plain version.

One upsample level of the vocoder runs x [B, C, L] through three
multi-dilation ResBlocks and averages them. `fused_mrf_level` takes the 18
conv weights in chain order (resblock-major; per dilation, the dilated conv
then the d=1 conv) in torch Conv1d layout [C_out, C_in, k], and their
biases. On a CUDA tensor it launches `csrc/mrf.cu` (bf16; C 32, 64 or a
multiple of 128; three ResBlocks of three dilations) and raises on anything
else; on a CPU tensor it runs `mrf_level_plain`. The backward differentiates the plain
chain, as the JAX package's custom VJP does.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from consistencytta_torch.ops import _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
WORKSPACE_GRID = 264  # blocks when the intermediates live in a workspace
MAX_TILE = 512  # positions per block
WORKSPACE_TILE = 64


def _lrelu(x, slope):
    return torch.where(x > 0, x, x * slope)


def dilated_conv1d(x: torch.Tensor, w: torch.Tensor, d: int,
                   phase_split: bool = False) -> torch.Tensor:
    """Same-length conv1d of x [B, C, L] with w [C_out, C, k] at dilation d,
    zero-padded by d*(k-1)/2. With `phase_split` and d > 1 the signal is
    split into its d phases (x[j*d + r] -> phase r, position j), each phase
    convolved at dilation 1, and the phases interleaved back: the same
    products, which cuDNN runs faster than its dilated kernels at C >= 256
    but slower at C <= 128 (PERF.md)."""
    k = w.shape[-1]
    if d == 1 or not phase_split:
        return F.conv1d(x, w, padding=d * (k - 1) // 2, dilation=d)
    b, c, n = x.shape
    m = -(-n // d)
    xp = F.pad(x, (0, m * d - n)).view(b, c, m, d).permute(0, 3, 1, 2)
    y = F.conv1d(xp.reshape(b * d, c, m), w, padding=(k - 1) // 2)
    y = y.view(b, d, -1, m).permute(0, 2, 3, 1).reshape(b, -1, m * d)
    return y[..., :n]


def mrf_level_plain(x, weights, biases, kernel_sizes, dilations, slope: float,
                    phase_split: bool = False):
    """The literal chain: 18 convs with leaky relus, residual adds and the
    3-way mean, each conv's bias added after its output is rounded to x's
    dtype (as the JAX package's per-conv formulation does). `phase_split`
    picks the dilated convs' formulation (`dilated_conv1d`)."""
    def conv(v, i, k, d):
        y = dilated_conv1d(v, weights[i], d, phase_split)
        return y + biases[i][:, None].to(y.dtype)

    acc = None
    ci = 0
    for k, ds in zip(kernel_sizes, dilations):
        xb = x
        for d in ds:
            t = conv(_lrelu(xb, slope), ci, k, d)
            t = conv(_lrelu(t, slope), ci + 1, k, 1)
            xb = xb + t
            ci += 2
        acc = xb if acc is None else acc + xb
    return acc / len(kernel_sizes)


class MrfPlan(ctypes.Structure):
    _fields_ = [("ks", ctypes.c_int * 3), ("dil", ctypes.c_int * 9)]


def halo(kernel_sizes, dilations) -> int:
    """Largest per-ResBlock halo: (k-1)/2 per conv of the chain."""
    return max(sum((d + 1) * (k - 1) // 2 for d in ds)
               for k, ds in zip(kernel_sizes, dilations))


def smem_bytes(c: int, rows: int, buffers_in_smem: bool) -> int:
    """Shared memory of one block (mirrors smem_bytes in csrc/mrf.cu):
    two weight units of min(C, 64) input x min(C, 128) output channels, and
    the two [rows, C + 8] bf16 buffers when they live there."""
    nbytes = 2 * min(c, 64) * (min(c, 128) + 8) * 2
    return nbytes + (2 * rows * (c + 8) * 2 if buffers_in_smem else 0)


def tile_plan(c: int, length: int, hmax: int):
    """(T, rows, buffers in shared memory?) for a level of width c. T is the
    largest multiple of 32 (at most 512, and no more than the signal needs)
    whose buffers of T + 2*hmax + 16 rows fit in shared memory; when not even
    T = 64 fits, the buffers go to a device workspace with T = 64."""
    free = SMEM_LIMIT - smem_bytes(c, 0, False)
    t = min(MAX_TILE, free // (2 * (c + 8) * 2) - 2 * hmax - 16)
    t = min(t, max(64, -(-length // 32) * 32)) // 32 * 32
    if t >= 64:
        return t, t + 2 * hmax + 16, True
    return WORKSPACE_TILE, WORKSPACE_TILE + 2 * hmax + 16, False


def _mrf_cuda(x, weights, biases, kernel_sizes, dilations, slope):
    b, c, length = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError("fused_mrf_level: the kernel takes contiguous bfloat16 x")
    if c not in (32, 64) and c % 128:
        raise ValueError(f"fused_mrf_level: C must be 32, 64 or a multiple of 128, got {c}")
    if len(kernel_sizes) != 3 or any(len(ds) != 3 for ds in dilations):
        raise ValueError("fused_mrf_level: the kernel takes 3 ResBlocks of 3 dilations")
    if len(weights) != 18 or len(biases) != 18:
        raise ValueError("fused_mrf_level: 18 weights and biases expected")
    for i, w in enumerate(weights):
        k = kernel_sizes[i // 6]
        if tuple(w.shape) != (c, c, k) or w.device != x.device:
            raise ValueError(f"fused_mrf_level: weight {i} has shape {tuple(w.shape)}")
    w_packed = torch.cat(
        [w.to(torch.bfloat16).permute(2, 1, 0).reshape(-1) for w in weights]
    ).contiguous()
    b_packed = torch.stack([bb.to(torch.bfloat16) for bb in biases]).contiguous()
    hmax = halo(kernel_sizes, dilations)
    t, rows, in_smem = tile_plan(c, length, hmax)
    n_work = b * -(-length // t)
    if in_smem:
        grid, workspace = n_work, None
    else:
        grid = min(n_work, WORKSPACE_GRID)
        workspace = torch.empty(
            grid * 2 * rows * (c + 8), dtype=torch.bfloat16, device=x.device
        )
    plan = MrfPlan((ctypes.c_int * 3)(*kernel_sizes),
                   (ctypes.c_int * 9)(*[d for ds in dilations for d in ds]))
    y = torch.empty_like(x)
    fn = _build.load("mrf").mrf_level_fwd
    fn.restype = ctypes.c_int
    code = fn(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        ctypes.c_void_p(w_packed.data_ptr()), ctypes.c_void_p(b_packed.data_ptr()),
        ctypes.c_void_p(workspace.data_ptr() if workspace is not None else None),
        plan, ctypes.c_int(b), ctypes.c_int(c), ctypes.c_int(length),
        ctypes.c_int(t), ctypes.c_int(rows), ctypes.c_int(grid),
        ctypes.c_float(slope), _build.stream_ptr(x.device),
    )
    _build.check(code, "fused_mrf_level")
    fused_mrf_level.launches += 1
    return y


class _FusedMrf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_sizes, dilations, slope, *params):
        ctx.save_for_backward(x, *params)
        ctx.cfg = (kernel_sizes, dilations, slope)
        n = len(params) // 2
        return _mrf_cuda(x, params[:n], params[n:], kernel_sizes, dilations, slope)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        kernel_sizes, dilations, slope = ctx.cfg
        n = len(params) // 2
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (x, *params)]
            out = mrf_level_plain(xs[0], xs[1:1 + n], xs[1 + n:],
                                  kernel_sizes, dilations, slope)
            grads = torch.autograd.grad(out, xs, g)
        return (grads[0], None, None, None, *grads[1:])


def fused_mrf_level(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    slope: float,
) -> torch.Tensor:
    """K3: one MRF level, x [B, C, L] -> [B, C, L]."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    if x.is_cuda:
        return _FusedMrf.apply(x, kernel_sizes, dilations, slope,
                               *weights, *biases)
    return mrf_level_plain(x, weights, biases, kernel_sizes, dilations, slope)


fused_mrf_level.launches = 0


def mrf_flops(b: int, c: int, length: int, kernel_sizes, dilations) -> int:
    """Operations the level needs: 2 per multiply-add of its 18 convs."""
    per_pos = sum(2 * len(ds) * k for k, ds in zip(kernel_sizes, dilations))
    return 2 * b * length * c * c * per_pos
