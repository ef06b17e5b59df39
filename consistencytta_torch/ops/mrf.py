"""Fused HiFi-GAN MRF level: kernel K3 with its plain version.

One upsample level of the vocoder runs x [B, C, L] through three
multi-dilation ResBlocks and averages them. `fused_mrf_level` takes the 18
conv weights in chain order (resblock-major; per dilation, the dilated conv
then the d=1 conv) in torch Conv1d layout [C_out, C_in, k], and their
biases. On a CUDA tensor it launches `csrc/mrf.cu` (bf16; C 32, 64 or a
multiple of 128; three ResBlocks of three dilations) and raises on
anything else; on a CPU tensor it runs `mrf_level_plain`. The backward
differentiates the plain chain, as the JAX package's custom VJP does.

The kernel takes the weights packed K-major (`pack_weights`), kept in the
caller's `ops._packs.Pack` (one a level: `HiFiGANGenerator` holds them).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from consistencytta_torch.ops import _build
from consistencytta_torch.ops._packs import Pack

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
STAGES = 4  # weight units in the kernel's ring
UNIT_K = 64  # reduction values (tap x input channel) of a weight unit
BAR_BYTES = 128  # the ring's mbarriers
CONSUMER_GROUPS = 2  # consumer warpgroups a block


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


def co_width(c: int) -> int:
    """Output channels of one pass of the kernel (CO in csrc/mrf.cu)."""
    return min(c, 128)


def m_tiles(c: int) -> int:
    """64-row m-tiles of accumulators a consumer warpgroup holds (MT)."""
    return {32: 6, 64: 4}.get(c, 2)


def smem_bytes(c: int, rows: int, buffers_in_smem: bool) -> int:
    """Shared memory of one block (mirrors smem_bytes in csrc/mrf.cu): the
    ring of weight units, its barriers, the 1024-byte alignment slack, and the
    two [rows, C + 8] bf16 buffers when they live there."""
    nbytes = STAGES * co_width(c) * 128 + BAR_BYTES + 1024
    return nbytes + (2 * rows * (c + 8) * 2 if buffers_in_smem else 0)


def tile_plan(c: int, length: int, kernel_sizes, dilations) -> Tuple[int, int, bool]:
    """(T, rows, buffers in shared memory?) for a level of width c. T, a
    multiple of 8 and no more than the signal needs, is bounded by the
    m-tiles of a block (the widest conv range, T + 2 H_k minus the first
    conv's padding, must fit 2 * MT * 64 rows) and, with the buffers in shared
    memory, by their T + 2 * halo rows. Widths of one output pass (C <= 128)
    keep their two buffers in shared memory; the wider ones take three in a
    device workspace."""
    hmax = halo(kernel_sizes, dilations)
    widest = max(2 * sum((d + 1) * (k - 1) // 2 for d in ds) - 2 * ds[0] * (k - 1) // 2
                 for k, ds in zip(kernel_sizes, dilations))
    need = -(-length // 8) * 8
    cover = CONSUMER_GROUPS * m_tiles(c) * 64 - widest
    per_row = 2 * (c + 8) * 2
    fit = (SMEM_LIMIT - smem_bytes(c, 0, False)) // per_row - 2 * hmax
    if c <= 128:
        t = min(cover, fit, need) // 8 * 8
        return t, t + 2 * hmax, True
    t = min(cover, need) // 8 * 8
    return t, t + 2 * hmax, False


def pack_weights(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                 kernel_sizes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 18 convs as the kernel reads them: [18 * C_out, kpad] bf16, row
    conv * C + c_out holding tap t, input channel c_in at column t * C + c_in,
    zeros after the conv's last tap up to kpad (the widest conv's k * C,
    rounded up to a multiple of 64); and the biases [18, C] bf16."""
    c = weights[0].shape[0]
    kpad = -(-max(kernel_sizes) * c // UNIT_K) * UNIT_K
    rows = [F.pad(w.detach().to(torch.bfloat16).permute(0, 2, 1).reshape(c, -1),
                  (0, kpad - w.shape[-1] * c)) for w in weights]
    return (torch.cat(rows).contiguous(),
            torch.stack([b.detach().to(torch.bfloat16) for b in biases]).contiguous())


def _mrf_cuda(x, weights, biases, kernel_sizes, dilations, slope, out=None,
              pack: Optional[Pack] = None):
    """Launch K3 on the weights kept in `pack` (packed for this call alone
    without one); `out` ([B, C, L] bf16, contiguous, 16-byte aligned) is
    written in place of a new tensor when given."""
    b, c, length = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError("fused_mrf_level: the kernel takes contiguous bfloat16 x")
    if c not in (32, 64) and c % 128:
        raise ValueError(f"fused_mrf_level: C must be 32, 64 or a multiple of 128, got {c}")
    if len(kernel_sizes) != 3 or any(len(ds) != 3 for ds in dilations):
        raise ValueError("fused_mrf_level: the kernel takes 3 ResBlocks of 3 dilations")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError("fused_mrf_level: the kernel takes odd kernel sizes")
    if len(weights) != 18 or len(biases) != 18:
        raise ValueError("fused_mrf_level: 18 weights and biases expected")
    for i, w in enumerate(weights):
        k = kernel_sizes[i // 6]
        if tuple(w.shape) != (c, c, k) or w.device != x.device:
            raise ValueError(f"fused_mrf_level: weight {i} has shape {tuple(w.shape)}")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel's 16-byte loads
    make = lambda: pack_weights(weights, biases, kernel_sizes)
    w_packed, b_packed = make() if pack is None else pack.get((*weights, *biases), make)
    t, rows, in_smem = tile_plan(c, length, kernel_sizes, dilations)
    n_work = b * -(-length // t)
    if in_smem:
        grid, workspace = n_work, None
    else:
        grid = min(n_work, torch.cuda.get_device_properties(x.device).multi_processor_count)
        workspace = torch.empty(
            grid * 3 * rows * (c + 8), dtype=torch.bfloat16, device=x.device
        )
    plan = MrfPlan((ctypes.c_int * 3)(*kernel_sizes),
                   (ctypes.c_int * 9)(*[d for ds in dilations for d in ds]))
    y = torch.empty_like(x) if out is None else out
    if y.shape != x.shape or y.dtype != x.dtype or not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("fused_mrf_level: out must be a contiguous, aligned tensor like x")
    fn = _build.load("mrf").mrf_level_fwd
    fn.restype = ctypes.c_int
    code = fn(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        ctypes.c_void_p(w_packed.data_ptr()), ctypes.c_void_p(b_packed.data_ptr()),
        ctypes.c_void_p(workspace.data_ptr() if workspace is not None else None),
        plan, ctypes.c_int(b), ctypes.c_int(c), ctypes.c_int(length),
        ctypes.c_int(t), ctypes.c_int(rows), ctypes.c_int(grid),
        ctypes.c_int(w_packed.shape[1]), ctypes.c_float(slope), _build.stream_ptr(x.device),
    )
    _build.check(code, "fused_mrf_level")
    fused_mrf_level.launches += 1
    return y


class _FusedMrf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_sizes, dilations, slope, pack, *params):
        ctx.save_for_backward(x, *params)
        ctx.cfg = (kernel_sizes, dilations, slope)
        n = len(params) // 2
        return _mrf_cuda(x, params[:n], params[n:], kernel_sizes, dilations, slope, pack=pack)

    @staticmethod
    def backward(ctx, g):
        # autograd through the plain version, for the inputs that need a
        # gradient only: a frozen vocoder's weights take none
        x, *params = ctx.saved_tensors
        kernel_sizes, dilations, slope = ctx.cfg
        n = len(params) // 2
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[5:])
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need) for t, need in zip((x, *params), needs)]
            out = mrf_level_plain(xs[0], xs[1:1 + n], xs[1 + n:],
                                  kernel_sizes, dilations, slope)
            found = iter(torch.autograd.grad(out, [t for t in xs if t.requires_grad], g))
        grads = [next(found) if need else None for need in needs]
        return (grads[0], None, None, None, None, *grads[1:])


def fused_mrf_level(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    slope: float,
    pack: Optional[Pack] = None,
) -> torch.Tensor:
    """K3: one MRF level, x [B, C, L] -> [B, C, L]. The kernel's weight
    layout is kept in `pack`, which a caller that runs the level again holds;
    without one it is made for this call alone."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    if x.is_cuda:
        return _FusedMrf.apply(x, kernel_sizes, dilations, slope, pack, *weights, *biases)
    return mrf_level_plain(x, weights, biases, kernel_sizes, dilations, slope)


fused_mrf_level.launches = 0


def mrf_flops(b: int, c: int, length: int, kernel_sizes, dilations) -> int:
    """Operations the level needs: 2 per multiply-add of its 18 convs."""
    per_pos = sum(2 * len(ds) * k for k, ds in zip(kernel_sizes, dilations))
    return 2 * b * length * c * c * per_pos


def weight_l2_bytes(b: int, c: int, length: int, kernel_sizes, dilations) -> int:
    """Bytes of weights the kernel streams from L2 for one level: every
    weight unit once per tile (the packed taps, rounded up to whole units)."""
    t, _, _ = tile_plan(c, length, kernel_sizes, dilations)
    units = sum(6 * -(-k * c // UNIT_K) for k in kernel_sizes) * (c // co_width(c))
    return b * -(-length // t) * units * co_width(c) * UNIT_K * 2
