"""HiFi-GAN MRF level: kernels K3 and K7 with their plain version.

One upsample level of the vocoder runs x [B, C, L] through three
multi-dilation ResBlocks and averages them. `fused_mrf_level` and
`wide_mrf_level` take the 18 conv weights in chain order (resblock-major;
per dilation, the dilated conv then the d=1 conv) in torch Conv1d layout
[C_out, C_in, k], and their biases. On a CPU tensor both run
`mrf_level_plain`. On a CUDA tensor `fused_mrf_level` launches K3
(`csrc/mrf.cu`: the whole level in one launch; bf16; C 32, 64 or a multiple
of 128; three ResBlocks of three dilations) and `wide_mrf_level` launches
K7 (`csrc/conv_nlc.cu`: one channels-last implicit-GEMM launch a conv, the
level's elementwise work in its epilogue; bf16; C a multiple of 64 above
128; odd kernel sizes); each raises on anything else. The backward
differentiates the plain chain, as the JAX package's custom VJP does.

Each kernel takes the weights in a layout of its own (`pack_weights`,
`pack_nlc_weights`), kept in the caller's `ops._packs.Pack` (one a level:
`HiFiGANGenerator` holds them).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

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


class _MrfLevel(torch.autograd.Function):
    """A level on the card (`run`: `_mrf_cuda` or `_wide_cuda`), its backward
    autograd through the plain chain."""

    @staticmethod
    def forward(ctx, x, run, kernel_sizes, dilations, slope, pack, *params):
        ctx.save_for_backward(x, *params)
        ctx.cfg = (kernel_sizes, dilations, slope)
        n = len(params) // 2
        return run(x, params[:n], params[n:], kernel_sizes, dilations, slope, pack=pack)

    @staticmethod
    def backward(ctx, g):
        # autograd through the plain version, for the inputs that need a
        # gradient only: a frozen vocoder's weights take none
        x, *params = ctx.saved_tensors
        kernel_sizes, dilations, slope = ctx.cfg
        n = len(params) // 2
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[6:])
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(need) for t, need in zip((x, *params), needs)]
            out = mrf_level_plain(xs[0], xs[1:1 + n], xs[1 + n:],
                                  kernel_sizes, dilations, slope)
            found = iter(torch.autograd.grad(out, [t for t in xs if t.requires_grad], g))
        grads = [next(found) if need else None for need in needs]
        return (grads[0], None, None, None, None, None, *grads[1:])


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
        return _MrfLevel.apply(x, _mrf_cuda, kernel_sizes, dilations, slope, pack,
                               *weights, *biases)
    return mrf_level_plain(x, weights, biases, kernel_sizes, dilations, slope)


fused_mrf_level.launches = 0


# -- K7: the wide levels, one channels-last implicit-GEMM launch a conv -------

WIDE_LAUNCH_NAME = "ctta_conv_nlc"  # in the name of each of K7's kernels, and no other's
WIDE_TILE_M = 128  # positions of a K7 tile (csrc/conv_nlc.cu BM)


def wide_tile_n(c: int, b: int, length: int, sms: int) -> int:
    """Output channels of a K7 tile: the widest of 256, 128 and 64 that
    divides C and still gives every SM a tile, else the narrowest that divides
    C (batch 1 at C = 512 takes 128: 164 tiles rather than 82)."""
    fits = [n for n in (256, 128, 64) if c % n == 0]
    m_tiles = b * -(-length // WIDE_TILE_M)
    return next((n for n in fits if m_tiles * (c // n) >= sms), fits[-1])


def pack_nlc_weights(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The convs as K7 reads them: one flat bf16 tensor holding, back to back,
    each conv's [C_out, k * C_in] with tap t, input channel c_in at column
    t * C + c_in; and the biases [n, C] in float32, of the bf16 values that
    the plain chain adds."""
    w = torch.cat([w.detach().to(torch.bfloat16).permute(0, 2, 1).reshape(-1) for w in weights])
    b = torch.stack([b.detach().to(torch.bfloat16).float() for b in biases])
    return w.contiguous(), b.contiguous()


class WideStep(NamedTuple):
    """One conv launch of a K7 level: conv `conv` of the chain at (k, d),
    reading buffer `src`; t = (conv + bias + `res` + `total`) * `scale`;
    y0 = lrelu(t) if `act0` else t, and y1 = lrelu(t) where named. Buffers
    are [B, L, C]: "xt" (x), "u0" (lrelu(x)), "u", "v", "xb", "acc"."""

    conv: int
    k: int
    d: int
    src: str
    y0: str
    y1: Optional[str] = None
    res: Optional[str] = None
    total: Optional[str] = None
    act0: bool = False
    scale: float = 1.0


def wide_plan(kernel_sizes, dilations) -> List[WideStep]:
    """K7's conv launches for a level, in order. Per dilation pair of a
    ResBlock: v = lrelu(conv1(u) + b); then xb' = xb + conv2(v) + b with
    u' = lrelu(xb'), or at the ResBlock's last pair xb' into the running sum
    "acc", which the last ResBlock's turns into the mean, written to "u"
    (free by then). A ResBlock's first pair reads u0 and adds xt."""
    steps, i, n = [], 0, len(kernel_sizes)
    for r, (k, ds) in enumerate(zip(kernel_sizes, dilations)):
        for p, d in enumerate(ds):
            steps.append(WideStep(i, k, d, "u0" if p == 0 else "u", "v", act0=True))
            res = "xt" if p == 0 else "xb"
            total = "acc" if r else None
            if p < len(ds) - 1:
                steps.append(WideStep(i + 1, k, 1, "v", "xb", "u", res))
            elif r < n - 1:
                steps.append(WideStep(i + 1, k, 1, "v", "acc", None, res, total))
            else:
                steps.append(WideStep(i + 1, k, 1, "v", "u", None, res, total, scale=1.0 / n))
            i += 2
    return steps


def _wide_cuda(x, weights, biases, kernel_sizes, dilations, slope, pack: Optional[Pack] = None):
    """Run a level on K7: x to [B, L, C] with lrelu(x) beside it, the
    `wide_plan` launches (the module note of csrc/conv_nlc.cu), the mean back
    to [B, C, L]."""
    b, c, length = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError("wide_mrf_level: the kernel takes bfloat16 x")
    if c <= 128 or c % 64:
        raise ValueError(f"wide_mrf_level: C must be a multiple of 64 above 128, got {c}")
    if any(k % 2 == 0 for k in kernel_sizes):
        raise ValueError("wide_mrf_level: the kernel takes odd kernel sizes")
    plan = wide_plan(kernel_sizes, dilations)
    if len(weights) != len(plan) or len(biases) != len(plan):
        raise ValueError(f"wide_mrf_level: {len(plan)} weights and biases expected")
    for step in plan:
        w = weights[step.conv]
        if tuple(w.shape) != (c, c, step.k) or w.device != x.device:
            raise ValueError(f"wide_mrf_level: weight {step.conv} has shape {tuple(w.shape)}")
    x = x.contiguous()
    make = lambda: pack_nlc_weights(weights, biases)
    w_flat, b_flat = make() if pack is None else pack.get((*weights, *biases), make)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bn = wide_tile_n(c, b, length, sms)
    bufs = {name: torch.empty(b, length, c, dtype=torch.bfloat16, device=x.device)
            for name in ("xt", "u0", "u", "v", "xb", "acc")}
    ptr = lambda name: ctypes.c_void_p(None if name is None else bufs[name].data_ptr())
    lib = _build.load("conv_nlc")
    stream = _build.stream_ptr(x.device)
    layout, conv = lib.conv_nlc_layout, lib.conv_nlc_fwd
    layout.restype = conv.restype = ctypes.c_int
    dims = ctypes.c_int(b), ctypes.c_int(c), ctypes.c_int(length)
    _build.check(layout(ctypes.c_void_p(x.data_ptr()), ptr("xt"), ptr("u0"), *dims,
                        ctypes.c_int(1), ctypes.c_float(slope), stream), "wide_mrf_level")
    w_off = 0
    for s in plan:
        _build.check(conv(
            ptr(s.src), ctypes.c_void_p(w_flat.data_ptr() + 2 * w_off),
            ctypes.c_void_p(b_flat.data_ptr() + 4 * s.conv * c), ptr(s.res), ptr(s.total),
            ptr(s.y0), ptr(s.y1), ctypes.c_int(b), ctypes.c_int(length), ctypes.c_int(c),
            ctypes.c_int(s.k), ctypes.c_int(s.d), ctypes.c_int(bn), ctypes.c_int(s.act0),
            ctypes.c_float(s.scale), ctypes.c_float(slope), stream), "wide_mrf_level")
        w_off += c * s.k * c
    y = torch.empty_like(x)
    _build.check(layout(ptr("u"), ctypes.c_void_p(y.data_ptr()), None, *dims, ctypes.c_int(0),
                        ctypes.c_float(slope), stream), "wide_mrf_level")
    wide_mrf_level.launches += len(plan) + 2
    return y


def wide_mrf_level(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    kernel_sizes: Sequence[int],
    dilations: Sequence[Sequence[int]],
    slope: float,
    pack: Optional[Pack] = None,
) -> torch.Tensor:
    """K7: one MRF level of more than 128 channels, x [B, C, L] -> [B, C, L],
    in 2 + 18 launches (the layout passes and one a conv; `launches` counts
    them all). The kernel's weight layout is kept in `pack`, as for K3."""
    kernel_sizes = tuple(kernel_sizes)
    dilations = tuple(tuple(d) for d in dilations)
    if x.is_cuda:
        return _MrfLevel.apply(x, _wide_cuda, kernel_sizes, dilations, slope, pack,
                               *weights, *biases)
    return mrf_level_plain(x, weights, biases, kernel_sizes, dilations, slope)


wide_mrf_level.launches = 0


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
