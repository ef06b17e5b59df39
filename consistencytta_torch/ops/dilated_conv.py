"""Standalone dilated conv1d: kernel K5 with its plain version.

`dilated_conv1d(x, w, dilation, padding)` convolves x [B, C, L] with
w [C_out, C_in, k] (torch Conv1d layout), zero-padded by `padding` at the
signal's edges, to [B, C, L + 2*padding - dilation*(k-1)]. On a CUDA tensor
it launches `csrc/dilated_conv.cu` (bf16, fp32 accumulation, C_in = C_out of
32, 64 or 128) and raises on anything else; on a CPU tensor it runs
`dilated_conv1d_plain`. The backward differentiates the plain version, as
the JAX package's custom VJP does. Nothing in the port dispatches it, as
nothing in the JAX package dispatches the kernel it replaces: the vocoder's
convs run inside the fused MRF level (`ops/mrf.py`) or as `F.conv1d`.

The kernel is persistent (one block an SM) and takes its weights packed as
wgmma A operands (`pack_weights`, kept in the caller's `ops._packs.Pack`);
`tile_plan` sizes its shared memory: a TMA ring of x windows where the rows
allow it (L % 8 == 0, x 16-byte aligned), a window buffer per consumer
warpgroup (two, or one for the widest windows), and the taps' weights,
resident where they all fit, else a ring of three tap slots (one, beside
one consumer, for the widest windows at C = 128). A conv whose window
does not fit even so is refused before any launch: (k-1)*d above 3385, 1593,
697 at C = 32, 64, 128.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from consistencytta_torch.ops import _build
from consistencytta_torch.ops._packs import Pack

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
CHANNELS = (32, 64, 128)  # the C_in = C_out the kernel takes
BAR_BYTES = 128  # the rings' mbarriers


def dilated_conv1d_plain(x, w, dilation: int, padding: int):
    """The literal conv: fp32 accumulation, output rounded to x's dtype."""
    return F.conv1d(x, w, dilation=dilation, padding=padding)


def tile_positions(c: int) -> int:
    """Output positions of a tile (the products' N)."""
    return 64 if c == 128 else 128


def weight_rows(c: int) -> int:
    """Rows of a packed tap: C output channels, zero rows up to wgmma's M of 64."""
    return max(c, 64)


class TilePlan(NamedTuple):
    wb: int  # window positions of a consumer's buffer (a multiple of 32)
    wr: int  # window positions of a TMA stage (a multiple of 64; 0 without TMA)
    xs: int  # TMA stages of x windows a consumer (0: the consumers gather x themselves)
    ws: int  # weight slots (k: every tap resident)
    ncw: int  # consumer warpgroups, one tile each (1 where two windows do not fit)
    smem: int  # bytes of shared memory a block


def smem_bytes(c: int, wb: int, wr: int, xs: int, ws: int, ncw: int) -> int:
    """Shared memory of one block (mirrors smem_bytes in csrc/dilated_conv.cu):
    the consumers' x rings, the weight slots, their window buffers, the
    barriers and the slack of the 1024-byte alignment."""
    return (ncw * xs * c * wr * 2 + ws * c * weight_rows(c) * 2
            + ncw * c * wb * 2 + BAR_BYTES + 1024)


def tile_plan(c: int, k: int, dilation: int, tma: bool = True) -> Optional[TilePlan]:
    """The first of these that fits, with two consumer warpgroups, then with
    one: every tap resident with TMA rings of 2, then 1 stage a consumer; the
    taps streamed through 3 slots with 2, then 1 stages; the same without the
    rings, the consumers gathering x (the only choice without `tma`); last,
    one consumer gathering x beside a single tap slot. None where that does
    not fit."""
    need = tile_positions(c) + (k - 1) * dilation + 7  # + the window's 8-alignment
    wb, wr = -(-need // 32) * 32, -(-need // 64) * 64
    order = [(k, 2), (k, 1), (3, 2), (3, 1), (k, 0), (3, 0)]
    for ncw, ws, xs in [(n, ws, xs) for n in (2, 1) for ws, xs in order] + [(1, 1, 0)]:
        ws = min(ws, k)
        if xs and not tma:
            continue
        nbytes = smem_bytes(c, wb, wr if xs else 0, xs, ws, ncw)
        if nbytes <= SMEM_LIMIT:
            return TilePlan(wb, wr if xs else 0, xs, ws, ncw, nbytes)
    return None


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """w [C_out, C_in, k] as the kernel reads it: [k, C_in/8, max(C, 64), 8]
    bf16, element [t, g, co, e] = w[co, 8 g + e, t], zero rows co >= C."""
    c, _, k = w.shape
    packed = w.detach().to(torch.bfloat16).permute(2, 1, 0).reshape(k, c // 8, 8, c)
    return F.pad(packed.transpose(2, 3), (0, 0, 0, weight_rows(c) - c)).contiguous()


def check_args(x, w, dilation: int, padding: int) -> TilePlan:
    """What the kernel takes, checked before any launch; returns its plan."""
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise TypeError(f"dilated_conv1d: the kernel takes bfloat16 {name} on x's device")
    if not x.is_contiguous():
        raise TypeError("dilated_conv1d: the kernel takes contiguous x")
    b, c, length = x.shape
    k = w.shape[-1]
    if c not in CHANNELS or tuple(w.shape[:2]) != (c, c):
        raise ValueError(
            f"dilated_conv1d: C_in = C_out of 32, 64 or 128 expected, got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}"
        )
    l_out = length + 2 * padding - dilation * (k - 1)
    if dilation < 1 or padding < 0 or l_out < 1:
        raise ValueError("dilated_conv1d: dilation >= 1, padding >= 0 and a non-empty output expected")
    plan = tile_plan(c, k, dilation, tma=length % 8 == 0 and x.data_ptr() % 16 == 0)
    if plan is None:
        raise ValueError(
            f"dilated_conv1d: a window of {tile_positions(c) + (k - 1) * dilation + 7} positions "
            f"at C = {c} (k = {k}, d = {dilation}) does not fit the shared memory of a block"
        )
    return plan


def _dilated_conv_cuda(x, w, dilation: int, padding: int, out=None,
                       pack: Optional[Pack] = None):
    """Launch K5 on the weights kept in `pack` (packed for this call alone
    without one); `out` ([B, C, L_out] bf16, contiguous, on x's device) is
    written in place of a new tensor when given."""
    plan = check_args(x, w, dilation, padding)
    b, c, length = x.shape
    k = w.shape[-1]
    l_out = length + 2 * padding - dilation * (k - 1)
    y = torch.empty((b, c, l_out), dtype=x.dtype, device=x.device) if out is None else out
    if y.shape != (b, c, l_out) or y.dtype != x.dtype or not y.is_contiguous() \
            or y.device != x.device:
        raise ValueError("dilated_conv1d: out must be a contiguous tensor like the output")
    w_packed = pack_weights(w) if pack is None else pack.get((w,), lambda: pack_weights(w))
    fn = _build.load("dilated_conv").dilated_conv1d_fwd
    fn.restype = ctypes.c_int
    code = fn(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_packed.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), ctypes.c_int(b), ctypes.c_int(c),
        ctypes.c_int(length), ctypes.c_int(l_out), ctypes.c_int(k),
        ctypes.c_int(dilation), ctypes.c_int(padding), ctypes.c_int(plan.wb),
        ctypes.c_int(plan.wr), ctypes.c_int(plan.xs), ctypes.c_int(plan.ws),
        ctypes.c_int(plan.ncw), _build.stream_ptr(x.device),
    )
    _build.check(code, "dilated_conv1d")
    dilated_conv1d.launches += 1
    return y


class _DilatedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation, padding, pack):
        ctx.save_for_backward(x, w)
        ctx.cfg = (dilation, padding)
        return _dilated_conv_cuda(x, w, dilation, padding, pack=pack)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
            out = dilated_conv1d_plain(xx, ww, *ctx.cfg)
            gx, gw = torch.autograd.grad(out, (xx, ww), g)
        return gx, gw, None, None, None


def dilated_conv1d(x: torch.Tensor, w: torch.Tensor, dilation: int, padding: int,
                   pack: Optional[Pack] = None):
    """K5: x [B, C, L], w [C_out, C_in, k] -> [B, C_out, L_out]. The kernel's
    weight layout is kept in `pack`, which a caller that runs the conv again
    holds; without one it is made for this call alone."""
    if x.is_cuda:
        return _DilatedConv.apply(x, w, dilation, padding, pack)
    return dilated_conv1d_plain(x, w, dilation, padding)


dilated_conv1d.launches = 0


def dilated_conv_flops(b: int, c: int, l_out: int, k: int) -> int:
    """Operations the conv needs: 2 per multiply-add."""
    return 2 * b * l_out * c * c * k
