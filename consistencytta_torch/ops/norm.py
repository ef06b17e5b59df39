"""GroupNorm, LayerNorm and RMSNorm: one CUDA source with its plain versions.

`group_norm` normalises consecutive channel groups of x [B, C, *spatial]
and can apply a SiLU after the affine; `layer_norm` and `rms_norm`
normalise the last axis. Statistics and affine are float32 whatever x's
dtype, and the output is rounded to x's dtype once. On a CPU tensor each
runs its plain version, the float32 code the modules ran before the kernel
(`*_plain`). On a CUDA tensor (bfloat16 or float32, contiguous) it launches
`csrc/norm.cu` and raises on anything else: GroupNorm on
`ctta_norm_groups_kernel` (a cluster of blocks a group, `group_plan`),
LayerNorm and RMSNorm on `ctta_norm_rows_kernel` (one or two warps a
row by width, `rows_instantiation`, `rows_plan`; rows at most
ROWS_MAX_WIDTH wide). `rows_launches` counts the rows kernel's launches by
the instantiation they took. `layer_norm` takes the
count `n` of a row's true features: rows padded with zeros to the next
multiple of 8 elements, 16 bytes of bf16 (the UNet transformer's 256 that
hold 255), and no wider, are normalised over
their first n features, with the affine's n entries, and their last
width - n outputs are 0. A call with a gradient goes through `_Norm`, whose
backward is autograd through the plain version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from consistencytta_torch.ops import _build

# the widest row of each of the rows kernel's instantiations, in the order
# of csrc/norm.cu's rows_width_dispatch, which takes the index: a warp a row
# at 8, 16, 32 elements a lane, two warps a row at 20
ROWS_WIDTHS = (256, 512, 1024, 1280)
ROWS_MAX_WIDTH = ROWS_WIDTHS[-1]  # widest row a block's warps hold in registers
PAD_ALIGN = 8  # elements: a padded row's width is its true features rounded up to this
ROWS_SPAN_BYTES = 32 * 1024  # rows a block stages at most, in bytes
CHUNK_BYTES = 32 * 1024  # a group's part a block takes, at most where the cluster allows
MIN_CHUNK_BYTES = 8 * 1024  # no smaller part to fill the card at a small batch
MAX_SPLIT = 8  # blocks a cluster (the portable maximum)
RESIDENT_BYTES = 192 * 1024  # the largest part a block keeps in shared memory
STREAM_TILE_BYTES = 64 * 1024  # the tile a larger part streams through
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
LAUNCH_NAME = "ctta_norm_"  # in both kernels' names, and in no kernel of torch's


# -- plain versions: float32 statistics and affine, one cast at the end --------

def _features(n: Optional[int], width: int, what: str) -> int:
    """n, where a row of `width` holds n true features: all of them, or n
    padded to the next multiple of PAD_ALIGN; anything else is refused."""
    if n is None:
        return width
    if not (n == width or 1 <= n < width == -(-n // PAD_ALIGN) * PAD_ALIGN):
        raise ValueError(f"{what}: {n} true features in rows of {width}")
    return n


def group_norm_plain(x, groups: int, weight, bias, eps: float, silu: bool = False):
    """The SiLU is y * sigmoid(y), as the JAX package writes it."""
    y = F.group_norm(x.float(), groups, None if weight is None else weight.float(),
                     None if bias is None else bias.float(), eps)
    return (y * torch.sigmoid(y) if silu else y).to(x.dtype)


def layer_norm_plain(x, weight, bias, eps: float, n: Optional[int] = None):
    """Over the first `n` features of the last axis (all of them by
    default), the rest of the output 0."""
    width = x.shape[-1]
    n = _features(n, width, "layer_norm")
    x32 = x.float() if n == width else x[..., :n].float()
    y = F.layer_norm(x32, (n,), None if weight is None else weight.float(),
                     None if bias is None else bias.float(), eps)
    return (y if n == width else F.pad(y, (0, width - n))).to(x.dtype)


def rms_norm_plain(x, weight, eps: float):
    x32 = x.float()
    var = x32.pow(2).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y if weight is None else y * weight.float()).to(x.dtype)


# each kind as f(x, weight, bias, *args), for the autograd.Function
_PLAIN = {
    "group": lambda x, w, b, groups, eps, silu: group_norm_plain(x, groups, w, b, eps, silu),
    "layer": layer_norm_plain,
    "rms": lambda x, w, b, eps: rms_norm_plain(x, w, eps),
}


# -- launch plans ----------------------------------------------------------------

def group_plan(n_rows: int, row_len: int, itemsize: int, sms: int) -> Tuple[int, int, int]:
    """(split, chunk, tile) for rows (groups) of `row_len` elements: a
    cluster of `split` blocks a row, `chunk` elements a block (a multiple of
    16 bytes), `tile` elements of shared memory a block. Rows are split
    until a block's part fits CHUNK_BYTES, and further while the grid holds
    fewer than two blocks an SM and the parts stay at MIN_CHUNK_BYTES or
    more; a part up to RESIDENT_BYTES stays in shared memory, a larger one
    (the float32 VAE decoder's 2-MB groups) streams through
    STREAM_TILE_BYTES tiles."""
    vec = 16 // itemsize

    def chunk(k):  # ceil(row_len / k), rounded up to whole 16-byte vectors
        return -(-row_len // (k * vec)) * vec

    split = 1
    while split < MAX_SPLIT and chunk(split) * itemsize > CHUNK_BYTES:
        split *= 2
    while (split < MAX_SPLIT and n_rows * split < 2 * sms
           and chunk(2 * split) * itemsize >= MIN_CHUNK_BYTES):
        split *= 2
    c = chunk(split)
    tile = c if c * itemsize <= RESIDENT_BYTES else STREAM_TILE_BYTES // itemsize
    return split, c, tile


def rows_instantiation(width: int, what: str = "norm") -> int:
    """The rows kernel's instantiation that takes rows of `width`, named by
    the widest row it holds: the least of ROWS_WIDTHS at or above `width`.
    The launch passes its index to the kernel, which takes no other. A row
    wider than ROWS_MAX_WIDTH is refused."""
    if width > ROWS_MAX_WIDTH:
        raise ValueError(f"{what}: rows of {width} elements, over the {ROWS_MAX_WIDTH} "
                         "the rows kernel holds")
    return next(w for w in ROWS_WIDTHS if w >= width)


def rows_plan(n_rows: int, width: int, itemsize: int, sms: int) -> int:
    """Rows a block of the rows kernel: enough for four blocks' worth an SM
    at most, at least 8 (a row for each warp or pair of warps), within
    ROWS_SPAN_BYTES; rows
    wider than ROWS_MAX_WIDTH are refused (`rows_instantiation`)."""
    rows_instantiation(width, "rows_plan")
    fit = max(1, ROWS_SPAN_BYTES // (width * itemsize))
    return max(1, min(max(8, -(-n_rows // (4 * sms))), fit))


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- the kernel ------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _checked(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype not in DTYPES:
        raise TypeError(f"{what}: the kernel takes bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a contiguous x")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty x")
    return x.clone() if x.data_ptr() % 16 else x  # the kernel's 16-byte loads


def _affine(t: Optional[torch.Tensor], n: int, x: torch.Tensor, what: str):
    if t is None:
        return None
    if t.numel() != n or t.device != x.device:
        raise ValueError(f"{what}: an affine parameter of {t.numel()} elements on {t.device}, "
                         f"expected {n} on {x.device}")
    return t.detach().float().contiguous()


def _output(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    y = torch.empty_like(x) if out is None else out
    if (y.shape != x.shape or y.dtype != x.dtype or not y.is_contiguous()
            or y.data_ptr() % 16):
        raise ValueError("norm: out must be a contiguous, 16-byte aligned tensor like x")
    return y


def _groups_launch(x, y, w, b, silu, n_rows, row_len, groups, cpg, inner, eps):
    split, chunk, tile = group_plan(n_rows, row_len, x.element_size(), _sms(x.device.index))
    fn = _build.load("norm").norm_groups_fwd
    fn.restype = ctypes.c_int
    code = fn(_ptr(x), _ptr(y), _ptr(w), _ptr(b), ctypes.c_int(DTYPES[x.dtype]),
              ctypes.c_int(int(silu)), ctypes.c_longlong(n_rows), ctypes.c_longlong(row_len),
              ctypes.c_longlong(chunk), ctypes.c_longlong(tile), ctypes.c_int(split),
              ctypes.c_int(groups), ctypes.c_int(cpg), ctypes.c_int(inner), ctypes.c_float(eps),
              _build.stream_ptr(x.device))
    _build.check(code, "group_norm")


def _rows_launch(x, y, w, b, rms, eps, what, n):
    width = x.shape[-1]
    n_rows = x.numel() // width
    held = rows_instantiation(width, what)
    fn = _build.load("norm").norm_rows_fwd
    fn.restype = ctypes.c_int
    r = rows_plan(n_rows, width, x.element_size(), _sms(x.device.index))
    code = fn(_ptr(x), _ptr(y), _ptr(w), _ptr(b), ctypes.c_int(DTYPES[x.dtype]),
              ctypes.c_int(int(rms)), ctypes.c_longlong(n_rows), ctypes.c_int(width),
              ctypes.c_int(n), ctypes.c_int(r), ctypes.c_float(eps),
              ctypes.c_int(ROWS_WIDTHS.index(held)), _build.stream_ptr(x.device))
    _build.check(code, what)
    rows_launches[held].launches += 1


def _group_cuda(x, groups, weight, bias, eps, silu=False, out=None):
    x = _checked(x, "group_norm")
    if x.dim() < 2 or x.shape[1] % groups:
        raise ValueError(f"group_norm: {groups} groups do not divide x of shape {tuple(x.shape)}")
    c = x.shape[1]
    inner = x[0, 0].numel()
    y = _output(x, out)
    _groups_launch(x, y, _affine(weight, c, x, "group_norm"), _affine(bias, c, x, "group_norm"),
                   silu, x.shape[0] * groups, c // groups * inner, groups, c // groups, inner, eps)
    group_norm.launches += 1
    return y


def _layer_cuda(x, weight, bias, eps, n=None, out=None):
    x = _checked(x, "layer_norm")
    n = _features(n, x.shape[-1], "layer_norm")
    y = _output(x, out)
    _rows_launch(x, y, _affine(weight, n, x, "layer_norm"), _affine(bias, n, x, "layer_norm"),
                 False, eps, "layer_norm", n)
    layer_norm.launches += 1
    return y


def _rms_cuda(x, weight, eps, out=None):
    x = _checked(x, "rms_norm")
    y = _output(x, out)
    d = x.shape[-1]
    _rows_launch(x, y, _affine(weight, d, x, "rms_norm"), None, True, eps, "rms_norm", d)
    rms_norm.launches += 1
    return y


_CUDA = {
    "group": lambda x, w, b, groups, eps, silu: _group_cuda(x, groups, w, b, eps, silu),
    "layer": _layer_cuda,
    "rms": lambda x, w, b, eps: _rms_cuda(x, w, eps),
}


class _Norm(torch.autograd.Function):
    """Forward: the kernel (the plain version on a CPU tensor). Backward:
    autograd through the plain float32 version, for the inputs that need a
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, kind, args):
        ctx.save_for_backward(x, weight, bias)
        ctx.kind, ctx.args = kind, args
        return (_CUDA if x.is_cuda else _PLAIN)[kind](x, weight, bias, *args)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                      for t, need in zip((x, weight, bias), ctx.needs_input_grad)]
            out = _PLAIN[ctx.kind](*leaves, *ctx.args)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            found = iter(torch.autograd.grad(out, wanted, g))
        grads = [next(found) if t is not None and t.requires_grad else None for t in leaves]
        return (*grads, None, None)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


# -- entry points ----------------------------------------------------------------

def group_norm(x: torch.Tensor, groups: int, weight, bias, eps: float,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm of x [B, C, *spatial] over `groups` consecutive channel
    groups, then SiLU where `silu`."""
    if not x.is_cuda:
        return group_norm_plain(x, groups, weight, bias, eps, silu)
    if _needs_grad(x, weight, bias):
        return _Norm.apply(x, weight, bias, "group", (groups, eps, silu))
    return _group_cuda(x, groups, weight, bias, eps, silu)


def layer_norm(x: torch.Tensor, weight, bias, eps: float,
               n: Optional[int] = None) -> torch.Tensor:
    """LayerNorm of x over the first `n` features of its last axis (all
    of them by default); the output's last width - n features are 0."""
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps, n)
    if _needs_grad(x, weight, bias):
        return _Norm.apply(x, weight, bias, "layer", (eps, n))
    return _layer_cuda(x, weight, bias, eps, n)


def rms_norm(x: torch.Tensor, weight, eps: float) -> torch.Tensor:
    """T5's RMSNorm of x over its last axis: no mean, no shift."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps)
    if _needs_grad(x, weight):
        return _Norm.apply(x, weight, None, "rms", (eps,))
    return _rms_cuda(x, weight, eps)


group_norm.launches = 0
layer_norm.launches = 0
rms_norm.launches = 0
# the rows kernel's launches (LayerNorm and RMSNorm) by the instantiation
# they took (`rows_instantiation`), each a counter like the entry points'
# `launches`
rows_launches = {w: SimpleNamespace(launches=0) for w in ROWS_WIDTHS}
