"""Flash self-attention: kernels K1 and K2 with their plain versions.

`flash_mha_packed` (K1) takes q/k/v in the packed [B, S, H*d] layout of one
fused QKV projection (d = 64: callers pad head width 51 with zero weight
columns) and replaces the JAX package's `ops/pallas_attention.py`
`flash_mha_packed`; `flash_self_attention` (K2) takes [BH, S, D] with D = 512
on the card (the VAE mid-block's width) and replaces `flash_self_attention`
there. Both compute softmax(q k^T * scale) v per head, non-causal and
unmasked, with fp32 logits and softmax and bf16 probabilities against v.

On a CUDA tensor each wrapper launches its kernel from
`csrc/flash_attention.cu` (bf16 only) and raises on anything the kernel does
not take; on a CPU tensor it runs the plain version below. On the H100 the
function is bound by operations (4 S^2 d of them against ~4 S d bytes), so
both products run as `wgmma` on tiles that TMA copies into 128-byte-swizzled
shared memory, fed by a producer warp through mbarriers, with the logits kept
in registers. Every S goes to the one kernel of its function. K1 has two
shapes: S > 1024 takes 192 query rows a block (three consumer warpgroups)
against key tiles of 128, S <= 1024 takes 64 query rows (one warpgroup)
against key tiles of 64, three blocks an SM. K2 takes 64 query rows, their
512 output columns split over two warpgroups, against key tiles of 32. Rows
beyond S are filled with zeros by TMA and masked, and are never written.

The views may be strided along rows and batch (slices of one QKV projection,
a sliced batch), but the feature axis must be contiguous: `kernel_layout`
turns each view into the (features, S, B) dims and byte strides of the tensor
map that the C entry point encodes at every launch (three maps, a few
microseconds of host time). Gradients flow through a
`torch.autograd.Function` whose backward is the JAX package's analytic one
(`_flash_bwd`): the float32 softmax recomputed over chunks of at most 512
queries (`attention_backward`), so that at most [BH, 512, S] float32 logits
are live where autograd through the plain version would hold several
[BH, S, S] ones (2.7 GB each for K1 at level 0 and micro-batch 8).
"""

from __future__ import annotations

import ctypes

import torch

from consistencytta_torch.ops import _build

LOG2E = 1.4426950408889634
BACKWARD_CHUNK = 512  # queries a chunk of the analytic backward, as in the JAX package


def attention_plain(q, k, v, scale: float):
    """softmax(q k^T * scale) v over [..., S, D]: fp32 logits and softmax,
    probabilities cast to v's dtype, fp32 accumulation, output in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_mha_packed_plain(q, k, v, heads: int, scale: float):
    """K1's plain version on the packed [B, S, H*d] layout."""
    b, s, hd = q.shape
    d = hd // heads
    split = lambda t: t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
    out = attention_plain(split(q), split(k), split(v), scale)
    return out.transpose(1, 2).reshape(b, s, hd)


def attention_backward(q, k, v, g, scale: float, chunk: int = BACKWARD_CHUNK):
    """(dq, dk, dv) of `attention_plain` over [..., S, D] at the output
    gradient g: the JAX package's analytic backward. Per chunk of up to
    `chunk` queries, in float32: p = softmax(q k^T * scale), dv += p^T g,
    ds = p * (dp - sum(dp * p)) with dp = g v^T, dq = ds k * scale,
    dk += ds^T q * scale. The gradients come back in the inputs' dtypes."""
    k32, v32 = k.float(), v.float()
    dk, dv = torch.zeros_like(k32), torch.zeros_like(v32)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i in range(0, q.shape[-2], chunk):
        qc, gc = q[..., i:i + chunk, :].float(), g[..., i:i + chunk, :].float()
        p = torch.softmax(torch.matmul(qc, k32.transpose(-1, -2)) * scale, dim=-1)
        dv += torch.matmul(p.transpose(-1, -2), gc)
        ds = torch.matmul(gc, v32.transpose(-1, -2))
        ds.sub_((ds * p).sum(-1, keepdim=True)).mul_(p)
        dq[..., i:i + chunk, :] = torch.matmul(ds, k32) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qc) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def mha_packed_backward(q, k, v, g, heads: int, scale: float, chunk: int = BACKWARD_CHUNK):
    """(dq, dk, dv) of `flash_mha_packed_plain` on the packed [B, S, H*d]
    layout: heads folded into the batch, `attention_backward`, unfolded (the
    JAX package's `_flash_nhd_bwd`)."""
    b, s, hd = q.shape
    d = hd // heads
    fold = lambda t: t.reshape(b, s, heads, d).transpose(1, 2)
    grads = attention_backward(fold(q), fold(k), fold(v), fold(g), scale, chunk)
    return tuple(t.transpose(1, 2).reshape(b, s, hd) for t in grads)


def kernel_layout(name, tensors, shape):
    """What the kernel is told of q, k, v (and the output): checked views of
    shape [B, S, width] as three-axis tensor maps, innermost axis first.

    Returns {"dims": (width, S, B), "row_bytes": [...], "batch_bytes": [...]}
    with one stride per tensor. A tensor map needs a 16-byte-aligned base, a
    contiguous innermost axis and strides that are multiples of 16 bytes
    (8 bf16 elements); anything else raises, as does a dtype other than
    bfloat16, a second device or a shape other than `shape`."""
    shape, device = tuple(shape), tensors[0].device
    row_bytes, batch_bytes = [], []
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.shape != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        batch, row, feature = t.stride()
        if feature != 1 or row % 8 or batch % 8 or row <= 0 or batch <= 0:
            raise ValueError(
                f"{name}: features must be contiguous and row/batch strides "
                f"multiples of 8 elements, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")
        row_bytes.append(2 * row)  # bfloat16: 2 bytes an element
        batch_bytes.append(2 * batch)
    b, s, width = shape
    return {"dims": (width, s, b), "row_bytes": row_bytes, "batch_bytes": batch_bytes}


_STRIDES = ctypes.c_longlong * 4
_entries = {}


def _entry(entry, n_ints):
    """A C entry point of csrc/flash_attention.cu: (q, k, v, out, n_ints
    ints, row strides, batch strides, scale, stream) -> CUDA error code."""
    fn = _entries.get(entry)
    if fn is None:
        fn = getattr(_build.load("flash_attention"), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints \
            + [_STRIDES, _STRIDES, ctypes.c_float, ctypes.c_void_p]
        _entries[entry] = fn
    return fn


def _launch(entry, name, ts, extra, scale):
    """Call one C entry point of csrc/flash_attention.cu on (q, k, v, out)."""
    layout = kernel_layout(name, ts, ts[0].shape)
    _, s, b = layout["dims"]
    code = _entry(entry, 2 + len(extra))(
        *[t.data_ptr() for t in ts], b, s, *extra,
        _STRIDES(*layout["row_bytes"]), _STRIDES(*layout["batch_bytes"]),
        scale * LOG2E, torch.cuda.current_stream(ts[0].device).cuda_stream,
    )
    _build.check(code, name)


def kernel_resources():
    """What the build gave the three kernels of csrc/flash_attention.cu."""
    out = (ctypes.c_int * 15)()
    _build.check(_build.load("flash_attention").flash_attention_resources(out),
                 "flash_attention_resources")
    keys = ("registers", "local_bytes", "static_smem_bytes", "dynamic_smem_bytes", "threads")
    names = ("mha_packed_kernel, S > 1024", "mha_packed_kernel, S <= 1024",
             "self_attention_kernel")
    return {n: dict(zip(keys, out[5 * i:5 * i + 5])) for i, n in enumerate(names)}


def _mha_packed_cuda(q, k, v, heads: int, scale: float):
    b, s, hd = q.shape
    if hd % heads or hd // heads != 64:
        raise ValueError(f"flash_mha_packed: head width must be 64, got {hd}/{heads}")
    out = torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
    _launch("flash_mha_packed_fwd", "flash_mha_packed", (q, k, v, out), (heads, 64), scale)
    flash_mha_packed.launches += 1
    return out


def _self_attention_cuda(q, k, v, scale: float):
    bh, s, d = q.shape
    if d != 512:
        raise ValueError(f"flash_self_attention: the kernel takes D = 512, got {d}")
    out = torch.empty((bh, s, d), dtype=q.dtype, device=q.device)
    _launch("flash_self_attention_fwd", "flash_self_attention", (q, k, v, out), (d,), scale)
    flash_self_attention.launches += 1
    return out


class _MhaPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return _mha_packed_cuda(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.autocast("cuda", enabled=False):  # float32 products
            return (*mha_packed_backward(q, k, v, g, ctx.heads, ctx.scale), None, None)


class _SelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _self_attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.autocast("cuda", enabled=False):  # float32 products
            return (*attention_backward(q, k, v, g, ctx.scale), None)


def flash_mha_packed(q, k, v, heads: int, scale: float):
    """K1: multi-head attention on the packed [B, S, H*64] layout."""
    if q.is_cuda:
        return _MhaPacked.apply(q, k, v, heads, scale)
    return flash_mha_packed_plain(q, k, v, heads, scale)


def flash_self_attention(q, k, v, scale: float):
    """K2: attention over [BH, S, D], D = 512 on the card."""
    if q.is_cuda:
        return _SelfAttention.apply(q, k, v, scale)
    return attention_plain(q, k, v, scale)


flash_mha_packed.launches = 0
flash_self_attention.launches = 0


def head_pad(width: int) -> int:
    """Head width rounded up to the kernel's 64."""
    return -(-width // 64) * 64
