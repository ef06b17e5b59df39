"""Flash self-attention: kernels K1 and K2 with their plain versions.

`flash_mha_packed` (K1) takes q/k/v in the packed [B, S, H*d] layout of one
fused QKV projection (d = 64: callers pad head width 51 with zero weight
columns); `flash_self_attention` (K2) takes [BH, S, D] with D = 512 on the
card (the VAE mid-block's width). Both compute softmax(q k^T * scale) v per
head, non-causal and unmasked, with fp32 logits and softmax and bf16
probabilities against v.

On a CUDA tensor each wrapper launches its kernel from
`csrc/flash_attention.cu` (bf16 only) and raises on anything the kernel does
not take; on a CPU tensor it runs the plain version below. The views may be
strided along rows (slices of one QKV projection), but the feature axis must
be contiguous. Gradients flow through a `torch.autograd.Function` whose
backward differentiates the plain version, as the JAX package's custom VJP
does with its einsum backward.
"""

from __future__ import annotations

import ctypes

import torch

from consistencytta_torch.ops import _build

LOG2E = 1.4426950408889634


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


def _check_cuda(name, tensors, shape):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: inputs on different devices")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
        if t.stride(-1) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
            raise ValueError(
                f"{name}: features must be contiguous and row/batch strides "
                f"multiples of 8 elements, got strides {t.stride()}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _strides(ts):
    """Row strides, then batch strides, in elements."""
    return [ctypes.c_int(t.stride(1)) for t in ts] + [
        ctypes.c_int(t.stride(0)) for t in ts
    ]


def _mha_packed_cuda(q, k, v, heads: int, scale: float):
    b, s, hd = q.shape
    if hd % heads or hd // heads != 64:
        raise ValueError(f"flash_mha_packed: head width must be 64, got {hd}/{heads}")
    _check_cuda("flash_mha_packed", (q, k, v), (b, s, hd))
    out = torch.empty((b, s, hd), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    fn = lib.flash_mha_packed_fwd
    fn.restype = ctypes.c_int
    ts = (q, k, v, out)
    code = fn(
        *[ctypes.c_void_p(t.data_ptr()) for t in ts],
        ctypes.c_int(b), ctypes.c_int(s), ctypes.c_int(heads), ctypes.c_int(64),
        *_strides(ts), ctypes.c_float(scale * LOG2E), _build.stream_ptr(q.device),
    )
    _build.check(code, "flash_mha_packed")
    flash_mha_packed.launches += 1
    return out


def _self_attention_cuda(q, k, v, scale: float):
    bh, s, d = q.shape
    if d != 512:
        raise ValueError(f"flash_self_attention: the kernel takes D = 512, got {d}")
    _check_cuda("flash_self_attention", (q, k, v), (bh, s, d))
    out = torch.empty((bh, s, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    fn = lib.flash_self_attention_fwd
    fn.restype = ctypes.c_int
    ts = (q, k, v, out)
    code = fn(
        *[ctypes.c_void_p(t.data_ptr()) for t in ts],
        ctypes.c_int(bh), ctypes.c_int(s), ctypes.c_int(d),
        *_strides(ts), ctypes.c_float(scale * LOG2E), _build.stream_ptr(q.device),
    )
    _build.check(code, "flash_self_attention")
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
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = flash_mha_packed_plain(qq, kk, vv, ctx.heads, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
        return dq, dk, dv, None, None


class _SelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _self_attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = attention_plain(qq, kk, vv, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (qq, kk, vv), g)
        return dq, dk, dv, None


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
