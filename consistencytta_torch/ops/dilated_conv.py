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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from consistencytta_torch.ops import _build

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
CHANNELS = {32: 512, 64: 256, 128: 128}  # C -> positions per block


def dilated_conv1d_plain(x, w, dilation: int, padding: int):
    """The literal conv: fp32 accumulation, output rounded to x's dtype."""
    return F.conv1d(x, w, dilation=dilation, padding=padding)


def _dilated_conv_cuda(x, w, dilation: int, padding: int):
    b, c, length = x.shape
    k = w.shape[-1]
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise TypeError(f"dilated_conv1d: the kernel takes bfloat16 {name} on x's device")
    if not x.is_contiguous():
        raise TypeError("dilated_conv1d: the kernel takes contiguous x")
    if c not in CHANNELS or tuple(w.shape[:2]) != (c, c):
        raise ValueError(
            f"dilated_conv1d: C_in = C_out of 32, 64 or 128 expected, got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}"
        )
    l_out = length + 2 * padding - dilation * (k - 1)
    if dilation < 1 or padding < 0 or l_out < 1:
        raise ValueError("dilated_conv1d: dilation >= 1, padding >= 0 and a non-empty output expected")
    kc = min(c, 64)
    smem = (2 * kc + CHANNELS[c] + (k - 1) * dilation) * (c + 8) * 2
    if smem > SMEM_LIMIT:
        raise ValueError(f"dilated_conv1d: k = {k}, d = {dilation} needs {smem} bytes of shared memory")
    w_packed = w.permute(2, 1, 0).contiguous()  # [k][C_in][C_out]
    y = torch.empty((b, c, l_out), dtype=x.dtype, device=x.device)
    fn = _build.load("dilated_conv").dilated_conv1d_fwd
    fn.restype = ctypes.c_int
    code = fn(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_packed.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), ctypes.c_int(b), ctypes.c_int(c),
        ctypes.c_int(length), ctypes.c_int(l_out), ctypes.c_int(k),
        ctypes.c_int(dilation), ctypes.c_int(padding), _build.stream_ptr(x.device),
    )
    _build.check(code, "dilated_conv1d")
    dilated_conv1d.launches += 1
    return y


class _DilatedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation, padding):
        ctx.save_for_backward(x, w)
        ctx.cfg = (dilation, padding)
        return _dilated_conv_cuda(x, w, dilation, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
            out = dilated_conv1d_plain(xx, ww, *ctx.cfg)
            gx, gw = torch.autograd.grad(out, (xx, ww), g)
        return gx, gw, None, None


def dilated_conv1d(x: torch.Tensor, w: torch.Tensor, dilation: int, padding: int):
    """K5: x [B, C, L], w [C_out, C_in, k] -> [B, C_out, L_out]."""
    if x.is_cuda:
        return _DilatedConv.apply(x, w, dilation, padding)
    return dilated_conv1d_plain(x, w, dilation, padding)


dilated_conv1d.launches = 0


def dilated_conv_flops(b: int, c: int, l_out: int, k: int) -> int:
    """Operations the conv needs: 2 per multiply-add."""
    return 2 * b * l_out * c * c * k
