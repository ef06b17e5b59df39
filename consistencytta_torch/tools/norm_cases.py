"""The cases the norm kernel (ops/norm.py) is checked on, for the card's
kernel tests, the CPU tests and `chip_smoke.py`'s kernel phase.

`generate_norms` lists every GroupNorm (+ SiLU), LayerNorm and RMSNorm call
of one generate call (the port's modules run on the meta device with
forward pre-hooks on their norms) at the batches and UNet widths of the
benchmark's cells (`CALLS`), a LayerNorm's with the count `n` of its rows'
true features (the UNet transformer pads its rows past them); `inputs`
makes inputs whose groups and rows differ in scale and offset; `ulps` and
`TOL_ULPS` hold the
kernel to its plain float32 version in bf16 ulps of the output;
`group_norm_fault` and `row_norm_fault` are the plain version with planted
faults; `library_call` is torch's own norm and `bound_ms` the time of one
bf16 read and one write of each element and the float32 affine at 3.35
TB/s. The device times are the smoke's.

The tolerance (`ulps`): the largest |kernel - plain| in bf16 ulps of the
output, the ulp taken at the larger of the two values and at least at
2^-6 of the output's largest magnitude. The floor: where an output cancels
to near zero (x near the mean, the shift against the scaled value) its
error is that of the terms it came from, and in a group whose mean is 300
times its spread those are 300 times the output. The kernel's float32
value and the plain version's differ only by the order of their float32
sums; an emulation of the kernel's sums on the CPU (per-thread sequential
sums of 16-byte vectors, a tree over threads, Chan's merge over the
cluster) read 0.06-0.16 ulps from the plain float32 output at the path's
group sizes. So a float32 output is held to half a bf16 ulp
(`TOL_ULPS[float32]`). A bf16 output is rounded once on each side, and the
two roundings can fall on either side of a boundary: 1 ulp
(`TOL_ULPS[bf16]`). The planted faults read 370-500 ulps (eps outside the
square root, the neighbour's statistics) and, in float32, 9.6-19 ulps (a
one-pass variance over the 300-offset groups). In bf16 the one-pass
variance moves these inputs by about one ulp, the output's own precision,
so that fault is checked on float32 inputs.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

from consistencytta_torch.configs import TANGO_FULL_UNET, TANGO_LIGHT_UNET, UNetConfig
from consistencytta_torch.ops import norm

TOL_ULPS = {torch.bfloat16: 1.0, torch.float32: 0.5}
FLOOR = 2.0 ** -6  # of the output's largest magnitude

# per-group (or per-row) spread and offset over the spread: unit groups,
# groups whose variance is near eps (1e-5 and 1e-6 here), wide groups, and
# groups whose mean is 300 times their spread
SCALES = (1.0, 3e-3, 1e-3, 10.0, 0.5, 2.0, 1e-3, 0.3)
OFFSETS = (0.0, 0.0, 1.0, -2.0, 300.0, 0.5, 0.0, -300.0)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |v| (v float32, nonzero): 2^(floor(log2 |v|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(v.abs())) - 7)


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 ulps of the output (module doc)."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    floor = FLOOR * want.abs().max().clamp_min(1e-30)
    at = torch.maximum(torch.maximum(got.abs(), want.abs()), floor)
    return ((got - want).abs() / bf16_ulp(at)).max().item()


def close(got, want) -> bool:
    return ulps(got, want) <= TOL_ULPS[want.dtype]


def structured(shape, dtype, gen, groups: int, device=None) -> torch.Tensor:
    """x of `shape` in `dtype` whose `groups` consecutive parts of each
    sample (channel groups of [B, C, ...]; rows of [..., D] with groups =
    the number of rows) cycle through SCALES and OFFSETS."""
    device = device or (gen.device if gen is not None else "cpu")
    z = torch.randn(shape, generator=gen, device=device)
    parts = z.reshape(-1, groups, z[0].numel() // groups)
    idx = torch.arange(parts.shape[0] * groups, device=device).reshape(-1, groups, 1)
    scale = torch.tensor(SCALES, device=device)[idx % len(SCALES)]
    offset = torch.tensor(OFFSETS, device=device)[idx % len(OFFSETS)]
    return (parts * scale + offset * scale).reshape(shape).to(dtype)


def affine(n: int, gen, device=None, bias: bool = True):
    device = device or (gen.device if gen is not None else "cpu")
    w = 1.0 + 0.5 * torch.randn(n, generator=gen, device=device)
    b = 0.5 * torch.randn(n, generator=gen, device=device) if bias else None
    return w, b


# -- the plain version with planted faults ---------------------------------------

def group_norm_fault(x, groups, w, b, eps, silu, fault: str):
    """group_norm_plain with one fault: `eps_outside_sqrt` (x - mean) /
    (sqrt(var) + eps); `neighbour_statistics` group g normalised with group
    g + 1's mean and variance; `one_pass_variance` var = E[x^2] - E[x]^2 in
    float32; `silu_left_off` no SiLU where one was asked for."""
    xs = x.float().reshape(x.shape[0], groups, -1)
    mean = xs.mean(-1, keepdim=True)
    var = xs.var(-1, unbiased=False, keepdim=True)
    if fault == "one_pass_variance":
        var = (xs * xs).mean(-1, keepdim=True) - mean * mean
    if fault == "neighbour_statistics":
        mean, var = mean.roll(-1, dims=1), var.roll(-1, dims=1)
    if fault == "eps_outside_sqrt":
        y = (xs - mean) / (var.clamp_min(0).sqrt() + eps)
    else:
        y = (xs - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = y.reshape(x.shape) * w.float().reshape(shape) + b.float().reshape(shape)
    if silu and fault != "silu_left_off":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def row_norm_fault(x, w, b, eps, rms: bool, fault: str, n=None):
    """layer_norm_plain (rms False, over the first `n` features) or
    rms_norm_plain with one fault, as in group_norm_fault;
    `neighbour_statistics` takes the next row's; `width_divisor` divides a
    padded row's sums by its width in place of n; `statistics_over_1024`
    takes the statistics over the first 1024 features only, all that one
    warp of the rows kernel holds."""
    width = x.shape[-1]
    n = width if n is None else n
    x32 = x.float()[..., :n]
    average = ((lambda t: t.sum(-1, keepdim=True) / width) if fault == "width_divisor"
               else (lambda t: t[..., :1024].mean(-1, keepdim=True))
               if fault == "statistics_over_1024" else (lambda t: t.mean(-1, keepdim=True)))
    mean = torch.zeros_like(x32[..., :1]) if rms else average(x32)
    var = average((x32 - mean).pow(2))
    if fault == "one_pass_variance" and not rms:
        var = x32.pow(2).mean(-1, keepdim=True) - mean * mean
    if fault == "neighbour_statistics":
        flat = lambda t: t.reshape(-1, 1).roll(-1, dims=0).reshape(t.shape)
        mean, var = flat(mean), flat(var)
    if fault == "eps_outside_sqrt":
        y = (x32 - mean) / (var.clamp_min(0).sqrt() + eps)
    else:
        y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * w.float()
    if b is not None:
        y = y + b.float()
    return F.pad(y, (0, width - n)).to(x.dtype)


GROUP_FAULTS = ("eps_outside_sqrt", "neighbour_statistics", "one_pass_variance",
                "silu_left_off")
ROW_FAULTS = ("eps_outside_sqrt", "neighbour_statistics", "one_pass_variance")
PAD_FAULT = "width_divisor"  # a fault only where a row is padded (n < width)
WIDE_FAULT = "statistics_over_1024"  # a fault only where a row is wider than 1024


# -- the norms a generate call sends ---------------------------------------------

# kind, shape, groups, eps, silu, and a LayerNorm's true features a row (0 for the others)
Call = Tuple[str, Tuple[int, ...], int, float, bool, int]


@lru_cache(maxsize=None)
def generate_norms(batch: int, text_len: int, unet_batch: int,
                   unet: UNetConfig = TANGO_LIGHT_UNET) -> Tuple[Call, ...]:
    """The norm calls of one generate call, in order: T5 over `text_len`
    tokens and one query of the UNet `unet` at `unet_batch`, the VAE decoder
    at `batch`, found with forward pre-hooks on the port's norm modules run
    on the meta device at the published widths."""
    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.nn.layers import GroupNorm, LayerNorm
    from consistencytta_torch.nn.t5 import RMSNorm, T5Encoder
    from consistencytta_torch.nn.unet import UNet2DConditionGuided
    from consistencytta_torch.nn.vae import Decoder

    cfg = PipelineConfig()
    kinds = {GroupNorm: "group", LayerNorm: "layer", RMSNorm: "rms"}
    calls = []

    def hook(m, args, kwargs):
        calls.append((kinds[type(m)], tuple(args[0].shape), getattr(m, "num_groups", 0), m.eps,
                      bool(kwargs.get("silu", False)),
                      m.normalized_shape[-1] if type(m) is LayerNorm else 0))

    meta = torch.device("meta")
    with meta:
        t5, model, dec = T5Encoder(cfg.t5), UNet2DConditionGuided(unet), Decoder(cfg.vae)
    for mod in (t5, model, dec):
        for m in mod.modules():
            if type(m) in kinds:
                m.register_forward_pre_hook(hook, with_kwargs=True)
    lat = cfg.latent
    with torch.no_grad():
        ids = torch.zeros(unet_batch, text_len, dtype=torch.long, device=meta)
        t5(ids, ids)
        vec = torch.zeros(unet_batch, device=meta)
        model(torch.zeros(unet_batch, lat.t, lat.f, lat.c, device=meta), vec,
              torch.zeros(unet_batch, text_len, cfg.t5.d_model, device=meta), ids, vec)
        dec(torch.zeros(batch, cfg.vae.z_channels, lat.t, lat.f, device=meta))
    return tuple(calls)


# (batch, text_len, unet_batch[, UNet]) of the calls the benchmark's cells
# make: bulk generation at batch 32, the CFG teacher at batch 8 (its UNet at
# 16), one prompt of up to 40 tokens, and the CFG teacher of TANGO's full
# UNet (320/640/1280/1280: GroupNorms of 10-80 channels a group, LayerNorms
# on rows of 320, 640 and 1280)
CALLS = {"generate-b32": (32, 64, 32), "teacher-b8": (8, 64, 16), "generate-b1": (1, 40, 1),
         "tango-b8": (8, 64, 16, TANGO_FULL_UNET)}


def plain_call(kind, x, w, b, groups, eps, silu, n=0):
    if kind == "group":
        return norm.group_norm_plain(x, groups, w, b, eps, silu)
    if kind == "layer":
        return norm.layer_norm_plain(x, w, b, eps, n or None)
    return norm.rms_norm_plain(x, w, eps)


def kernel_call(kind, x, w, b, groups, eps, silu, n=0):
    if kind == "group":
        return norm.group_norm(x, groups, w, b, eps, silu)
    if kind == "layer":
        return norm.layer_norm(x, w, b, eps, n or None)
    return norm.rms_norm(x, w, eps)


def inputs(kind, shape, groups, dtype, gen, n=0):
    """x, w, b for one call: x structured by channel group (GroupNorm) or by
    row, a random affine (no shift for RMSNorm) over the channels or the
    row's first `n` features (all of them where n is 0). A padded row's
    features from n on are not zero: the kernel must ignore them."""
    if kind == "group":
        parts, width = groups, shape[1]
    else:
        parts, width = int(torch.tensor(shape[1:-1]).prod()), n or shape[-1]
    w, b = affine(width, gen, bias=kind != "rms")
    return structured(shape, dtype, gen, parts), w, b


def has_library(kind: str) -> bool:
    """Whether this torch has a norm of its own for `kind` (F.rms_norm
    came with torch 2.4)."""
    return kind != "rms" or hasattr(F, "rms_norm")


def library_call(kind, x, w, b, groups, eps, silu, n=0):
    """torch's own norm on x's dtype (float32 inside), then F.silu where
    the kernel fuses it (`has_library(kind)` must hold); a padded row's
    LayerNorm over its first n features, then the zeros after them."""
    if kind == "group":
        y = F.group_norm(x, groups, w.to(x.dtype), b.to(x.dtype), eps)
    elif kind == "layer":
        n = n or x.shape[-1]
        y = F.pad(F.layer_norm(x[..., :n], (n,), w.to(x.dtype), b.to(x.dtype), eps),
                  (0, x.shape[-1] - n))
    else:
        y = F.rms_norm(x, x.shape[-1:], w.to(x.dtype), eps)
    return F.silu(y) if silu else y


def bound_ms(x: torch.Tensor, kind: str) -> float:
    """One read and one write of x and the float32 affine at 3.35 TB/s."""
    width = x.shape[1] if kind == "group" else x.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + 4 * width * (1 if kind == "rms" else 2)
    return nbytes / 3.35e12 * 1e3
