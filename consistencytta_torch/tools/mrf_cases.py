"""The cases the wide MRF level (K7, ops/mrf.py:wide_mrf_level) is checked
on, for the card's kernel tests, the CPU tests and `chip_smoke.py`'s kernel
phase.

`inputs` makes a level's input and its 18 conv weights and biases at the
scales K3's checks use (x ~ 0.5 N(0, 1), weights fan-in scaled, biases
0.05 N(0, 1)), bf16 on the card. `close` is the tolerance of K3's 18-conv
chain: the largest error at most 3e-2 of the plain output's largest
magnitude, and the relative L2 error at most 1e-2; K7 rounds to bf16 once a
conv, the plain chain after each op, and the two read ~0.5% apart in relative
L2 on an H100 at the cells' levels. `fault` is the plain level with a planted fault:
the dilations of every ResBlock reversed, the bias of the first ResBlock's
first d = 1 conv dropped, the slope 0.2 in place of 0.1, or the first
conv's first tap reading one row further (its weights moved onto the next
tap: the conv has d = 1). Each must fail `close`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from consistencytta_torch.ops import mrf

KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3
SLOPE = 0.1
TOL_MAX, TOL_L2 = 3e-2, 1e-2
FAULTS = ("dilations_reversed", "bias_dropped", "slope_0.2", "tap_off_by_one")


def inputs(gen: torch.Generator, b: int, c: int, length: int, dtype=torch.bfloat16):
    dev = gen.device
    x = (torch.randn(b, c, length, device=dev, generator=gen) * 0.5).to(dtype)
    ws = [(torch.randn(c, c, k, device=dev, generator=gen) / (c * k) ** 0.5).to(dtype)
          for k in KS for _ in range(6)]
    bs = [(torch.randn(c, device=dev, generator=gen) * 0.05).to(dtype) for _ in range(18)]
    return x, ws, bs


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    got, want = got.float(), want.float()
    return {"finite": bool(torch.isfinite(got).all()),
            "max_err_share": ((got - want).abs().max() / want.abs().max()).item(),
            "rel_l2": ((got - want).norm() / want.norm()).item()}


def close(got: torch.Tensor, want: torch.Tensor) -> bool:
    e = errors(got, want)
    return e["finite"] and e["max_err_share"] <= TOL_MAX and e["rel_l2"] <= TOL_L2


def fault(x, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor], name: str,
          ks=KS, ds=DS) -> torch.Tensor:
    """The plain level (direct dilated convs) with the planted fault `name`."""
    ws, bs, slope = list(ws), list(bs), SLOPE
    if name == "dilations_reversed":
        ds = tuple(tuple(reversed(d)) for d in ds)
    elif name == "bias_dropped":
        bs[1] = torch.zeros_like(bs[1])
    elif name == "slope_0.2":
        slope = 0.2
    elif name == "tap_off_by_one":
        if ds[0][0] != 1:
            raise ValueError("tap_off_by_one: the first conv must have d = 1")
        w = ws[0].clone()
        w[..., 1] += w[..., 0]
        w[..., 0] = 0
        ws[0] = w
    else:
        raise ValueError(f"unknown fault {name}")
    return mrf.mrf_level_plain(x, ws, bs, ks, ds, slope)
