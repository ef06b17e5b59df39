"""geglu_roofline.gen: the port's GEGLU kernel (`ctta_geglu`,
consistencytta_torch/ops/geglu.py) in the traced requests: the bound of every
GEGLU of each UNet call the stage hooks saw, at its batch, over that
kernel's summed device time in the trace, in %. A transformer block has one
GEGLU, over the tokens of its self-attention (`yardstick.k1_shapes`) and a
hidden width N of four times the block's inner width, heads x head width, as
published (1020 at the light UNet's level 0, which the port pads to 1024);
its bound is M N 3 bytes in the configuration's dtype (h and gate read
once, the product written once) at the card's memory rate. It is counted
from the configuration's shapes, so it is the same work whatever runs it.
None where no such kernel ran."""

import torch

from benchmark import yardstick
from benchmark.reading import roofline_pct, traced_calls

LAUNCH_NAME = "ctta_geglu"


def geglu_shapes(unet: dict, latent: dict):
    """(tokens a sample, hidden width N) of each GEGLU of one UNet query,
    down blocks, mid block, then up blocks."""
    return [(s, 4 * h * d) for s, h, d in yardstick.k1_shapes(unet, latent)]


def geglu_bound_s(unet: dict, latent: dict, batch: int, itemsize: int) -> float:
    nbytes = sum(3 * batch * s * n * itemsize for s, n in geglu_shapes(unet, latent))
    return yardstick.bound_s(0.0, nbytes)


def read(run):
    calls = traced_calls(run, "unet")
    if not calls:
        return None
    itemsize = torch.empty((), dtype=run.dtype).element_size()
    p = run.pipeline
    bound = sum(geglu_bound_s(p["unet"], p["latent"], b, itemsize) for b in calls)
    return roofline_pct(run, LAUNCH_NAME, bound)
