"""k1_roofline.gen: K1 (`mha_packed_kernel`, ops/attention.py
flash_mha_packed) in the traced requests: the yardstick's bound for every
UNet query the stage hooks saw, at its batch, over K1's summed device time
in the trace, in %."""

from benchmark import yardstick
from benchmark.reading import roofline_pct, traced_calls

LAUNCH_NAME = "mha_packed_kernel"


def read(run):
    p = run.pipeline
    bound = sum(yardstick.k1_bound_s(p["unet"], p["latent"], b) for b in traced_calls(run, "unet"))
    return roofline_pct(run, LAUNCH_NAME, bound) if bound else None
