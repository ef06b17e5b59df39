"""mrf_wide_roofline.gen: K7 (`ctta_conv_nlc`, the port's ops/mrf.py
wide_mrf_level: its 18 conv launches a level and its two layout passes) in
the traced requests: the yardstick's bound of the vocoder levels that K3 did
not run (the widest len(upsample_rates) less K3's launches a vocoder call)
at each call's batch, over K7's summed device time in the trace, in %. Each
level's bound is 2 b L C^2 sum(2 len(d) k) operations at the card's peak,
or its bytes if more, as `yardstick.k3_bound_s` reckons a level: it counts
the level's work whatever runs it, so it cannot read over 100%. None where
no K7 kernel ran."""

from benchmark import yardstick
from benchmark.reading import roofline_pct, traced_calls

LAUNCH_NAME = "ctta_conv_nlc"
K3_NAME = "mrf_level_kernel"


def wide_bound_s(vocoder: dict, frames: int, batch: int, fused_levels: int) -> float:
    """The bound of one vocoder call's levels other than the `fused_levels`
    narrowest: every level's, less those K3 ran."""
    every = len(vocoder["upsample_rates"])
    return (yardstick.k3_bound_s(vocoder, frames, batch, every)
            - yardstick.k3_bound_s(vocoder, frames, batch, fused_levels))


def read(run):
    calls = traced_calls(run, "vocoder")
    if not calls or run.trace_read is None:
        return None
    _, wide = yardstick.kernel_seconds(run.trace_read, LAUNCH_NAME)
    _, fused = yardstick.kernel_seconds(run.trace_read, K3_NAME)
    if wide == 0 or fused % len(calls):
        return None
    p = run.pipeline
    frames = p["latent"]["t"] * 2 ** (len(p["vae"]["ch_mult"]) - 1)
    bound = sum(wide_bound_s(p["vocoder"], frames, b, fused // len(calls)) for b in calls)
    return roofline_pct(run, LAUNCH_NAME, bound)
