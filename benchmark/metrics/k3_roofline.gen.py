"""k3_roofline.gen: K3 (`mrf_level_kernel`, ops/mrf.py fused_mrf_level) in
the traced requests: the yardstick's bound for the MRF levels it ran (its
launches per vocoder call, the narrowest levels) at each call's batch,
over K3's summed device time in the trace, in %."""

from benchmark import yardstick
from benchmark.reading import roofline_pct, traced_calls

LAUNCH_NAME = "mrf_level_kernel"


def read(run):
    calls = traced_calls(run, "vocoder")
    if not calls or run.trace_read is None:
        return None
    _, launches = yardstick.kernel_seconds(run.trace_read, LAUNCH_NAME)
    if launches % len(calls):
        return None
    p = run.pipeline
    frames = p["latent"]["t"] * 2 ** (len(p["vae"]["ch_mult"]) - 1)
    bound = sum(yardstick.k3_bound_s(p["vocoder"], frames, b, launches // len(calls))
                for b in calls)
    return roofline_pct(run, LAUNCH_NAME, bound)
