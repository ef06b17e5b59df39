"""What the metric readers under `metrics/` share: the window's requests,
the stage timers' per-request times and call counts, and the traced
requests' kernel times against the yardstick's bounds."""

from __future__ import annotations

import statistics
from typing import Optional

import numpy as np

from benchmark import yardstick


def latencies_ms(run):
    return [1e3 * (r.end - r.start) for r in run.records]


def stage_median_ms(run, stage: str) -> Optional[float]:
    """Median over the window's requests of a stage's device ms (summed over
    its calls in a request); None where the stage was not timed."""
    per = run.stage_ms.get(stage, {})
    ms = [per[r.index] for r in run.records if r.index in per]
    return statistics.median(ms) if ms else None


def request_s(run) -> float:
    """The window's median request, host-clock seconds."""
    return statistics.median(r.end - r.start for r in run.records)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def traced_calls(run, stage: str):
    """[batch of each call of `stage`] in the traced requests."""
    calls = run.timer.calls(stage) if run.timer is not None else {}
    return [b for i in run.profiled for b in calls.get(i, [])]


def roofline_pct(run, launch_name: str, bound_s: float) -> Optional[float]:
    """100 x bound / the kernel's summed seconds in the trace; None where
    the trace has no such kernel."""
    if run.trace_read is None:
        return None
    seconds, launches = yardstick.kernel_seconds(run.trace_read, launch_name)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds


def idle_pct(run) -> Optional[float]:
    """100 x (1 - the device's busy seconds per traced request over the
    window's median request): the profiler lengthens the traced requests'
    host time, not their kernels."""
    tr = run.trace_read
    if tr is None or not run.profiled or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / len(run.profiled) / request_s(run))
