"""The program's own spans in a traced run. The port names ranges of its
generate path (`consistencytta_torch/utils.py` `span`): the stages
`generate`, `t5`, `unet`, `vae_decode`, `vocoder`, and the modules `norm`,
`resnet`, `transformer`, `mrf`. Under the profiler each is a
`user_annotation` range of the Chrome trace, on the kernels' timeline; with
the program's `Tracer` installed the stage spans also keep host clocks and
CUDA events in memory.

`attach(run, pipe)` installs a Tracer for the rest of a traced run (in
`run.state["tracer"]`). `read(trace)` reads the exported Chrome trace: the
kernels, copies and memsets launched inside each span. `norm_ms` and
`idle_ms` are the per-layer numbers made from the two. Where the program
has no spans, each returns None."""

from __future__ import annotations

import bisect
import json
import os
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark import yardstick

STAGES = ("generate", "t5", "unet", "vae_decode", "vocoder")
MODULES = ("norm", "resnet", "transformer", "mrf")
# the host's launch calls, runtime and low-level API alike: K1 and K3 launch
# by cuLaunchKernel
LAUNCH_CATEGORIES = tuple(c for c in yardstick.HOST_CATEGORIES if c.startswith("cuda_"))


def attach(run, pipe) -> None:
    """Installs the program's Tracer for the rest of the run, kept in
    `run.state["tracer"]`; nothing where the program has none."""
    from consistencytta_torch import utils

    tracer = getattr(utils, "Tracer", None)
    if tracer is not None:
        run.state["tracer"] = tracer(pipe.device).install()


def _complete(events):
    return [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]


def _interval(e) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def read(trace) -> Optional[dict]:
    """Read a Chrome trace (a path or the parsed JSON; microseconds). A
    device operation belongs to every program span that encloses its launch
    on the launching thread (launch and operation matched by correlation
    id, whichever CUDA API launched it); requests are the profiler's
    `ProfilerStep` ranges. Returns None where the trace holds no program
    span, else:

      requests   the profiler steps (1 where there are none);
      spans      {span name: {"count": ranges, "launches": kernels,
                 "device_ms": summed device time, "busy_ms": the union of
                 the device intervals, so overlapping work counts once}},
                 summed over the requests;
      ops        {device op name: {innermost enclosing span, or "none":
                 [ms, launches]}}, summed over the requests.
    """
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    events = _complete(trace["traceEvents"] if isinstance(trace, dict) else trace)
    names = set(STAGES) | set(MODULES)
    ranges = defaultdict(list)  # (pid, tid) -> [(start, end, name)]
    steps = []
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        if e["name"] in names:
            ranges[(e.get("pid"), e.get("tid"))].append((*_interval(e), e["name"]))
        elif e["name"].startswith("ProfilerStep"):
            steps.append(_interval(e))
    if not ranges:
        return None
    launches = {}  # correlation id -> (pid, tid, ts)
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = (e.get("pid"), e.get("tid"), float(e["ts"]))
    device = defaultdict(list)  # thread -> [(launch ts, start, end, name, category)]
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in yardstick.DEVICE_CATEGORIES and corr in launches:
            pid, tid, ts = launches[corr]
            device[(pid, tid)].append((ts, *_interval(e), e["name"], e["cat"]))
    steps.sort()
    step_starts = [a for a, _ in steps]

    def step_of(ts: float) -> int:
        k = bisect.bisect_right(step_starts, ts) - 1
        return k if k >= 0 and ts <= steps[k][1] else -1

    spans = {n: {"count": 0, "launches": 0, "device_ms": 0.0, "busy_ms": 0.0}
             for n in (*STAGES, *MODULES)}
    for rs in ranges.values():
        for _, _, name in rs:
            spans[name]["count"] += 1
    intervals = defaultdict(list)  # (span name, step) -> device intervals
    ops: Dict[str, Dict[str, List[float]]] = defaultdict(dict)
    for thread, launched in device.items():
        for inside, launch, a, b, op, cat in _sweep(ranges.get(thread, []), launched):
            for name in {n for _, _, n in inside}:
                s = spans[name]
                s["launches"] += cat == "kernel"
                s["device_ms"] += (b - a) / 1e3
                intervals[(name, step_of(launch))].append((a, b))
            where = inside[-1][2] if inside else "none"
            entry = ops[op].setdefault(where, [0.0, 0])
            entry[0] += (b - a) / 1e3
            entry[1] += cat == "kernel"
    for (name, _), iv in intervals.items():
        spans[name]["busy_ms"] += sum(b - a for a, b in yardstick._union(iv)) / 1e3
    return {"requests": max(len(steps), 1), "spans": spans, "ops": dict(ops)}


def _sweep(ranges: List[tuple], launched: List[tuple]):
    """Yields (the ranges that hold the launch, outermost first, *launch)
    for each of one thread's launches. A thread's ranges nest, so one pass
    over both, in time order, with a stack of the open ranges finds them."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    k, stack = 0, []
    for launch in sorted(launched):
        ts = launch[0]
        while k < len(ranges) and ranges[k][0] <= ts:
            while stack and stack[-1][1] < ranges[k][0]:
                stack.pop()
            stack.append(ranges[k])
            k += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        yield (list(stack), *launch)


def stage_ms(run, stage: str) -> Optional[float]:
    """Median over the window's requests of a stage's span ms: its spans'
    CUDA-event ms summed over the request's generate call. The call is the
    Tracer's root `generate` span that the request's host clock holds."""
    tracer = run.state.get("tracer")
    if tracer is None:
        return None
    roots = [s for s in tracer.spans if s.parent is None and s.name == "generate"
             and s.end is not None]
    starts = [s.start for s in roots]
    per = tracer.per_request()
    ms = []
    for r in run.records:
        k = bisect.bisect_left(starts, r.start)
        if k < len(roots) and roots[k].end <= r.end:
            call = per.get(roots[k].request, {})
            if stage in call:
                ms.append(call[stage])
    return statistics.median(ms) if ms else None


def norm_ms(run) -> Optional[float]:
    """Device ms a traced request of everything launched inside `norm`
    spans, summed."""
    read = run.state.get("spans")
    if not read or not read["spans"]["norm"]["count"]:
        return None
    return read["spans"]["norm"]["device_ms"] / read["requests"]


def idle_ms(run, stage: str) -> Optional[float]:
    """A stage's idle ms in a request: its span ms over the window
    (`stage_ms`) less the busy ms a traced request of what its spans
    launched. The profiler slows launches, not kernels, so the window gives
    the elapsed time and the trace the busy time."""
    read = run.state.get("spans")
    elapsed = stage_ms(run, stage)
    if not read or elapsed is None or not read["spans"][stage]["count"]:
        return None
    return elapsed - read["spans"][stage]["busy_ms"] / read["requests"]
