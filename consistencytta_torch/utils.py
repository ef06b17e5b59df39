"""Device, precision, seeding, timing and profiling helpers shared by the
port's entry points and tools.

`seed_all`, `profile_trace` and `PhaseTimer` are the counterparts of the JAX
package's utils.py: the host RNGs seeded alike, a profiler trace around a
region, and phase timing that waits for the card where asked.
`read_trace` reads the Chrome trace that `profile_trace` exports: the
device's busy share of the traced window, kernel time by name, and the
longest idle gaps with the host operation that ran during each.

`span` names a range of the program's own code: the generate path's stages
(`STAGE_SPANS`) and its modules (`norm`, `resnet`, `transformer`, `mrf`).
Off, it costs one flag and the profiler's enabled check; under a running
profiler it is a `record_function` range, on the same timeline as the
kernels it launched; with a `Tracer` installed the stage spans are also kept
in memory, with host clocks and CUDA events. A module span inside a
CUDA-graph replay (`graphs.py`) records nothing: the replay runs no Python.

`graph_counts` counts how the four stage modules' calls ran: captures,
replays and eager calls per stage (`graphs.py`).
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

TRACE_FILE = "trace.json"
# the trace's event categories: what the device runs, and what the host runs
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def resolve_device(device="cuda") -> torch.device:
    """The device a caller asked for. Asking for CUDA where no card is
    present raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions"
        )
    return dev


def cast_module(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast a module's parameters to the compute dtype, except those of
    submodules flagged `keep_fp32` (normalization affines, the frozen
    Fourier projection): the JAX package applies those in float32 under
    bf16 compute, and so does the port."""
    module.to(dtype)
    for m in module.modules():
        if getattr(m, "keep_fp32", False):
            m.float()
    return module


def seed_all(seed: int, device="cpu") -> torch.Generator:
    """Seed Python's, numpy's and torch's global RNGs (every card's too) and
    PYTHONHASHSEED, and return a generator on `device` seeded alike: the
    port's random draws take an explicit generator, as the JAX package's
    take a key."""
    seed = int(seed)
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device="cuda") -> Iterator[Optional[str]]:
    """A torch.profiler trace of the region: host operations, plus the
    card's kernels and copies where `device` is a CUDA device. The Chrome
    trace is written to `log_dir`/trace.json when the region ends; the
    context yields that path. With `log_dir` None it does nothing and
    yields None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


class PhaseTimer:
    """Host-clock seconds per named phase, summed over repeats; a phase
    given `sync` (a CUDA device) waits for that card before it stops, the
    counterpart of the JAX package's block_until_ready."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync is not None and torch.device(sync).type == "cuda":
            torch.cuda.synchronize(sync)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> Dict[str, float]:
        return dict(self.phases)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def read_trace(trace, top: Optional[int] = 15, gaps: int = 5) -> dict:
    """Read a Chrome trace (a path, or the parsed JSON) as `profile_trace`
    exports it; times in the trace are microseconds. Returns, in ms:

      window_ms       from the first event's start to the last one's end;
      busy_ms         the union of the device's intervals (kernels, copies,
                      memsets), so that overlapping work counts once;
      busy_share      busy_ms / window_ms (the idle share is 1 minus it);
      kernels         the number of kernel launches in the trace;
      top_kernels     the `top` kernel names (all with None) by summed
                      time, with their launches;
      gaps            the `gaps` longest stretches of the window in which the
                      device ran nothing, each with its start (from the
                      window's start) and the host operation that overlapped
                      it most (the shortest such one on a tie, so the
                      innermost), or None.
    """
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    if not spans:
        raise ValueError("the trace holds no complete events")
    start = min(float(e["ts"]) for e in spans)
    end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, List[float]] = {}
    for e in device:
        if e.get("cat") == "kernel":
            entry = by_name.setdefault(e["name"], [0.0, 0])
            entry[0] += float(e["dur"])
            entry[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]

    idle, cursor = [], start
    for a, b in busy + [(end, end)]:
        if a > cursor:
            idle.append((cursor, a))
        cursor = max(cursor, b)
    idle = sorted(idle, key=lambda ab: -(ab[1] - ab[0]))[:gaps]
    host = [e for e in spans if e.get("cat") in HOST_CATEGORIES]

    def host_op(a: float, b: float) -> Optional[str]:
        best, best_key = None, None
        for e in host:
            lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            overlap = min(hi, b) - max(lo, a)
            if overlap <= 0:
                continue
            key = (overlap, -float(e["dur"]))
            if best_key is None or key > best_key:
                best, best_key = e["name"], key
        return best

    return {
        "window_ms": (end - start) / 1e3,
        "busy_ms": busy_us / 1e3,
        "busy_share": busy_us / (end - start) if end > start else 0.0,
        "kernels": sum(n for _, n in by_name.values()),
        "top_kernels": [{"name": name, "ms": us / 1e3, "launches": n}
                        for name, (us, n) in ranked],
        "gaps": [{"start_ms": (a - start) / 1e3, "ms": (b - a) / 1e3,
                  "host_op": host_op(a, b)} for a, b in idle],
    }


# -- spans ------------------------------------------------------------------

# the spans a Tracer keeps: a generate call and its stages
STAGE_SPANS = ("generate", "t5", "unet", "vae_decode", "vocoder")
_KEPT = frozenset(STAGE_SPANS)
_profiler_enabled = torch._C._autograd._profiler_enabled
_tracer: Optional["Tracer"] = None  # the installed Tracer, if any


class _NoSpan:
    """The shared context of a span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "tracer", "range", "record")

    def __init__(self, name: str, tracer: Optional["Tracer"]):
        self.name, self.tracer = name, tracer
        self.range = self.record = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.tracer is not None:
            self.record = self.tracer._open(self.name)
        return self.record

    def __exit__(self, *exc):
        if self.record is not None:
            self.tracer._close(self.record)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A named range of the program's code, as a context manager. With no
    Tracer installed and no profiler running it returns the shared no-op
    `NO_SPAN`: no allocation, no event, no device call. Under a running
    profiler it enters `torch.profiler.record_function(name)`, which the
    Chrome trace shows as a `user_annotation` range. A stage span
    (`STAGE_SPANS`) under an installed Tracer also records a `SpanRecord`.
    It never synchronises."""
    tracer = _tracer if name in _KEPT else None
    if tracer is None and not _profiler_enabled():
        return NO_SPAN
    return _Span(name, tracer)


@dataclass
class SpanRecord:
    """One span a Tracer kept. `parent` is the index in `Tracer.spans` of
    the kept span around it; `request` is the index of the root `generate`
    span it lies in, the call's identifier (None outside a generate call);
    `start` and `end` are `time.perf_counter()` at entry and exit; `events`
    are the CUDA start and end events recorded on the current stream, None
    on the CPU or while the stream captured a CUDA graph."""

    name: str
    parent: Optional[int]
    request: Optional[int]
    start: float
    end: Optional[float] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


class Tracer:
    """Keeps the stage spans of every call made while it is installed
    (`install()` / `remove()`, or `with Tracer(device):`). One Tracer is
    installed at a time: installing one takes the place of any other. The
    spans are kept in memory and read after the calls (`per_request`);
    there is no exporter: a profiler trace holds the same ranges
    (`profile_trace`)."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.spans: List[SpanRecord] = []
        self.requests = 0  # root generate spans so far
        self._stack: List[int] = []

    def install(self) -> "Tracer":
        global _tracer
        _tracer = self
        return self

    def remove(self) -> None:
        global _tracer
        if _tracer is self:
            _tracer = None

    def __enter__(self) -> "Tracer":
        return self.install()

    def __exit__(self, *exc):
        self.remove()
        return False

    def _event(self) -> torch.cuda.Event:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _open(self, name: str) -> SpanRecord:
        parent = self._stack[-1] if self._stack else None
        if parent is not None:
            request = self.spans[parent].request
        elif name == "generate":
            request, self.requests = self.requests, self.requests + 1
        else:
            request = None
        events = None
        if self.cuda and not torch.cuda.is_current_stream_capturing():
            events = (self._event(), None)
        rec = SpanRecord(name, parent, request, time.perf_counter(), events=events)
        self._stack.append(len(self.spans))
        self.spans.append(rec)
        return rec

    def _close(self, rec: SpanRecord) -> None:
        if rec.events is not None:
            rec.events = (rec.events[0], self._event())
        rec.end = time.perf_counter()
        self._stack.pop()

    def per_request(self) -> Dict[int, Dict[str, float]]:
        """{request: {span name: ms summed over its spans in the call}} of
        the spans inside generate calls: device ms from the spans' events
        (waiting for them), else host-clock ms."""
        out: Dict[int, Dict[str, float]] = {}
        for rec in self.spans:
            if rec.request is None or rec.end is None:
                continue
            if rec.events is not None:
                rec.events[1].synchronize()
                ms = rec.events[0].elapsed_time(rec.events[1])
            else:
                ms = 1e3 * (rec.end - rec.start)
            per = out.setdefault(rec.request, {})
            per[rec.name] = per.get(rec.name, 0.0) + ms
        return out


# -- CUDA graphs of the stage modules ----------------------------------------

# how a stage module's call ran (graphs.py): a capture (which replays the new
# graph once), a replay of a graph captured before, or eagerly
GRAPH_EVENTS = ("captures", "replays", "eager")
_graph_counts: Dict[str, Dict[str, int]] = {}


def count_graph(stage: str, event: str) -> None:
    per = _graph_counts.get(stage)
    if per is None:
        per = _graph_counts[stage] = dict.fromkeys(GRAPH_EVENTS, 0)
    per[event] += 1


def graph_counts() -> Dict[str, Dict[str, int]]:
    """{stage: {"captures": n, "replays": n, "eager": n}} since the last
    `reset_graph_counts`, for the stages called since."""
    return {stage: dict(per) for stage, per in _graph_counts.items()}


def reset_graph_counts() -> None:
    _graph_counts.clear()
