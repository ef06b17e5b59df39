"""Device, precision, seeding, timing and profiling helpers shared by the
port's entry points and tools.

`seed_all`, `profile_trace` and `PhaseTimer` are the counterparts of the JAX
package's utils.py: the host RNGs seeded alike, a profiler trace around a
region, and phase timing that waits for the card where asked.
`read_trace` reads the Chrome trace that `profile_trace` exports: the
device's busy share of the traced window, kernel time by name, and the
longest idle gaps with the host operation that ran during each.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import time
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
