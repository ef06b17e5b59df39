"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics. `run.py` is the command around it; the
tests drive it on the CPU at a small size with `device="cpu"`."""

from __future__ import annotations

import gc
import heapq
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from benchmark import manifest, yardstick
from benchmark.hooks import StageTimer
from benchmark.weights import derive

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "consistencytta_tpu")


@dataclass
class Record:
    """One request of the window: host-clock start and end (the output on
    the host), the clips it carried, its prompt length."""

    index: int
    start: float
    end: float
    clips: int
    length: int


class Sample:
    """The window's requests that the check compares, kept as the window
    runs so that the host holds k + 1 outputs and not every one: the k of
    lowest priority, a number drawn from (seed, request), which makes them
    k requests of the window drawn uniformly from the seed, and the one with
    the longest prompts (of those, the lowest priority: where every request
    is as long, one of the k)."""

    def __init__(self, seed: int, k: int):
        self.seed, self.k = int(seed), int(k)
        self.heap: List[tuple] = []  # (-priority, request)
        self.longest: Optional[tuple] = None  # (length, -priority, request)
        self.outputs: Dict[int, Any] = {}

    def offer(self, i: int, length: int, out) -> None:
        keep = set()
        p = derive(self.seed, "check", i)
        if len(self.heap) < self.k:
            heapq.heappush(self.heap, (-p, i))
            keep.add(i)
        elif self.heap and p < -self.heap[0][0]:
            heapq.heapreplace(self.heap, (-p, i))
            keep.add(i)
        if self.longest is None or (length, -p) > self.longest[:2]:
            self.longest = (length, -p, i)
            keep.add(i)
        if i in keep:
            self.outputs[i] = out
        picked = set(self.picked())
        for j in [j for j in self.outputs if j not in picked]:
            del self.outputs[j]

    def picked(self) -> List[int]:
        chosen = {i for _, i in self.heap}
        if self.longest is not None:
            chosen.add(self.longest[2])
        return sorted(chosen)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)  # a NaN fails


@dataclass
class Run:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    dtype: torch.dtype
    pipeline: dict  # the configuration's `pipeline` section, as run
    t0: float = field(default_factory=time.perf_counter)
    setup_s: float = 0.0
    window_s: float = 0.0
    records: List[Record] = field(default_factory=list)
    sample: Optional[Sample] = None  # the driver's: the window's outputs it keeps
    timer: Optional[StageTimer] = None
    profiled: List[int] = field(default_factory=list)
    trace_read: Optional[dict] = None
    stage_ms: Dict[str, Dict[int, float]] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    state: Dict[str, Any] = field(default_factory=dict)  # the driver's

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


def closed_loop(run: Run, call, trace_requests: int) -> None:
    """One client: call(i) returns (host output, clips, prompt length) once
    the output is on the host; the next request follows; `run.sample`, where
    the driver set one, keeps the outputs that it draws. The window runs
    until `run.seconds` have passed at the end of a request and ends with
    that request, so every request of the window completes inside it. A
    traced run then traces `trace_requests` more (`trace`)."""
    t_start = time.perf_counter()
    i = 0
    while True:
        if run.timer is not None:
            run.timer.request = i
        t0 = time.perf_counter()
        out, clips, length = call(i)
        t1 = time.perf_counter()
        run.records.append(Record(i, t0, t1, clips, length))
        if run.sample is not None:
            run.sample.offer(i, length, out)
        del out
        i += 1
        if t1 - t_start >= run.seconds:
            break
    run.window_s = run.records[-1].end - t_start
    if run.trace:
        trace(run, call, i, trace_requests)


def trace(run: Run, call, first: int, n: int) -> None:
    """A torch.profiler trace of n requests after the window, behind one
    request that warms the profiler up and is left out. The profiler runs
    only after the window: once started it slows every later launch of the
    process, so stage times and latencies come from the window before it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.cuda else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=n, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for k in range(n + 1):
                if run.timer is not None:
                    run.timer.request = first + k
                call(first + k)
                prof.step()
        run.trace_read = yardstick.read_trace(path)
    run.profiled = list(range(first + 1, first + 1 + n))


def free_cuda(run: Run) -> None:
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             dtype: torch.dtype = None, pipeline: dict = None, t0: float = None) -> dict:
    """Runs the cell once and returns the result line (a dict)."""
    dev = torch.device(device)
    run = Run(cell, int(seed), float(seconds), bool(trace), dev,
              dtype or getattr(torch, cell.config["dtype"]),
              pipeline or cell.pipeline)
    if t0 is not None:
        run.t0 = t0
    drv = manifest.driver(cell.driver)
    if run.cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    drv.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - run.t0
    drv.window(run)
    run.sync()
    if run.timer is not None:
        run.stage_ms = run.timer.ms_per_request()
        run.timer.remove()
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if run.cuda else 0
    drv.free(run)
    free_cuda(run)
    checks: List[Check] = drv.check(run)
    metrics = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in metrics:
        v = manifest.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if run.cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if run.cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(run.memory_peak_bytes),
    }
    result = {"correct": all(c.ok for c in checks), "attempted": len(run.records), "failed": 0,
              "metrics": values, "device": device_info}
    if trace and run.trace_read is not None:
        tr = run.trace_read
        device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[k, v[0]] for k, v in ops],
                               "idle_gaps": tr["gaps"][:10]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def forbidden_loaded() -> List[str]:
    """Top-level names of JAX and the JAX package among the loaded modules."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
