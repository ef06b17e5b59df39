"""Finds everything by name: BENCHMARK.json at the checkout's root, and
under this folder `configs/<config>.json`, `traffic/<traffic>.json`,
`workloads/<cell>.json`, `drivers/<driver>.py` and `metrics/<metric>.py`.
A cell, a configuration, a mix or a metric is added by adding its file and
its entry; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    spec: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def driver(self) -> str:
        return self.spec["driver"]

    @property
    def pipeline(self) -> dict:
        return self.config["pipeline"]


def _listed(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def cell(name: str, bench: dict = None, root: str = ROOT) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(entries)}")
    entry = entries[name]
    here = os.path.join(root, "benchmark")
    spec = _json(os.path.join(here, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json has {key} {spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = _json(os.path.join(here, "configs", f"{entry['config']}.json"))
    traffic = _json(os.path.join(here, "traffic", f"{entry['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _listed(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _listed(m, name, reported)]
    return Cell(name, entry, spec, config, traffic, e2e, layer)


def driver(name: str):
    """The module `drivers/<name>.py`."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(name: str, root: str = ROOT) -> Callable:
    """`read(run)` of `metrics/<name>.py` (names may hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(metrics: List[dict], root: str = ROOT) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"], root) for m in metrics}
