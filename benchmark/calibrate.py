"""Readings that set a cell's limit: for each seed, the program's number
(the timed entry on the same requests a run's check would sample, without
a window) and, on the control seeds, the control's: the reference itself
put in the program's place, its linears and convolutions through float8.

    python3 -m benchmark.calibrate --workload gen-b32 --seeds 1,2,3 --control 1,2,3

One JSON line a seed. The limit sits between the largest program reading
and the smallest control reading (PERF.md gives both)."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness, manifest
from benchmark.reference.layers import float8_round


def readings(cell: manifest.Cell, seed: int, control: bool, device="cuda:0", dtype=None,
             pipeline=None) -> dict:
    dev = torch.device(device)
    run = harness.Run(cell, seed, 0.0, False, dev, dtype or getattr(torch, cell.config["dtype"]),
                      pipeline or cell.pipeline)
    drv = manifest.driver(cell.driver)
    drv.setup(run)
    k = cell.spec["check"]["requests"] + 1
    outputs = {}
    for i in range(k):
        outputs[i] = run.state["call"](i)[0]
    drv.free(run)
    harness.free_cuda(run)
    picked = list(range(k))
    probe = drv.probed(cell.spec["check"]["limit"])
    line = {"workload": cell.name, "seed": seed,
            "program": drv.readings(run, picked, outputs, probe=probe)}
    if control:
        line["control"] = drv.readings(run, picked, None, quant=float8_round, probe=probe)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", default="", help="seeds, of --seeds, that also read the control")
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    control = {int(s) for s in args.control.split(",") if s}
    for s in args.seeds.split(","):
        t = time.perf_counter()
        line = readings(cell, int(s), int(s) in control)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
