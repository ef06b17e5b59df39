"""Runs one cell of BENCHMARK.json once and prints one JSON line.

    python3 -m benchmark.run --workload gen-b32 --seed 7 --seconds 30 --trace 0

From the root of a checkout. `--trace 0` reports the cell's end-to-end
metrics, `--trace 1` its per-layer metrics from a profiler trace and
in-situ stage timers. The last lines of standard error, and the result's
last key `checks`, give each number compared with the plain reference
beside its limit. Exits non-zero, printing no result, without enough CUDA
cards, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import manifest  # noqa: E402


def cache_dirs(root: str) -> None:
    """Every cache the run may write, at fixed paths inside the checkout;
    libraries that could pull in JAX are told not to."""
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs(manifest.ROOT)
    cell = manifest.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import harness

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t0=T0)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
