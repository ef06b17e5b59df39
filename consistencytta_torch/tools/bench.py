"""Benchmark: 1-NFE end-to-end generation throughput on one card, the
counterpart of the JAX package's bench.py.

    python3 -m consistencytta_torch.tools.bench
    python3 -m consistencytta_torch.tools.bench --device cpu   # tiny, plain versions

The same workload as bench.py: `PipelineConfig()` with random weights from
seed 0, bf16, 1 NFE, batch 32, text length 64, guidance 4.0, token ids from
`numpy.random.default_rng(0)`; one warm-up call, then 10 timed calls with
one synchronise at the end. Prints ONE JSON line with bench.py's four keys
(`metric` = 10s_clips_per_sec_per_chip_1nfe, `value`, `unit`,
`vs_baseline`), and beside them: the host ms per call and the CUDA-event
device ms per call of the same window, the teacher's clips/s, and the
card's `name` and `power_limit` as nvidia-smi gives them.

`vs_baseline` divides by the 18-step Heun CFG teacher (35 NFE) measured on
the same card in the same run, as bench.py's docstring defines the
denominator (bench.py's constant 2.21 is a TPU's number and is not used):
`build_teacher_generate_fn` at batch 32, one warm-up and 2 timed calls.

`--device cpu` runs at `PipelineConfig.tiny()` in float32 at batch 2 (2
timed calls, 1 of the teacher) through the kernels' plain versions, with
`platform` "cpu" and no device times: a test of the tool, not a
measurement.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from consistencytta_torch.inference.generate import (
    GenerateConfig, build_generate_fn, build_teacher_generate_fn,
)
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.tools.profile_stages import token_inputs, workload
from consistencytta_torch.utils import PhaseTimer, resolve_device

TEXT_LEN = 64
GUIDANCE = 4.0
TEACHER_STEPS = 18  # Heun: 35 queries
ITERS = {"cuda": 10, "cpu": 2}  # timed calls after one warm-up
TEACHER_ITERS = {"cuda": 2, "cpu": 1}


def card_name_and_power_limit():
    """(name, power limit) of the first card as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def timed_calls(fn, iters: int, dev: torch.device):
    """One warm-up call, then `iters` calls with one synchronise at the end:
    (host seconds, CUDA-event ms of the same window or None on the CPU)."""
    cuda = dev.type == "cuda"
    fn(0)
    if cuda:
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    timer = PhaseTimer()
    with timer.phase("calls", sync=dev):
        for i in range(iters):
            fn(i + 1)
        if cuda:
            end.record()
    return timer.summary()["calls"], (start.elapsed_time(end) if cuda else None)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help='"cuda", or "cpu" for the tiny config through the plain versions')
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    config, dtype, batch = workload(dev)
    iters, teacher_iters = ITERS[dev.type], TEACHER_ITERS[dev.type]
    pipe = Pipeline.create(config, dtype=dtype, device=dev, seed=0,
                           roles=(*STUDENT_ROLES, "teacher"))
    text = token_inputs(config, batch, TEXT_LEN)
    student = build_generate_fn(pipe, GenerateConfig(num_steps=1))
    teacher = build_teacher_generate_fn(pipe, num_steps=TEACHER_STEPS)

    def call(fn):
        return lambda i: fn(*text, GUIDANCE,
                            generator=torch.Generator(device=dev).manual_seed(i))

    seconds, device_ms = timed_calls(call(student), iters, dev)
    t_seconds, t_device_ms = timed_calls(call(teacher), teacher_iters, dev)
    clips_per_sec = batch * iters / seconds
    teacher_clips_per_sec = batch * teacher_iters / t_seconds
    name, limit = card_name_and_power_limit() if cuda else ("cpu", None)
    line = {
        "metric": "10s_clips_per_sec_per_chip_1nfe",
        "value": clips_per_sec,
        "unit": "clips/s/chip",
        "vs_baseline": clips_per_sec / teacher_clips_per_sec,
        "platform": "gpu" if cuda else "cpu",
        "host_ms_per_call": 1e3 * seconds / iters,
        "device_ms_per_call": device_ms / iters if cuda else None,
        "teacher_clips_per_sec": teacher_clips_per_sec,
        "teacher_host_ms_per_call": 1e3 * t_seconds / teacher_iters,
        "teacher_device_ms_per_call": t_device_ms / teacher_iters if cuda else None,
        "teacher": f"Heun CFG, {TEACHER_STEPS} steps ({2 * TEACHER_STEPS - 1} NFE)",
        "batch": batch, "iters": iters, "teacher_iters": teacher_iters,
        "name": name, "power_limit": limit,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
