"""The training CLI data-parallel over NCCL at full width, on 1, 2 and 4
cards where present:

    python3 -m consistencytta_torch.tools.ddp_scaling [--steps 4]

Each run is `python -m consistencytta_torch.cli.train --stage 2 --use_edm
--use_bf16 --random_init --num_devices N` (per-device batch 2, no
accumulation, constant learning rate, no checkpoints) on a synthetic
manifest of 10-s clips, `steps` optimizer steps in one epoch and one
validation batch a rank; N = 1 runs in this process. Builds the kernels
first. Prints the card's name and power limit, then one JSON line a run:
its wall seconds and its epoch record (the steps' and the loader's
seconds, the validation losses; the first step of a run pays the CUDA and
NCCL set-up, and a rank's first batch the loader's imports).
`chip_smoke.py`'s ddp phase runs it at the cards present. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

PROMPTS = ["a dog barks in the distance", "rain falls on a tin roof",
           "a crowd cheers at a stadium", "an engine idles then revs"]
CLIP_SAMPLES = 16000 * 10


def _manifest(path, d, count, rng):
    from consistencytta_torch.io.audio import write_wav

    with open(path, "w") as f:
        for i in range(count):
            wav = os.path.join(d, f"{os.path.basename(path)}.{i}.wav")
            t = np.arange(CLIP_SAMPLES) / 16000
            write_wav(wav, 0.3 * np.sin(2 * np.pi * (110 + 40 * i) * t)
                      + 0.05 * rng.standard_normal(CLIP_SAMPLES))
            f.write(json.dumps({"captions": PROMPTS[i % len(PROMPTS)], "location": wav}) + "\n")
    return path


def cli_run(out_dir: str, n: int, steps: int = 2) -> dict:
    """One CLI run at `--num_devices n` under `out_dir`; raises unless it
    wrote the replay and one epoch of `steps` steps with finite losses."""
    from consistencytta_torch.cli import train

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    train_m = _manifest(os.path.join(out_dir, "train.jsonl"), out_dir, 2 * n * steps, rng)
    val_m = _manifest(os.path.join(out_dir, "val.jsonl"), out_dir, n, rng)
    run_dir = os.path.join(out_dir, "run")
    argv = ["--stage", "2", "--use_edm", "--use_bf16", "--freeze_text_encoder", "--random_init",
            "--train_file", train_m, "--validation_file", val_m, "--num_devices", str(n),
            "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "1",
            "--gradient_accumulation_steps", "1", "--max_train_steps", str(steps),
            "--checkpointing_steps", "none", "--save_every", "1000", "--snr_gamma", "5",
            "--teacher_guidance_scale", "-1", "--learning_rate", "1e-4",
            "--lr_scheduler_type", "constant", "--output_dir", run_dir]
    t0 = time.perf_counter()
    train.main(argv)
    seconds = time.perf_counter() - t0
    with open(os.path.join(run_dir, "summary.jsonl")) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if "train_loss" in r]
    finite = all(np.isfinite(v) for k, v in epochs[0].items()
                 if k.startswith(("train", "loss"))) if epochs else False
    if len(records) != 2 or len(epochs) != 1 or epochs[0]["step"] != steps or not finite:
        raise RuntimeError(f"--num_devices {n}: the run wrote {records}")
    return {"num_devices": n, "seconds": seconds, "record": epochs[0]}


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--output_dir", type=str, default="outputs/ddp_scaling")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ddp_scaling needs CUDA cards")
    from consistencytta_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    _build.build()  # the kernels built before any timed run
    for n in (1, 2, 4):
        if n <= torch.cuda.device_count():
            res = cli_run(os.path.join(args.output_dir, f"n{n}"), n, args.steps)
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
