"""The epoch loop of training: steps over a fresh loader each epoch, the
per-epoch validation, the `best` / `epoch_<n>` / `step_<n>` checkpoints and
the summary.jsonl log (the port's copy of the JAX package's
training/loop.py, itself the reference's train.py main loop).

One `torch.Generator` on the run's device, seeded from `LoopConfig.seed`,
feeds every step and every validation. With `LoopConfig.mesh` (one rank of
a data-parallel run, parallel/mesh.py) every rank reads the same global
batch and keeps its rows, the generator draws at the global batch and
keeps the rank's rows (`RankGenerator`), the validation losses are
averaged over the ranks, rank 0 writes summary.jsonl, and every rank takes
part in a checkpoint's gather while rank 0 writes it. `float(loss)` waits
for each step; the loader runs on the host between steps. Each epoch's
record carries, besides the JAX package's keys, the seconds spent in the
loader (host reads, mixing, tokenizing and the copy to the device), in the
steps, in validation and in checkpoint writes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from consistencytta_torch.io.checkpoints import SummaryWriter, save_checkpoint
from consistencytta_torch.parallel.mesh import (
    Mesh,
    RankGenerator,
    agree,
    all_reduce_mean,
    shard_batch,
)
from consistencytta_torch.training.data import to_device
from consistencytta_torch.utils import resolve_device


@dataclass
class LoopConfig:
    num_epochs: int = 60
    output_dir: str = "saved/run"
    save_every: int = 5  # epoch checkpoints (--save_every)
    eval_batches: Optional[int] = None  # cap on validation batches
    log_every: int = 50
    starting_epoch: int = 0
    seed: int = 0
    # --max_train_steps: training stops, mid-epoch, at this optimizer step
    max_steps: Optional[int] = None
    # --checkpointing_steps: "best" keeps the best-validation checkpoint; an
    # integer n saves `step_{n}` checkpoints every n optimizer steps instead
    save_best: bool = True
    step_checkpoint_every: Optional[int] = None
    use_wandb: bool = False  # --with_tracking: mirror the log to wandb
    wandb_kwargs: Optional[dict] = None
    device: str = "cuda"
    mesh: Optional[Mesh] = None  # this rank of a data-parallel run
    accum_steps: int = 1  # micro-batches a step: how a global batch splits over ranks


def train_loop(
    step_fn: Callable,
    validate_fn: Optional[Callable],
    state,
    pipeline,
    make_train_loader: Callable[[int], Iterable[dict]],
    make_eval_loader: Optional[Callable[[], Iterable[dict]]],
    config: LoopConfig,
    pipeline_config=None,
):
    """Run the loop and return the state (updated in place).

    `make_train_loader(epoch)` gives that epoch's batches (numpy, as
    `training/data.DataLoader` yields them); `step_fn(state, batch,
    generator=...)` and `validate_fn(state, batch, generator=...)` are the
    builders' functions of `training/step.py`. Checkpoints hold `pipeline`'s
    teacher and T5 besides the state (`io/checkpoints.save_checkpoint`).
    The best checkpoint follows `loss_w_teacher` (stage 2), else
    `val_loss` (stage 1), else the epoch's mean train loss."""
    mesh = config.mesh
    main_rank = mesh is None or mesh.is_main
    writer = SummaryWriter(config.output_dir, use_wandb=config.use_wandb,
                           wandb_kwargs=config.wandb_kwargs) if main_rank else None
    dev = resolve_device(config.device)
    generator = torch.Generator(device=dev).manual_seed(config.seed)
    if mesh is not None:
        generator = RankGenerator(generator, mesh.rank, mesh.world)

    def rows(batch, accum=1):
        return batch if mesh is None else shard_batch(batch, mesh, accum)
    best_eval_loss = float("inf")
    reached_max = False

    for epoch in range(config.starting_epoch, config.num_epochs):
        if reached_max:
            break
        t_epoch = time.perf_counter()
        train_loss, n_steps = 0.0, 0
        seconds = {"loader_seconds": 0.0, "step_seconds": 0.0, "checkpoint_seconds": 0.0}

        def save(name):
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(config.output_dir, name), state, pipeline,
                            pipeline_config)
            seconds["checkpoint_seconds"] += time.perf_counter() - t0

        batches = iter(make_train_loader(epoch))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            batch = to_device(rows(batch, config.accum_steps), dev)
            t1 = time.perf_counter()
            metrics = step_fn(state, batch, generator=generator)
            n_steps += 1
            loss = float(metrics["loss"])
            seconds["loader_seconds"] += t1 - t0
            seconds["step_seconds"] += time.perf_counter() - t1
            if np.isfinite(loss):
                train_loss += loss
            global_step = int(state.step)
            if n_steps % config.log_every == 0 and main_rank:
                writer.log({"epoch": epoch, "step": global_step, "train_loss": loss})
            if config.step_checkpoint_every and global_step % config.step_checkpoint_every == 0:
                save(f"step_{global_step}")
            if config.max_steps is not None and global_step >= config.max_steps:
                reached_max = True
                break

        record = {"epoch": epoch, "step": int(state.step), "steps": n_steps,
                  "train_loss": train_loss / max(n_steps, 1),
                  "epoch_seconds": time.perf_counter() - t_epoch}

        if validate_fn is not None and make_eval_loader is not None:
            t0 = time.perf_counter()
            totals, n_eval = {}, 0
            for i, batch in enumerate(make_eval_loader()):
                if config.eval_batches is not None and i >= config.eval_batches:
                    break
                losses = validate_fn(state, to_device(rows(batch), dev), generator=generator)
                if mesh is not None:
                    names = sorted(losses)
                    means = torch.stack([torch.as_tensor(losses[k], device=dev).float()
                                         for k in names])
                    all_reduce_mean([means], mesh)
                    losses = dict(zip(names, means))
                for k, v in losses.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                n_eval += 1
            for k in totals:
                record[k] = totals[k] / max(n_eval, 1)
            record["validation_batches"] = n_eval
            record["validation_seconds"] = time.perf_counter() - t0
            loss_to_track = record.get("loss_w_teacher", record.get("val_loss",
                                                                    record["train_loss"]))
        else:
            loss_to_track = record["train_loss"]

        better = loss_to_track < best_eval_loss
        if mesh is not None:  # the same decision on every rank
            better = agree(better, mesh)
        if config.save_best and better:
            best_eval_loss = loss_to_track
            save("best")
        if (epoch + 1) % config.save_every == 0:
            save(f"epoch_{epoch + 1}")
        if main_rank:
            writer.log({**record, **seconds})

    return state
