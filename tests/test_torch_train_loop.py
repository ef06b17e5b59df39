"""The port's training loop (consistencytta_torch/training/loop.py), the
behaviours tests/test_loop_flags.py holds the JAX loop to: --max_train_steps
stops mid-epoch, --checkpointing_steps=<n> writes `step_<n>` checkpoints,
`save_best` off writes no `best`, --with_tracking without wandb still logs;
and the rest of the loop's contract: the best checkpoint follows
loss_w_teacher, else val_loss, else the train loss; `epoch_<n>` every
save_every epochs; eval_batches caps validation; a non-finite loss stays
out of the epoch's mean; one generator feeds steps and validation.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from consistencytta_torch.io.checkpoints import MODEL_FILE
from consistencytta_torch.training import loop
from consistencytta_torch.training.loop import LoopConfig, train_loop
from consistencytta_torch.training.optim import OptimizerConfig, make_optimizer
from consistencytta_torch.training.step import TrainState


def _state():
    student = nn.Linear(2, 1)
    optimizer, sched = make_optimizer(list(student.parameters()), OptimizerConfig())
    return TrainState(0, student, nn.Linear(2, 1), nn.Linear(2, 1), optimizer, sched)


def _step_fn(losses=None):
    seen = []

    def step(state, batch, generator=None):
        assert isinstance(batch["wav"], torch.Tensor) and "captions" not in batch
        seen.append(generator)
        state.step += 1
        loss = 0.5 if losses is None else losses[state.step - 1]
        return {"loss": torch.tensor(loss)}

    step.seen = seen
    return step


def _loader(n_batches):
    def make(epoch=0):
        return [{"wav": np.zeros((1,), np.float32), "captions": ["x"]}
                for _ in range(n_batches)]

    return make


def _records(path):
    with open(os.path.join(path, "summary.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run(tmp_path, n_batches=5, step_fn=None, validate_fn=None, eval_loader=None, **kw):
    cfg = LoopConfig(output_dir=str(tmp_path), device="cpu", **{
        "num_epochs": 1, "save_every": 100, "save_best": False, **kw})
    return train_loop(step_fn or _step_fn(), validate_fn, _state(), None, _loader(n_batches),
                      eval_loader, cfg)


def test_max_steps_stops_mid_epoch(tmp_path):
    state = _run(tmp_path, num_epochs=10, max_steps=3)
    assert state.step == 3
    assert [r["steps"] for r in _records(tmp_path)] == [3]


def test_step_checkpointing(tmp_path):
    _run(tmp_path, step_checkpoint_every=2)
    assert os.path.exists(tmp_path / "step_2" / MODEL_FILE)
    assert os.path.exists(tmp_path / "step_4" / MODEL_FILE)
    assert not os.path.exists(tmp_path / "step_3")
    assert sorted(os.listdir(tmp_path / "step_2")) == ["optimizer.bin", MODEL_FILE,
                                                        "scheduler.bin"]


def test_save_best_toggle(tmp_path):
    _run(tmp_path, n_batches=2)
    assert not os.path.exists(tmp_path / "best")
    _run(tmp_path / "b", n_batches=2, save_best=True)
    assert os.path.exists(tmp_path / "b" / "best" / MODEL_FILE)


def test_tracking_without_wandb_is_safe(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    _run(tmp_path, n_batches=1, use_wandb=True)
    assert os.path.exists(tmp_path / "summary.jsonl")


@pytest.mark.parametrize("keys,tracked", [
    (("loss_w_teacher", "val_loss"), "loss_w_teacher"), (("val_loss",), "val_loss"),
    ((), "train_loss")])
def test_best_follows_the_tracked_loss_and_epochs_save(tmp_path, monkeypatch, keys, tracked):
    """Epoch losses 3, 1, 2 of the tracked quantity: `best` is written after
    epochs 0 and 1 only; `epoch_2` after the second epoch (save_every 2)."""
    per_epoch = [3.0, 1.0, 2.0]
    val_calls = []

    def validate(state, batch, generator=None):
        val_calls.append(generator)
        v = per_epoch[state.step // 2 - 1]
        return {k: torch.tensor(v if k == tracked else -v) for k in keys}

    steps = _step_fn([v for v in per_epoch for _ in range(2)])
    saves = []
    real = loop.save_checkpoint

    def spy(directory, state, *a):
        saves.append((os.path.basename(directory), state.step))
        real(directory, state, *a)

    monkeypatch.setattr(loop, "save_checkpoint", spy)
    _run(tmp_path, n_batches=2, step_fn=steps, validate_fn=validate if keys else None,
         eval_loader=_loader(3) if keys else None, num_epochs=3, save_best=True,
         save_every=2, eval_batches=2)
    assert saves == [("best", 2), ("best", 4), ("epoch_2", 4)]
    records = _records(tmp_path)
    assert [r[tracked] for r in records] == per_epoch
    if keys:
        assert [r["validation_batches"] for r in records] == [2, 2, 2]
        assert len(val_calls) == 6
    gens = set(map(id, steps.seen + val_calls))
    assert len(gens) == 1 and isinstance(steps.seen[0], torch.Generator)


def test_non_finite_losses_stay_out_of_the_mean(tmp_path):
    _run(tmp_path, n_batches=4, step_fn=_step_fn([1.0, math.nan, 3.0, math.inf]), log_every=2)
    records = _records(tmp_path)
    assert [r.get("step") for r in records[:2]] == [2, 4]  # the log_every records
    assert records[-1]["train_loss"] == pytest.approx((1.0 + 3.0) / 4)
    assert records[-1]["steps"] == 4
    for key in ("loader_seconds", "step_seconds", "checkpoint_seconds", "epoch_seconds"):
        assert records[-1][key] >= 0
