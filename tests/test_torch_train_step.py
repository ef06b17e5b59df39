"""The port's stage-2 train step against the JAX package's: two optimizer
steps, same weights, same batches, same draws. See
tests/torch_training_common.py for the set-up and the tolerances;
tests/test_torch_train_accum.py holds the step with `accum_steps=2`.
"""

import pytest
import torch

from tests import torch_training_common as common


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return common.run_stage2_steps(accum=1, n_steps=2)


@pytest.mark.parametrize("i", [0, 1], ids=["first_step", "second_step"])
def test_loss_matches(runs, i):
    got, want = runs[0][i]
    assert got["loss_finite"] and bool(want["loss_finite"])
    common.close(got["loss"], want["loss"])


def test_student_target_and_ema_match_after_two_steps(runs):
    _, state, jstate, before = runs
    common.assert_states_agree(state, jstate, before)
    assert state.step == 2


def test_learning_rate_stays_constant_and_the_schedule_counts_updates(runs):
    _, state, _, _ = runs
    assert state.optimizer.param_groups[0]["lr"] == common.LR
    assert state.lr_scheduler.last_epoch == 2
