"""The port's stage-2 train step with gradient accumulation against the JAX
package's: one optimizer step of `accum_steps=2` micro-batches, each with
its own draws, and one EMA update. See tests/torch_training_common.py for
the set-up and the tolerances.
"""

import pytest
import torch

from consistencytta_torch.training import step
from tests import torch_training_common as common

ACCUM = 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return common.run_stage2_steps(accum=ACCUM, n_steps=1)


def test_accumulated_loss_matches(runs):
    got, want = runs[0][0]
    assert got["loss_finite"] and bool(want["loss_finite"])
    common.close(got["loss"], want["loss"])


def test_one_update_and_one_ema_step_per_optimizer_step(runs):
    _, state, jstate, before = runs
    common.assert_states_agree(state, jstate, before)
    assert state.step == 1 and state.lr_scheduler.last_epoch == 1


def test_draws_must_cover_every_micro_batch(runs):
    _, state, _, _ = runs
    with pytest.raises(ValueError, match="one per micro-batch"):
        step.accumulate_gradients(state, None, common.make_batch(4), ACCUM, None, [{}])
