"""The DDIM branch of the port's stage-2 train step against the JAX
package's: two optimizer steps along DDIM steps of an 18-step schedule
(losses, then student, target and EMA), same weights, batches and draws.
See tests/torch_training_common.py for the set-up and the tolerances;
tests/test_torch_validation_ddim.py holds the DDIM validation (one JAX
compile a file, so that the test workers take them in parallel).
"""

import jax
import pytest
import torch

from consistencytta_torch.configs import SchedulerConfig
from consistencytta_torch.ops import schedulers as sched
from tests import torch_training_common as common


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return common.run_stage2_steps(accum=1, n_steps=2, use_edm=False)


@pytest.mark.parametrize("i", [0, 1], ids=["first_step", "second_step"])
def test_ddim_loss_matches(runs, i):
    got, want = runs[0][i]
    assert got["loss_finite"] and bool(want["loss_finite"])
    common.close(got["loss"], want["loss"])


def test_ddim_student_target_and_ema_match_after_two_steps(runs):
    _, state, jstate, before = runs
    common.assert_states_agree(state, jstate, before)


def test_ddim_draws_reach_the_last_interval():
    """u spans 0 .. n - 2 (t_next == 0 at u = n - 2, where the target is the
    ground truth), and u = 0 starts from pure noise."""
    ts = sched.make_ddim_schedule(SchedulerConfig(), 18)
    assert ts.timesteps[-1] == 0 and len(ts.timesteps) == 18
    draws = common.stage2_draws(jax.random.PRNGKey(3), 64, 18)
    assert draws["u"].min() == 0 and draws["u"].max() == 16
