"""The port's stage-2 validation step against the JAX package's: the four
losses at a 4-step Heun schedule (one Heun interval, the target network at
both of its ends, the teacher's rollout over the rest), same weights, batch
and draws. See tests/torch_training_common.py for the set-up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_torch.configs import SchedulerConfig
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.training import step
from tests import torch_training_common as common

LOSSES = ("loss_w_gt", "loss_w_teacher", "loss_consistency", "loss_teacher")
N_STEPS, B = 4, 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def losses():
    jp, params, frozen = common.make_jax_side()
    js = jsched.make_heun_schedule(jsched.SchedulerConfig(), N_STEPS)
    ts = sched.make_heun_schedule(SchedulerConfig(), N_STEPS)
    tx = joptim.make_optimizer(joptim.OptimizerConfig())
    batch = common.make_batch(B, seed=4)
    rng = jax.random.PRNGKey(7)
    r_enc, r_eps, r_w = jax.random.split(rng, 3)  # as the JAX validate splits
    shape = (B, *common.LATENT)
    draws = {"posterior_noise": np.asarray(jax.random.normal(r_enc, shape, jnp.float32)),
             "eps": np.asarray(jax.random.normal(r_eps, shape)),
             "w": np.asarray(jax.random.uniform(r_w, (B,)))}
    want = jax.jit(jstep.build_validation_step(jp, js))(
        jstep.TrainState.create(params, tx), frozen, batch, rng)
    port = common.make_port(params)
    got = step.build_validation_step(port, ts)(step.TrainState.create(port), batch, draws=draws)
    return got, want


def test_validation_returns_the_four_losses(losses):
    got, _ = losses
    assert sorted(got) == sorted(LOSSES)
    assert all(torch.isfinite(v) and not v.requires_grad for v in got.values())


@pytest.mark.parametrize("name", LOSSES)
def test_validation_loss_matches(losses, name):
    got, want = losses
    common.close(got[name], want[name])
