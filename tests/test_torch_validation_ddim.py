"""The port's DDIM validation against the JAX package's
(`_build_ddim_validation_step`): the four losses at a 4-step DDIM schedule
(pure noise at t_0, one teacher DDIM step for the target network's pair,
the teacher's rollout over the remaining timesteps), same weights, batch
and draws. See tests/torch_training_common.py for the set-up and the
tolerances.
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


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def validation():
    n, b = 4, 2
    jp, params, frozen = common.make_jax_side()
    js = jsched.make_ddim_schedule(jsched.SchedulerConfig(), n)
    ts = sched.make_ddim_schedule(SchedulerConfig(), n)
    tx = joptim.make_optimizer(joptim.OptimizerConfig())
    batch = common.make_batch(b, seed=4)
    rng = jax.random.PRNGKey(7)
    r_enc, r_eps, r_w = jax.random.split(rng, 3)  # as the JAX validate splits
    shape = (b, *common.LATENT)
    draws = {"posterior_noise": np.asarray(jax.random.normal(r_enc, shape, jnp.float32)),
             "eps": np.asarray(jax.random.normal(r_eps, shape)),
             "w": np.asarray(jax.random.uniform(r_w, (b,)))}
    cfg = jstep.ConsistencyStepConfig(use_edm=False)
    want = jax.jit(jstep.build_validation_step(jp, js, cfg))(
        jstep.TrainState.create(params, tx), frozen, batch, rng)
    port = common.make_port(params)
    validate = step.build_validation_step(port, ts, step.ConsistencyStepConfig(use_edm=False))
    return validate(step.TrainState.create(port), batch, draws=draws), want


@pytest.mark.parametrize("name", LOSSES)
def test_ddim_validation_loss_matches(validation, name):
    got, want = validation
    assert sorted(got) == sorted(LOSSES)
    assert torch.isfinite(got[name]) and not got[name].requires_grad
    common.close(got[name], want[name])
