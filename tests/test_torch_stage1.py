"""The port's stage-1 (guided distillation) loss, train step and validation
step against the JAX package's: one optimizer step, same weights, batch and
draws. See tests/torch_training_common.py for the set-up and the tolerances.
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

B = 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def stage1_draws(rng, b):
    """The draws of the JAX guided_distill_loss, from its own key splits."""
    r_enc, r_t, r_eps, r_w = jax.random.split(rng, 4)
    shape = (b, *common.LATENT)
    return {"posterior_noise": np.asarray(jax.random.normal(r_enc, shape, jnp.float32)),
            "t": np.asarray(jax.random.randint(r_t, (b,), 0, 1000)),
            "eps": np.asarray(jax.random.normal(r_eps, shape)),
            "w": np.asarray(jax.random.uniform(r_w, (b,)))}


@pytest.fixture(scope="module")
def run():
    jp, params, frozen = common.make_jax_side()
    jcfg, tcfg = common.optimizer_configs()
    js = jsched.make_ddpm_schedule(jsched.SchedulerConfig())
    ts = sched.make_ddpm_schedule(SchedulerConfig())
    port = common.make_port(params)
    batch = common.make_batch(B, seed=8)
    rng = jax.random.PRNGKey(11)
    draws = stage1_draws(rng, B)
    with torch.no_grad():
        loss_alone = step.guided_distill_loss(port, ts, step.GuidedStepConfig(),
                                              port.unets["student"], batch, draws=draws)
    tx = joptim.make_optimizer(jcfg)
    jstate = jstep.TrainState.create(params, tx, with_target=False)
    state = step.TrainState.create(port, tcfg, with_target=False)
    before = common.student_weights(state)
    target_before = port.unets["student_target"].state_dict()["conv_in.weight"].clone()
    jstate, jmetrics = jax.jit(jstep.build_guided_train_step(jp, js, tx))(
        jstate, frozen, batch, rng)
    metrics = step.build_guided_train_step(port, ts)(state, batch, draws=draws)
    return dict(port=port, ts=ts, batch=batch, draws=draws, loss_alone=loss_alone,
                state=state, jstate=jstate, metrics=metrics, jmetrics=jmetrics,
                before=before, target_before=target_before)


def test_guided_distill_loss_matches(run):
    """The JAX step's loss is guided_distill_loss at the weights before the
    update; so is the port's, from the function alone and from its step."""
    common.close(run["loss_alone"], run["jmetrics"]["loss"])
    common.close(run["metrics"]["loss"], run["jmetrics"]["loss"])
    assert run["metrics"]["loss_finite"]


def test_stage1_step_matches(run):
    common.assert_states_agree(run["state"], run["jstate"], run["before"])
    # stage 1 has no target network: the pipeline's is left alone
    assert run["state"].student_target is None
    assert torch.equal(run["port"].unets["student_target"].state_dict()["conv_in.weight"],
                       run["target_before"])


def test_stage1_validation_and_last_timestep(run):
    port, ts, batch = run["port"], run["ts"], run["batch"]
    val = step.build_guided_validation_step(port, ts)(run["state"], batch, draws=run["draws"])
    assert torch.isfinite(val["val_loss"]) and not val["val_loss"].requires_grad
    # t = N - 1 resamples to pure noise: the loss no longer depends on z0
    last = dict(run["draws"], t=np.array([999, 999]))
    other = dict(batch, wav=common.make_batch(B, seed=9)["wav"])
    cfg, student = step.GuidedStepConfig(), port.unets["student"]
    with torch.no_grad():
        a = step.guided_distill_loss(port, ts, cfg, student, batch, draws=last)
        b = step.guided_distill_loss(port, ts, cfg, student, other, draws=last)
    assert torch.isfinite(a) and torch.equal(a, b)
