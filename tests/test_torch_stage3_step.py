"""One stage-3 optimizer step of the port (the stage-2 Heun step with the
CLAP loss as its `loss_fn_override`, training/clap_loss.py) against the JAX
package's (build_consistency_train_step with build_clap_loss) on the CPU in
float32: the same weights (tiny pipeline, an audible vocoder, the tiny CLAP
towers), batch and draws; the student, the target and the EMA compared
through tests/torch_training_common.py:assert_states_agree. The JAX step is
jitted once (about three minutes on one core).
"""

import jax
import numpy as np
import pytest
import torch

from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_tpu.training.clap_loss import build_clap_loss as jax_build_clap_loss
from consistencytta_torch.configs import SchedulerConfig
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.training import step
from consistencytta_torch.training.clap_loss import build_clap_loss
from tests.torch_stage3_common import CLIP_SECONDS, clap_batch, jax_configs, make_stage3_sides
from tests.torch_training_common import (
    assert_states_agree, optimizer_configs, stage2_draws, student_weights,
)

B, N_STEPS = 2, 18


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def stepped():
    jp, params, frozen, port, audio, text = make_stage3_sides()
    jcfg, tcfg = optimizer_configs()
    tx = joptim.make_optimizer(jcfg)
    ja, jt = jax_configs()
    jloss = jax_build_clap_loss(jp, htsat_config=ja, roberta_config=jt,
                                clip_seconds=CLIP_SECONDS)
    jrun = jax.jit(jstep.build_consistency_train_step(
        jp, jsched.make_heun_schedule(jsched.SchedulerConfig(), N_STEPS), tx,
        jstep.ConsistencyStepConfig(), loss_fn_override=jloss))
    batch = clap_batch(B)
    rng = jax.random.PRNGKey(10)
    jstate, jmetrics = jrun(jstep.TrainState.create(params, tx), frozen, batch, rng)
    state = step.TrainState.create(port, tcfg)
    before = student_weights(state)
    run = step.build_consistency_train_step(
        port, sched.make_heun_schedule(SchedulerConfig(), N_STEPS), step.ConsistencyStepConfig(),
        build_clap_loss(port, audio, text, clip_seconds=CLIP_SECONDS))
    metrics = run(state, batch, draws=stage2_draws(rng, B, N_STEPS))
    return state, jstate, before, metrics, jmetrics, (audio, text)


def test_loss_matches_jax(stepped):
    _, _, _, metrics, jmetrics, _ = stepped
    assert metrics["loss_finite"] and bool(jmetrics["loss_finite"])
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)


def test_states_agree_with_jax(stepped):
    state, jstate, before, _, _, _ = stepped
    assert_states_agree(state, jstate, before)


def test_towers_stay_frozen(stepped):
    for tower in stepped[5]:
        assert all(p.grad is None and not p.requires_grad for p in tower.parameters())
