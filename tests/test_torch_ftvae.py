"""One FTVAE step of the port (training/ftvae.py: the CLAP loss decoded
through a trainable float32 copy of the VAE decoder pair, one AdamW over the
student and the pair, the pair's EMA) against the JAX package's
build_ftvae_train_step on the CPU in float32: the same weights (tiny
pipeline, an audible vocoder, the tiny CLAP towers), batch and draws. The
student, the target and the EMA through
tests/torch_training_common.py:assert_states_agree; the decoder pair and its
EMA leaf by leaf with the same tolerance. The JAX step is jitted once
(about three and a half minutes on one core).
"""

import jax
import numpy as np
import pytest
import torch

from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.training import ftvae as jftvae
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
from consistencytta_torch.io import from_jax
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.training import ftvae, step
from consistencytta_torch.training.clap_loss import build_clap_loss
from tests.torch_stage3_common import CLIP_SECONDS, clap_batch, jax_configs, make_stage3_sides
from tests.torch_training_common import (
    LR, assert_states_agree, optimizer_configs, stage2_draws, student_weights,
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
    jrun = jax.jit(jftvae.build_ftvae_train_step(
        jp, jsched.make_heun_schedule(jsched.SchedulerConfig(), N_STEPS), tx,
        jstep.ConsistencyStepConfig(), htsat_config=ja, roberta_config=jt,
        clip_seconds=CLIP_SECONDS))
    batch = clap_batch(B)
    rng = jax.random.PRNGKey(10)
    jstate, jmetrics = jrun(jftvae.FTVAETrainState.create(params, tx), frozen, batch, rng)
    state = ftvae.FTVAETrainState.create(port, tcfg)
    before = student_weights(state)
    dec_before = {k: v.clone() for k, v in state.vae_dec.state_dict().items()}
    vae_before = {k: v.clone() for k, v in port.vae.state_dict().items()}
    run = ftvae.build_ftvae_train_step(
        port, sched.make_heun_schedule(SchedulerConfig(), N_STEPS), step.ConsistencyStepConfig(),
        build_clap_loss(port, audio, text, clip_seconds=CLIP_SECONDS))
    metrics = run(state, batch, draws=stage2_draws(rng, B, N_STEPS))
    return state, jstate, before, metrics, jmetrics, dec_before, vae_before, port


def test_loss_matches_jax(stepped):
    metrics, jmetrics = stepped[3], stepped[4]
    assert metrics["loss_finite"] and bool(jmetrics["loss_finite"])
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)


def test_student_roles_agree_with_jax(stepped):
    state, jstate, before = stepped[:3]
    assert_states_agree(state, jstate, before)


@pytest.mark.parametrize("which", ["vae_dec", "vae_dec_ema"])
def test_decoder_pair_agrees_with_jax(stepped, which):
    """Every leaf of the pair (and of its EMA) within 2e-3 of one learning
    rate plus two float32 roundings of its largest value."""
    state, jstate = stepped[:2]
    want = from_jax.vae_decoder_state_dict(getattr(jstate, which), PipelineConfig.tiny().vae)
    got = getattr(state, which).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        ulps = 2 * np.finfo(np.float32).eps * float(v.abs().max())
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-3 * LR + ulps, rtol=0,
                                   err_msg=f"{which}.{k}")


def test_decoder_trained_and_frozen_vae_untouched(stepped):
    state, dec_before, vae_before, port = stepped[0], stepped[5], stepped[6], stepped[7]
    after = state.vae_dec.state_dict()
    moved = max(float((after[k] - v).abs().max()) for k, v in dec_before.items())
    assert moved > 0.1 * LR
    # the EMA moved by (1 - 0.999) of the step
    ema = state.vae_dec_ema.state_dict()
    for k, v in dec_before.items():
        torch.testing.assert_close(ema[k], torch.lerp(v, after[k], 1 - 0.999), rtol=0,
                                   atol=4 * float(np.finfo(np.float32).eps) * float(v.abs().max()))
    # the frozen VAE, which the encoder and the other losses read, is as it was
    for k, v in port.vae.state_dict().items():
        assert torch.equal(v, vae_before[k]), k
    assert all(p.grad is None for p in port.vae.parameters())


def test_one_optimizer_holds_both(stepped):
    state = stepped[0]
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert {id(p) for p in state.vae_dec.parameters()} <= held
    assert {id(p) for p in state.student.parameters()} <= held
    assert not {id(p) for p in state.vae_dec_ema.parameters()} & held
