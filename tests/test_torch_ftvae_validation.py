"""The port's FTVAE validation (training/ftvae.py:build_ftvae_validation_step)
against the JAX package's on the CPU in float32: the four stage-2 losses and
`loss_decoder_mel`, with the same weights, batch and draws, on a state whose
decoder copy differs from the frozen VAE (as it does after training). The
JAX validation is jitted once (about a minute and a half on one core).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.training import ftvae as jftvae
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_torch.configs import SchedulerConfig
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.training import ftvae
from consistencytta_torch.training import step as tstep
from tests.torch_stage3_common import clap_batch, make_stage3_sides
from tests.torch_training_common import LATENT, optimizer_configs

B, N_STEPS = 2, 4
LOSSES = ("loss_w_gt", "loss_w_teacher", "loss_consistency", "loss_teacher", "loss_decoder_mel")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def losses():
    jp, params, frozen, port, _, _ = make_stage3_sides()
    jcfg, tcfg = optimizer_configs()
    jstate = jftvae.FTVAETrainState.create(params, joptim.make_optimizer(jcfg))
    jstate.vae_dec = jax.tree_util.tree_map(lambda a: a * 1.01, jstate.vae_dec)
    state = ftvae.FTVAETrainState.create(port, tcfg)
    with torch.no_grad():
        for q in state.vae_dec.parameters():
            q.mul_(1.01)
    batch = clap_batch(B, seed=4)
    rng = jax.random.PRNGKey(7)
    validate = jax.jit(jftvae.build_ftvae_validation_step(
        jp, jsched.make_heun_schedule(jsched.SchedulerConfig(), N_STEPS),
        jstep.ConsistencyStepConfig()))
    want = validate(jstate, frozen, batch, rng)
    r_enc, r_eps, r_w = jax.random.split(rng, 3)  # as the JAX validate splits
    draws = {"posterior_noise": np.asarray(jax.random.normal(r_enc, (B, *LATENT), jnp.float32)),
             "eps": np.asarray(jax.random.normal(r_eps, (B, *LATENT))),
             "w": np.asarray(jax.random.uniform(r_w, (B,)))}
    got = ftvae.build_ftvae_validation_step(
        port, sched.make_heun_schedule(SchedulerConfig(), N_STEPS),
        tstep.ConsistencyStepConfig())(state, batch, draws=draws)
    return got, want


def test_validation_returns_the_five_losses(losses):
    got, want = losses
    assert sorted(got) == sorted(want) == sorted(LOSSES)
    assert all(torch.isfinite(v) and not v.requires_grad for v in got.values())


@pytest.mark.parametrize("name", LOSSES)
def test_validation_loss_matches(losses, name):
    got, want = losses
    np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4, atol=0)
