"""Shared by the tests of the port's train and validation steps
(tests/test_torch_train*.py, test_torch_stage1.py, test_torch_validation.py):
the two pipelines at the tiny geometry with equal weights, a seeded batch,
the random draws of each JAX step made from its own key splits, and the
comparison of a port `TrainState` with a JAX one.

The JAX steps run under `jax.jit`, one compile per file (a minute or so each
on one core, which is why the steps are spread over several files: the test
workers take one file each). The draws are made with `jax.random` exactly as
the JAX functions split their key, and handed to the port as tensors.

Tolerances. Forward quantities (predictions, losses): 1e-4 of the output's
scale, the same float32 math in another summation order. Optimizer steps:
the tests use a constant learning rate of 1e-3, weight decay 1e-2 and an
Adam epsilon of 1e-3, far above the gradients' float32 noise, so that an
update is a smooth function of the gradient (with the default 1e-8 the first
Adam update is lr * g / |g|, which turns the rounding noise of a near-zero
gradient into a full-size step in either direction); the updated weights
then agree within 2e-3 of one learning rate per step taken, and so do the
EMA shadows.

The guidance Fourier projection is frozen in both packages, and both hand
it to AdamW with a zero gradient, whose decoupled weight decay shrinks it by
lr * weight_decay each step: it is compared like every other leaf, and its
decay is asserted besides. The tolerance of a leaf also allows two float32
roundings of its largest value (the projection's entries reach tens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_tpu.models.pipeline import PipelineParams
from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
from consistencytta_torch.io import from_jax
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.training import optim, step
from tests.tiny import cached_init_params

TEXT_LEN = 8
ROLES = (*STUDENT_ROLES, "teacher")
LR, WEIGHT_DECAY, ADAM_EPS = 1e-3, 1e-2, 1e-3
FOURIER = "guidance_proj.weight"
LATENT = (16, 16, 8)


def make_jax_side():
    """(JAX pipeline, its random-init params, the frozen subset)."""
    jp = JaxPipeline.create(JaxPipelineConfig.tiny())
    params = cached_init_params(jp, text_len=TEXT_LEN)
    frozen = PipelineParams(teacher=params.teacher, vae=params.vae,
                            vocoder=params.vocoder, t5=params.t5)
    return jp, params, frozen


def make_port(params):
    """A port pipeline with training roles, holding the JAX weights."""
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                        roles=ROLES, training=True)
    from_jax.load_pipeline_params(p, params)
    return p


def make_batch(b, seed=0):
    tok = HashTokenizer(vocab_size=256)
    ids, mask, uids, umask = tokenize_with_uncond(
        tok, [f"sound number {i}" for i in range(b)], TEXT_LEN)
    wav = np.random.default_rng(seed).standard_normal((b, 64 * 160)) * 0.1
    return {"wav": wav.astype(np.float32), "ids": ids, "mask": mask,
            "uncond_ids": uids, "uncond_mask": umask}


def stage2_draws(rng, b, n):
    """The draws of the JAX consistency_forward, from its own key splits."""
    r_enc, r_u, r_eps, r_w = jax.random.split(rng, 4)
    return {
        "posterior_noise": np.asarray(jax.random.normal(r_enc, (b, *LATENT), jnp.float32)),
        "u": np.asarray(jax.random.randint(r_u, (b,), 0, n - 1)),
        "eps": np.asarray(jax.random.normal(r_eps, (b, *LATENT))),
        "w": np.asarray(jax.random.uniform(r_w, (b,))),
    }


def close(got, want, rel=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=rel)


def optimizer_configs():
    """(JAX OptimizerConfig, port OptimizerConfig) with the tests' values."""
    common = dict(learning_rate=LR, weight_decay=WEIGHT_DECAY, adam_epsilon=ADAM_EPS,
                  lr_scheduler_type="constant")
    return joptim.OptimizerConfig(**common), optim.OptimizerConfig(**common)


def student_weights(state):
    return {k: v.clone() for k, v in state.student.state_dict().items()}


def _assert_unet(module, tree, atol):
    """Every leaf of the module against the JAX tree, none left out."""
    want = from_jax.unet_state_dict(tree, PipelineConfig.tiny().unet)
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        ulps = 2 * np.finfo(np.float32).eps * float(v.abs().max())
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol + ulps, rtol=0,
                                   err_msg=k)


def assert_states_agree(state, jstate, before):
    """The port's state after some steps against the JAX state: student and
    shadows within 2e-3 of one learning rate per step, the frozen Fourier
    weight included, which weight decay alone has moved. `before` is
    `student_weights(state)` taken before the first step."""
    steps = int(jstate.step)
    assert state.step == steps
    tol = 2e-3 * LR * steps
    _assert_unet(state.student, jstate.student, tol)
    _assert_unet(state.student_ema, jstate.student_ema, tol)
    if jstate.student_target is not None:
        _assert_unet(state.student_target, jstate.student_target, tol)
    moved = (state.student.state_dict()["conv_in.weight"] - before["conv_in.weight"]).abs().max()
    assert moved > 0.1 * LR
    decayed = before[FOURIER].numpy() * (1 - LR * WEIGHT_DECAY) ** steps
    np.testing.assert_allclose(state.student.state_dict()[FOURIER].numpy(), decayed, rtol=1e-6)
    assert not torch.equal(state.student.state_dict()[FOURIER], before[FOURIER])


def run_stage2_steps(accum: int, n_steps: int, micro: int = 2, heun_steps: int = 18,
                     use_edm: bool = True):
    """`n_steps` stage-2 optimizer steps of `accum` micro-batches on both
    sides, from equal weights, with the same batches and draws, along Heun
    intervals (`use_edm`) or DDIM steps of a `heun_steps`-step schedule.
    Returns ([(port metrics, JAX metrics)], port state, JAX state, the
    student's weights before the first step)."""
    jp, params, frozen = make_jax_side()
    jcfg, tcfg = optimizer_configs()
    if use_edm:
        js = jsched.make_heun_schedule(jsched.SchedulerConfig(), heun_steps)
        ts = sched.make_heun_schedule(SchedulerConfig(), heun_steps)
    else:
        js = jsched.make_ddim_schedule(jsched.SchedulerConfig(), heun_steps)
        ts = sched.make_ddim_schedule(SchedulerConfig(), heun_steps)
    tx = joptim.make_optimizer(jcfg)
    jstate = jstep.TrainState.create(params, tx)
    jrun = jax.jit(jstep.build_consistency_train_step(
        jp, js, tx, jstep.ConsistencyStepConfig(accum_steps=accum, use_edm=use_edm)))
    port = make_port(params)
    state = step.TrainState.create(port, tcfg)
    run = step.build_consistency_train_step(
        port, ts, step.ConsistencyStepConfig(accum_steps=accum, use_edm=use_edm))
    before = student_weights(state)
    metrics = []
    for i in range(n_steps):
        batch = make_batch(accum * micro, seed=i)
        rng = jax.random.PRNGKey(10 + i)
        if accum == 1:
            draws = stage2_draws(rng, micro, heun_steps)
        else:  # the JAX step splits its key into one per micro-batch
            draws = [stage2_draws(r, micro, heun_steps) for r in jax.random.split(rng, accum)]
        jstate, jm = jrun(jstate, frozen, batch, rng)
        metrics.append((run(state, batch, draws=draws), jm))
    return metrics, state, jstate, before
