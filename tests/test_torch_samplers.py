"""The port's multi-step samplers against the JAX package's: the DDIM solver
step (v and epsilon) of consistencytta_torch/ops/schedulers.py, and
`build_teacher_generate_fn` and `build_guided_student_generate_fn`
(Heun and DDIM, with and without external CFG on the guided student) of
consistencytta_torch/inference/generate.py against the JAX functions with
`jit=False`, at the tiny geometry, fp32 on the CPU. The JAX random-init
weights are loaded into the port, and the port is fed JAX's own draw
`jax.random.normal(rng, latent_shape)`.

Tolerances: the DDIM step within 1e-5 of the output's scale (a handful of
float32 operations an element, the alpha-bar tables bit-equal); the
waveforms within 1e-4 of the waveform's scale (fp32 through T5, three to
four UNet queries, the VAE decoder and the vocoder).
"""

import jax
import numpy as np
import pytest
import torch

from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.inference import generate as jgen
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
from consistencytta_torch.inference import generate as gen
from consistencytta_torch.io.from_jax import load_pipeline_params
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
from tests.tiny import cached_init_params

TEXT_LEN = 16
SHAPE = (3, 4, 4, 2)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("steps", [20, 3])
def test_ddim_step_matches_jax(prediction_type, steps):
    """Every timestep of the schedule at once, so that the last step's
    previous timestep falls below 0 and takes the final alpha-bar; the
    sample, model output and snr against the JAX schedule's."""
    kw = dict(prediction_type=prediction_type)
    ts = sched.make_ddim_schedule(SchedulerConfig(**kw), steps)
    js = jsched.make_ddim_schedule(jsched.SchedulerConfig(**kw), steps)
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    assert ts.final_alpha_cumprod == js.final_alpha_cumprod
    t = np.asarray(ts.timesteps)[[0, steps // 2, steps - 1]]
    rng = np.random.default_rng(steps)
    x, out = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    got = ts.step(torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(x)).numpy()
    want = np.asarray(js.step(out, t, x))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-5)
    np.testing.assert_allclose(ts.snr(torch.from_numpy(t)).numpy(), np.asarray(js.snr(t)),
                               rtol=1e-6)


def test_ddim_step_refuses_an_unknown_prediction_type():
    ts = sched.make_ddim_schedule(SchedulerConfig(prediction_type="sample"), 4)
    with pytest.raises(ValueError, match="prediction type"):
        ts.step(torch.zeros(SHAPE), torch.tensor([750, 750, 750]), torch.zeros(SHAPE))


@pytest.fixture(scope="module")
def setup():
    jp = JaxPipeline.create(JaxPipelineConfig.tiny())
    params = cached_init_params(jp, text_len=TEXT_LEN)
    port = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                           roles=STUDENT_ROLES + ("teacher",))
    load_pipeline_params(port, params)
    text = tokenize_with_uncond(
        HashTokenizer(vocab_size=256), ["a dog barks", "rain falls on a tin roof"], TEXT_LEN)
    return jp, params, port, text


def _compare(jax_fn, port_fn, setup, seed):
    jp, params, _, (ids, mask, uids, umask) = setup
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jax_fn(params, ids, mask, uids, umask, rng, 3.0))
    noise = np.array(jax.random.normal(rng, jp.latent_shape(ids.shape[0]), np.float32))
    got = port_fn(ids, mask, uids, umask, 3.0, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


@pytest.mark.parametrize("use_edm,num_steps", [(True, 2), (False, 3)], ids=["heun", "ddim"])
def test_teacher_generate_matches_jax(setup, use_edm, num_steps):
    jp, _, port, _ = setup
    _compare(jgen.build_teacher_generate_fn(jp, num_steps, use_edm, truncate_seconds=0.5,
                                            jit=False),
             gen.build_teacher_generate_fn(port, num_steps, use_edm, truncate_seconds=0.5),
             setup, seed=4)


@pytest.mark.parametrize("use_edm,num_steps,guidance_post,use_ema", [
    (False, 3, 1.0, True), (False, 2, 2.5, False), (True, 2, 1.0, True), (True, 2, 2.5, True),
], ids=["ddim", "ddim_cfg_post_student", "heun", "heun_cfg_post"])
def test_guided_student_generate_matches_jax(setup, use_edm, num_steps, guidance_post, use_ema):
    jp, _, port, _ = setup
    kw = dict(num_steps=num_steps, guidance_post=guidance_post, use_ema=use_ema,
              use_edm=use_edm, truncate_seconds=None)
    _compare(jgen.build_guided_student_generate_fn(jp, jit=False, **kw),
             gen.build_guided_student_generate_fn(port, **kw), setup, seed=5)


def test_teacher_needs_the_teacher_role():
    port = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="teacher"):
        gen.build_teacher_generate_fn(port)
