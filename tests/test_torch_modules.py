"""The port's modules against their JAX counterparts at the tiny geometry,
fp32 on the CPU, with the JAX package's random-init weights loaded through
consistencytta_torch/io/from_jax.py: the T5 encoder, the UNet in its guided
and teacher forms, the VAE `decode_first_stage`, and the schedules.

Tolerance: 1e-4 relative to each output's scale (fp32, the same math in
another summation order through up to ~40 layers).
"""

import numpy as np
import pytest
import torch

from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
from consistencytta_torch.io import from_jax
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.text.tokenizer import HashTokenizer
from tests.tiny import cached_init_params

TEXT_LEN = 16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_side():
    jp = JaxPipeline.create(JaxPipelineConfig.tiny())
    return jp, cached_init_params(jp, text_len=TEXT_LEN)


@pytest.fixture(scope="module")
def port(jax_side):
    _, params = jax_side
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                        roles=("student", "student_target", "student_ema", "teacher"))
    from_jax.load_pipeline_params(p, params)
    return p


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=rel)


def _text():
    return HashTokenizer(vocab_size=256)(["a dog barks loudly", "rain"], TEXT_LEN)


def test_t5_encoder(jax_side, port):
    jp, params = jax_side
    ids, mask = _text()
    want = jp.encode_text(params.t5, ids, mask)
    with torch.no_grad():
        got = port.encode_text(ids, mask)
    _close(got.numpy(), want)


@pytest.mark.parametrize("role", ["student_ema", "teacher"])
def test_unet(jax_side, port, role):
    jp, params = jax_side
    rng = np.random.default_rng(0)
    cfg = PipelineConfig.tiny()
    z = rng.standard_normal((2, cfg.latent.t, cfg.latent.f, cfg.latent.c)).astype(np.float32)
    t = np.array([999.0, 412.5], np.float32)
    text = rng.standard_normal((2, TEXT_LEN, cfg.unet.cross_attention_dim)).astype(np.float32)
    mask = np.ones((2, TEXT_LEN), np.int32)
    mask[1, 5:] = 0
    g = np.array([4.0, 2.5], np.float32)
    if role == "teacher":
        want = jp.teacher_unet.apply({"params": params.teacher}, z, t, text, mask)
        args = (z, t, text, mask, None)
    else:
        want = jp.query_student(params.student_ema, z, t, text, mask, g)
        args = (z, t, text, mask, g)
    with torch.no_grad():
        got = port.unets[role](*[None if a is None else torch.from_numpy(a) for a in args])
    _close(got.numpy(), want)


def test_vae_decode_first_stage(jax_side, port):
    jp, params = jax_side
    rng = np.random.default_rng(1)
    cfg = PipelineConfig.tiny()
    z = rng.standard_normal((2, cfg.latent.t, cfg.latent.f, cfg.latent.c)).astype(np.float32)
    want = jp.vae.apply({"params": params.vae}, z, method=jp.vae.decode_first_stage)
    with torch.no_grad():
        got = port.vae.decode_first_stage(torch.from_numpy(z))
    _close(got.numpy(), want)


@pytest.mark.parametrize("steps,karras", [(18, False), (2, False), (5, True)])
def test_heun_schedule(steps, karras):
    cfg = SchedulerConfig()
    want = jsched.make_heun_schedule(jsched.SchedulerConfig(), steps, karras)
    got = sched.make_heun_schedule(cfg, steps, karras)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.sigmas, np.asarray(want.sigmas))
    assert got.init_noise_sigma == float(want.init_noise_sigma)
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    e = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    s = got.sigmas[:3]
    _close(got.scale_model_input(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
           want.scale_model_input(x, s), rel=1e-6)
    _close(got.add_noise(torch.from_numpy(x), torch.from_numpy(e), torch.from_numpy(s)).numpy(),
           want.add_noise(x, e, s), rel=1e-6)


def test_ddim_schedule():
    want = jsched.make_ddim_schedule(jsched.SchedulerConfig(), 18)
    got = sched.make_ddim_schedule(SchedulerConfig(), 18)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
    e = rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
    t = np.array([999, 3], np.int32)
    _close(got.add_noise(torch.from_numpy(x), torch.from_numpy(e), torch.from_numpy(t)).numpy(),
           want.add_noise(x, e, t), rel=1e-6)
    np.testing.assert_array_equal(got.scale_model_input(torch.from_numpy(x)).numpy(),
                                  want.scale_model_input(x))
