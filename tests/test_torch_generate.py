"""The whole slice: the port's `build_generate_fn` against the JAX package's
`build_generate_fn(jit=False)` at the tiny geometry, fp32 on the CPU, with
the JAX random-init weights loaded into the port and JAX's own random draws
(the initial latent noise and one eps per refinement step, made with
jax.random exactly as inference/generate.py makes them) fed to the port.

Tolerance: 1e-4 relative to the waveform's scale (fp32 through T5, the
UNet, the VAE decoder and the vocoder).
"""

import jax
import numpy as np
import pytest
import torch

from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.inference.generate import (
    GenerateConfig as JaxGenerateConfig,
    build_generate_fn as jax_build_generate_fn,
)
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn
from consistencytta_torch.io.from_jax import load_pipeline_params
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
from tests.tiny import cached_init_params

TEXT_LEN = 16


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jp = JaxPipeline.create(JaxPipelineConfig.tiny())
    params = cached_init_params(jp, text_len=TEXT_LEN)
    port = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu")
    load_pipeline_params(port, params)
    text = tokenize_with_uncond(
        HashTokenizer(vocab_size=256), ["a dog barks", "rain falls on a tin roof"],
        TEXT_LEN,
    )
    return jp, params, port, text


def _jax_draws(jp, seed, b, num_steps):
    """The draws generate.py makes from `rng`, in its order."""
    rng = jax.random.PRNGKey(seed)
    rng, noise_rng = jax.random.split(rng)
    shape = jp.latent_shape(b)
    noise = np.array(jax.random.normal(noise_rng, shape, np.float32))
    eps = []
    for _ in range(1, num_steps):
        rng, step_rng = jax.random.split(rng)
        eps.append(np.array(jax.random.normal(step_rng, shape, np.float32)))
    return noise, eps


@pytest.mark.parametrize(
    "kw",
    [dict(num_steps=1), dict(num_steps=2, guidance_post=2.0, truncate_seconds=0.5)],
    ids=["1nfe", "2step_cfg_post"],
)
def test_generate_matches_jax(setup, kw):
    jp, params, port, (ids, mask, uids, umask) = setup
    seed = 3
    want = np.asarray(jax_build_generate_fn(jp, JaxGenerateConfig(**kw), jit=False)(
        params, ids, mask, uids, umask, jax.random.PRNGKey(seed), 4.0
    ))
    noise, eps = _jax_draws(jp, seed, ids.shape[0], kw["num_steps"])
    got = build_generate_fn(port, GenerateConfig(**kw))(
        ids, mask, uids, umask, 4.0,
        noise=torch.from_numpy(noise), eps=[torch.from_numpy(e) for e in eps],
    ).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_generator_draws_are_reproducible(setup):
    _, _, port, (ids, mask, uids, umask) = setup
    gen = build_generate_fn(port, GenerateConfig(decode_chunk=1))
    a = gen(ids, mask, uids, umask, 4.0, generator=torch.Generator().manual_seed(9))
    b = gen(ids, mask, uids, umask, 4.0, generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
