"""The port's VAE encoder path (consistencytta_torch/nn/vae.py and
`Pipeline.encode_audio`) against the JAX package's, at the tiny geometry,
float32 on the CPU, with the JAX random-init weights loaded through
io/from_jax.py. The posterior noise is drawn with `jax.random` from the key
the JAX functions are given, and handed to the port as a tensor.

Tolerance: 1e-4 of each output's scale (float32, the same math in another
summation order through ~15 layers); the mel image that feeds the encoder
is held to its own tolerance in tests/test_torch_stft.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_tpu.nn import layers as jlayers
from consistencytta_tpu.nn import vae as jvae
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.io import from_jax
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.nn import layers, vae
from tests.tiny import cached_init_params

B = 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_side():
    jp = JaxPipeline.create(JaxPipelineConfig.tiny())
    return jp, cached_init_params(jp, text_len=16)


@pytest.fixture(scope="module")
def port(jax_side):
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu")
    from_jax.load_pipeline_params(p, jax_side[1])
    return p


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=rel)


def _mel_image(seed):
    cfg = PipelineConfig.tiny()
    shape = (B, cfg.target_mel_frames, cfg.stft.n_mel_channels, 1)
    return (np.random.default_rng(seed).standard_normal(shape) * 2.0 - 4.0).astype(np.float32)


def test_asymmetric_pad_downsample():
    x = np.random.default_rng(0).standard_normal((2, 5, 6, 3)).astype(np.float32)  # NHWC
    want = np.asarray(jlayers.asymmetric_pad_downsample(x))
    got = layers.asymmetric_pad_downsample(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_encode_moments(jax_side, port):
    jp, params = jax_side
    x = _mel_image(1)
    want = jp.vae.apply({"params": params.vae}, x, method=jp.vae.encode_moments)
    with torch.no_grad():
        got = port.vae.encode_moments(torch.from_numpy(x))
    assert got.shape == (B, 16, 16, 16) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_encode_to_latent_with_the_noise_passed_in(jax_side, port):
    jp, params = jax_side
    x = _mel_image(2)
    rng = jax.random.PRNGKey(3)
    want = jp.vae.apply({"params": params.vae}, x, rng, method=jp.vae.encode_to_latent)
    noise = np.asarray(jax.random.normal(rng, want.shape, jnp.float32))
    with torch.no_grad():
        got = port.vae.encode_to_latent(torch.from_numpy(x), noise=noise)
    assert got.shape == (B, 16, 16, 8)
    _close(got.numpy(), want)


def test_diagonal_gaussian(jax_side):
    m = np.random.default_rng(4).standard_normal((2, 4, 4, 6)).astype(np.float32) * 20.0
    want, got = jvae.DiagonalGaussian(jnp.asarray(m)), vae.DiagonalGaussian(torch.from_numpy(m))
    _close(got.mean.numpy(), want.mean, 1e-6)
    _close(got.std.numpy(), want.std, 1e-6)  # logvar clamped to [-30, 20] on both
    _close(got.kl().numpy(), want.kl(), 1e-5)
    assert got.mode() is got.mean
    a = got.sample(generator=torch.Generator().manual_seed(0))
    b = got.sample(generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, got.mean)


def test_pipeline_encode_audio_end_to_end(jax_side, port):
    jp, params = jax_side
    wav = (np.random.default_rng(5).standard_normal((B, 64 * 160)) * 0.2).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    want = jp.encode_audio(params.vae, wav, rng)
    noise = np.asarray(jax.random.normal(rng, want.shape, jnp.float32))
    got = port.encode_audio(wav, noise=noise)
    assert got.shape == port.latent_shape(B) and not got.requires_grad
    _close(got.numpy(), want)
    # without noise the generator draws it
    g = lambda: torch.Generator().manual_seed(1)
    a, b = port.encode_audio(wav, generator=g()), port.encode_audio(wav, generator=g())
    assert torch.equal(a, b) and not torch.equal(a, got)
