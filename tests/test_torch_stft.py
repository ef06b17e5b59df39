"""The port's mel frontend (consistencytta_torch/ops/stft.py, ops/mel.py)
against the JAX package's, float32 on the CPU, inputs from a numpy seed.

Tolerances: the plain STFT magnitude against the JAX plain path within
2e-4 absolute + 1e-4 relative (two float32 products of 1024 terms in
different orders, outputs up to ~25); against the Pallas kernel in interpret
mode within that kernel's own test tolerance (atol 2e-3, rtol 1e-4: its
bf16x3 split drops one cross term); the log-mel within 2e-3 absolute, and
the log-magnitude within 2e-3 plus the magnitude's own 2e-4 divided by the
magnitude (the log amplifies float32 noise on bins near the 1e-5 floor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.configs import STFTConfig as JaxSTFTConfig
from consistencytta_tpu.ops import mel as jmel
from consistencytta_tpu.ops import stft as jstft
from consistencytta_torch.configs import STFTConfig
from consistencytta_torch.ops import mel, stft


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def frontends():
    return jstft.MelFrontend(JaxSTFTConfig(), use_pallas=False), stft.MelFrontend(STFTConfig(), device="cpu")


def _wav(seed, b, t, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((b, t)) * scale).astype(np.float32)


def test_builders_match():
    np.testing.assert_array_equal(mel.mel_filterbank(16000, 1024, 64, 0.0, 8000.0),
                                  jmel.mel_filterbank(16000, 1024, 64, 0.0, 8000.0))
    for got, want in zip(mel.real_dft_basis(1024, 1024), jmel.real_dft_basis(1024, 1024)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mel.pad_center(mel.hann_window(800), 1024),
                                  jmel.pad_center(jmel.hann_window(800), 1024))


def test_plain_magnitude_matches_jax_plain(frontends):
    jf, tf = frontends
    wav = _wav(0, 2, 32000)
    want = np.asarray(jstft.stft_magnitude(wav, jf.cos_basis, jf.sin_basis,
                                           hop_length=160, center_pad=512))
    got = tf.magnitude(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 201, 513)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_plain_magnitude_matches_pallas_kernel_in_interpret_mode(frontends):
    from jax.experimental.pallas import tpu as pltpu

    from consistencytta_tpu.ops import pallas_stft

    jf, tf = frontends
    wav = _wav(1, 2, 32000)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_stft.stft_magnitude_pallas(
            wav, jf.cos_basis, jf.sin_basis, hop_length=160, center_pad=512))
    got = tf.magnitude(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)


def test_torch_stft_computes_the_same_function(frontends):
    """The library call timed beside K4 on the card: periodic Hann window,
    centred, reflect padding, magnitude."""
    _, tf = frontends
    wav = torch.from_numpy(_wav(2, 2, 16000))
    lib = torch.stft(wav, 1024, 160, 1024, torch.hann_window(1024, periodic=True),
                     center=True, pad_mode="reflect", return_complex=True).abs()
    got = tf.magnitude(wav)
    np.testing.assert_allclose(got.numpy(), lib.transpose(1, 2).numpy(), atol=2e-4, rtol=1e-4)


def test_log_mel_matches_jax(frontends):
    jf, tf = frontends
    wav = _wav(3, 2, 16000, scale=0.5)  # some samples clip at +-1
    wav[0, 5] = np.nan  # sanitised to 0 by both
    want_mel, want_mag = (np.asarray(a) for a in jf(wav))
    got_mel, got_mag = (a.numpy() for a in tf(torch.from_numpy(wav)))
    assert got_mel.shape == want_mel.shape == (2, 101, 64)
    np.testing.assert_allclose(got_mel, want_mel, atol=2e-3, rtol=0)
    # a magnitude m with float32 error dm has a log with error dm / m: the
    # 2e-4 of the magnitude test, divided by the magnitude, beside the 2e-3
    assert (np.abs(got_mag - want_mag) <= 2e-3 + 2e-4 / np.exp(want_mag)).all()


@pytest.mark.parametrize("samples,frames", [(32000, 201), (170000, 1063)],
                         ids=["shorter_than_1024_frames", "longer_than_1024_frames"])
def test_wav_to_mel_image_matches_jax(frontends, samples, frames):
    jf, tf = frontends
    wav = _wav(4, 1, samples)
    assert samples // 160 + 1 == frames
    want = np.asarray(jf.wav_to_mel_image(wav))
    got = tf.wav_to_mel_image(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 1024, 64, 1)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    if frames < 1024:
        assert not got[:, frames:].any()  # zero padding past the clip


def test_to_fixed_drops_an_odd_mel_channel(frontends):
    jf, tf = frontends
    m = np.random.default_rng(5).standard_normal((2, 10, 65)).astype(np.float32)
    np.testing.assert_array_equal(tf.to_fixed(torch.from_numpy(m), 16).numpy(),
                                  np.asarray(jf.to_fixed(m, 16)))


def test_stft_power_gradient_matches_jax_custom_vjp(frontends):
    """Autograd through `unfold` is the overlap-add that the JAX package
    writes by hand. Tolerance 1e-4 of the gradient's scale."""
    jf, tf = frontends
    wav = _wav(6, 2, 4000)
    weight = np.random.default_rng(7).standard_normal((2, 26, 513)).astype(np.float32)

    def jloss(w):
        p = jstft.stft_power(w, jf.cos_basis, jf.sin_basis, hop_length=160, center_pad=512)
        return jnp.sum(p * weight)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(wav)))
    w = torch.from_numpy(wav).requires_grad_()
    p = stft.stft_power(w, tf.cos_basis, tf.sin_basis, 160, 512)
    (p * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_clip_shorter_than_the_padding_raises(frontends):
    _, tf = frontends
    with pytest.raises(ValueError, match="reflect"):
        tf.magnitude(torch.zeros(1, 512))
    assert tf.magnitude(torch.zeros(1, 513)).shape == (1, 4, 513)


def test_pack_basis_is_the_kernel_tile_order(frontends):
    """packed[bin tile][k // 8][column][slot(k % 8)] is basis[k, bin], with
    the cos columns of a tile's 64 bins first and their sin columns after,
    samples of a group of 8 ordered k0 k4 k1 k5 k2 k6 k3 k7, zeros past the
    last bin."""
    _, tf = frontends
    packed = stft.pack_basis(tf.cos_basis, tf.sin_basis)
    assert packed.shape == (9, 128, 128, 8) and packed.is_contiguous()
    slot = lambda j: 2 * j if j < 4 else 2 * (j - 4) + 1
    rng = np.random.default_rng(8)
    for k, b in zip(rng.integers(0, 1024, 500), rng.integers(0, 513, 500)):
        tile, col = divmod(int(b), 64)
        assert packed[tile, k // 8, col, slot(k % 8)] == tf.cos_basis[k, b]
        assert packed[tile, k // 8, 64 + col, slot(k % 8)] == tf.sin_basis[k, b]
    assert not packed[8, :, 1:64].any() and not packed[8, :, 65:].any()  # bins 513..575
    assert packed.abs().sum() == tf.cos_basis.abs().sum() + tf.sin_basis.abs().sum()


def test_kernel_wrapper_refuses_what_it_does_not_take(frontends):
    """These checks come before the kernel is built, so they run without a
    card: no gradient, float32 only."""
    _, tf = frontends
    wav = torch.zeros(1, 4000)
    with pytest.raises(RuntimeError, match="no gradient"):
        stft.stft_magnitude_cuda(wav.clone().requires_grad_(), tf.cos_basis, tf.sin_basis, 160, 512)
    with pytest.raises(TypeError):
        stft.stft_magnitude_cuda(wav.double(), tf.cos_basis, tf.sin_basis, 160, 512)
    with pytest.raises(ValueError, match="hop"):
        stft.stft_magnitude_cuda(wav, tf.cos_basis, tf.sin_basis, 150, 512)
    assert stft.stft_magnitude_cuda.launches == 0
