"""The port's mel frontend (consistencytta_torch/ops/stft.py, ops/mel.py)
against the JAX package's, float32 on the CPU, inputs from a numpy seed.

Tolerances: the plain STFT magnitude and the JAX plain path each within
TOL_MAX = 1e-5 of the largest magnitude of a float64 oracle and of each
other (two float32 products of 1024 terms in different orders sit near 1e-6
of it; a single TF32 pass near 1e-4); against the Pallas kernel in interpret
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

TOL_MAX = 1e-5  # largest error allowed, as a share of the largest magnitude


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


def _oracle(wav, cos_b, sin_b):
    """The same frames times the same float32 basis, in float64."""
    padded = np.pad(wav.astype(np.float64), ((0, 0), (512, 512)), mode="reflect")
    n_frames = (padded.shape[1] - 1024) // 160 + 1
    frames = padded[:, np.arange(n_frames)[:, None] * 160 + np.arange(1024)[None]]
    spec = frames @ np.concatenate([cos_b, sin_b], axis=1).astype(np.float64)
    return np.sqrt(spec[..., :513] ** 2 + spec[..., 513:] ** 2), frames


def _tf32(a):
    """float32 values rounded to TF32's 10 mantissa bits (nearest)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_plain_magnitude_matches_jax_plain(frontends):
    """Each side against a float64 oracle of the same frames times the same
    basis, then against each other, within TOL_MAX of the largest magnitude
    (both sit near 1e-6 of it: two float32 sums of 1024 terms); so a failure
    names the side that drifted. A single TF32 pass (1e-4 of it) fails."""
    jf, tf = frontends
    wav = _wav(0, 2, 32000)
    want = np.asarray(jstft.stft_magnitude(wav, jf.cos_basis, jf.sin_basis,
                                           hop_length=160, center_pad=512))
    got = tf.magnitude(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 201, 513)
    cos_b, sin_b = np.asarray(jf.cos_basis), np.asarray(jf.sin_basis)
    oracle, frames = _oracle(wav, cos_b, sin_b)
    tol = TOL_MAX * oracle.max()
    assert np.abs(got - oracle).max() <= tol, "the port's magnitude drifted"
    assert np.abs(want - oracle).max() <= tol, "the JAX package's magnitude drifted"
    assert np.abs(got - want).max() <= tol
    spec = _tf32(frames).astype(np.float64) @ _tf32(np.concatenate([cos_b, sin_b], 1))
    single_tf32 = np.sqrt(spec[..., :513] ** 2 + spec[..., 513:] ** 2)
    assert np.abs(single_tf32 - oracle).max() > tol


def test_plain_magnitude_holds_float32_under_lowered_matmul_precision(frontends):
    """A caller that lowers torch's float32 matmul precision on the CPU
    (oneDNN's "bf16": bf16 passes on a CPU with bf16 matrix units) does not
    lower the frontend's product, and gets its setting back."""
    _, tf = frontends
    wav = _wav(10, 1, 16000)
    oracle, _ = _oracle(wav, tf.cos_basis.numpy(), tf.sin_basis.numpy())
    onednn = getattr(torch.backends.mkldnn, "matmul", None)
    prev = getattr(onednn, "fp32_precision", None)
    if prev is not None:
        onednn.fp32_precision = "bf16"
    try:
        got = tf.magnitude(torch.from_numpy(wav)).numpy()
        if prev is not None:
            assert onednn.fp32_precision == "bf16"
    finally:
        if prev is not None:
            onednn.fp32_precision = prev
    assert np.abs(got - oracle).max() <= TOL_MAX * oracle.max()


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


@pytest.mark.parametrize("filter_length,win_length", [(1024, 1024), (1024, 800)],
                         ids=["config", "padded_window"])
def test_windowed_basis_is_window_times_dft(filter_length, win_length):
    """K4 rests on it: the frontend's windowed basis is the padded window
    times the DFT (to float32 rounding, 1e-7 on values up to 1), and its
    bin-0 cos column is the window exactly."""
    cos_b, sin_b = mel.real_dft_basis(filter_length, win_length)
    w = mel.pad_center(mel.hann_window(win_length, dtype=np.float64), filter_length)
    n = np.arange(filter_length)[:, None]
    k = np.arange(filter_length // 2 + 1)[None, :]
    ang = 2 * np.pi * n * k / filter_length
    np.testing.assert_allclose(cos_b, w[:, None] * np.cos(ang), rtol=0, atol=1e-7)
    np.testing.assert_allclose(sin_b, -w[:, None] * np.sin(ang), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(cos_b[:, 0], w.astype(np.float32))


def test_twiddle_table_within_one_ulp():
    """The kernel's float32 twiddles are the float64 values rounded once:
    within one float32 ulp of exp(-2 pi i e / M)."""
    tw = stft.fft_twiddles()
    assert tw.shape == (32 * 32 + 16, 2) and tw.dtype == np.float32
    k2, n1 = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    exact = np.exp(-2j * np.pi * np.concatenate([(n1 * k2).ravel() / 1024, np.arange(16) / 32]))
    for got, want in ((tw[:, 0], exact.real), (tw[:, 1], exact.imag)):
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


def _bitrev5(x):
    return int(f"{x:05b}"[::-1], 2)


def _fft32(v, tw32):
    """csrc/stft.cu:fft32 in numpy: radix-2 DIF, bin k at index bitrev5(k)."""
    v = v.copy()
    half = 16
    while half:
        for base in range(0, 32, 2 * half):
            j = np.arange(half)
            a, b = base + j, base + j + half
            e = j * (16 // half)
            u, w = v[..., a] + v[..., b], v[..., a] - v[..., b]
            v[..., a] = u
            v[..., b] = np.where(e == 0, w, np.where(e == 8, -1j * w, w * tw32[e % 16]))
        half //= 2
    return v


@pytest.mark.parametrize("samples", [2000, 2160], ids=["odd_frames", "even_frames"])
def test_fft_kernel_algorithm_is_the_dft(frontends, samples):
    """The kernel's arithmetic, step for step in float64 with its float32
    twiddle table: two frames as one complex sequence, the 32 x 32 four-step
    FFT with the transposed exchange, the bins of lane k2 in registers
    bitrev5(k1), each bin's partner N - k fetched from lane (32 - k2) % 32,
    and the two spectra separated by conjugate symmetry. It equals the plain
    version's magnitude (1e-6 of the largest: the plain version is float32)."""
    _, tf = frontends
    wav = _wav(9, 1, samples)
    tw = stft.fft_twiddles().astype(np.float64)
    twc = tw[:, 0] + 1j * tw[:, 1]
    step, tw32 = twc[:1024].reshape(32, 32), twc[1024:]
    padded = np.pad(wav[0].astype(np.float64), (512, 512), mode="reflect")
    window = tf.window.numpy().astype(np.float64)
    n_frames = (samples + 1024 - 1024) // 160 + 1
    frames = np.stack([padded[f * 160:f * 160 + 1024] * window for f in range(n_frames)]
                      + [np.zeros(1024)] * (n_frames % 2))
    z = frames[0::2] + 1j * frames[1::2]  # [pairs, 1024]
    y = _fft32(z.reshape(-1, 32, 32).transpose(0, 2, 1), tw32)  # lane n1: samples n1 + 32 n2
    bins = [_bitrev5(k2) for k2 in range(32)]
    x = y[..., bins] * step.T  # [pair, n1, k2] times W_1024^(n1 k2)
    regs = _fft32(x.transpose(0, 2, 1), tw32)  # lane k2, register bitrev5(k1)
    got = np.zeros((len(z) * 2, 513))
    for k1 in range(17):
        for lane in range(32 if k1 < 16 else 1):
            partner = (32 - lane) % 32
            give = _bitrev5((32 - k1) % 32) if partner == 0 else _bitrev5(31 - k1)
            zk, pk = regs[:, lane, _bitrev5(k1)], regs[:, partner, give]
            k = lane + 32 * k1
            got[0::2, k] = 0.5 * np.abs((zk.real + pk.real) + 1j * (zk.imag - pk.imag))
            got[1::2, k] = 0.5 * np.abs((zk.imag + pk.imag) + 1j * (zk.real - pk.real))
    want = tf.magnitude(torch.from_numpy(wav))[0].numpy()
    assert got[:n_frames].shape == want.shape
    np.testing.assert_allclose(got[:n_frames], want, rtol=0, atol=1e-6 * want.max())


def test_kernel_wrapper_refuses_what_it_does_not_take(frontends):
    """These checks come before the kernel is built, so they run without a
    card: no gradient, float32 only, a 512- or 1024-point filter with its
    N / 2 + 1 bins, a window padded to the filter, a span of frames that
    fits a block."""
    _, tf = frontends
    wav = torch.zeros(1, 4000)
    with pytest.raises(RuntimeError, match="no gradient"):
        stft.stft_magnitude_cuda(wav.clone().requires_grad_(), tf.cos_basis, tf.sin_basis, 160, 512)
    with pytest.raises(TypeError):
        stft.stft_magnitude_cuda(wav.double(), tf.cos_basis, tf.sin_basis, 160, 512)
    cos_768, sin_768 = (torch.from_numpy(b) for b in mel.real_dft_basis(768, 768))
    with pytest.raises(ValueError, match="filter of 512 or 1024"):
        stft.stft_magnitude_cuda(wav, cos_768, sin_768, 160, 384)
    with pytest.raises(ValueError, match="filter of 512 or 1024"):
        stft.stft_magnitude_cuda(wav, tf.cos_basis[:, :400].contiguous(),
                                 tf.sin_basis[:, :400].contiguous(), 160, 512)
    with pytest.raises(ValueError, match="window"):
        stft.stft_magnitude_cuda(wav, tf.cos_basis, tf.sin_basis, 160, 512, torch.ones(1100))
    with pytest.raises(ValueError, match="shared memory"):
        stft.stft_magnitude_cuda(torch.zeros(1, 100000), tf.cos_basis, tf.sin_basis, 4000, 512)
    with pytest.raises(ValueError, match="reflect"):
        stft.stft_magnitude_cuda(torch.zeros(1, 512), tf.cos_basis, tf.sin_basis, 160, 512)
    assert stft.stft_magnitude_cuda.launches == 0
