"""The port's evaluation mels and audio IO against the JAX package's, on the
CPU, inputs from a numpy seed: the 512-point eval frontend (kernel K4's
plain version, and K4's 32 x 16 FFT modelled step for step), the batched
`normalized_logmel` against the JAX per-file result, `load_wav_16k`,
`resample_numpy`, and wav files written and read by both packages.

Tolerances: the plain 512-point magnitude within 1e-5 of the largest
magnitude of a float64 oracle and of the JAX plain path (as at N = 1024 in
tests/test_torch_stft.py); the kernel's arithmetic within 1e-6 of it; the
normalised mels within 2e-4 absolute (the log amplifies float32 noise on
bins far below the largest: tests/test_torch_stft.py's 2e-3 on the natural
log, times 20 / (100 ln 10)); the resampler within 1e-6 of the signal's
scale (float32 sums of ~400 products in another order); files, decimation,
DC removal and padding bit for bit.
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from consistencytta_tpu.evaluation import harness as jharness
from consistencytta_tpu.io import audio as jaudio
from consistencytta_tpu.ops import resample as jresample
from consistencytta_tpu.ops import stft as jstft
from consistencytta_torch.evaluation import mels
from consistencytta_torch.io import audio
from consistencytta_torch.ops import resample, stft

N, HOP, PAD = 512, 160, 256
TOL_MAX = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def frontend():
    return mels.eval_mel_frontend("cpu")


def _clip(seed, t, sr=16000):
    """A tone, its octave and noise, peak under 0.5."""
    rng = np.random.default_rng(seed)
    f0 = 110.0 * 2 ** (4 * rng.random())
    n = np.arange(t) / sr
    wav = 0.25 * np.sin(2 * np.pi * f0 * n) + 0.1 * np.sin(4 * np.pi * f0 * n) \
        + 0.05 * rng.standard_normal(t)
    return wav.astype(np.float32)


def _oracle(wav, cos_b, sin_b):
    padded = np.pad(wav.astype(np.float64), ((0, 0), (PAD, PAD)), mode="reflect")
    n_frames = (padded.shape[1] - N) // HOP + 1
    frames = padded[:, np.arange(n_frames)[:, None] * HOP + np.arange(N)[None]]
    spec = frames @ np.concatenate([cos_b, sin_b], axis=1).astype(np.float64)
    return np.sqrt(spec[..., :257] ** 2 + spec[..., 257:] ** 2)


def test_eval_frontend_is_the_jax_one(frontend):
    cfg = jharness.eval_mel_frontend().config
    assert frontend.config.to_dict() == {k: getattr(cfg, k) for k in frontend.config.to_dict()}
    assert frontend.n_bins == 257 and frontend.window.shape == (N,)


def test_plain_512_magnitude_matches_oracle_and_jax(frontend):
    wav = np.stack([_clip(0, 32000), _clip(1, 32000)])
    jf = jstft.MelFrontend(jharness.eval_mel_frontend().config, use_pallas=False)
    want = np.asarray(jstft.stft_magnitude(wav, jf.cos_basis, jf.sin_basis,
                                           hop_length=HOP, center_pad=PAD))
    got = frontend.magnitude(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 201, 257)
    oracle = _oracle(wav, frontend.cos_basis.numpy(), frontend.sin_basis.numpy())
    tol = TOL_MAX * oracle.max()
    assert np.abs(got - oracle).max() <= tol, "the port's magnitude drifted"
    assert np.abs(want - oracle).max() <= tol, "the JAX package's magnitude drifted"


def test_twiddle_table_512_within_one_ulp():
    tw = stft.fft_twiddles(512)
    assert tw.shape == (16 * 32 + 16, 2) and tw.dtype == np.float32
    k2, n1 = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    exact = np.exp(-2j * np.pi * np.concatenate([(n1 * k2).ravel() / 512, np.arange(16) / 32]))
    for got, want in ((tw[:, 0], exact.real), (tw[:, 1], exact.imag)):
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


def _bitrev(x, bits):
    return int(f"{x:0{bits}b}"[::-1], 2)


def _fft(v, tw32, m):
    """csrc/stft.cu:fft<M> in numpy: radix-2 DIF with W_M^e = W_32^(e 32 / M)
    and exact multiplications by 1 and -i; bin k at index bitrev(k)."""
    v = v.copy()
    half = m // 2
    while half:
        for base in range(0, m, 2 * half):
            j = np.arange(half)
            a, b = base + j, base + j + half
            e = j * ((m // 2) // half)
            u, w = v[..., a] + v[..., b], v[..., a] - v[..., b]
            v[..., a] = u
            v[..., b] = np.where(e == 0, w, np.where(e == m // 4, -1j * w,
                                                     w * tw32[(e * (32 // m)) % 16]))
        half //= 2
    return v


@pytest.mark.parametrize("samples", [2000, 2160, 2320], ids=["frames_13", "frames_14", "frames_15"])
def test_fft512_kernel_algorithm_is_the_dft(frontend, samples):
    """K4 at N = 512, step for step in float64 with its float32 twiddle
    table: two frames as one complex sequence; lane n1 runs a 16-point FFT
    over the samples n1 + 32 n2 and multiplies by W_512^(n1 k2); lane k2 of
    the pair runs the 32-point FFT over n1, leaving bin k2 + 16 k1 in
    register bitrev5(k1); each bin's partner N - k comes from lane
    (16 - k2) % 16 of the same pair; the spectra are separated by conjugate
    symmetry. It equals the plain version's magnitude."""
    wav = _clip(9, samples)[None]
    q = N // 32
    tw = stft.fft_twiddles(N).astype(np.float64)
    twc = tw[:, 0] + 1j * tw[:, 1]
    step, tw32 = twc[:q * 32].reshape(q, 32), twc[q * 32:]
    padded = np.pad(wav[0].astype(np.float64), (PAD, PAD), mode="reflect")
    window = frontend.window.numpy().astype(np.float64)
    n_frames = samples // HOP + 1
    frames = np.stack([padded[f * HOP:f * HOP + N] * window for f in range(n_frames)]
                      + [np.zeros(N)] * (n_frames % 2))
    z = frames[0::2] + 1j * frames[1::2]  # [pairs, 512]
    y = _fft(z.reshape(-1, q, 32).transpose(0, 2, 1), tw32, q)  # [pair, n1, n2 -> k2]
    x = y[..., [_bitrev(k2, 4) for k2 in range(q)]] * step.T  # times W_512^(n1 k2)
    regs = _fft(x.transpose(0, 2, 1), tw32, 32)  # [pair, lane k2, register bitrev5(k1)]
    got = np.zeros((len(z) * 2, N // 2 + 1))
    for k1 in range(N // 2 // q + 1):
        for k2 in range(q):
            k = k2 + q * k1
            if k > N // 2:
                continue
            partner = (q - k2) % q
            give = _bitrev((32 - k1) % 32, 5) if k2 == 0 else _bitrev(31 - k1, 5)
            zk, pk = regs[:, k2, _bitrev(k1, 5)], regs[:, partner, give]
            got[0::2, k] = 0.5 * np.abs((zk.real + pk.real) + 1j * (zk.imag - pk.imag))
            got[1::2, k] = 0.5 * np.abs((zk.imag + pk.imag) + 1j * (zk.real - pk.real))
    want = frontend.magnitude(torch.from_numpy(wav))[0].numpy()
    assert got[:n_frames].shape == want.shape
    np.testing.assert_allclose(got[:n_frames], want, rtol=0, atol=1e-6 * want.max())


def test_kernel_wrapper_takes_the_512_point_filter(frontend):
    """The wrapper's checks pass for the eval frontend's bases (the build is
    next, and needs nvcc), its block fits shared memory, and a 768-point
    filter is still refused."""
    assert stft.fft_smem_bytes(HOP, N) <= stft.SMEM_LIMIT
    assert stft.fft_smem_bytes(HOP, N) == stft.EXCHANGE_BYTES + (2 * N + 63 * HOP) * 4
    wav = torch.zeros(1, 4000)
    with pytest.raises(RuntimeError, match="nvcc|CUDA|cuda"):
        stft.stft_magnitude_cuda(wav, frontend.cos_basis, frontend.sin_basis, HOP, PAD,
                                 frontend.window)
    other = stft.MelFrontend(mels.EVAL_STFT.__class__(filter_length=768, win_length=768),
                             device="cpu")
    with pytest.raises(ValueError, match="filter of 512 or 1024"):
        stft.stft_magnitude_cuda(wav, other.cos_basis, other.sin_basis, HOP, 384)


def _write(path, data, sr):
    wavfile.write(path, sr, data)
    return path


def test_normalized_logmel_of_a_batch_is_each_files_jax_result(tmp_path, frontend):
    paths = [_write(str(tmp_path / f"{i}.wav"), (_clip(i, 160000) * 32767).astype(np.int16),
                    16000) for i in range(3)]
    clips = np.stack([mels.load_wav_16k(p, 1000) for p in paths])
    got = mels.normalized_logmel(clips, frontend)
    assert got.shape == (3, 1001, 64)
    jf = jharness.eval_mel_frontend()
    for i, p in enumerate(paths):
        want = jharness.normalized_logmel(jharness.load_wav_16k(p, 1000), jf)
        assert want.dtype == got.dtype
        np.testing.assert_allclose(got[i], want, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(mels.normalized_logmel(clips[1], frontend), got[1])


@pytest.mark.parametrize("sr,dtype", [(16000, np.int16), (48000, np.int16), (44100, np.int32),
                                      (16000, np.float32)])
def test_load_wav_16k_matches_jax(tmp_path, sr, dtype):
    t = int(1.3 * sr)  # shorter than 2 s: padded
    x = _clip(3, t, sr) + 0.02  # a DC offset to remove
    data = x if dtype == np.float32 else (x * np.iinfo(dtype).max).astype(dtype)
    path = _write(str(tmp_path / "a.wav"), np.stack([data, data[::-1]], axis=1), sr)
    for centisec in (None, 50):
        got = mels.load_wav_16k(path, centisec)
        want = jharness.load_wav_16k(path, centisec)
        assert got.shape == want.shape and got.dtype == want.dtype
        if sr == 44100:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mels.load_wav_16k(path, pad_to_2s=False).shape,
                                  jharness.load_wav_16k(path, pad_to_2s=False).shape)


@pytest.mark.parametrize("orig,new", [(44100, 16000), (16000, 48000), (22050, 16000)])
def test_resample_numpy_matches_jax(orig, new):
    x = np.stack([_clip(5, 4000, orig), _clip(6, 4000, orig)])
    got, want = resample.resample_numpy(x, orig, new), jresample.resample_numpy(x, orig, new)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(resample.resample_numpy(x[0], orig, new), got[0], rtol=0,
                               atol=1e-7)
    assert resample.resample_numpy(x, orig, orig) is x


def test_written_files_are_the_jax_packages_bytes(tmp_path):
    x = _clip(7, 20000).astype(np.float64) * 2.5  # beyond [-1, 1]: clipped
    x[:5] = [-1.0, -0.99999, 32767 / 32768, 0.5 / 32768, -0.5 / 32768]
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    audio.write_wav(a, x, 16000)
    jaudio.write_wav(b, x, 16000)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, sr = audio.read_wav(a)
    want, jsr = jaudio.read_wav(b)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8, np.float32])
def test_read_wav_and_the_data_chain_match_jax(tmp_path, dtype):
    x = _clip(8, 12000)
    if dtype == np.uint8:
        data = ((x + 1) * 127.5).astype(np.uint8)
    elif dtype == np.float32:
        data = x
    else:
        data = (x * np.iinfo(dtype).max).astype(dtype)
    path = _write(str(tmp_path / "a.wav"), np.stack([data, data], axis=1), 16000)
    np.testing.assert_array_equal(audio.read_wav(path)[0], jaudio.read_wav(path)[0])
    for seg in (16000, 8000, None):
        np.testing.assert_array_equal(audio.read_wav_file(path, seg),
                                      jaudio.read_wav_file(path, seg))
    assert os.path.getsize(path) > 0
