"""Mel filterbank and window construction (pure numpy, no librosa/scipy deps).

The reference obtains its mel basis from ``librosa.filters.mel`` with default
arguments (Slaney-style mel scale, ``norm='slaney'`` area normalization); see
reference audioldm/audio/stft.py:151-153. This module re-derives that math
from the Slaney Auditory Toolbox definitions so the port needs no librosa.
The port's own copy of the JAX package's builders, function for function.
"""

from __future__ import annotations

import numpy as np

# Slaney mel scale constants (Auditory Toolbox): linear below 1 kHz
# (mel = 3 f / 200), logarithmic above with step log(6.4)/27.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    """Slaney-scale Hz -> mel (librosa default, htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    """Slaney-scale mel -> Hz."""
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_mels, 1 + n_fft // 2].

    Matches ``librosa.filters.mel(sr=sr, n_fft=n_fft, n_mels=n_mels,
    fmin=fmin, fmax=fmax)`` with default htk=False, norm='slaney'.
    """
    if fmax is None:
        fmax = sr / 2.0

    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)  # [n_mels + 2] band edges

    fdiff = np.diff(hz_pts)  # [n_mels + 1]
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels + 2, n_bins]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each filter integrates to ~2 / bandwidth.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]

    return weights.astype(dtype)


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, matching
    ``scipy.signal.get_window('hann', win_length, fftbins=True)`` used by the
    reference STFT (audioldm/audio/stft.py:41)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to `size` (librosa.util.pad_center)."""
    n = window.shape[0]
    if size < n:
        raise ValueError(f"cannot pad window of size {n} to {size}")
    lpad = (size - n) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad : lpad + n] = window
    return out


def real_dft_basis(
    filter_length: int, win_length: int | None = None, window: str | None = "hann"
) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT analysis basis.

    Returns (cos_basis, sin_basis), each [filter_length, n_bins] with
    n_bins = filter_length // 2 + 1, such that for a frame x of length
    filter_length:  real = x @ cos_basis, imag = x @ sin_basis, matching the
    conv1d-against-DFT-eye construction of reference audioldm/audio/stft.py:
    25-47 (fourier_basis = fft(eye(N)) rows real/imag, scaled by the window).

    Note the reference uses ``np.fft.fft`` whose imaginary part is the
    *negative* sine; magnitude is unaffected, and we reproduce the same sign
    so intermediate real/imag parts are bit-comparable.
    """
    if win_length is None:
        win_length = filter_length
    n_bins = filter_length // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    n = np.arange(filter_length, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n / filter_length
    cos_b = np.cos(ang)
    sin_b = -np.sin(ang)  # fft convention: X[k] = sum x[n] e^{-2pi i k n / N}

    if window is not None:
        if window != "hann":
            raise ValueError(f"unsupported window {window!r}")
        w = pad_center(hann_window(win_length, dtype=np.float64), filter_length)
        cos_b = cos_b * w[:, None]
        sin_b = sin_b * w[:, None]

    return cos_b.astype(np.float32), sin_b.astype(np.float32)
