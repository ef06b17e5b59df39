"""Kaiser-windowed sinc resampling (polyphase, torchaudio semantics): on the
host for reading audio files (`resample_numpy`), and on tensors with
gradients for the stage-3 CLAP loss's 16 -> 48 kHz step (`resample`).

The port's copy of the JAX package's `resample`, `resample_numpy` and the
filter bank they build (consistencytta_tpu/ops/resample.py:31-91): resampy's
kaiser_best settings (lowpass filter width 64, rolloff 0.9475937167399596,
beta 14.769656459379492) as torchaudio's `sinc_interp_kaiser`. The bank is
[new, width] for the gcd-reduced frequencies, and each output phase is one
float32 product with the strided frames of the zero-padded input: a strided
`F.conv1d` on tensors, as the JAX package computes it with an XLA
convolution outside any Pallas kernel.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

KAISER_BEST_ROLLOFF = 0.9475937167399596
KAISER_BEST_BETA = 14.769656459379492
KAISER_BEST_WIDTH = 64


@lru_cache(maxsize=32)
def _sinc_resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = KAISER_BEST_WIDTH,
    rolloff: float = KAISER_BEST_ROLLOFF,
    beta: float = KAISER_BEST_BETA,
):
    """(kernel [new, 1, K] float32, width, orig, new) for the gcd-reduced
    frequencies, as torchaudio's _get_sinc_resample_kernel builds it. The
    cached kernel is read-only."""
    from scipy.special import i0

    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g

    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)

    window = i0(beta * np.sqrt(1 - (t / lowpass_filter_width) ** 2)) / i0(beta)
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t)) * window
    kernel = (kernel * base_freq / orig).astype(np.float32)[:, None, :]
    kernel.flags.writeable = False
    return kernel, width, orig, new


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample [B, T] -> [B, ceil(T * new / orig)] float32, differentiable:
    the bank as one strided conv1d, its phases interleaved."""
    if orig_freq == new_freq:
        return wav
    kernel, width, orig, new = _sinc_resample_kernel(orig_freq, new_freq)
    b, length = wav.shape
    target_length = int(math.ceil(new * length / orig))
    x = F.pad(wav.float(), (width, width + orig))
    bank = torch.tensor(kernel, device=wav.device)
    y = F.conv1d(x[:, None, :], bank, stride=orig)  # [B, new, frames]
    return y.transpose(1, 2).reshape(b, -1)[:, :target_length]


def resample_numpy(wav: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Resample [T] or [B, T] -> [.., ceil(T * new / orig)] float32."""
    if orig_freq == new_freq:
        return wav
    squeeze = wav.ndim == 1
    x = np.asarray(wav, np.float32)
    if squeeze:
        x = x[None, :]
    kernel, width, orig, new = _sinc_resample_kernel(orig_freq, new_freq)
    b, length = x.shape
    target_length = int(math.ceil(new * length / orig))
    x = np.pad(x, ((0, 0), (width, width + orig)))
    frames = np.lib.stride_tricks.sliding_window_view(x, kernel.shape[-1], axis=1)[:, ::orig]
    y = frames @ kernel[:, 0, :].T  # [B, frames, new]: one column a phase
    y = y.reshape(b, -1)[:, :target_length]
    return y[0] if squeeze else y
