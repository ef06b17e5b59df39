"""Distillation losses with per-instance reduction: each returns a vector
[B], so that the min-SNR weights multiply before the mean.

The port's copy of the JAX package's loss zoo (consistencytta_tpu/training/
losses.py, after the reference's tools/losses.py): the latent MSE, the mel
loss (`loss_type` "mel") and the multi-resolution STFT loss ("stft"). The
stage-3 CLAP loss is `training/clap_loss.py`.

The STFT loss's three resolutions (1024/120/600, 2048/240/1200, 512/50/240)
are plain float32 products of frames and a windowed DFT basis, as the JAX
package computes them (`_stft_mag`, outside any Pallas kernel): kernel K4
takes only the mel frontend's filters. Known reference bug not reproduced,
as in the JAX package: the reference's MultiResolutionSTFTLoss reads a
`self.sr` that is never set, so its "stft" loss type crashes upstream; here
it works, with sr 16000.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from consistencytta_torch.ops.mel import hann_window
from consistencytta_torch.ops.stft import _matmul_fp32, frame_signal, reflect_pad


def mse_instance(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-instance MSE [B], taken in float32."""
    d = (pred.float() - target.float()) ** 2
    return d.mean(dim=tuple(range(1, d.ndim)))


def mel_loss_instance(
    pred_latent: torch.Tensor,
    target_latent: torch.Tensor,
    decode_fn: Callable[[torch.Tensor], torch.Tensor],
    mse_weight: float = 0.7,
    mel_weight: float = 0.3,
) -> torch.Tensor:
    """0.7 * latent MSE + 0.3 * decoded-mel MSE (tools/losses.py:36-64).
    `decode_fn` is the differentiable scaled-latent -> mel decoder."""
    mel_pred = decode_fn(pred_latent)
    mel_target = decode_fn(target_latent)
    return mse_weight * mse_instance(pred_latent, target_latent) + (
        mel_weight * mse_instance(mel_pred, mel_target)
    )


def stft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """[n_fft, 2 * (n_fft / 2 + 1)] float32: cos and -sin columns times the
    periodic Hann window of `win_length`, zero-padded to `n_fft` in the
    middle (torch.stft's placement)."""
    window = np.zeros(n_fft, np.float32)
    lpad = (n_fft - win_length) // 2
    window[lpad:lpad + win_length] = hann_window(win_length)
    k = np.arange(n_fft // 2 + 1)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    return np.concatenate(
        [np.cos(ang) * window[:, None], -np.sin(ang) * window[:, None]], axis=1
    ).astype(np.float32)


def _stft_mag(x: torch.Tensor, basis: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """torch.stft-compatible magnitude (centre reflect pad), clamped at 1e-8
    like tools/losses.py:145-169: [B, T] -> [B, frames, bins], float32 at
    full precision."""
    frames = frame_signal(reflect_pad(x.float(), n_fft // 2), n_fft, hop)
    spec = _matmul_fp32(frames, basis)
    n_bins = n_fft // 2 + 1
    re, im = spec[..., :n_bins], spec[..., n_bins:]
    return torch.sqrt(torch.clamp(re * re + im * im, min=1e-8))


@dataclass
class MultiResolutionSTFTLoss:
    """MSE + multi-resolution spectral-convergence + log-magnitude losses on
    decoded waveforms (tools/losses.py:187-256; the shipped weights
    factor_sc 0.1, factor_mag 0.1, factor_mse 0.8 per
    models/audio_consistency_model.py:95-99). The DFT bases are made once
    per resolution and device."""

    fft_sizes: Sequence[int] = (1024, 2048, 512)
    hop_sizes: Sequence[int] = (120, 240, 50)
    win_lengths: Sequence[int] = (600, 1200, 240)
    factor_sc: float = 0.1
    factor_mag: float = 0.1
    factor_mse: float = 0.8
    sr: int = 16000
    _bases: Dict[Tuple[int, int, str], torch.Tensor] = field(default_factory=dict, repr=False)

    def _basis(self, n_fft: int, win: int, device) -> torch.Tensor:
        key = (n_fft, win, str(device))
        if key not in self._bases:
            self._bases[key] = torch.from_numpy(stft_basis(n_fft, win)).to(device)
        return self._bases[key]

    def __call__(
        self,
        pred_latent: torch.Tensor,
        target_latent: torch.Tensor,
        decode_to_wav: Callable[[torch.Tensor], torch.Tensor],
    ) -> torch.Tensor:
        mse = mse_instance(pred_latent, target_latent)
        wav_pred = decode_to_wav(pred_latent)[:, : self.sr * 10]
        wav_target = decode_to_wav(target_latent)[:, : self.sr * 10]
        b = wav_pred.shape[0]
        sc_total = torch.zeros(b, device=wav_pred.device)
        mag_total = torch.zeros(b, device=wav_pred.device)
        for n_fft, hop, win in zip(self.fft_sizes, self.hop_sizes, self.win_lengths):
            basis = self._basis(n_fft, win, wav_pred.device)
            m_pred = _stft_mag(wav_pred, basis, n_fft, hop)
            m_tgt = _stft_mag(wav_target, basis, n_fft, hop)
            sc_total = sc_total + torch.linalg.norm((m_tgt - m_pred).reshape(b, -1), dim=1) \
                / torch.linalg.norm(m_tgt.reshape(b, -1), dim=1)
            mag_total = mag_total + (torch.log(m_tgt) - torch.log(m_pred)).abs().mean(dim=(1, 2))
        n = len(self.fft_sizes)
        return (self.factor_mse * mse + self.factor_sc * sc_total / n
                + self.factor_mag * mag_total / n)
