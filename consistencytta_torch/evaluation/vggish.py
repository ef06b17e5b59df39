"""VGGish embedding model: the FAD backbone.

The port's counterpart of consistencytta_tpu/evaluation/vggish.py, after
the torchvggish hub model that the reference FAD uses
(audioldm_eval/metrics/fad.py:53-59, postprocess=False and the final ReLU
stripped), with its frontend from the original TF VGGish on the host
(numpy, as in the JAX package):

  * 16 kHz waveform, no STFT centring, frame 400 samples / hop 160,
    periodic Hann, |rfft| at fft_length 512 (magnitude, not power),
  * 64 HTK-mel bands 125-7500 Hz built on spectrogram bin centres
    (no Slaney area norm; DC bin excluded),
  * log(mel + 0.01), framed into 0.96-s examples (96 frames, hop 96),
  * VGG conv stack -> flatten in (H, W, C) order -> 4096-4096-128 MLP,
    returning the raw 128-d linear output per example.

`VGGish` keeps torchvggish's keys (features.{0,3,6,8,11,13},
embeddings.{0,2,4}), so `load_state_dict(strict=True)` takes its checkpoint.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from consistencytta_torch.io.audio import read_wav
from consistencytta_torch.io.checkpoints import load_torch_state_dict
from consistencytta_torch.ops.resample import resample_numpy
from consistencytta_torch.utils import resolve_device

SAMPLE_RATE = 16000
WIN_LENGTH = 400
HOP_LENGTH = 160
FFT_LENGTH = 512
NUM_BANDS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96


def _hz_to_htk_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def htk_mel_matrix(
    num_bands: int = NUM_BANDS,
    num_bins: int = FFT_LENGTH // 2 + 1,
    sr: int = SAMPLE_RATE,
    fmin: float = MEL_MIN_HZ,
    fmax: float = MEL_MAX_HZ,
) -> np.ndarray:
    """[num_bins, num_bands] mel weight matrix, torchvggish
    mel_features.spectrogram_to_mel_matrix semantics."""
    nyquist = sr / 2.0
    bin_hz = np.linspace(0.0, nyquist, num_bins)
    bin_mel = _hz_to_htk_mel(bin_hz)
    band_edges = np.linspace(_hz_to_htk_mel(fmin), _hz_to_htk_mel(fmax), num_bands + 2)
    weights = np.zeros((num_bins, num_bands))
    for i in range(num_bands):
        lower, center, upper = band_edges[i : i + 3]
        lower_slope = (bin_mel - lower) / (center - lower)
        upper_slope = (upper - bin_mel) / (upper - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0  # DC bin excluded
    return weights.astype(np.float32)


def waveform_to_examples(wav: np.ndarray) -> np.ndarray:
    """float waveform [-1, 1] -> [n_examples, 96, 64] log-mel patches
    (torchvggish vggish_input.waveform_to_examples)."""
    window = (0.5 - 0.5 * np.cos(2 * np.pi / WIN_LENGTH * np.arange(WIN_LENGTH))).astype(np.float64)

    n_frames = 1 + (len(wav) - WIN_LENGTH) // HOP_LENGTH if len(wav) >= WIN_LENGTH else 0
    if n_frames <= 0:
        return np.zeros((0, EXAMPLE_FRAMES, NUM_BANDS), np.float32)
    idx = np.arange(WIN_LENGTH)[None, :] + HOP_LENGTH * np.arange(n_frames)[:, None]
    frames = wav[idx] * window[None, :]
    mag = np.abs(np.fft.rfft(frames, FFT_LENGTH, axis=1))
    mel = mag @ htk_mel_matrix()
    logmel = np.log(mel + LOG_OFFSET)

    n_examples = len(logmel) // EXAMPLE_FRAMES
    if n_examples == 0:
        return np.zeros((0, EXAMPLE_FRAMES, NUM_BANDS), np.float32)
    return (
        logmel[: n_examples * EXAMPLE_FRAMES]
        .reshape(n_examples, EXAMPLE_FRAMES, NUM_BANDS)
        .astype(np.float32)
    )


class VGGish(nn.Module):
    """[N, 96, 64] log-mel examples -> [N, 128] embeddings (the final ReLU
    stripped, as fad.py's use_activation=False)."""

    def __init__(self):
        super().__init__()
        conv = lambda cin, cout: [nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU()]
        pool = lambda: [nn.MaxPool2d(2, 2)]
        self.features = nn.Sequential(
            *conv(1, 64), *pool(), *conv(64, 128), *pool(),
            *conv(128, 256), *conv(256, 256), *pool(),
            *conv(256, 512), *conv(512, 512), *pool(),
        )
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 4 * 6, 4096), nn.ReLU(),
            nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, 128),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x[:, None])  # [N, 512, 6, 4]
        # torchvggish flattens after permuting to (H, W, C)
        return self.embeddings(x.permute(0, 2, 3, 1).flatten(1))


def load_vggish(checkpoint: Optional[str], device="cuda") -> Optional[VGGish]:
    """The torchvggish checkpoint -> an eval-mode VGGish on `device`, or
    None without a checkpoint file. A missing, unexpected or wrongly shaped
    key raises, naming it."""
    device = resolve_device(device)
    if not checkpoint or not os.path.exists(checkpoint):
        return None
    model = VGGish()
    model.load_state_dict(load_torch_state_dict(checkpoint), strict=True)
    return model.to(device).eval()


def load_audio_fad(path: str, target_centisec: int = 1000, target_sr: int = 16000) -> np.ndarray:
    """The FAD loader (reference audioldm_eval/metrics/fad.py:22-36
    load_audio_task): int16 read scaled by 32768, mono mean, integer-ratio
    decimation (else the kaiser resampler), head crop to target_centisec;
    unlike the Cnn14 loader, no mean-centring and no 2-s minimum pad."""
    wav, sr = read_wav(path)
    wav = wav.astype(np.float32)
    if sr != target_sr:
        if sr % target_sr == 0:
            wav = wav[:: sr // target_sr]
        else:
            wav = resample_numpy(wav, sr, target_sr)
    return wav[: int(target_centisec * target_sr / 100)]


def vggish_embeddings(paths: List[str], checkpoint: Optional[str], batch: int = 32,
                      device="cuda") -> Optional[np.ndarray]:
    """Per-example VGGish embeddings of a list of wav files, the examples of
    all files concatenated and run in batches of `batch` (fad.py:61-79).
    None without a checkpoint file."""
    model = load_vggish(checkpoint, device)
    if model is None:
        return None
    examples = [waveform_to_examples(load_audio_fad(p, 1000)) for p in paths]
    all_ex = np.concatenate([e for e in examples if len(e)], axis=0)
    dev = next(model.parameters()).device
    outs = []
    with torch.no_grad():
        for start in range(0, len(all_ex), batch):
            x = torch.from_numpy(all_ex[start : start + batch]).to(dev)
            outs.append(model(x).cpu().numpy())
    return np.concatenate(outs, axis=0)
