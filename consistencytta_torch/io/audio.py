"""Waveform file IO and preprocessing on the host (numpy).

The port's copy of the JAX package's io/audio.py (itself the reference's
tools/torch_tools.py:25-75): wav read -> mono -> kaiser-sinc resample to
16 kHz -> mean-centre -> peak-normalise to 0.5 -> pad or crop to the segment
length -> peak-normalise again. Writing quantises as the reference's
inference does, `(wav * 32768).astype(int16)`, truncating, so that a file
the port writes is the same, byte for byte, as the JAX package's from the
same waveform. Reading uses scipy's wav reader; other formats are converted
to wav beforehand.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from consistencytta_torch.ops.resample import resample_numpy


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float64 mono waveform in [-1, 1], sample rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float64) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float64) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float64) - 128.0) / 128.0
    else:
        wav = data.astype(np.float64)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)  # the mean of the channels, as librosa.to_mono
    return wav, int(sr)


def write_wav(path: str, wav: np.ndarray, sr: int = 16000) -> None:
    """Write a float waveform as 16-bit PCM: clipped to [-1, 32767 / 32768],
    times 32768, truncated to int16 (the reference's vocoder output
    quantisation). The vocoder's DC-centred tanh output is always inside
    (-1, 1); the clip guards other callers."""
    from scipy.io import wavfile

    pcm = np.clip(np.asarray(wav, np.float64), -1.0, 32767.0 / 32768.0)
    wavfile.write(path, sr, (pcm * 32768.0).astype(np.int16))


def pad_wav(wav: np.ndarray, segment_length: Optional[int]) -> np.ndarray:
    """Crop or zero-pad to segment_length."""
    if segment_length is None or len(wav) == segment_length:
        return wav
    if len(wav) > segment_length:
        return wav[:segment_length]
    return np.pad(wav, (0, segment_length - len(wav)))


def normalize_wav(wav: np.ndarray) -> np.ndarray:
    """Mean-centre, then peak-normalise to 0.5."""
    wav = wav - wav.mean()
    return wav / (np.abs(wav).max() + 1e-8) / 2.0


def read_wav_file(path: str, segment_length: Optional[int],
                  target_sr: int = 16000) -> np.ndarray:
    """The reference's whole chain: read -> mono -> resample -> normalise ->
    pad -> normalise again. Returns float32 [segment_length]."""
    wav, sr = read_wav(path)
    if sr != target_sr:
        wav = resample_numpy(wav.astype(np.float32), sr, target_sr).astype(np.float64)
    wav = normalize_wav(wav)
    wav = pad_wav(wav, segment_length)
    wav = wav / (np.abs(wav).max() + 1e-8) / 2.0
    return wav.astype(np.float32)
