"""The evaluation protocol's mel images: 16-kHz wav loading and the
normalised log-mel of the eval frontend (a 512-point STFT, hop 160, fmin
50; kernel K4 on the card).

The port's counterpart of consistencytta_tpu/evaluation/harness.py:46-98
(after audioldm_eval's load_mel.py and eval.py:90-93). The test-set CLI
stores these mels of the files it writes as `all_mels.npz`, and the
evaluation harness (evaluation/harness.py) computes PSNR and SSIM on them.
`normalized_logmel` takes a batch, so that one kernel launch serves a
generate batch; each row equals the per-file result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from consistencytta_torch.configs import STFTConfig
from consistencytta_torch.io.audio import read_wav
from consistencytta_torch.ops.resample import resample_numpy
from consistencytta_torch.ops.stft import MelFrontend

EVAL_STFT = STFTConfig(filter_length=512, hop_length=160, win_length=512, mel_fmin=50.0)


def load_wav_16k(path: str, target_centisec: Optional[int] = None,
                 pad_to_2s: bool = True) -> np.ndarray:
    """Read -> float32 -> 16 kHz (integer ratios by decimation, others by the
    kaiser-best resampler) -> remove the DC offset -> crop to
    target_centisec * 160 samples -> zero-pad to 2 s (unless `pad_to_2s` is
    False)."""
    wav, sr = read_wav(path)
    wav = wav.astype(np.float32)
    if sr != 16000:
        if sr % 16000 == 0:
            wav = wav[:: sr // 16000]
        else:
            wav = resample_numpy(wav, sr, 16000)
    wav = wav - wav.mean()
    if target_centisec is not None:
        wav = wav[: target_centisec * 160]
    if pad_to_2s and len(wav) < 32000:
        wav = np.pad(wav, (0, 32000 - len(wav)))
    return wav


def eval_mel_frontend(device="cuda") -> MelFrontend:
    """The eval protocol's frontend on `device` (the card unless the caller
    passes "cpu")."""
    return MelFrontend(EVAL_STFT, device=device)


def normalized_logmel(wavs: np.ndarray, frontend: MelFrontend) -> np.ndarray:
    """[B, T] (or [T]) float32 waveforms of one length -> [B, frames, n_mels]
    (or [frames, n_mels]): log10 mel, then (mel * 20 - 20 + 100) / 100
    clipped to [0, 1]. The log-mel runs on the frontend's device in one
    batch; the normalisation is the reference's numpy expression on the
    host."""
    wavs = np.asarray(wavs, np.float32)
    squeeze = wavs.ndim == 1
    x = torch.from_numpy(np.ascontiguousarray(wavs.reshape(-1, wavs.shape[-1])))
    with torch.no_grad():
        mel_ln, _ = frontend(x.to(frontend.cos_basis.device))
    mel_log10 = mel_ln.cpu().numpy() / np.log(10.0)
    out = np.clip((mel_log10 * 20 - 20 + 100) / 100, 0, 1)
    return out[0] if squeeze else out
