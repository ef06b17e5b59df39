"""PANN Cnn14 audio classifier: the FD / KL / ISc / KID feature backbone.

The port's counterpart of consistencytta_tpu/evaluation/panns.py, after
audioldm_eval/feature_extractors/panns/models.py:168-324 at the 16 kHz eval
configuration (window 512 / hop 160 / 64 mel / fmin 50 / fmax 8000;
audioldm_eval/eval.py:71-75). Returns the same feature dict: {"2048": the
penultimate embedding, "logits": the 527-way AudioSet logits}.

Inference only: the batch norms apply the checkpoint's running statistics,
and dropout and spec-augment are left out (the harness never trains it).
The module's state-dict keys are the official `Cnn14_16k_mAP=0.438.pth`'s,
the torchlibrosa frontend's windowed-DFT and mel bases included, so
`load_state_dict(strict=True)` takes that file once its `model.` prefix is
stripped (`load_cnn14`). The frontend is the power STFT through
ops/stft.py's plain `stft_power` (no Pallas kernel in the JAX package
either), a float32 mel product and 10 log10; both products are pinned to
full float32, as the JAX package pins them with Precision.HIGHEST. The
convolutions are cuDNN's under PyTorch's settings (TF32 by default on the
card, as the reference ran them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch.io.checkpoints import load_torch_state_dict
from consistencytta_torch.ops.mel import mel_filterbank, real_dft_basis
from consistencytta_torch.ops.stft import _matmul_fp32, stft_power
from consistencytta_torch.utils import resolve_device

CHANNELS = (64, 128, 256, 512, 1024, 2048)
POOLS = (2, 2, 2, 2, 2, 1)


@dataclass(frozen=True)
class Cnn14Config:
    sample_rate: int = 16000
    window_size: int = 512
    hop_size: int = 160
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 8000.0
    classes_num: int = 527
    amin: float = 1e-10


class BatchNormInference(nn.BatchNorm1d):
    """Batch norm over axis 1 with the stored running statistics, in any
    mode (eval only). The keys are torch BatchNorm's, num_batches_tracked
    included, so reference checkpoints load as they are."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _holder(**tensors: torch.Tensor) -> nn.Module:
    """A module that only holds buffers: a reference key path for tensors
    the model reads but never trains."""
    m = nn.Module()
    for name, t in tensors.items():
        m.register_buffer(name, t)
    return m


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn1 = BatchNormInference(out_channels)
        self.bn2 = BatchNormInference(out_channels)

    def forward(self, x: torch.Tensor, pool: int) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.avg_pool2d(x, pool) if pool > 1 else x


class Cnn14(nn.Module):
    """waveform [B, T] -> {"2048": [B, 2048], "logits": [B, classes]}."""

    def __init__(self, config: Cnn14Config = Cnn14Config()):
        super().__init__()
        self.config = config
        cos_b, sin_b = real_dft_basis(config.window_size, config.window_size, "hann")
        mel = mel_filterbank(config.sample_rate, config.window_size, config.mel_bins,
                             config.fmin, config.fmax)
        # torchlibrosa's layout: conv weights [n_bins, 1, window], melW [n_bins, mel]
        stft = _holder()
        stft.conv_real = _holder(weight=torch.from_numpy(cos_b.T.copy())[:, None])
        stft.conv_imag = _holder(weight=torch.from_numpy(sin_b.T.copy())[:, None])
        self.spectrogram_extractor = nn.Module()
        self.spectrogram_extractor.stft = stft
        self.logmel_extractor = _holder(melW=torch.from_numpy(mel.T.copy()))
        self.bn0 = BatchNormInference(config.mel_bins)
        prev = 1
        for i, ch in enumerate(CHANNELS):
            setattr(self, f"conv_block{i + 1}", ConvBlock(prev, ch))
            prev = ch
        self.fc1 = nn.Linear(CHANNELS[-1], 2048)
        self.fc_audioset = nn.Linear(2048, config.classes_num)

    def logmel(self, wav: torch.Tensor) -> torch.Tensor:
        """torchlibrosa Spectrogram(power=2) + LogmelFilterBank(ref=1,
        amin=1e-10, top_db=None): [B, T] -> [B, frames, mel]."""
        cfg = self.config
        stft = self.spectrogram_extractor.stft
        power = stft_power(wav.float(), stft.conv_real.weight[:, 0].t(),
                           stft.conv_imag.weight[:, 0].t(), cfg.hop_size, cfg.window_size // 2)
        mel = _matmul_fp32(power, self.logmel_extractor.melW)
        return 10.0 * torch.log10(mel.clamp_min(cfg.amin))

    def forward(self, wav: torch.Tensor) -> Dict[str, torch.Tensor]:
        # bn0 normalises over the mel axis (the reference transposes C <-> F)
        x = self.bn0(self.logmel(wav).transpose(1, 2)).transpose(1, 2)
        x = x[:, None]  # [B, 1, T, mel]
        for i, pool in enumerate(POOLS):
            x = getattr(self, f"conv_block{i + 1}")(x, pool)
        x = x.mean(dim=3)  # over mel -> [B, C, T']
        x = x.amax(dim=2) + x.mean(dim=2)  # max + mean over time
        embedding = F.relu(self.fc1(x))
        return {"2048": embedding, "logits": self.fc_audioset(embedding)}


def load_cnn14(path: str, device="cuda") -> Cnn14:
    """The official checkpoint (weights under "model", keys maybe prefixed
    `model.`) or any file under the same keys -> an eval-mode Cnn14 on
    `device`. A missing, unexpected or wrongly shaped key raises, naming it."""
    device = resolve_device(device)
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in load_torch_state_dict(path).items()}
    model = Cnn14()
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
