"""Seeded random weights for the evaluation backbones, under the reference
checkpoints' key layouts.

The published backbone checkpoints (`Cnn14_16k_mAP=0.438.pth`, `vggish.pth`,
`music_audioset_epoch_15_esc_90.14.pt`) are not in the repository, and
nothing is downloaded. These functions stand in for them: each builds the
port's module, fills its weights from a CPU generator seeded with `seed`
(convolutions and linears at He / 1/sqrt(fan-in) scale, norms and running
statistics near their trained ranges, so that activations neither vanish
nor blow up through the full-depth stacks), and returns its state dict on
the CPU, which both packages load: the port with `load_state_dict(strict=True)`,
the JAX package through its `convert_*` importers.

    write_eval_checkpoints("ckpt", seed=0)   # the three files the harness looks for
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from consistencytta_torch.evaluation.clap_model import (
    CLAPAudioTower, CLAPTextTower, HTSATConfig, RobertaConfig,
)
from consistencytta_torch.evaluation.panns import BatchNormInference, Cnn14
from consistencytta_torch.evaluation.vggish import VGGish

CHECKPOINT_NAMES = {
    "cnn14": "Cnn14_16k_mAP=0.438.pth",
    "vggish": "vggish.pth",
    "clap": "music_audioset_epoch_15_esc_90.14.pt",
}


def randomize_(model: nn.Module, seed: int, bn0_stats=(0.0, 1.0),
               centre_rows: bool = False) -> nn.Module:
    """Fill every parameter and running statistic of `model` in place from
    a generator seeded with `seed`, in module order. `bn0_stats` (mean,
    variance) sets the running statistics of a batch norm named bn0, which
    sees raw log-mels in decibels. `centre_rows` gives every linear weight
    zero-mean rows, so that a layer adds no direction common to all its
    inputs (the GELU's positive mean, through fc2); over HTSAT's 18 residual
    blocks such a direction outgrows the input's part and the mean-pooled
    embeddings of different clips close onto one vector."""
    g = torch.Generator().manual_seed(seed)
    normal = lambda t, mean, std: t.copy_(torch.randn(t.shape, generator=g) * std + mean)
    uniform = lambda t, lo, hi: t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                normal(m.weight, 0.0, (gain / fan_in) ** 0.5)
                if centre_rows and isinstance(m, nn.Linear):
                    m.weight.sub_(m.weight.mean(dim=1, keepdim=True))
                if m.bias is not None:
                    normal(m.bias, 0.0, 0.02)
            elif isinstance(m, nn.Embedding):
                normal(m.weight, 0.0, 0.5)
            elif isinstance(m, (nn.LayerNorm, BatchNormInference)):
                uniform(m.weight, 0.8, 1.2)
                normal(m.bias, 0.0, 0.05)
                if isinstance(m, BatchNormInference):
                    mean, var = bn0_stats if name.endswith("bn0") else (0.0, 1.0)
                    normal(m.running_mean, mean, 0.1 * var**0.5)
                    uniform(m.running_var, 0.5 * var, 1.5 * var)
            if hasattr(m, "relative_position_bias_table"):
                normal(m.relative_position_bias_table, 0.0, 0.5)
    return model


def _cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def cnn14_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    return _cpu_state_dict(randomize_(Cnn14(), seed, bn0_stats=(-40.0, 400.0)))


def vggish_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    return _cpu_state_dict(randomize_(VGGish(), seed))


def clap_state_dict(seed: int = 0, audio: HTSATConfig = HTSATConfig(),
                    text: RobertaConfig = RobertaConfig()) -> Dict[str, torch.Tensor]:
    """Both towers' entries in one laion_clap-format state dict."""
    sd = _cpu_state_dict(randomize_(CLAPAudioTower(audio), seed, bn0_stats=(-40.0, 400.0),
                                    centre_rows=True))
    sd.update(_cpu_state_dict(randomize_(CLAPTextTower(text), seed + 1)))
    return sd


def write_eval_checkpoints(directory: str, seed: int = 0,
                           clap_audio: Optional[HTSATConfig] = HTSATConfig(),
                           clap_text: RobertaConfig = RobertaConfig(),
                           which=("cnn14", "vggish", "clap")) -> Dict[str, str]:
    """Write the named backbones' files under `directory` with the
    published file names and wrappers (Cnn14's weights under "model", CLAP's
    under "state_dict" with `module.` prefixes); returns their paths."""
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for name in which:
        path = os.path.join(directory, CHECKPOINT_NAMES[name])
        if name == "cnn14":
            torch.save({"model": cnn14_state_dict(seed)}, path)
        elif name == "vggish":
            torch.save(vggish_state_dict(seed + 1), path)
        else:
            sd = clap_state_dict(seed + 2, clap_audio, clap_text)
            torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
        paths[name] = path
    return paths
