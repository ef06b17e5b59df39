"""HiFi-GAN generator (16 kHz, 64 mels) in float32 with the reference's key
names: conv_pre, per level a leaky relu, the transposed conv and the mean
of three multi-dilation residual blocks, then leaky relu (0.01), conv_post,
tanh; and the batch-wide DC centring of the reference's vocoder_infer."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Conv1d, ConvTranspose1d


class ResBlock(nn.Module):
    def __init__(self, ch: int, k: int, dilations, slope: float):
        super().__init__()
        self.slope = slope
        self.convs1 = nn.ModuleList([Conv1d(ch, ch, k, dilation=d, padding=d * (k - 1) // 2)
                                     for d in dilations])
        self.convs2 = nn.ModuleList([Conv1d(ch, ch, k, padding=(k - 1) // 2)
                                     for _ in dilations])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, self.slope)), self.slope))
        return x


class HiFiGAN(nn.Module):
    """mel [B, n_mels, frames] -> waveform [B, frames * hop]."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        c0, slope = c["upsample_initial_channel"], c["lrelu_slope"]
        self.conv_pre = Conv1d(c["num_mels"], c0, 7, padding=3)
        self.ups, self.resblocks = nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(c["upsample_rates"], c["upsample_kernel_sizes"])):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d(c0 // 2 ** i, ch, k, stride=u, padding=(k - u) // 2))
            for rk, rd in zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock(ch, rk, rd, slope))
        self.conv_post = Conv1d(c0 // 2 ** len(c["upsample_rates"]), 1, 7, padding=3)

    def forward(self, mel):
        nk = len(self.c["resblock_kernel_sizes"])
        x = self.conv_pre(mel)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, self.c["lrelu_slope"]))
            x = sum(rb(x) for rb in self.resblocks[i * nk:(i + 1) * nk]) / nk
        return torch.tanh(self.conv_post(F.leaky_relu(x))).flatten(1)


def dc_centre(wav: torch.Tensor) -> torch.Tensor:
    """wav - (max + min) / 2 over the whole batch."""
    return wav - (wav.max() + wav.min()) / 2.0
