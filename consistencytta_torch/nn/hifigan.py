"""HiFi-GAN vocoder generator (mel -> 16 kHz waveform) in the natural
[B, C, L] layout, with the reference's key names (`conv_pre`, `ups.{i}`,
`resblocks.{n}.convs{1,2}.{m}`, `conv_post`; weight norm already removed).

conv_pre (k7) -> per upsample level: leaky_relu(0.1) -> ConvTranspose1d ->
the MRF level (3 multi-dilation ResBlocks, averaged) -> leaky_relu (default
slope 0.01) -> conv_post -> tanh. The MRF levels of width <= 128 go through
`ops.mrf.fused_mrf_level` (kernel K3 on the card: the whole level in one
launch), the wider ones through `ops.mrf.wide_mrf_level` (kernel K7: one
channels-last implicit-GEMM launch a conv); both run the plain chain on the
CPU. A frozen inference call replays a CUDA graph (graphs.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch import graphs
from consistencytta_torch.configs import HiFiGANConfig
from consistencytta_torch.ops._packs import Pack
from consistencytta_torch.ops.mrf import fused_mrf_level, wide_mrf_level
from consistencytta_torch.utils import span

FUSE_MAX_CHANNELS = 128


def _get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=_get_padding(kernel_size, d))
            for d in dilations
        ])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=1,
                      padding=_get_padding(kernel_size, 1))
            for _ in dilations
        ])

    def chain(self):
        """(weights, biases) in the fused level's chain order."""
        ws, bs = [], []
        for c1, c2 in zip(self.convs1, self.convs2):
            ws += [c1.weight, c2.weight]
            bs += [c1.bias, c2.bias]
        return ws, bs


class HiFiGANGenerator(nn.Module):
    """mel [B, n_mels, T_frames] -> waveform [B, T_frames * 160]."""

    def __init__(self, config: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        self.config = cfg = config
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(
                c0 // (2**i), ch, k, stride=u, padding=(k - u) // 2
            ))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, rd))
        self.conv_post = nn.Conv1d(c0 // (2 ** len(cfg.upsample_rates)), 1, 7, padding=3)
        self.level_packs = [Pack() for _ in self.ups]  # K3's or K7's weight layout, a level

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return graphs.run(self, "vocoder", self._forward, mel)

    def _forward(self, mel):
        cfg = self.config
        x = self.conv_pre(mel.to(self.conv_pre.weight.dtype))
        nk = len(cfg.resblock_kernel_sizes)
        ks = tuple(cfg.resblock_kernel_sizes)
        ds = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
        for i, up in enumerate(self.ups):
            x = F.leaky_relu(x, cfg.lrelu_slope)
            x = up(x)
            ws, bs = [], []
            for rb in self.resblocks[i * nk:(i + 1) * nk]:
                w, b = rb.chain()
                ws += w
                bs += b
            with span("mrf"):
                level = fused_mrf_level if x.shape[1] <= FUSE_MAX_CHANNELS else wide_mrf_level
                x = level(x, ws, bs, ks, ds, cfg.lrelu_slope, self.level_packs[i])
        x = F.leaky_relu(x)  # default slope 0.01
        x = torch.tanh(self.conv_post(x))
        return x.reshape(x.shape[0], -1)


def vocoder_postprocess(wav: torch.Tensor) -> torch.Tensor:
    """DC-centre the waveform batch: wav - (max + min) / 2, with the extrema
    taken over the whole batch (the reference's vocoder_infer)."""
    return wav - (wav.max() + wav.min()) / 2.0
