"""AudioLDM's AutoencoderKL in float32 with the reference's key names:
the encoder with its posterior (training), `post_quant_conv` and the decoder
(generation). NHWC in and out: mel image [B, T, F, 1], latent [B, t, f, c]."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Quantized, Conv2d, attention


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class Attn(Quantized, nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.q, self.k, self.v = (Conv2d(ch, ch, 1) for _ in range(3))
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        n = self.norm(x)
        tok = lambda t: t.flatten(2).transpose(1, 2)
        out = attention(tok(self.q(n)), tok(self.k(n)), tok(self.v(n)), c ** -0.5, quant=self.quant)
        return x + self.proj_out(out.transpose(1, 2).reshape(b, c, h, w))


class Resample(nn.Module):
    def __init__(self, ch: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = Conv2d(ch, ch, 3, stride=2) if down else Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Level(nn.Module):
    def __init__(self, blocks, name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, name, resample)


def _mid(ch: int, g: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = Resnet(ch, ch, g), Attn(ch, g), Resnet(ch, ch, g)
    return mid


class Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        ch, g, mults = c["base_channels"], c["norm_num_groups"], c["ch_mult"]
        self.conv_in = Conv2d(c["in_channels"], ch, 3, padding=1)
        cin, levels = ch, []
        for i, m in enumerate(mults):
            blocks = []
            for _ in range(c["num_res_blocks"]):
                blocks.append(Resnet(cin, ch * m, g))
                cin = ch * m
            levels.append(Level(blocks, "downsample",
                                Resample(cin, True) if i != len(mults) - 1 else None))
        self.down = nn.ModuleList(levels)
        self.mid = _mid(cin, g)
        self.norm_out = nn.GroupNorm(g, cin, eps=c["norm_eps"])
        self.conv_out = Conv2d(cin, 2 * c["z_channels"] if c["double_z"] else c["z_channels"],
                               3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i, level in enumerate(self.down):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        ch, g, mults = c["base_channels"], c["norm_num_groups"], c["ch_mult"]
        cin = ch * mults[-1]
        self.conv_in = Conv2d(c["z_channels"], cin, 3, padding=1)
        self.mid = _mid(cin, g)
        levels = [None] * len(mults)
        for i in reversed(range(len(mults))):
            blocks = []
            for _ in range(c["num_res_blocks"] + 1):
                blocks.append(Resnet(cin, ch * mults[i], g))
                cin = ch * mults[i]
            levels[i] = Level(blocks, "upsample", Resample(cin, False) if i != 0 else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = nn.GroupNorm(g, cin, eps=c["norm_eps"])
        self.conv_out = Conv2d(cin, c["out_channels"], 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            for blk in self.up[i].block:
                h = blk(h)
            if i != 0:
                h = self.up[i].upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.encoder = Encoder(c)
        self.quant_conv = Conv2d(2 * c["z_channels"], 2 * c["embed_dim"], 1)
        self.decoder = Decoder(c)
        self.post_quant_conv = Conv2d(c["embed_dim"], c["z_channels"], 1)

    def decode_mel(self, z_scaled):
        """scaled latent NHWC -> mel image NHWC."""
        z = (z_scaled / self.c["scale_factor"]).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def encode_latent(self, mel_image, noise):
        """mel image NHWC -> scaled posterior sample NHWC with standard-normal
        `noise` of the latent's shape (logvar clamped to [-30, 20])."""
        moments = self.quant_conv(self.encoder(mel_image.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        return self.c["scale_factor"] * (mean + std * noise)
