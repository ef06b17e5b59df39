"""The two generation paths the benchmark judges, in float32, in blocks of
rows: the 1-NFE consistency student, and the Heun CFG teacher (the
LightweightLDM baseline). Both end in the VAE decoder, the vocoder, the
batch-wide DC centring and the cut to 10 s."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from benchmark.reference.hifigan import HiFiGAN, dc_centre
from benchmark.reference.layers import no_tf32
from benchmark.reference.schedules import Heun
from benchmark.reference.t5 import T5Encoder
from benchmark.reference.unet import UNet
from benchmark.reference.vae import AutoencoderKL

CLIP_SECONDS = 10.0  # every clip is cut to 10 s, as the reference's generation cuts it
BLOCK = 8  # rows a block: the float32 reference runs in blocks so that it fits


@dataclass
class Models:
    t5: nn.Module
    unet: nn.Module
    vae: nn.Module
    vocoder: nn.Module

    def modules(self):
        return [self.t5, self.unet, self.vae, self.vocoder]


def build(pipeline: dict, state: dict, device, teacher: bool) -> Models:
    """The reference models from the configuration's `pipeline` section and
    the benchmark's state dicts ({"t5", "unet", "vae", "vocoder"}), float32,
    loaded strictly. `teacher` builds the UNet unguided."""
    no_tf32()
    unet_cfg = dict(pipeline["unet"], guided=not teacher and pipeline["unet"]["guided"])
    with torch.device("meta"):
        models = Models(T5Encoder(pipeline["t5"]), UNet(unet_cfg), AutoencoderKL(pipeline["vae"]),
                        HiFiGAN(pipeline["vocoder"]))
    for name, m in zip(("t5", "unet", "vae", "vocoder"), models.modules()):
        m.to_empty(device=device)
        m.load_state_dict({k: v.float() for k, v in state[name].items()}, strict=True)
        m.eval().requires_grad_(False)
    return models


def decode(models: Models, z, sample_rate: int):
    """scaled latents NHWC -> waveforms [B, CLIP_SECONDS * rate]."""
    wav = []
    for zb in z.split(BLOCK):
        mel = models.vae.decode_mel(zb)[..., 0].transpose(1, 2)
        wav.append(models.vocoder(mel))
    return dc_centre(torch.cat(wav))[:, : int(CLIP_SECONDS * sample_rate)]


@torch.no_grad()
def student(models: Models, pipeline: dict, ids, mask, noise, guidance: float,
            init_steps: int = 18):
    """1-NFE: the student's x0 from pure noise at the first sigma of the
    `init_steps` Heun schedule, decoded."""
    sched = Heun.make(pipeline["scheduler"], init_steps)
    out = []
    for i in range(0, ids.shape[0], BLOCK):
        sl = slice(i, i + BLOCK)
        b = ids[sl].shape[0]
        text = models.t5(ids[sl], mask[sl])
        t, s = sched.level(0, b, ids.device)
        z = noise[sl] * s
        g = torch.full((b,), float(guidance), device=ids.device)
        out.append(models.unet(sched.scale(z, s), t.reshape(-1), text, mask[sl], g))
    return decode(models, torch.cat(out), pipeline["sample_rate"])


@torch.no_grad()
def teacher(models: Models, pipeline: dict, ids, mask, uncond_ids, uncond_mask, noise,
            guidance: float, num_steps: int):
    """Heun CFG sampling: each query runs [uncond; cond] through the teacher
    UNet and mixes (1 - w) uncond + w cond."""
    sched = Heun.make(pipeline["scheduler"], num_steps)
    out = []
    for i in range(0, ids.shape[0], BLOCK):
        sl = slice(i, i + BLOCK)
        b = ids[sl].shape[0]
        both_mask = torch.cat([uncond_mask[sl], mask[sl]])
        text = models.t5(torch.cat([uncond_ids[sl], ids[sl]]), both_mask)

        def query(z_scaled, t):
            pred = models.unet(torch.cat([z_scaled, z_scaled]), torch.cat([t, t]).reshape(-1),
                               text, both_mask)
            return (1.0 - guidance) * pred[:b] + guidance * pred[b:]

        z = noise[sl] * float(sched.sigmas[0])
        out.append(sched.sample(z, query))
    return decode(models, torch.cat(out), pipeline["sample_rate"])
