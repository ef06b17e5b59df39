"""The model bundle of the generation pipeline: the T5 encoder, the UNet
roles, the VAE decoder (plus an optional EMA decoder pair) and the HiFi-GAN
vocoder, with the text-encoding, UNet-query and decode helpers that
generation uses.

UNet roles follow the reference naming: `student`, `student_target`,
`student_ema` (the guided UNet; `Pipeline.create` gives them one shared
module, as the JAX package's `init_params` gives them one tree) and
`teacher` (the plain UNet, created only when asked for).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from consistencytta_torch.configs import PipelineConfig, UNetConfig
from consistencytta_torch.nn.hifigan import HiFiGANGenerator, vocoder_postprocess
from consistencytta_torch.nn.t5 import T5Encoder
from consistencytta_torch.nn.unet import UNet2DConditionGuided
from consistencytta_torch.nn.vae import AutoencoderKLDecoder
from consistencytta_torch.utils import cast_module, resolve_device

STUDENT_ROLES = ("student", "student_target", "student_ema")


class Pipeline:
    def __init__(self, config: PipelineConfig, unets: Dict[str, nn.Module],
                 vae: nn.Module, vocoder: nn.Module, t5: nn.Module,
                 device: torch.device, dtype: torch.dtype,
                 vae_ema: Optional[nn.Module] = None):
        self.config = config
        self.unets = unets
        self.vae = vae
        self.vae_ema = vae_ema
        self.vocoder = vocoder
        self.t5 = t5
        self.device = device
        self.dtype = dtype

    @classmethod
    def create(
        cls,
        config: PipelineConfig = PipelineConfig(),
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        seed: int = 0,
        roles: Sequence[str] = STUDENT_ROLES,
    ) -> "Pipeline":
        """Random-init every module from `seed` (torch's default inits),
        built directly on `device` and cast to `dtype` (normalization
        affines stay float32). Load real weights with `load_state_dict`."""
        dev = resolve_device(device)
        teacher_cfg = UNetConfig.from_dict({**config.unet.to_dict(), "guided": False})
        fork = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=fork), torch.device(dev):
            torch.manual_seed(seed)
            student = UNet2DConditionGuided(config.unet)
            unets = {r: student for r in roles if r in STUDENT_ROLES}
            if "teacher" in roles:
                unets["teacher"] = UNet2DConditionGuided(teacher_cfg)
            vae = AutoencoderKLDecoder(config.vae)
            vocoder = HiFiGANGenerator(config.vocoder)
            t5 = T5Encoder(config.t5)
        mods = [*unets.values(), vae, vocoder, t5]
        for m in mods:
            cast_module(m, dtype).eval().requires_grad_(False)
        return cls(config, unets, vae, vocoder, t5, dev, dtype)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    # -- text ---------------------------------------------------------------

    def encode_text(self, ids, mask) -> torch.Tensor:
        return self.t5(self._tensor(ids, torch.long), self._tensor(mask, torch.long))

    def encode_text_cfg(
        self, ids, mask, uncond_ids, uncond_mask
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(embeds_cf [2B], mask_cf [2B], embeds [B], mask [B]) with the
        unconditional half first."""
        ids, mask = self._tensor(ids, torch.long), self._tensor(mask, torch.long)
        both_ids = torch.cat([self._tensor(uncond_ids, torch.long), ids])
        both_mask = torch.cat([self._tensor(uncond_mask, torch.long), mask])
        embeds_cf = self.t5(both_ids, both_mask)
        return embeds_cf, both_mask, embeds_cf[ids.shape[0]:], mask

    # -- UNet ---------------------------------------------------------------

    def query_student(self, z_scaled, t, text_embeds, text_mask, guidance,
                      role: str = "student_ema") -> torch.Tensor:
        return self.unets[role](z_scaled, t, text_embeds, text_mask, guidance)

    # -- decode -------------------------------------------------------------

    def decode_latents(self, z_scaled: torch.Tensor, chunk: Optional[int] = None,
                       use_ema_decoder: bool = False) -> torch.Tensor:
        """scaled latent NHWC [B, t, f, c] -> waveform [B, samples], float32.

        `use_ema_decoder` decodes through `vae_ema` when one is loaded (a
        missing EMA pair falls back to the plain decoder, as in the
        reference). `chunk` decodes in batch sub-chunks to bound the peak
        activation memory; the DC centring stays batch-global, so chunked
        and whole results are the same."""
        vae = self.vae_ema if use_ema_decoder and self.vae_ema is not None else self.vae

        def decode_one(z):
            mel = vae.decode_first_stage(z)  # [b, T, F, 1]
            return self.vocoder(mel[..., 0].transpose(1, 2))

        b = z_scaled.shape[0]
        if chunk and 0 < chunk < b and b % chunk == 0:
            wav = torch.cat([decode_one(z) for z in z_scaled.split(chunk)])
        else:
            wav = decode_one(z_scaled)
        return vocoder_postprocess(wav).float()

    def latent_shape(self, batch: int) -> Tuple[int, int, int, int]:
        ls = self.config.latent
        return (batch, ls.t, ls.f, ls.c)
