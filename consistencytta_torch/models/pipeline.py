"""The model bundle: the T5 encoder, the UNet roles, the VAE (plus an
optional EMA decoder pair), the HiFi-GAN vocoder and the mel frontend, with
the text-encoding, UNet-query, audio-encoding and decode helpers that
generation and training use.

UNet roles follow the reference naming: `student`, `student_target`,
`student_ema` (the guided UNet) and `teacher` (the plain UNet, created only
when asked for). For generation `Pipeline.create` gives the three student
roles one shared frozen module in the compute dtype. With `training=True`
they are three modules with equal initial values and float32 parameters (an
EMA decay of 0.999 is below bf16's resolution), `student` trainable; such a
module is queried under autocast, so that its matrix products and the
attention kernels still run in the compute dtype. The frozen modules
(teacher, T5, VAE, vocoder) hold their weights in the compute dtype.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from consistencytta_torch.configs import PipelineConfig, UNetConfig
from consistencytta_torch.nn.embeddings import GaussianFourierProjection
from consistencytta_torch.nn.hifigan import HiFiGANGenerator, vocoder_postprocess
from consistencytta_torch.nn.t5 import T5Encoder
from consistencytta_torch.nn.unet import UNet2DConditionGuided
from consistencytta_torch.nn.vae import AutoencoderKL
from consistencytta_torch.ops.stft import MelFrontend
from consistencytta_torch.utils import cast_module, resolve_device, span

STUDENT_ROLES = ("student", "student_target", "student_ema")


def set_trainable(unet: nn.Module) -> nn.Module:
    """Make a UNet's parameters require grad, except the Fourier guidance
    projection, which the reference keeps frozen."""
    unet.requires_grad_(True)
    for m in unet.modules():
        if isinstance(m, GaussianFourierProjection):
            m.requires_grad_(False)
    return unet


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
        self.frontend = MelFrontend(config.stft, device=device)

    @classmethod
    def create(
        cls,
        config: PipelineConfig = PipelineConfig(),
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        seed: int = 0,
        roles: Sequence[str] = STUDENT_ROLES,
        training: bool = False,
    ) -> "Pipeline":
        """Random-init every module from `seed` (torch's default inits),
        built directly on `device` and cast to `dtype` (normalization
        affines stay float32). Load real weights with `load_state_dict`.
        `training` gives each student role asked for its own float32 module
        (equal values; `student` requires grad) instead of one shared frozen
        module in `dtype`."""
        dev = resolve_device(device)
        teacher_cfg = UNetConfig.from_dict({**config.unet.to_dict(), "guided": False})
        fork = [dev] if dev.type == "cuda" else []
        with torch.random.fork_rng(devices=fork), torch.device(dev):
            torch.manual_seed(seed)
            student = UNet2DConditionGuided(config.unet)
            teacher = UNet2DConditionGuided(teacher_cfg) if "teacher" in roles else None
            vae = AutoencoderKL(config.vae)
            vocoder = HiFiGANGenerator(config.vocoder)
            t5 = T5Encoder(config.t5)
        student.eval().requires_grad_(False)
        student_roles = [r for r in roles if r in STUDENT_ROLES]
        if training:
            unets = {r: student if i == 0 else copy.deepcopy(student)
                     for i, r in enumerate(student_roles)}
            if "student" in unets:
                set_trainable(unets["student"])
        else:
            unets = {r: cast_module(student, dtype) for r in student_roles}
        frozen = [vae, vocoder, t5]
        if teacher is not None:
            unets["teacher"] = teacher
            frozen.append(teacher)
        for m in frozen:
            cast_module(m, dtype).eval().requires_grad_(False)
        return cls(config, unets, vae, vocoder, t5, dev, dtype)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    # -- text ---------------------------------------------------------------

    def encode_text(self, ids, mask) -> torch.Tensor:
        with span("t5"):
            return self.t5(self._tensor(ids, torch.long), self._tensor(mask, torch.long))

    def encode_text_cfg(
        self, ids, mask, uncond_ids, uncond_mask
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """(embeds_cf [2B], mask_cf [2B], embeds [B], mask [B]) with the
        unconditional half first."""
        with span("t5"):
            ids, mask = self._tensor(ids, torch.long), self._tensor(mask, torch.long)
            both_ids = torch.cat([self._tensor(uncond_ids, torch.long), ids])
            both_mask = torch.cat([self._tensor(uncond_mask, torch.long), mask])
            embeds_cf = self.t5(both_ids, both_mask)
        return embeds_cf, both_mask, embeds_cf[ids.shape[0]:], mask

    # -- UNet ---------------------------------------------------------------

    def query_unet(self, unet: nn.Module, *args) -> torch.Tensor:
        """Call a UNet; one that holds float32 weights under a lower compute
        dtype on the card (a training role) runs under autocast."""
        autocast = (self.device.type == "cuda" and self.dtype != torch.float32
                    and unet.conv_in.weight.dtype == torch.float32)
        with span("unet"), \
                torch.autocast("cuda", dtype=self.dtype, enabled=autocast):
            return unet(*args)

    def query_student(self, z_scaled, t, text_embeds, text_mask, guidance,
                      role: str = "student_ema") -> torch.Tensor:
        return self.query_unet(self.unets[role], z_scaled, t, text_embeds, text_mask, guidance)

    def query_teacher_cfg(self, z_scaled, t, text_embeds_cf, text_mask_cf,
                          guidance_scale) -> torch.Tensor:
        """CFG teacher query: the stacked [uncond; cond] batch through the
        plain teacher UNet, then (1 - w) * uncond + w * cond with a
        per-sample w [B] (or a scalar)."""
        b = z_scaled.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device).reshape(-1).expand(b)
        pred = self.query_unet(self.unets["teacher"], torch.cat([z_scaled, z_scaled]),
                               torch.cat([t, t]), text_embeds_cf, text_mask_cf)
        uncond, cond = pred[:b], pred[b:]
        w = torch.as_tensor(guidance_scale, dtype=pred.dtype, device=self.device)
        w = w.reshape((-1,) + (1,) * (pred.ndim - 1))
        return (1.0 - w) * uncond + w * cond

    # -- encode (training) --------------------------------------------------

    def encode_audio(self, wav, noise=None, generator=None) -> torch.Tensor:
        """waveform [B, samples] -> scaled sampled latent NHWC [B, t, f, c]:
        mel frontend (kernel K4 on the card), VAE encoder, posterior sample
        with `noise` (standard normal, the latent's shape) or `generator`."""
        mel_img = self.frontend.wav_to_mel_image(
            self._tensor(wav, torch.float32), self.config.target_mel_frames
        )
        return self.vae.encode_to_latent(mel_img, noise, generator)

    # -- decode -------------------------------------------------------------

    def decode_mel(self, vae: nn.Module, z_scaled: torch.Tensor) -> torch.Tensor:
        """scaled latent NHWC -> mel image NHWC through the decoder pair `vae`;
        a pair that holds float32 weights under a lower compute dtype on the
        card (the stage-3 FTVAE decoder in training) runs under autocast."""
        autocast = (self.device.type == "cuda" and self.dtype != torch.float32
                    and vae.post_quant_conv.weight.dtype == torch.float32)
        with span("vae_decode"), \
                torch.autocast("cuda", dtype=self.dtype, enabled=autocast):
            return vae.decode_first_stage(z_scaled)

    def decode_latents(self, z_scaled: torch.Tensor, chunk: Optional[int] = None,
                       use_ema_decoder: bool = False,
                       decoder: Optional[nn.Module] = None) -> torch.Tensor:
        """scaled latent NHWC [B, t, f, c] -> waveform [B, samples], float32.

        `decoder` (a decoder pair: `decoder` + `post_quant_conv`) decodes in
        place of the pipeline's VAE: the stage-3 FTVAE step's trainable copy.
        `use_ema_decoder` decodes through `vae_ema` when one is loaded (a
        missing EMA pair falls back to the plain decoder, as in the
        reference). `chunk` decodes in batch sub-chunks to bound the peak
        activation memory; the DC centring stays batch-global, so chunked
        and whole results are the same."""
        vae = self.vae_ema if use_ema_decoder and self.vae_ema is not None else self.vae
        vae = decoder if decoder is not None else vae

        def decode_one(z):
            mel = self.decode_mel(vae, z)  # [b, T, F, 1]
            with span("vocoder"):
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
