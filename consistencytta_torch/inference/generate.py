"""End-to-end generation: tokens -> T5 -> consistency UNet -> VAE decode ->
HiFi-GAN -> waveform, 1-NFE by default; plus the two multi-step samplers of
the test-set CLI: the CFG teacher (`build_teacher_generate_fn`, Heun or
DDIM) and the stage-1 guided student (`build_guided_student_generate_fn`).

Multi-step consistency sampling re-noises at the coarser num_steps
schedule's unique timesteps [1:] and queries again; `guidance_post > 1`
adds external classifier-free guidance on the student (the batch is doubled
inside each query, unconditional half first).

Random draws: the initial latent noise and one `eps` per refinement step
come either from the caller (`noise=`, `eps=`, standard normal tensors)
or from `torch.randn` with the caller's `generator`. The multi-step
samplers draw only the initial noise.

Each call of a built function is one root `generate` span
(`utils.span`), around the pipeline's `t5`, `unet`, `vae_decode` and
`vocoder` spans.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.ops.schedulers import make_ddim_schedule, make_heun_schedule
from consistencytta_torch.utils import span


@dataclass(frozen=True)
class GenerateConfig:
    num_steps: int = 1
    guidance_post: float = 1.0  # > 1 enables external CFG on the student
    use_ema: bool = True  # query student_ema (else student_target)
    use_edm: bool = True  # Heun/EDM schedule (else DDIM)
    init_steps: int = 18  # the first query uses the 18-step schedule
    truncate_seconds: Optional[float] = 10.0
    use_karras: bool = False
    decode_chunk: Optional[int] = None
    use_ema_decoder: Optional[bool] = None  # None follows use_ema


def _guidance(guidance, b: int, dev) -> torch.Tensor:
    return torch.as_tensor(guidance, dtype=torch.float32, device=dev).reshape(-1).expand(b)


def _initial_noise(pipeline: Pipeline, b: int, generator, noise) -> torch.Tensor:
    dev = pipeline.device
    if noise is None:
        return torch.randn(pipeline.latent_shape(b), generator=generator, device=dev)
    return noise.to(dev, torch.float32)


def _truncate(pipeline: Pipeline, wav: torch.Tensor, seconds: Optional[float]) -> torch.Tensor:
    if seconds is None:
        return wav
    return wav[:, : int(pipeline.config.sample_rate * seconds)]


def _generate_span(fn: Callable) -> Callable:
    """Each call of a built generate function is one root `generate` span."""
    @functools.wraps(fn)
    def call(ids, *args, **kwargs):
        with span("generate"):
            return fn(ids, *args, **kwargs)
    return call


def _solve(sched, use_edm: bool, noise: torch.Tensor, query: Callable) -> torch.Tensor:
    """The multi-step samplers' loop from standard-normal `noise`: Heun over
    the schedule's intervals then its final Euler step, or DDIM over its
    timesteps; `query(z_scaled, t)` returns the model output at t [B]."""
    if use_edm:
        return sched.sample_loop(noise * sched.init_noise_sigma,
                                 lambda z_scaled, t, sigma: query(z_scaled, t))
    z = noise
    for t_scalar in sched.timesteps:
        t = torch.full((z.shape[0],), int(t_scalar), dtype=torch.int32, device=z.device)
        z = sched.step(query(z, t.float()), t, z)
    return z


def build_generate_fn(pipeline: Pipeline, gen: GenerateConfig = GenerateConfig()) -> Callable:
    """Returns generate(ids, mask, uncond_ids, uncond_mask, guidance,
    generator=None, noise=None, eps=None) -> waveform [B, samples] float32."""
    sched_cfg = pipeline.config.scheduler
    use_cfg_post = gen.guidance_post > 1.0
    if gen.use_edm:
        sched_init = make_heun_schedule(sched_cfg, gen.init_steps, gen.use_karras)
        sched_multi = (make_heun_schedule(sched_cfg, gen.num_steps, gen.use_karras)
                       if gen.num_steps > 1 else None)
    else:
        sched_init = make_ddim_schedule(sched_cfg, gen.init_steps)
        sched_multi = (make_ddim_schedule(sched_cfg, gen.num_steps)
                       if gen.num_steps > 1 else None)
    role = "student_ema" if gen.use_ema else "student_target"
    ema_dec = gen.use_ema if gen.use_ema_decoder is None else gen.use_ema_decoder
    dev = pipeline.device

    def calc_zhat_0(z_n, t, level, text, text_mask, guidance):
        if use_cfg_post:
            z_in, t_in, level_in, g_in = (
                torch.cat([a, a]) for a in (z_n, t, level, guidance)
            )
        else:
            z_in, t_in, level_in, g_in = z_n, t, level, guidance
        z_scaled = sched_init.scale_model_input(z_in, level_in)
        zhat_0 = pipeline.query_student(z_scaled, t_in, text, text_mask, g_in, role)
        if use_cfg_post:
            uncond, cond = zhat_0.chunk(2)
            zhat_0 = (1.0 - gen.guidance_post) * uncond + gen.guidance_post * cond
        return zhat_0

    def full(b, value, dtype):
        return torch.full((b,), value, dtype=dtype, device=dev)

    def levels(sched, i, b):
        if gen.use_edm:
            t = full(b, float(sched.timesteps[i]), torch.float32)
            return t, full(b, float(sched.sigmas[i]), torch.float32)
        t = full(b, int(sched.timesteps[i]), torch.int32)
        return t, t

    @_generate_span
    @torch.no_grad()
    def generate(ids, mask, uncond_ids, uncond_mask, guidance,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 eps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        b = ids.shape[0]
        guidance = _guidance(guidance, b, dev)
        if use_cfg_post:
            text, text_mask, _, _ = pipeline.encode_text_cfg(ids, mask, uncond_ids, uncond_mask)
        else:
            text = pipeline.encode_text(ids, mask)
            text_mask = torch.as_tensor(mask, device=dev)

        shape = pipeline.latent_shape(b)
        z_n = _initial_noise(pipeline, b, generator, noise) * sched_init.init_noise_sigma
        t0, level0 = levels(sched_init, 0, b)
        zhat_0 = calc_zhat_0(z_n, t0, level0, text, text_mask, guidance)

        for i in range(1, gen.num_steps):
            t_i, level_i = levels(sched_multi, i, b)
            if eps is not None:
                e = eps[i - 1].to(dev, torch.float32)
            else:
                e = torch.randn(shape, generator=generator, device=dev)
            z_n = sched_multi.add_noise(zhat_0, e, level_i)
            zhat_0 = calc_zhat_0(z_n, t_i, level_i, text, text_mask, guidance)

        wav = pipeline.decode_latents(zhat_0, chunk=gen.decode_chunk,
                                      use_ema_decoder=ema_dec)
        return _truncate(pipeline, wav, gen.truncate_seconds)

    return generate


def build_guided_student_generate_fn(
    pipeline: Pipeline,
    num_steps: int = 20,
    guidance_post: float = 1.0,
    use_ema: bool = True,
    use_edm: bool = False,
    truncate_seconds: Optional[float] = 10.0,
) -> Callable:
    """Multi-step denoising with the stage-1 guided student (the reference's
    AudioGDM inference): the guidance weight goes into the UNet, and with
    `guidance_post > 1` an external CFG mix uncond + w (cond - uncond) is
    applied on top. DDIM by default (num_steps queries), Heun with `use_edm`
    (2 num_steps - 1 queries). Queries `student_ema` (else `student`).

    Returns generate(ids, mask, uncond_ids, uncond_mask, guidance,
    generator=None, noise=None) -> waveform [B, samples] float32."""
    sched_cfg = pipeline.config.scheduler
    use_cfg_post = guidance_post > 1.0
    role = "student_ema" if use_ema else "student"
    sched = (make_heun_schedule(sched_cfg, num_steps) if use_edm
             else make_ddim_schedule(sched_cfg, num_steps))
    dev = pipeline.device

    @_generate_span
    @torch.no_grad()
    def generate(ids, mask, uncond_ids, uncond_mask, guidance,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = ids.shape[0]
        guidance = _guidance(guidance, b, dev)
        if use_cfg_post:
            text, text_mask, _, _ = pipeline.encode_text_cfg(ids, mask, uncond_ids, uncond_mask)
        else:
            text = pipeline.encode_text(ids, mask)
            text_mask = torch.as_tensor(mask, device=dev)

        def query(z_scaled, t):
            if use_cfg_post:
                pred = pipeline.query_student(torch.cat([z_scaled, z_scaled]), torch.cat([t, t]),
                                              text, text_mask, torch.cat([guidance, guidance]),
                                              role)
                uncond, cond = pred.chunk(2)
                return uncond + guidance_post * (cond - uncond)
            return pipeline.query_student(z_scaled, t, text, text_mask, guidance, role)

        z0 = _solve(sched, use_edm, _initial_noise(pipeline, b, generator, noise), query)
        return _truncate(pipeline, pipeline.decode_latents(z0), truncate_seconds)

    return generate


def build_teacher_generate_fn(
    pipeline: Pipeline,
    num_steps: int = 18,
    use_edm: bool = True,
    use_karras: bool = False,
    truncate_seconds: Optional[float] = 10.0,
) -> Callable:
    """Multi-step CFG sampling with the teacher UNet (the LightweightLDM
    baseline): every query runs the stacked [uncond; cond] batch through the
    teacher (`Pipeline.query_teacher_cfg`, so the UNet sees batch 2B).
    Heun (2 num_steps - 1 queries) by default, DDIM (num_steps) without
    `use_edm`. The pipeline must hold the "teacher" role.

    Returns generate(ids, mask, uncond_ids, uncond_mask, guidance,
    generator=None, noise=None) -> waveform [B, samples] float32."""
    if "teacher" not in pipeline.unets:
        raise ValueError('the pipeline has no teacher: create it with roles=(..., "teacher")')
    sched_cfg = pipeline.config.scheduler
    sched = (make_heun_schedule(sched_cfg, num_steps, use_karras) if use_edm
             else make_ddim_schedule(sched_cfg, num_steps))
    dev = pipeline.device

    @_generate_span
    @torch.no_grad()
    def generate(ids, mask, uncond_ids, uncond_mask, guidance,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = ids.shape[0]
        guidance = _guidance(guidance, b, dev)
        text_cf, mask_cf, _, _ = pipeline.encode_text_cfg(ids, mask, uncond_ids, uncond_mask)

        def query(z_scaled, t):
            return pipeline.query_teacher_cfg(z_scaled, t, text_cf, mask_cf, guidance)

        z0 = _solve(sched, use_edm, _initial_noise(pipeline, b, generator, noise), query)
        return _truncate(pipeline, pipeline.decode_latents(z0), truncate_seconds)

    return generate
