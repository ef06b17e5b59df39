"""Train and validation steps of the distillation recipe.

  * build_guided_train_step / build_guided_validation_step: stage 1, the CFG
    teacher's prediction distilled into the guidance-conditioned student at
    uniformly sampled DDPM timesteps;
  * build_consistency_train_step: stage 2, consistency distillation along
    one solver interval of the CFG teacher (a Heun interval with `use_edm`,
    else a DDIM step), against an EMA target network;
  * build_validation_step: the 4-loss stage-2 validation with the full
    teacher rollout, for either solver.

One step does: waveform -> mel (kernel K4 on the card) -> VAE encoder ->
sampled latent; T5 on [uncond; cond]; the frozen teacher and target queries
under `no_grad`; the trainable student with gradients; per-instance loss
times min-SNR weights; AdamW; the EMA updates. Gradient accumulation is a
loop over micro-batches inside the step, so the EMA update happens once per
optimizer step. A non-finite loss or gradient leaves the student and the
optimizer untouched, while the step count still advances and the EMAs still
update. The state is updated in place.

Random draws come from an explicit `torch.Generator` on the pipeline's
device, or are passed in as tensors (`draws`), which is how the tests feed
this package and the JAX package the same numbers. A rank of a
data-parallel run passes a `parallel.mesh.RankGenerator`: each draw is then
made at the global micro-batch and the rank keeps its rows, so that a row's
noise is the single-rank run's. Keys of `draws`:
`posterior_noise` (the latent's shape), `eps` (the same), `w` [B] (uniform
in [0, 1), before the scaling by `max_rand_guidance_scale`), `u` [B] (stage
2: schedule index) or `t` [B] (stage 1: DDPM timestep), `drop` [B] bool
(`uncondition`). With `accum_steps` > 1, `draws` is a list with one
such dict per micro-batch.

A ZeRO-1 state (`parallel/mesh.py:shard_train_state`, one rank of several)
takes the update through its `zero1`: the gradients and the loss averaged
over the ranks, the rank's share of AdamW and of the EMA shadows.

A LoRA state (`training/lora.py:init_lora_state`) holds rank-r factors in
its three roles and the frozen base student in `lora_base`; every query of
a role then runs the base with the factors merged in (`role_unet`).

The stage-2 step's per-instance loss is the latent MSE, or with
`loss_type` "mel" the mel loss through the frozen VAE decoder, or "stft" the
multi-resolution STFT loss on waveforms decoded through the frozen VAE and
vocoder (`training/losses.py`); `loss_fn_override` replaces it, which is how
stage 3's CLAP loss comes in (`training/clap_loss.py`). The FTVAE variant,
whose VAE decoder trains beside the student, is `training/ftvae.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.parallel.mesh import RankGenerator
from consistencytta_torch.ops.schedulers import (
    DDIMSchedule,
    DDPMSchedule,
    HeunSchedule,
    min_snr_weights_stage1,
    min_snr_weights_stage2,
)
from consistencytta_torch.training.ema import ema_update
from consistencytta_torch.training.losses import (
    MultiResolutionSTFTLoss,
    mel_loss_instance,
    mse_instance,
)
from consistencytta_torch.training.optim import OptimizerConfig, make_optimizer
from consistencytta_torch.utils import resolve_device

Batch = Dict[str, torch.Tensor]
Draws = Optional[Dict[str, torch.Tensor]]


@dataclass
class TrainState:
    """The trainable student, its two EMA shadows (modules of the pipeline,
    float32 parameters), the optimizer with its schedule, the step count."""

    step: int
    student: nn.Module
    student_target: Optional[nn.Module]
    student_ema: nn.Module
    optimizer: torch.optim.Optimizer
    lr_scheduler: torch.optim.lr_scheduler.LambdaLR
    max_grad_norm: Optional[float] = None
    lora_base: Optional[nn.Module] = None  # set for a LoRA state: the frozen student
    zero1: Optional[object] = None  # a rank's ZeRO-1 update (parallel/mesh.py)

    @classmethod
    def create(cls, pipeline: Pipeline, config: OptimizerConfig = OptimizerConfig(),
               with_target: bool = True) -> "TrainState":
        """From a pipeline made with `training=True`."""
        unets = pipeline.unets
        student = unets["student"]
        shadows = [unets["student_ema"]] + ([unets["student_target"]] if with_target else [])
        if any(s is student for s in shadows):
            raise ValueError("the student roles share a module: create the pipeline with training=True")
        for m in (student, *shadows):
            if any(p.dtype != torch.float32 for p in m.parameters()):
                raise ValueError("trainable and EMA parameters must be float32")
        # every leaf, the frozen Fourier projection too: see guarded_update
        optimizer, lr_scheduler = make_optimizer(list(student.parameters()), config)
        return cls(0, student, unets["student_target"] if with_target else None,
                   unets["student_ema"], optimizer, lr_scheduler, config.max_grad_norm)


@dataclass(frozen=True)
class ConsistencyStepConfig:
    """Static stage-2 options (the stage-2 recipe's defaults)."""

    snr_gamma: Optional[float] = 5.0
    teacher_guidance_scale: float = -1.0  # -1 -> w ~ Unif(0, max_rand)
    max_rand_guidance_scale: float = 6.0
    target_ema_decay: float = 0.95
    ema_decay: float = 0.999
    loss_type: str = "mse"  # mse | mel | stft (clap comes through loss_fn_override)
    use_edm: bool = True
    accum_steps: int = 1
    uncondition: bool = False  # drop 10% of the text conditions per micro-batch
    # recompute the trainable student's forward in the backward pass. Off by
    # default: in eager PyTorch nothing runs between the student's forward
    # and its backward, so the recomputation costs a forward and lowers no
    # peak (PERF.md, section 5); it pays only for a caller that holds other
    # activations across the step.
    remat_student: bool = False


@dataclass(frozen=True)
class GuidedStepConfig:
    """Static stage-1 options (the stage-1 recipe's defaults)."""

    snr_gamma: Optional[float] = 5.0
    teacher_guidance_scale: float = -1.0
    max_rand_guidance_scale: float = 6.0
    ema_decay: float = 0.999
    accum_steps: int = 1


LOSS_TYPES = ("mse", "mel", "stft")


def _check_solver(schedule, cfg: ConsistencyStepConfig) -> None:
    want = HeunSchedule if cfg.use_edm else DDIMSchedule
    if not isinstance(schedule, want):
        raise ValueError(f"use_edm={cfg.use_edm} takes a {want.__name__}, not "
                         f"{type(schedule).__name__}")
    if cfg.loss_type not in LOSS_TYPES:
        raise ValueError(f"unsupported loss type {cfg.loss_type!r}; choose one of {LOSS_TYPES} "
                         "(clap comes through loss_fn_override)")


def role_unet(state: TrainState, role: nn.Module):
    """What a query of `role` calls: the module itself, or for a LoRA state
    the frozen base with the role's factors merged in."""
    if state.lora_base is None:
        return role
    from consistencytta_torch.training.lora import LoRAUNet

    return LoRAUNet(state.lora_base, role)


class _Sampler:
    """The step's random draws: a tensor passed in under its name wins, else
    the generator draws on the device; a `RankGenerator` draws for the
    global micro-batch and keeps the rank's rows."""

    def __init__(self, device, generator, draws: Draws):
        self.ranks = generator if isinstance(generator, RankGenerator) else None
        if self.ranks is not None:
            generator = generator.generator
        self.device, self.generator, self.draws = device, generator, draws or {}

    def _rows(self, draw, b):
        return draw(b) if self.ranks is None else self.ranks.rows(draw, b)

    def _given(self, name, dtype):
        v = self.draws.get(name)
        return None if v is None else torch.as_tensor(v, device=self.device).to(dtype)

    def normal(self, name, shape):
        v = self._given(name, torch.float32)
        if v is None:
            v = self._rows(lambda n: torch.randn((n, *shape[1:]), generator=self.generator,
                                                 device=self.device), shape[0])
        return v

    def uniform(self, name, b):
        v = self._given(name, torch.float32)
        if v is None:
            v = self._rows(lambda n: torch.rand(n, generator=self.generator,
                                                device=self.device), b)
        return v

    def randint(self, name, b, high):
        v = self._given(name, torch.long)
        if v is None:
            v = self._rows(lambda n: torch.randint(0, high, (n,), generator=self.generator,
                                                   device=self.device), b)
        return v

    def bernoulli(self, name, b, p):
        v = self._given(name, torch.bool)
        if v is None:
            v = self._rows(lambda n: torch.rand(n, generator=self.generator,
                                                device=self.device), b) < p
        return v

    def encode(self, pipeline: Pipeline, wav) -> torch.Tensor:
        """The sampled latent of `wav`: the posterior noise given, else drawn
        here for a rank (at the global micro-batch), else by the encoder."""
        noise = self.draws.get("posterior_noise")
        if noise is None and self.ranks is not None:
            noise = self.normal("posterior_noise", pipeline.latent_shape(len(wav)))
        return pipeline.encode_audio(wav, noise=noise, generator=self.generator)


def _rows(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-sample condition [B], shaped to broadcast against `like`."""
    return cond.reshape((-1,) + (1,) * (like.ndim - 1))


def _text(pipeline: Pipeline, micro: Batch):
    long = lambda k: torch.as_tensor(micro[k], device=pipeline.device).long()
    return long("ids"), long("mask"), long("uncond_ids"), long("uncond_mask")


def _guidance(sampler: _Sampler, cfg, b: int) -> torch.Tensor:
    """Per-sample w ~ Unif(0, max_rand), or the fixed teacher scale."""
    if cfg.teacher_guidance_scale == -1.0:
        return sampler.uniform("w", b) * cfg.max_rand_guidance_scale
    return torch.full((b,), cfg.teacher_guidance_scale, device=sampler.device)


def consistency_forward(
    pipeline: Pipeline,
    schedule,
    cfg: ConsistencyStepConfig,
    student,
    target,
    micro: Batch,
    generator: Optional[torch.Generator] = None,
    draws: Draws = None,
):
    """The stage-2 forward: sample adjacent solver steps, noise the latent,
    run one interval of the CFG teacher (Heun with `use_edm`, else one DDIM
    step), evaluate the target network (ground truth where t_next == 0) and
    the student. `student` and `target` are UNets or what `role_unet` gives.

    Returns (student prediction from t_{n+1}, target from t_n, snr [B]);
    only the first carries gradients."""
    _check_solver(schedule, cfg)
    dev = pipeline.device
    sampler = _Sampler(dev, generator, draws)
    ids, mask, uids, umask = _text(pipeline, micro)
    b = ids.shape[0]
    if cfg.uncondition:
        drop = sampler.bernoulli("drop", b, 0.1)[:, None]
        ids, mask = torch.where(drop, uids, ids), torch.where(drop, umask, mask)
    n = schedule.num_steps if cfg.use_edm else schedule.num_inference_steps

    with torch.no_grad():
        z0 = sampler.encode(pipeline, micro["wav"])
        text_cf, mask_cf, text, mask_c = pipeline.encode_text_cfg(ids, mask, uids, umask)
        # adjacent solver steps t_{n+1} = t[u], t_n = t[u + 1]
        u = sampler.randint("u", b, n - 1)
        w = _guidance(sampler, cfg, b)
        eps = sampler.normal("eps", z0.shape)
        timesteps = torch.as_tensor(schedule.timesteps, device=dev)
        t_u, t_next = timesteps[u], timesteps[u + 1]
        first = _rows(u == 0, z0)

        if cfg.use_edm:
            sigmas = torch.as_tensor(schedule.sigmas, device=dev)
            sigma_u, sigma_next = sigmas[u], sigmas[u + 1]
            z_noisy = schedule.add_noise(z0, eps, sigma_u)
            # the first step starts from pure noise
            z_np1 = torch.where(first, eps * schedule.init_noise_sigma, z_noisy)

            def teacher_fn(z_scaled, t, sigma):
                return pipeline.query_teacher_cfg(z_scaled, t, text_cf, mask_cf, w)

            zhat_n, _ = schedule.heun_pair(z_np1, sigma_u, sigma_next, teacher_fn, t_u, t_next)
            z_np1_scaled = schedule.scale_model_input(z_np1, sigma_u)
            zhat_n_scaled = schedule.scale_model_input(zhat_n, sigma_next)
            snr = schedule.snr(u)
        else:
            z_noisy = schedule.add_noise(z0, eps, t_u)
            z_np1 = torch.where(first, eps, z_noisy)
            eps_pred = pipeline.query_teacher_cfg(z_np1, t_u, text_cf, mask_cf, w)
            zhat_n = schedule.step(eps_pred, t_u, z_np1)
            z_np1_scaled, zhat_n_scaled = z_np1, zhat_n
            snr = schedule.snr(t_u)

        # target network on the teacher-stepped latent; ground truth at t = 0
        zhat_0_from_n = pipeline.query_unet(target, zhat_n_scaled, t_next, text, mask_c, w)
        zhat_0_from_n = torch.where(_rows(t_next == 0, z0), z0, zhat_0_from_n)

    # trainable student on the noisier latent
    args = (student, z_np1_scaled, t_u, text, mask_c, w)
    if cfg.remat_student and torch.is_grad_enabled():
        zhat_0_from_np1 = checkpoint(pipeline.query_unet, *args, use_reentrant=False)
    else:
        zhat_0_from_np1 = pipeline.query_unet(*args)
    return zhat_0_from_np1, zhat_0_from_n, snr


def accumulate_gradients(state: TrainState, micro_loss: Callable, batch: Batch, accum: int,
                generator, draws) -> torch.Tensor:
    """Gradients of the mean of `micro_loss` over `accum` micro-batches, left
    in the student's `.grad`; returns that mean loss (detached)."""
    state.optimizer.zero_grad(set_to_none=True)
    if accum == 1:
        loss = micro_loss(batch, generator, draws)
        loss.backward()
        return loss.detach()
    if draws is not None and len(draws) != accum:
        raise ValueError(f"draws must be a list of {accum} dicts, one per micro-batch")
    micros = [{} for _ in range(accum)]
    for key, value in batch.items():
        for m, part in zip(micros, torch.as_tensor(value).chunk(accum)):
            m[key] = part
    total = 0.0
    for i, micro in enumerate(micros):
        loss = micro_loss(micro, generator, draws[i] if draws is not None else None) / accum
        loss.backward()
        total = total + loss.detach()
    return total


def guarded_update(state: TrainState, loss: torch.Tensor) -> bool:
    """One optimizer update from the accumulated gradients, unless the loss
    or a gradient is non-finite: then student and optimizer stay as they
    are. Returns whether the update was taken. A ZeRO-1 state takes the
    rank's part of it (`parallel.mesh.Zero1.update`), from the gradients
    and the loss averaged over the ranks (`loss` is overwritten with that
    mean), so that every rank takes or skips it alike.

    A frozen leaf of the student (the Fourier guidance projection) takes the
    update of a zero gradient, as in the JAX package, which stops that
    gradient but keeps the leaf in AdamW: the moments stay zero and the
    decoupled weight decay still shrinks it by lr * weight_decay."""
    if state.zero1 is not None:
        return state.zero1.update(state, loss)
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None and not p.requires_grad:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params if p.grad is not None]
    checks = torch.stack([loss.float(), *torch._foreach_norm(grads)])
    finite = bool(torch.isfinite(checks).all())
    if finite:
        if state.max_grad_norm is not None:
            torch.nn.utils.clip_grad_norm_(params, state.max_grad_norm)
        state.optimizer.step()
        state.lr_scheduler.step()
    state.optimizer.zero_grad(set_to_none=True)
    return finite


def build_instance_loss(pipeline: Pipeline, loss_type: str) -> Callable:
    """instance_loss(pred, target, micro) -> [B] for a `loss_type` of
    LOSS_TYPES (the JAX build_consistency_train_step's dispatch): the latent
    MSE; "mel", the mel loss through the frozen VAE decoder; "stft", the
    multi-resolution STFT loss on waveforms through the frozen decoder and
    vocoder. Gradients flow through the decoders to the prediction only."""
    if loss_type == "mel":
        decode = lambda z: pipeline.decode_mel(pipeline.vae, z)
        return lambda pred, target, micro: mel_loss_instance(pred, target, decode)
    if loss_type == "stft":
        stft_loss = MultiResolutionSTFTLoss(sr=pipeline.config.sample_rate)
        return lambda pred, target, micro: stft_loss(pred, target, pipeline.decode_latents)
    return lambda pred, target, micro: mse_instance(pred, target)


def build_consistency_train_step(
    pipeline: Pipeline,
    schedule,
    cfg: ConsistencyStepConfig = ConsistencyStepConfig(),
    loss_fn_override: Optional[Callable] = None,
) -> Callable:
    """Returns step(state, batch, generator=None, draws=None) -> metrics.

    batch: dict with wav [B, S], ids / mask / uncond_ids / uncond_mask
    [B, L]; B = accum_steps * micro_batch. `loss_fn_override(pred, target,
    micro)` replaces the per-instance loss of `cfg.loss_type`. `schedule` is
    a HeunSchedule with `cfg.use_edm`, else a DDIMSchedule. The state is
    updated in place."""
    _check_solver(schedule, cfg)
    resolve_device(pipeline.device)
    instance_loss = loss_fn_override or build_instance_loss(pipeline, cfg.loss_type)

    def step(state: TrainState, batch: Batch, generator=None, draws=None):
        def micro_loss(micro, generator, draws):
            pred, target, snr = consistency_forward(
                pipeline, schedule, cfg, role_unet(state, state.student),
                role_unet(state, state.student_target), micro, generator, draws,
            )
            inst = instance_loss(pred, target, micro)
            if cfg.snr_gamma is not None:
                inst = inst * min_snr_weights_stage2(snr, cfg.snr_gamma)
            return inst.mean()

        loss = accumulate_gradients(state, micro_loss, batch, cfg.accum_steps, generator, draws)
        finite = guarded_update(state, loss)
        ema_update(state.student_target, state.student, cfg.target_ema_decay)
        ema_update(state.student_ema, state.student, cfg.ema_decay)
        state.step += 1
        return {"loss": loss, "loss_finite": finite}

    return step


def build_validation_step(
    pipeline: Pipeline,
    schedule,
    cfg: ConsistencyStepConfig = ConsistencyStepConfig(),
) -> Callable:
    """Stage-2 validation: start at t_0 (pure noise), run the teacher all the
    way to t = 0, and compare the target network's two estimates along the
    first interval with each other, the ground truth and the teacher. Takes
    the solver of the schedule: Heun intervals for a HeunSchedule, DDIM
    steps for a DDIMSchedule.

    Returns validate(state, batch, generator=None, draws=None) ->
    dict(loss_w_gt, loss_w_teacher, loss_consistency, loss_teacher)."""
    heun = isinstance(schedule, HeunSchedule)
    if not heun and not isinstance(schedule, DDIMSchedule):
        raise ValueError(f"validation takes a HeunSchedule or a DDIMSchedule, not "
                         f"{type(schedule).__name__}")
    resolve_device(pipeline.device)

    @torch.no_grad()
    def validate(state: TrainState, batch: Batch, generator=None, draws=None):
        dev = pipeline.device
        sampler = _Sampler(dev, generator, draws)
        ids, mask, uids, umask = _text(pipeline, batch)
        b = ids.shape[0]
        z0 = sampler.encode(pipeline, batch["wav"])
        text_cf, mask_cf, text, mask_c = pipeline.encode_text_cfg(ids, mask, uids, umask)
        w = _guidance(sampler, cfg, b)
        eps = sampler.normal("eps", z0.shape)
        z_np1 = eps * schedule.init_noise_sigma
        target = role_unet(state, state.student_target)

        if heun:
            def teacher_fn(z_scaled, t, sigma):
                return pipeline.query_teacher_cfg(z_scaled, t, text_cf, mask_cf, w)

            t0, t1, s0, s1 = schedule.interval(0, b, dev)
            zhat_n, _ = schedule.heun_pair(z_np1, s0, s1, teacher_fn, t0, t1)
            z_np1_scaled = schedule.scale_model_input(z_np1, s0)
            zhat_n_scaled = schedule.scale_model_input(zhat_n, s1)
            # the teacher's rollout over the remaining intervals and the last step
            z_teacher_from = lambda z: schedule.sample_loop(z, teacher_fn, start=1)
            snr0 = schedule.snr(torch.zeros(b, dtype=torch.long, device=dev))
        else:
            full = lambda i: torch.full((b,), int(schedule.timesteps[i]), device=dev)
            t0, t1 = full(0), full(1)

            def ddim_step(z, t):
                return schedule.step(
                    pipeline.query_teacher_cfg(z, t, text_cf, mask_cf, w), t, z)

            zhat_n = ddim_step(z_np1, t0)
            z_np1_scaled, zhat_n_scaled = z_np1, zhat_n

            def z_teacher_from(z):  # DDIM steps over the remaining timesteps
                for i in range(1, schedule.num_inference_steps):
                    z = ddim_step(z, full(i))
                return z

            snr0 = schedule.snr(t0)

        # the target network's estimates from both ends of the first interval
        zhat0_from_np1 = pipeline.query_unet(target, z_np1_scaled, t0, text, mask_c, w)
        zhat0_from_n = pipeline.query_unet(target, zhat_n_scaled, t1, text, mask_c, w)
        z_teacher = z_teacher_from(zhat_n)

        inst = mse_instance(zhat0_from_np1, zhat0_from_n)
        if cfg.snr_gamma is not None:
            inst = inst * min_snr_weights_stage2(snr0, cfg.snr_gamma)
        return {
            "loss_w_gt": mse_instance(zhat0_from_np1, z0).mean(),
            "loss_w_teacher": mse_instance(zhat0_from_np1, z_teacher).mean(),
            "loss_consistency": inst.mean(),
            "loss_teacher": mse_instance(z_teacher, z0).mean(),
        }

    return validate


def guided_distill_loss(
    pipeline: Pipeline,
    schedule: DDPMSchedule,
    cfg: GuidedStepConfig,
    student: nn.Module,
    micro: Batch,
    generator: Optional[torch.Generator] = None,
    draws: Draws = None,
) -> torch.Tensor:
    """The stage-1 loss: the CFG teacher's prediction distilled into the
    guidance-conditioned student at uniformly sampled DDPM timesteps."""
    dev = pipeline.device
    sampler = _Sampler(dev, generator, draws)
    n_train = schedule.num_train_timesteps
    ids, mask, uids, umask = _text(pipeline, micro)
    b = ids.shape[0]
    with torch.no_grad():
        z0 = sampler.encode(pipeline, micro["wav"])
        text_cf, mask_cf, text, mask_c = pipeline.encode_text_cfg(ids, mask, uids, umask)
        t = sampler.randint("t", b, n_train)
        eps = sampler.normal("eps", z0.shape)
        z_noisy = schedule.add_noise(z0, eps, t)
        z_n = torch.where(_rows(t == n_train - 1, z0),
                          eps * schedule.init_noise_sigma, z_noisy)
        w = _guidance(sampler, cfg, b)
        teacher_pred = pipeline.query_teacher_cfg(z_n, t.float(), text_cf, mask_cf, w)
    student_pred = pipeline.query_unet(student, z_n, t.float(), text, mask_c, w)
    inst = mse_instance(student_pred, teacher_pred)
    if cfg.snr_gamma is not None:
        inst = inst * min_snr_weights_stage1(
            schedule.snr(t), cfg.snr_gamma, schedule.prediction_type
        )
    return inst.mean()


def build_guided_validation_step(
    pipeline: Pipeline, schedule: DDPMSchedule, cfg: GuidedStepConfig = GuidedStepConfig()
) -> Callable:
    """Stage-1 validation: the distillation loss on a held-out batch.
    Returns validate(state, batch, generator=None, draws=None) -> {val_loss}."""

    @torch.no_grad()
    def validate(state: TrainState, batch: Batch, generator=None, draws=None):
        loss = guided_distill_loss(pipeline, schedule, cfg, state.student, batch,
                                   generator, draws)
        return {"val_loss": loss}

    return validate


def build_guided_train_step(
    pipeline: Pipeline, schedule: DDPMSchedule, cfg: GuidedStepConfig = GuidedStepConfig()
) -> Callable:
    """Stage-1 step; returns step(state, batch, generator=None, draws=None)
    -> metrics. The target network, if the state has one, is left alone."""
    resolve_device(pipeline.device)

    def step(state: TrainState, batch: Batch, generator=None, draws=None):
        def micro_loss(micro, generator, draws):
            return guided_distill_loss(pipeline, schedule, cfg, state.student, micro,
                                       generator, draws)

        loss = accumulate_gradients(state, micro_loss, batch, cfg.accum_steps, generator, draws)
        finite = guarded_update(state, loss)
        ema_update(state.student_ema, state.student, cfg.ema_decay)
        state.step += 1
        return {"loss": loss, "loss_finite": finite}

    return step
