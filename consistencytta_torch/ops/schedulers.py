"""Noise schedules: numpy table builders and the device-side ops that
consistency sampling and training use. Heun/EDM: scale_model_input,
add_noise, pred_x0, snr, the Euler step, one Heun interval (`heun_pair`)
and the full sampling loop. DDPM (stage-1 training): add_noise and snr.
DDIM: the tables, scale_model_input, add_noise, snr and the deterministic
(eta = 0) solver step that the teacher's and the guided student's DDIM
samplers take. Plus the min-SNR loss weights of both training stages.

Tables are built in numpy exactly as the JAX package builds them (float64
interpolation, float32 storage); the per-sample ops run on torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from consistencytta_torch.configs import SchedulerConfig


def make_betas(config: SchedulerConfig) -> np.ndarray:
    n = config.num_train_timesteps
    if config.beta_schedule == "linear":
        return np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    if config.beta_schedule == "scaled_linear":
        return (
            np.linspace(config.beta_start**0.5, config.beta_end**0.5, n, dtype=np.float64)
            ** 2
        )
    if config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        i = np.arange(n, dtype=np.float64)
        return np.minimum(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999)
    raise ValueError(f"unknown beta schedule {config.beta_schedule!r}")


def make_alphas_cumprod(config: SchedulerConfig) -> np.ndarray:
    """float32 cumprod over float32 betas (torch.cumprod semantics)."""
    betas32 = make_betas(config).astype(np.float32)
    return np.cumprod(1.0 - betas32, dtype=np.float32)


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    """Invert the sigma table by log-sigma interpolation (Karras schedules)."""
    log_sigma = np.log(sigma)
    dists = log_sigma - log_sigmas[:, None]
    low_idx = np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(
        max=log_sigmas.shape[0] - 2
    )
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return ((1 - w) * low_idx + w * high_idx).reshape(sigma.shape)


def _per_sample(v, like: torch.Tensor) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def _lookup(table: np.ndarray, index: torch.Tensor) -> torch.Tensor:
    """table[index] for an integer index tensor [B], on the index's device."""
    return torch.as_tensor(table, device=index.device)[index.long()]


@dataclass(frozen=True)
class DDPMSchedule:
    """Stage-1 noise schedule: alphas_cumprod [N] float32; init_noise_sigma
    is 1 (variance-preserving)."""

    alphas_cumprod: np.ndarray
    num_train_timesteps: int
    prediction_type: str

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """z_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, integer t [B]."""
        abar = _per_sample(_lookup(self.alphas_cumprod, t.to(x0.device)), x0)
        return torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * noise

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """(alpha / sigma)^2 = abar / (1 - abar) at integer t [B]."""
        abar = _lookup(self.alphas_cumprod, t)
        return abar / (1.0 - abar)


def make_ddpm_schedule(config: SchedulerConfig) -> DDPMSchedule:
    return DDPMSchedule(
        alphas_cumprod=make_alphas_cumprod(config),
        num_train_timesteps=config.num_train_timesteps,
        prediction_type=config.prediction_type,
    )


@dataclass(frozen=True)
class HeunSchedule:
    """EDM sigma schedule: unique timesteps [n] descending, sigmas [n+1]
    with a trailing 0 (float32 numpy tables)."""

    timesteps: np.ndarray
    sigmas: np.ndarray
    num_train_timesteps: int
    num_steps: int
    prediction_type: str

    @property
    def init_noise_sigma(self) -> float:
        return float(self.sigmas[0])

    @staticmethod
    def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
        """z / sqrt(sigma^2 + 1); sigma broadcasts per sample."""
        sigma = _per_sample(sigma, sample)
        return sample / torch.sqrt(sigma**2 + 1.0)

    @staticmethod
    def add_noise(x0: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
        """z = x0 + sigma * eps."""
        return x0 + noise * _per_sample(sigma, x0)

    def pred_x0(self, sample: torch.Tensor, model_output: torch.Tensor, sigma) -> torch.Tensor:
        """Predicted x0 from the unscaled sample in sigma space."""
        sigma = _per_sample(sigma, sample)
        if self.prediction_type == "v_prediction":
            alpha_prod = 1.0 / (sigma**2 + 1.0)
            return sample * alpha_prod - model_output * (sigma * torch.sqrt(alpha_prod))
        if self.prediction_type == "epsilon":
            return sample - sigma * model_output
        raise ValueError(f"unsupported prediction type {self.prediction_type}")

    def snr(self, unique_index: torch.Tensor) -> torch.Tensor:
        """SNR = sigma^-2 at schedule index [B], for min-SNR weighting."""
        return _lookup(self.sigmas, unique_index) ** (-2.0)

    def euler_step(self, sample, model_output, sigma, sigma_next) -> torch.Tensor:
        """First-order step sigma -> sigma_next."""
        sigma_b, next_b = _per_sample(sigma, sample), _per_sample(sigma_next, sample)
        x0 = self.pred_x0(sample, model_output, sigma)
        return sample + (sample - x0) / sigma_b * (next_b - sigma_b)

    def heun_pair(self, sample, sigma, sigma_next, model_fn: Callable,
                  timestep, timestep_next):
        """One Heun interval sigma -> sigma_next with two model evaluations;
        `model_fn(z_scaled, t, sigma)` returns the raw model output. Returns
        (z_next, z_mid): the corrected sample and the Euler predictor."""
        sigma_b, next_b = _per_sample(sigma, sample), _per_sample(sigma_next, sample)
        out_1 = model_fn(self.scale_model_input(sample, sigma), timestep, sigma)
        d1 = (sample - self.pred_x0(sample, out_1, sigma)) / sigma_b
        dt = next_b - sigma_b
        z_mid = sample + d1 * dt
        out_2 = model_fn(self.scale_model_input(z_mid, sigma_next), timestep_next, sigma_next)
        x0_2 = self.pred_x0(z_mid, out_2, sigma_next)
        # guard sigma_next == 0 (the final step is Euler-only, so the Heun
        # intervals never reach it; kept so that no interval can divide by 0)
        at_zero = next_b == 0.0
        d2 = torch.where(at_zero, d1, (z_mid - x0_2) / torch.where(at_zero, 1.0, next_b))
        return sample + 0.5 * (d1 + d2) * dt, z_mid

    def interval(self, i: int, b: int, device):
        """(t_i, t_{i+1}, sigma_i, sigma_{i+1}) as [b] float32 tensors."""
        full = lambda v: torch.full((b,), float(v), dtype=torch.float32, device=device)
        t_next = self.timesteps[i + 1] if i + 1 < self.num_steps else 0.0
        return (full(self.timesteps[i]), full(t_next), full(self.sigmas[i]),
                full(self.sigmas[i + 1]))

    def sample_loop(self, z_init: torch.Tensor, model_fn: Callable, start: int = 0):
        """Heun on every interval from index `start`, then the final Euler
        step sigma_{n-1} -> 0: 2 (n - 1 - start) + 1 model evaluations."""
        z, b, n = z_init, z_init.shape[0], self.num_steps
        for i in range(start, n - 1):
            t_i, t_next, s_i, s_next = self.interval(i, b, z.device)
            z, _ = self.heun_pair(z, s_i, s_next, model_fn, t_i, t_next)
        t_last, _, s_last, zero = self.interval(n - 1, b, z.device)
        out = model_fn(self.scale_model_input(z, s_last), t_last, s_last)
        return self.euler_step(z, out, s_last, zero)


@dataclass(frozen=True)
class DDIMSchedule:
    """DDIM inference schedule: integer timesteps descending,
    (arange(n) * (N // n)).round()[::-1]; `final_alpha_cumprod` is
    alphas_cumprod[0] (set_alpha_to_one=False), the alpha-bar a step whose
    previous timestep falls below 0 lands on."""

    alphas_cumprod: np.ndarray
    timesteps: np.ndarray
    num_train_timesteps: int
    num_inference_steps: int
    prediction_type: str
    final_alpha_cumprod: float

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    @staticmethod
    def scale_model_input(sample: torch.Tensor, t=None) -> torch.Tensor:
        return sample

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """z_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, integer t [B]."""
        table = torch.as_tensor(self.alphas_cumprod, device=x0.device)
        t = torch.as_tensor(t, device=x0.device).long()
        abar = _per_sample(table[t], x0)
        return torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * noise

    def snr(self, t: torch.Tensor) -> torch.Tensor:
        """abar / (1 - abar) at integer t [B]."""
        abar = _lookup(self.alphas_cumprod, t)
        return abar / (1.0 - abar)

    def step(self, model_output: torch.Tensor, t, sample: torch.Tensor) -> torch.Tensor:
        """Deterministic (eta = 0) DDIM step from integer t [B] to
        t - N // n: x0 and eps from the model output (v or epsilon), then
        sqrt(abar_prev) x0 + sqrt(1 - abar_prev) eps, with abar_prev the
        final alpha-bar where t - N // n < 0."""
        t = torch.as_tensor(t, device=sample.device).reshape(-1).long()
        prev_t = t - self.num_train_timesteps // self.num_inference_steps
        table = torch.as_tensor(self.alphas_cumprod, device=sample.device)
        abar_t = _per_sample(table[t], sample)
        final = torch.full_like(table[t], self.final_alpha_cumprod)
        abar_prev = _per_sample(
            torch.where(prev_t >= 0, table[prev_t.clamp_min(0)], final), sample)
        if self.prediction_type == "v_prediction":
            x0 = torch.sqrt(abar_t) * sample - torch.sqrt(1.0 - abar_t) * model_output
            eps = torch.sqrt(abar_t) * model_output + torch.sqrt(1.0 - abar_t) * sample
        elif self.prediction_type == "epsilon":
            x0 = (sample - torch.sqrt(1.0 - abar_t) * model_output) / torch.sqrt(abar_t)
            eps = model_output
        else:
            raise ValueError(f"unsupported prediction type {self.prediction_type}")
        return torch.sqrt(abar_prev) * x0 + torch.sqrt(1.0 - abar_prev) * eps


def make_heun_schedule(
    config: SchedulerConfig, num_steps: int, use_karras: bool = False
) -> HeunSchedule:
    abar = make_alphas_cumprod(config).astype(np.float64)
    n_train = config.num_train_timesteps
    timesteps = np.linspace(0, n_train - 1, num_steps, dtype=np.float64)[::-1].copy()
    sigmas_full = np.sqrt((1 - abar) / abar)
    log_sigmas = np.log(sigmas_full)
    sigmas = np.interp(timesteps, np.arange(n_train), sigmas_full)
    if use_karras:
        rho = 7.0
        sigma_min, sigma_max = sigmas[-1], sigmas[0]
        ramp = np.linspace(0, 1, num_steps)
        sigmas = (
            sigma_max ** (1 / rho)
            + ramp * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
        ) ** rho
        timesteps = np.array([_sigma_to_t(s, log_sigmas) for s in sigmas])
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return HeunSchedule(
        timesteps=timesteps.astype(np.float32),
        sigmas=sigmas,
        num_train_timesteps=n_train,
        num_steps=num_steps,
        prediction_type=config.prediction_type,
    )


def make_ddim_schedule(config: SchedulerConfig, num_inference_steps: int) -> DDIMSchedule:
    abar = make_alphas_cumprod(config)
    step_ratio = config.num_train_timesteps // num_inference_steps
    timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1].copy()
    return DDIMSchedule(
        alphas_cumprod=abar,
        timesteps=timesteps.astype(np.int32),
        num_train_timesteps=config.num_train_timesteps,
        num_inference_steps=num_inference_steps,
        prediction_type=config.prediction_type,
        final_alpha_cumprod=float(abar[0]),
    )


def min_snr_weights_stage1(snr: torch.Tensor, snr_gamma: float, prediction_type: str):
    """Stage-1 weights: v-prediction min(SNR, gamma) / (SNR + 1); epsilon
    min(SNR, gamma) / SNR."""
    truncated = snr.clamp_max(snr_gamma)
    if prediction_type == "v_prediction":
        return truncated / (snr + 1.0)
    if prediction_type == "epsilon":
        return truncated / snr
    raise ValueError(f"unknown prediction type {prediction_type}")


def min_snr_weights_stage2(snr: torch.Tensor, snr_gamma: float):
    """Stage-2 weights: min(SNR, gamma)."""
    return snr.clamp_max(snr_gamma)
