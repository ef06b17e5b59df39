"""Noise schedules for generation: numpy table builders and the device-side
ops that consistency sampling uses (init_noise_sigma, timesteps, sigmas,
scale_model_input, add_noise) for the Heun/EDM and DDIM families.

Tables are built in numpy exactly as the JAX package builds them (float64
interpolation, float32 storage); the per-sample ops run on torch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class DDIMSchedule:
    """DDIM inference schedule: integer timesteps descending."""

    alphas_cumprod: np.ndarray
    timesteps: np.ndarray
    num_train_timesteps: int
    num_inference_steps: int
    prediction_type: str

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
    )
