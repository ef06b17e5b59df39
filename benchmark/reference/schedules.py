"""The EDM (Heun) sigma schedule of the SD-2.1 noise schedule, built in
float64 numpy and stored float32, and the sampler's per-step math:
scale_model_input, x0 from a v-prediction, the Euler step, the Heun
interval and the whole sampling loop."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def alphas_cumprod(c: dict) -> np.ndarray:
    n = c["num_train_timesteps"]
    if c["beta_schedule"] != "scaled_linear":
        raise ValueError(f"the reference has the scaled_linear schedule only, not {c['beta_schedule']}")
    betas = (np.linspace(c["beta_start"] ** 0.5, c["beta_end"] ** 0.5, n, dtype=np.float64) ** 2)
    return np.cumprod(1.0 - betas.astype(np.float32), dtype=np.float32)


@dataclass(frozen=True)
class Heun:
    timesteps: np.ndarray  # [n] descending
    sigmas: np.ndarray  # [n + 1], trailing 0
    prediction_type: str

    @classmethod
    def make(cls, c: dict, num_steps: int) -> "Heun":
        abar = alphas_cumprod(c).astype(np.float64)
        n_train = c["num_train_timesteps"]
        t = np.linspace(0, n_train - 1, num_steps, dtype=np.float64)[::-1].copy()
        sigmas = np.interp(t, np.arange(n_train), np.sqrt((1 - abar) / abar))
        return cls(t.astype(np.float32), np.concatenate([sigmas, [0.0]]).astype(np.float32),
                   c["prediction_type"])

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def scale(z, sigma):
        return z / torch.sqrt(sigma ** 2 + 1.0)

    def x0(self, z, out, sigma):
        if self.prediction_type != "v_prediction":
            raise ValueError("the reference has v-prediction only")
        abar = 1.0 / (sigma ** 2 + 1.0)
        return z * abar - out * sigma * torch.sqrt(abar)

    def heun(self, z, s, s_next, model, t, t_next):
        """One Heun interval s -> s_next (s_next > 0): (z_next, z_mid)."""
        d1 = (z - self.x0(z, model(self.scale(z, s), t), s)) / s
        z_mid = z + d1 * (s_next - s)
        d2 = (z_mid - self.x0(z_mid, model(self.scale(z_mid, s_next), t_next), s_next)) / s_next
        return z + 0.5 * (d1 + d2) * (s_next - s), z_mid

    def level(self, i: int, b: int, device):
        """(t_i, sigma_i) as [b, 1, 1, 1] float32 tensors; t_n is 0."""
        t = float(self.timesteps[i]) if i < self.num_steps else 0.0
        full = lambda v: torch.full((b, 1, 1, 1), v, dtype=torch.float32, device=device)
        return full(t), full(float(self.sigmas[i]))

    def sample(self, z, model):
        """Heun over every interval, then Euler from the last sigma to 0:
        2 n - 1 model calls. `model(z_scaled, t)` with t [B, 1, 1, 1]."""
        b, dev = z.shape[0], z.device
        for i in range(self.num_steps - 1):
            (t, s), (t_next, s_next) = self.level(i, b, dev), self.level(i + 1, b, dev)
            z, _ = self.heun(z, s, s_next, model, t, t_next)
        t, s = self.level(self.num_steps - 1, b, dev)
        x0 = self.x0(z, model(self.scale(z, s), t), s)
        return z + (z - x0) / s * (0.0 - s)
