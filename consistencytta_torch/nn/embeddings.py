"""Timestep and guidance-weight embeddings for the UNet (diffusers
get_timestep_embedding, GaussianFourierProjection, TimestepEmbedding)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """[B] -> [B, embedding_dim] DDPM sinusoidal embedding, float32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    return emb


class GaussianFourierProjection(nn.Module):
    """Random-Fourier features with a frozen N(0, scale) weight, applied in
    float32 (`keep_fp32`)."""

    keep_fp32 = True

    def __init__(self, embedding_size: int, scale: float = 1.0,
                 flip_sin_to_cos: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn(embedding_size) * scale, requires_grad=False
        )
        self.flip_sin_to_cos = flip_sin_to_cos

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = x.float()[:, None] * self.weight.float()[None, :] * 2 * math.pi
        if self.flip_sin_to_cos:
            return torch.cat([torch.cos(x_proj), torch.sin(x_proj)], dim=-1)
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))
