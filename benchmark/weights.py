"""Seeded random weights under the port's state-dict key names, made on the
device in one draw a model: every linear and conv weight and bias uniform in
+-1/sqrt(fan_in) (PyTorch's default initialisation), embeddings and the
Fourier guidance projection standard normal, normalisation scales 1 and
shifts 0; T5's query projection 1/sqrt(d_kv) narrower and its relative
position table N(0, 1/d_model), as T5's own initialisation has them (T5
scales no logits, so without that its attention saturates and the encoder
turns chaotic: bf16 rounding then moves its output by ~90%). The shapes and kinds come from the reference's modules, built on
the meta device; the values are drawn in float32 and rounded to the dtype they are served
in, and
both the program and the reference load them."""

from __future__ import annotations

import hashlib
from typing import Dict

import torch
from torch import nn

from benchmark.reference.generate import Models
from benchmark.reference.hifigan import HiFiGAN
from benchmark.reference.t5 import RMSNorm, T5Encoder
from benchmark.reference.unet import FourierProjection, UNet
from benchmark.reference.vae import AutoencoderKL

NORMS = (nn.GroupNorm, nn.LayerNorm, RMSNorm)
NORMAL = (nn.Embedding, FourierProjection)


BIAS_SCALE = 0.1


def fan_in(m: nn.Module) -> float:
    """Inputs that sum into one output: in_channels x taps, and for a
    transposed conv in_channels x taps / stride."""
    if isinstance(m, nn.Linear):
        return m.in_features
    if isinstance(m, nn.Embedding):
        return 1
    k = m.weight[0, 0].numel()
    if isinstance(m, nn.ConvTranspose1d):
        return m.in_channels * k / m.stride[0]
    return m.in_channels * k / m.groups


def derive(seed: int, *salt) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    text = ":".join(str(s) for s in (int(seed), *salt)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def reference_models(pipeline: dict, teacher: bool) -> Models:
    """The reference's modules on the meta device (shapes only)."""
    unet = dict(pipeline["unet"], guided=not teacher and pipeline["unet"]["guided"])
    with torch.device("meta"):
        return Models(T5Encoder(pipeline["t5"]), UNet(unet), AutoencoderKL(pipeline["vae"]),
                      HiFiGAN(pipeline["vocoder"]))


def make_state(model: nn.Module, seed: int, salt: str, device, dtype) -> Dict[str, torch.Tensor]:
    """The state dict of `model` (a meta module) filled from (seed, salt)."""
    plan = []
    for mod_name, m in model.named_modules():
        for p_name, p in m.named_parameters(recurse=False):
            key = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(m, NORMS):
                plan.append((key, p.shape, "one" if p_name == "weight" else "zero", 0.0))
            elif key.endswith("relative_attention_bias.weight"):
                plan.append((key, p.shape, "normal", model.c["d_model"] ** -0.5))
            elif isinstance(m, NORMAL):
                plan.append((key, p.shape, "normal", 1.0))
            elif key.endswith("SelfAttention.q.weight"):
                # T5 folds the attention's 1/sqrt(d_kv) into q's initialisation
                plan.append((key, p.shape, "uniform", (3 / (fan_in(m) * model.c["d_kv"])) ** 0.5))
            elif p_name == "bias":
                plan.append((key, p.shape, "uniform", BIAS_SCALE * fan_in(m) ** -0.5))
            else:
                plan.append((key, p.shape, "uniform", 3 ** 0.5 * fan_in(m) ** -0.5))
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights", salt))
    n_uniform = sum(s.numel() for _, s, kind, _ in plan if kind == "uniform")
    n_normal = sum(s.numel() for _, s, kind, _ in plan if kind == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    state, iu, inorm = {}, 0, 0
    for key, shape, kind, scale in plan:
        n = shape.numel()
        if kind == "uniform":
            state[key] = ((uniform[iu:iu + n].view(shape) * 2 - 1) * scale).to(dtype)
            iu += n
        elif kind == "normal":
            state[key] = (normal[inorm:inorm + n].view(shape) * scale).to(dtype)
            inorm += n
        else:
            state[key] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device, dtype=dtype)
    return state


def make_weights(pipeline: dict, seed: int, device, dtype, teacher: bool = False):
    """{"t5", "unet", "vae", "vocoder"} state dicts of one configuration."""
    models = reference_models(pipeline, teacher)
    names = ("t5", "unet", "vae", "vocoder")
    return {n: make_state(m, seed, n, device, dtype) for n, m in zip(names, models.modules())}
