"""Low-rank adaptation (LoRA) of the student UNet's attention projections.

Rank-r factors A [in, r] and B [r, out] on `to_q`, `to_k`, `to_v` and
`to_out.0` of every self- and cross-attention (`attn1`, `attn2`), with only
the factors trained (the reference's `--use_lora`: diffusers'
LoRAAttnProcessor on every attention). B starts at zero, so the adapted
UNet starts equal to its base.

The update is merged into the base weights before each query: the weight W
[out, in] becomes W + scale * (A @ B)^T, and the base UNet runs with the
merged weights through `torch.func.functional_call`. Gradients then reach
only A and B, and the EMA shadows of a LoRA run are factor modules too. The
UNet's attention pads the weights it is handed (`nn/attention.py`), merged
ones too, so they reach kernel K1 and the GEMMs unchanged; `ops/_packs.py`
says when such a copy is made.

A LoRA `TrainState` (`init_lora_state`) holds `LoRAFactors` in its three
roles and the frozen base in `lora_base`; the step and validation builders
of `training/step.py` merge through `step.role_unet`.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn
from torch.func import functional_call

from consistencytta_torch.training.optim import make_optimizer
from consistencytta_torch.training.step import TrainState, build_consistency_train_step

_ADAPTED = re.compile(r"(.+\.)?attn[12]\.(to_q|to_k|to_v|to_out\.0)\.weight")
_FACTOR = re.compile(r"([ab])\.(\d+)")


def adapted_weights(unet: nn.Module) -> List[str]:
    """The names of the weights LoRA adapts, in the module's order:
    `...attn{1,2}.to_{q,k,v}.weight` and `...attn{1,2}.to_out.0.weight`."""
    return [name for name, _ in unet.named_parameters() if _ADAPTED.fullmatch(name)]


class LoRAFactors(nn.Module):
    """One role's factors: `a[i]` [in, rank] and `b[i]` [rank, out] for the
    base weight `names[i]` (float32)."""

    def __init__(self, names: List[str], shapes: List[torch.Size], rank: int,
                 scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.names, self.rank, self.scale = list(names), rank, scale
        # A ~ N(0, 1) / rank, B = 0: the adapted UNet starts at its base
        self.a = nn.ParameterList(
            [nn.Parameter(torch.randn(shape[1], rank, generator=generator) / rank)
             for shape in shapes])
        self.b = nn.ParameterList(
            [nn.Parameter(torch.zeros(rank, shape[0])) for shape in shapes])


def init_lora_params(unet: nn.Module, rank: int = 4, seed: int = 0) -> LoRAFactors:
    """Factors for every attention projection of `unet`, drawn on the CPU
    from `seed` (the same numbers whatever the device) and placed on the
    UNet's device."""
    names = adapted_weights(unet)
    params = dict(unet.named_parameters())
    gen = torch.Generator().manual_seed(seed)
    factors = LoRAFactors(names, [params[n].shape for n in names], rank, generator=gen)
    return factors.to(unet.conv_in.weight.device)


def merge_lora(unet: nn.Module, factors: LoRAFactors) -> Dict[str, torch.Tensor]:
    """The UNet's parameters and buffers with W + scale * (A @ B)^T in place
    of every adapted weight (the delta cast to W's dtype). Differentiable
    with respect to the factors."""
    merged = dict(unet.named_parameters())
    merged.update(unet.named_buffers())
    for name, a, b in zip(factors.names, factors.a, factors.b):
        w = merged[name]
        merged[name] = w + factors.scale * (a @ b).t().to(w.dtype)
    return merged


def merged_state_dict(unet: nn.Module, factors: LoRAFactors) -> Dict[str, torch.Tensor]:
    """`merge_lora` detached, keyed as `unet.state_dict()`: a plain UNet's
    weights, which is how a LoRA run's roles are saved."""
    with torch.no_grad():
        merged = merge_lora(unet, factors)
    return {k: merged[k].detach() for k in unet.state_dict()}


class LoRAUNet:
    """The base UNet called with a role's factors merged in. Stands where a
    UNet module is queried (`Pipeline.query_unet` reads `conv_in` for the
    parameters' dtype)."""

    def __init__(self, base: nn.Module, factors: LoRAFactors):
        self.base, self.factors = base, factors

    @property
    def conv_in(self) -> nn.Module:
        return self.base.conv_in

    def __call__(self, *args):
        return functional_call(self.base, merge_lora(self.base, self.factors), args)


def lora_param_count(factors: LoRAFactors) -> int:
    return sum(p.numel() for p in factors.parameters())


def is_lora_tree(tree) -> bool:
    """True for a factor module or its state dict (only `a.<i>` / `b.<i>`
    pairs), False for a UNet, its state dict, or an empty mapping."""
    if isinstance(tree, LoRAFactors):
        return True
    if isinstance(tree, nn.Module):
        return False
    if not isinstance(tree, Mapping) or not tree:
        return False
    matches = [_FACTOR.fullmatch(k) for k in tree]
    if not all(matches):
        return False
    a = {m.group(2) for m in matches if m.group(1) == "a"}
    return a == {m.group(2) for m in matches if m.group(1) == "b"}


def init_lora_state(pipeline, config, rank: int = 4, seed: int = 0):
    """A stage-2 `TrainState` that trains only LoRA factors: the pipeline's
    `student` becomes the frozen base (`lora_base`), the three roles are
    factor modules from one init (target and EMA start equal to it), and
    AdamW takes the student's factors."""
    base = pipeline.unets["student"].requires_grad_(False)
    if any(p.dtype != torch.float32 for p in base.parameters()):
        raise ValueError("the LoRA base must be a float32 student: create the pipeline "
                         "with training=True")
    student = init_lora_params(base, rank, seed)
    optimizer, lr_scheduler = make_optimizer(list(student.parameters()), config)
    return TrainState(0, student, copy.deepcopy(student), copy.deepcopy(student), optimizer,
                      lr_scheduler, config.max_grad_norm, lora_base=base)


def build_lora_consistency_train_step(pipeline, schedule, cfg, loss_fn_override=None):
    """The stage-2 step of `training/step.py` for a state from
    `init_lora_state`: the student and the target query the base with their
    factors merged, AdamW updates the factors, and both EMAs follow the
    student's factors."""
    step = build_consistency_train_step(pipeline, schedule, cfg, loss_fn_override)

    def lora_step(state, batch, generator=None, draws=None):
        if state.lora_base is None:
            raise ValueError("not a LoRA state: make it with init_lora_state")
        return step(state, batch, generator, draws)

    return lora_step
