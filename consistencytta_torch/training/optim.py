"""Optimizer and learning-rate schedule factory: AdamW with a warm-up to the
base rate, then the decay shape named by `lr_scheduler_type`
(transformers.get_scheduler semantics; 'linear' in every shipped recipe).

`torch.optim.AdamW` is the update the JAX package takes from optax.adamw:
decoupled weight decay scaled by the learning rate, and eps added outside
the root of the bias-corrected second moment. The schedule is a function of
the number of optimizer updates taken so far, starting at 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import torch

SUPPORTED_LR_SCHEDULES = ("linear", "cosine", "constant", "constant_with_warmup")


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    weight_decay: float = 1e-4
    num_warmup_steps: int = 750
    max_train_steps: int = 100_000
    lr_scheduler_type: str = "linear"
    max_grad_norm: Optional[float] = None  # the reference does not clip


def lr_schedule_with_warmup(config: OptimizerConfig) -> Callable[[int], float]:
    """step -> learning rate."""
    if config.lr_scheduler_type not in SUPPORTED_LR_SCHEDULES:
        raise ValueError(
            f"lr_scheduler_type {config.lr_scheduler_type!r} is not supported; "
            f"choose one of {SUPPORTED_LR_SCHEDULES}"
        )
    kind, warmup = config.lr_scheduler_type, config.num_warmup_steps

    def schedule(step: int) -> float:
        if kind == "constant":  # no warm-up, flat
            return config.learning_rate
        if step < warmup:
            factor = min(1.0, step / max(warmup, 1))
        else:
            progress = (step - warmup) / max(config.max_train_steps - warmup, 1)
            progress = min(max(progress, 0.0), 1.0)
            if kind == "cosine":
                factor = 0.5 * (1.0 + math.cos(math.pi * progress))
            elif kind == "constant_with_warmup":
                factor = 1.0
            else:  # linear
                factor = 1.0 - progress
        return config.learning_rate * factor

    return schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter], config: OptimizerConfig
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """(AdamW over `params`, its LambdaLR). The scheduler is stepped once per
    optimizer update; `config.max_grad_norm` is applied by the train step
    (`clip_grad_norm_`) before the update."""
    schedule = lr_schedule_with_warmup(config)
    optimizer = torch.optim.AdamW(
        params, lr=1.0, betas=(config.adam_beta1, config.adam_beta2),
        eps=config.adam_epsilon, weight_decay=config.weight_decay,
    )
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
