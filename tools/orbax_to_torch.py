#!/usr/bin/env python3
"""Convert a JAX-package orbax checkpoint directory into the PyTorch port's
checkpoint layout.

    python tools/orbax_to_torch.py ORBAX_DIR OUT_DIR [train flags of a run that resumes]

Runs where the JAX package and orbax are installed, which is where its
checkpoints are written: it restores with
`consistencytta_tpu.io.checkpoints.load_checkpoint`. The card's host needs
neither: the port reads what this writes, and nothing in
`consistencytta_torch/` imports this script.

ORBAX_DIR is a directory of the JAX training CLI (`state/`, `frozen/`,
`config.json`): a stage-1, stage-2, LoRA or FTVAE state, a ZeRO-1 run's
included (orbax restores it whole on the host). OUT_DIR receives:

  pytorch_model_2.bin    the state's student roles as `<role>_unet.*` (a
                         LoRA state's factors merged into the frozen base
                         student with the JAX package's `merge_lora`, as its
                         CLI loader does), the frozen teacher as
                         `teacher_unet.*` and T5 as `text_encoder.*`, an
                         FTVAE state's decoder pair and its EMA under the
                         reference's keys; the port's `model_state_dict` keys;
  first_stage_model.bin  the frozen VAE and vocoder in the AudioLDM layout
                         (`first_stage_model.*`, `first_stage_model.vocoder.*`),
                         which the port's loader puts over `--vae_checkpoint`'s
                         as the JAX loader does;
  optimizer.bin          torch AdamW's state dict: `exp_avg` from optax's `mu`,
                         `exp_avg_sq` from `nu`, `step` from `count`, in the
                         order of the parameters of the port's state for this
                         kind of run (a LoRA state's factors under
                         `lora_factors`; an FTVAE state's decoder moments after
                         the student's);
  scheduler.bin          the LR schedule's state at `count` updates and the
                         state's step;
  config.json            copied.

The trailing flags are the port's training CLI's (its names and defaults;
`consistencytta_torch.cli.train`): AdamW's hyperparameters and the learning
rate of the schedule at `count`, which optimizer.bin holds as torch does, come
from them, so pass those of the run that will resume (`--max_train_steps`
included where the schedule decays; without it the port's OptimizerConfig
default stands). Such a run passes `--resume_from_checkpoint OUT_DIR` and the
flags that load the same base roles (a LoRA run's base must be the one its
factors were trained on).

Each role is converted, then dropped from the restored tree, and the model
file is written before the moments are converted, so that no more than one
extra copy of a role is held at once.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import warnings
from typing import Any, Dict, List, Mapping, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import torch  # noqa: E402

from consistencytta_torch.cli import train as train_cli  # noqa: E402
from consistencytta_torch.configs import PipelineConfig, UNetConfig  # noqa: E402
from consistencytta_torch.io import checkpoints as ck  # noqa: E402
from consistencytta_torch.io import from_jax as fj  # noqa: E402
from consistencytta_torch.nn.unet import UNet2DConditionGuided  # noqa: E402
from consistencytta_torch.nn.vae import AutoencoderKLDecoder  # noqa: E402
from consistencytta_torch.training.lora import LoRAFactors, adapted_weights  # noqa: E402
from consistencytta_torch.training.optim import OptimizerConfig, make_optimizer  # noqa: E402

STUDENT_ROLES = ck.STUDENT_ROLES


def find_adam_state(opt_state) -> Optional[Mapping[str, Any]]:
    """The `ScaleByAdamState` (restored as a {count, mu, nu} mapping) inside
    an optax state, wherever the chain put it (after a clip transform, for
    one)."""
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state
        children = list(opt_state.values())
    elif isinstance(opt_state, (list, tuple)):
        if hasattr(opt_state, "_fields") and {"count", "mu", "nu"} <= set(opt_state._fields):
            return opt_state._asdict()
        children = list(opt_state)
    else:
        return None
    for child in children:
        found = find_adam_state(child)
        if found is not None:
            return found
    return None


def _is_lora(state: Mapping[str, Any]) -> bool:
    from consistencytta_tpu.training.lora import is_lora_tree

    return any(is_lora_tree(state.get(r)) for r in STUDENT_ROLES if state.get(r) is not None)


def _meta_unet(config: PipelineConfig) -> torch.nn.Module:
    with torch.device("meta"):
        return UNet2DConditionGuided(config.unet)


def _named_order(module: torch.nn.Module) -> List[str]:
    return [name for name, _ in module.named_parameters()]


def _moments(tree, kind: str, config: PipelineConfig, names: List[str]) -> List[torch.Tensor]:
    """One optax moment tree as the port's optimizer lists its parameters."""
    if kind == "lora":
        sd = fj.lora_state_dict(tree, adapted_weights(_meta_unet(config)))
        return [sd[n] for n in names]
    if kind == "ftvae":
        unet = fj.unet_state_dict(tree["unet"], config.unet)
        dec = fj.vae_decoder_state_dict(tree["vae_dec"], config.vae)
        n_unet = len(_named_order(_meta_unet(config)))
        return [unet[n] for n in names[:n_unet]] + [dec[n] for n in names[n_unet:]]
    sd = fj.unet_state_dict(tree, config.unet)
    return [sd[n] for n in names]


def _parameter_names(kind: str, config: PipelineConfig, state) -> List[str]:
    """The names of the parameters the port's optimizer takes, in its order:
    the student UNet's (TrainState.create), the LoRA factors' a then b
    (init_lora_state), or the student's then the decoder pair's
    (FTVAETrainState.create)."""
    unet = _meta_unet(config)
    if kind == "lora":
        names = adapted_weights(unet)
        params = dict(unet.named_parameters())
        rank = next(iter(fj.lora_state_dict(state["student"], names).values())).shape[1]
        with torch.device("meta"):
            factors = LoRAFactors(names, [params[n].shape for n in names], rank)
        return _named_order(factors)
    names = _named_order(unet)
    if kind == "ftvae":
        with torch.device("meta"):
            names += _named_order(AutoencoderKLDecoder(config.vae))
    return names


def optimizer_files(adam: Mapping[str, Any], kind: str, config: PipelineConfig, state,
                    opt_config: OptimizerConfig):
    """(optimizer.bin's dict, scheduler.bin's dict) for the port's AdamW and
    LambdaLR at `adam["count"]` updates."""
    names = _parameter_names(kind, config, state)
    count = int(adam["count"])
    exp_avg = _moments(adam["mu"], kind, config, names)
    exp_avg_sq = _moments(adam["nu"], kind, config, names)
    placeholders = [torch.nn.Parameter(torch.empty(0)) for _ in names]
    optimizer, scheduler = make_optimizer(placeholders, opt_config)
    with warnings.catch_warnings():  # the schedule is stepped without an update
        warnings.simplefilter("ignore")
        scheduler.last_epoch = count - 1
        scheduler.step()
    opt = optimizer.state_dict()
    # torch keeps `step` per parameter as a float32 scalar on the host (a
    # non-capturable, non-fused AdamW, as the port's is)
    opt["state"] = {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": m, "exp_avg_sq": v}
                    for i, (m, v) in enumerate(zip(exp_avg, exp_avg_sq))}
    sched = {"lr_scheduler": scheduler.state_dict(), "step": int(state["step"])}
    return opt, sched


def convert(orbax_dir: str, out_dir: str, opt_config: Optional[OptimizerConfig] = None) -> Dict[str, str]:
    """Convert ORBAX_DIR into OUT_DIR (the module's docstring); returns the
    written files by name."""
    from consistencytta_tpu.io.checkpoints import load_checkpoint
    from consistencytta_tpu.training.lora import merge_lora

    if not ck.is_orbax_checkpoint(orbax_dir):
        raise ValueError(f"{orbax_dir} is not an orbax checkpoint directory (no state/)")
    config_path = os.path.join(orbax_dir, ck.CONFIG_FILE)
    if not os.path.exists(config_path):
        raise ValueError(f"{orbax_dir} has no {ck.CONFIG_FILE}: the maps need the run's "
                         "PipelineConfig")
    state, frozen, config_dict = load_checkpoint(orbax_dir)
    config = PipelineConfig.from_dict(config_dict)
    teacher_cfg = UNetConfig.from_dict({**config.unet.to_dict(), "guided": False})
    frozen = frozen or {}
    kind = "lora" if _is_lora(state) else "ftvae" if state.get("vae_dec") is not None else "full"
    base = frozen.get("student")
    if kind == "lora" and base is None:
        raise ValueError(f"{orbax_dir} holds LoRA factors but no base student weights in its "
                         "frozen tree; cannot merge for inference")
    os.makedirs(out_dir, exist_ok=True)
    written = {}

    model: ck.StateDict = {}
    factors = {}
    for role in STUDENT_ROLES:
        tree = state.pop(role, None)
        if tree is None:
            continue
        if kind == "lora":
            factors[role] = tree
            tree = merge_lora(base, tree)
        model.update({f"{role}_unet.{k}": v
                      for k, v in fj.unet_state_dict(tree, config.unet).items()})
        del tree
    if frozen.get("teacher") is not None:
        model.update({f"teacher_unet.{k}": v for k, v in
                      fj.unet_state_dict(frozen.pop("teacher"), teacher_cfg).items()})
    if frozen.get("t5") is not None:
        model.update({ck.T5_PREFIX + k: v for k, v in
                      fj.t5_state_dict(frozen.pop("t5"), config.t5.num_layers).items()})
    if kind == "ftvae":
        model.update(ck.ftvae_state_dict(
            fj.vae_decoder_state_dict(state.pop("vae_dec"), config.vae),
            fj.vae_decoder_state_dict(state.pop("vae_dec_ema"), config.vae)))
    written[ck.MODEL_FILE] = os.path.join(out_dir, ck.MODEL_FILE)
    torch.save(model, written[ck.MODEL_FILE])
    del model

    first_stage: ck.StateDict = {}
    if frozen.get("vae") is not None:
        first_stage.update({"first_stage_model." + k: v for k, v in
                            fj.vae_state_dict(frozen.pop("vae"), config.vae).items()})
    if frozen.get("vocoder") is not None:
        first_stage.update({"first_stage_model.vocoder." + k: v for k, v in
                            fj.hifigan_state_dict(frozen.pop("vocoder"), config.vocoder).items()})
    if first_stage:
        written[ck.FIRST_STAGE_FILE] = os.path.join(out_dir, ck.FIRST_STAGE_FILE)
        torch.save(first_stage, written[ck.FIRST_STAGE_FILE])
    del first_stage

    adam = find_adam_state(state.get("opt_state"))
    if adam is None:
        raise ValueError(f"{orbax_dir}: no AdamW (optax scale_by_adam) state in opt_state")
    if kind == "lora":
        state = {**state, "student": factors["student"]}
    opt, sched = optimizer_files(adam, kind, config, state, opt_config or OptimizerConfig())
    if kind == "lora":
        names = adapted_weights(_meta_unet(config))
        opt["lora_factors"] = {r: fj.lora_state_dict(t, names) for r, t in factors.items()}
    for name, obj in ((ck.OPTIMIZER_FILE, opt), (ck.SCHEDULER_FILE, sched)):
        written[name] = os.path.join(out_dir, name)
        torch.save(obj, written[name])
    written[ck.CONFIG_FILE] = os.path.join(out_dir, ck.CONFIG_FILE)
    shutil.copyfile(config_path, written[ck.CONFIG_FILE])
    return written


def main(argv=None) -> Dict[str, str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("orbax_dir")
    parser.add_argument("out_dir")
    args, rest = parser.parse_known_args(argv)
    train_args = train_cli.parse_args(rest)
    opt_config = train_cli.optimizer_config_from_args(
        train_args, train_args.max_train_steps or OptimizerConfig().max_train_steps)
    written = convert(args.orbax_dir, args.out_dir, opt_config)
    for name, path in written.items():
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
