"""Reference-format torch checkpoints: the port's loader and its training
checkpoints.

The port's modules keep the reference's state-dict key names and torch
layouts, so loading a reference checkpoint is key surgery plus
`load_state_dict`, with no conversion. The surgery is the port's own copy of
the JAX package's (consistencytta_tpu/io/torch_import.py and
cli/common.py:80-234), which follows the reference:

  * the AudioLDM VAE checkpoint (`audioldm-s-full.ckpt`): keys under
    `first_stage_model.`, its HiFi-GAN under `first_stage_model.vocoder.`;
  * the full ConsistencyTTA model (`pytorch_model_2.bin`) with its legacy
    role names (`consistency_unet` is the student, `consistency_ema_unet`
    the target and, where no slow EMA is saved, the EMA,
    `consistency_slow_ema_unet` the EMA, `diffusion_unet` the teacher);
  * a TANGO checkpoint (`unet.*`, the teacher), with an optional stage-1
    file whose `student_ema_unet.*` weights seed the student roles; TANGO
    has no guidance weights, so the guided roles get the same fresh
    guidance init as the JAX package (`init_guidance_params`);
  * the FTVAE decoder pair and its EMA copy (stage 3).

The port's training writes the reference's Accelerate layout, one
directory per checkpoint (`best`, `epoch_<n>`, `step_<n>`):

  {dir}/pytorch_model_2.bin  the UNet roles the run holds under the
                             reference's names (`teacher_unet.*`,
                             `student_unet.*`, `student_target_unet.*`,
                             `student_ema_unet.*`; a LoRA run's roles merged
                             into its base), the T5 encoder
                             (`text_encoder.*`) and, for a stage-3 FTVAE
                             run, the trained decoder pair (`vae.decoder.*`,
                             `vae.post_quant_conv.*`) and its EMA
                             (`ema_vae_decoder.*`, `ema_vae_pqconv.*`), the
                             reference's layout, each in its own dtype; no
                             CLAP weights;
  {dir}/optimizer.bin        the optimizer's state dict (an FTVAE run's
                             holds the decoder's moments too), plus a LoRA
                             run's factors of every role (`lora_factors`);
  {dir}/scheduler.bin        the LR schedule's state dict and the step count;
  {dir}/config.json          `PipelineConfig.to_dict()`.

`model_path` and `stage1_model` may name such a directory; it is read as its
`pytorch_model_2.bin`. The T5 encoder has no published checkpoint here (the
reference takes it from the Hugging Face hub, which the port never
contacts), so a training run random-inits it from its seed; where a
checkpoint holds `text_encoder.*`, the loader takes the T5 from it, so that
a trained student is served with the encoder it was trained with.

Orbax checkpoint directories (the JAX package's own training output, its
LoRA and FTVAE forms included) are refused: `tools/orbax_to_torch.py`, run
where JAX and orbax are installed, converts one into this layout, plus
{dir}/first_stage_model.bin, the VAE and vocoder of the JAX run's frozen
tree in the AudioLDM layout (`first_stage_model.*`, the vocoder under
`first_stage_model.vocoder.*`). Where `model_path` names a directory that
holds that file, its VAE and vocoder go over `vae_checkpoint`'s, as the JAX
loader puts an orbax directory's frozen VAE and vocoder over them.

`torch.load` unpickles: load only checkpoints you trust, as with the
reference's own loader.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from consistencytta_torch.configs import UNetConfig
from consistencytta_torch.nn.vae import AutoencoderKLDecoder
from consistencytta_torch.parallel.mesh import gathered_state
from consistencytta_torch.training.lora import merged_state_dict
from consistencytta_torch.utils import cast_module

StateDict = Dict[str, torch.Tensor]
UNET_ROLES = ("teacher", "student", "student_target", "student_ema")
STUDENT_ROLES = ("student", "student_target", "student_ema")
MODEL_FILE = "pytorch_model_2.bin"
OPTIMIZER_FILE = "optimizer.bin"
SCHEDULER_FILE = "scheduler.bin"
CONFIG_FILE = "config.json"
FIRST_STAGE_FILE = "first_stage_model.bin"
T5_PREFIX = "text_encoder."


def load_torch_state_dict(path: str) -> StateDict:
    """A torch checkpoint's tensors on the CPU, descending into a
    {"state_dict": ...} or {"model": ...} wrapper when the top level holds
    no tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("state_dict", "model"):
        if (isinstance(sd, dict) and isinstance(sd.get(wrapper), dict)
                and not any(torch.is_tensor(v) for v in sd.values())):
            sd = sd[wrapper]
            break
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def strip_prefix(sd: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    """The entries under `prefix`, with the prefix cut off; others dropped."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def split_consistencytta_checkpoint(sd: Mapping[str, torch.Tensor]) -> Dict[str, StateDict]:
    """A full ConsistencyTTA state dict -> one UNet state dict per role,
    after the legacy-name remapping of the reference
    (models/audio_consistency_model.py:160-204)."""
    remapped: StateDict = {}
    for k, v in sd.items():
        if "consistency_slow_ema_" in k:
            remapped["student_ema_" + k.split("consistency_slow_ema_")[-1]] = v
        elif "consistency_ema_" in k:
            tail = k.split("consistency_ema_")[-1]
            remapped.setdefault("student_target_" + tail, v)
            remapped.setdefault("student_ema_" + tail, v)
        elif "consistency_unet" in k:
            remapped["student_unet" + k.split("consistency_unet")[-1]] = v
        elif "diffusion_unet" in k:
            remapped["teacher_unet" + k.split("diffusion_unet")[-1]] = v
        else:
            remapped.setdefault(k, v)
    roles: Dict[str, StateDict] = {r: {} for r in UNET_ROLES}
    for k, v in remapped.items():
        for role in UNET_ROLES:
            prefix = f"{role}_unet."
            if k.startswith(prefix):
                roles[role][k[len(prefix):]] = v
                break
    return roles


def fan_out_tango_checkpoint(tango_sd: Mapping[str, torch.Tensor],
                             stage1_sd: Optional[Mapping[str, torch.Tensor]] = None
                             ) -> Dict[str, StateDict]:
    """TANGO -> ConsistencyTTA initialisation (the reference's
    models/audio_consistency_model.py:107-158): TANGO's `unet.*` is the
    teacher; the student roles start from the stage-1 student EMA when given,
    else from the teacher."""
    teacher = strip_prefix(tango_sd, "unet.")
    if stage1_sd is not None:
        init = {k.split("student_ema_unet.")[-1]: v for k, v in stage1_sd.items()
                if "student_ema_unet." in k}
    else:
        init = teacher
    return {"teacher": teacher, **{role: dict(init) for role in STUDENT_ROLES}}


def extract_ftvae_decoders(sd: Mapping[str, torch.Tensor]
                           ) -> Tuple[Optional[StateDict], Optional[StateDict]]:
    """The fine-tuned VAE decoder pair and its EMA copy in a stage-3 (FTVAE)
    state dict (the reference's models/audio_consistency_model_ftvae.py:
    69-91): `vae.decoder.*` / `vae.post_quant_conv.*` are the trained pair,
    `ema_vae_decoder.*` / `ema_vae_pqconv.*` (or `vae.ema_decoder.*` /
    `vae.ema_post_quant_conv.*`) the EMA pair; `loss.`-prefixed duplicates
    count once. Each comes back rooted at decoder. / post_quant_conv., or None
    where absent."""
    trained: StateDict = {}
    ema: StateDict = {}
    alias_map = (
        ("vae.ema_decoder.", "decoder.", ema),
        ("vae.ema_post_quant_conv.", "post_quant_conv.", ema),
        ("vae.decoder.", "decoder.", trained),
        ("vae.post_quant_conv.", "post_quant_conv.", trained),
        ("ema_vae_decoder.", "decoder.", ema),
        ("ema_vae_pqconv.", "post_quant_conv.", ema),
    )
    for k, v in sd.items():
        key = k[5:] if k.startswith("loss.") else k
        for prefix, root, dest in alias_map:
            if key.startswith(prefix):
                dest.setdefault(root + key[len(prefix):], v)
                break
    return (trained or None), (ema or None)


def init_guidance_params(config: UNetConfig, seed: int = 0) -> StateDict:
    """Fresh guidance weights (the Fourier projection and its two-layer
    MLP), the same numbers as the JAX package's init from
    np.random.RandomState(seed), in torch layout: a TANGO checkpoint has no
    guidance keys, and every student role gets this one init."""
    rs = np.random.RandomState(seed)
    ch = config.block_out_channels[0]
    emb = ch * 4
    proj = rs.standard_normal((ch * 2,)).astype(np.float32)
    sd = {"guidance_proj.weight": torch.from_numpy(proj)}
    for name in ("linear_1", "linear_2"):
        kernel = (rs.standard_normal((emb, emb)) / np.sqrt(emb)).astype(np.float32)
        sd[f"guidance_embedding.{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        sd[f"guidance_embedding.{name}.bias"] = torch.zeros(emb)
    return sd


def is_orbax_checkpoint(path: Optional[str]) -> bool:
    """A directory written by the JAX package's checkpoint writer
    ({dir}/state, with frozen/ and config.json)."""
    return bool(path) and os.path.isdir(path) and os.path.exists(os.path.join(path, "state"))


def checkpoint_file(path: str) -> str:
    """The model file a path names: a file as it is, a directory written by
    `save_checkpoint` as its pytorch_model_2.bin. An orbax directory is
    refused."""
    if not os.path.isdir(path):
        return path
    if is_orbax_checkpoint(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory (the JAX package's training "
            "output): the port reads reference-format torch files and its own "
            "checkpoint directories; convert it first with `python "
            f"tools/orbax_to_torch.py {path} OUT_DIR`, which runs where JAX and "
            "orbax are installed, and pass OUT_DIR")
    model = os.path.join(path, MODEL_FILE)
    if not os.path.exists(model):
        raise FileNotFoundError(f"{path} is a directory without {MODEL_FILE}")
    return model


def load_into(module: nn.Module, sd: Mapping[str, torch.Tensor], what: str,
          prefixes: Optional[Tuple[str, ...]] = None) -> None:
    """Copy the checkpoint's tensors into `module` (cast to its dtype and
    device). Every key of the module (or of its `prefixes`) must be there
    with its shape; keys the module does not have are ignored."""
    keys = [k for k in module.state_dict() if prefixes is None or k.startswith(prefixes)]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{what}: {len(missing)} of {len(keys)} keys missing from the "
                       f"checkpoint, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in keys}, strict=prefixes is None)


def _own_module(pipeline, role: str) -> nn.Module:
    """The role's UNet, copied first if another role shares the module
    (generation pipelines share one frozen student among the student roles),
    so that loading one role leaves the others as they were."""
    module = pipeline.unets[role]
    if any(other is module for r, other in pipeline.unets.items() if r != role):
        module = copy.deepcopy(module)
        pipeline.unets[role] = module
    return module


def _load_first_stage(pipeline, path: str, loaded: Dict[str, str],
                      require_vae: bool) -> None:
    """Load an AudioLDM-layout file's VAE and vocoder (`first_stage_model.*`,
    the vocoder under `.vocoder.*`; the prefix may be absent). The vocoder
    is loaded where the file holds it; the VAE too, and a file without VAE
    keys raises where `require_vae`."""
    sd = load_torch_state_dict(path)
    if any(k.startswith("first_stage_model.") for k in sd):
        sd = strip_prefix(sd, "first_stage_model.")
    voc = strip_prefix(sd, "vocoder.")
    vae = {k: v for k, v in sd.items() if not k.startswith("vocoder.")}
    if vae or require_vae:
        load_into(pipeline.vae, vae, "vae")
        loaded["vae"] = path
    if voc:
        load_into(pipeline.vocoder, voc, "vocoder")
        loaded["vocoder"] = path


def load_frozen_and_roles(pipeline, tango_model: Optional[str] = None,
                          stage1_model: Optional[str] = None,
                          model_path: Optional[str] = None,
                          vae_checkpoint: Optional[str] = None,
                          random_init_seed: Optional[int] = None) -> Dict[str, str]:
    """Load reference-format checkpoints into `pipeline` in place, as the
    JAX package's CLIs do (cli/common.py:80-234), and return what came from
    which file.

    `vae_checkpoint` gives the VAE and, where it holds one, the vocoder;
    `model_path` a full ConsistencyTTA model (UNet roles, and an FTVAE
    decoder pair where present); otherwise `tango_model` (+ `stage1_model`)
    the TANGO fan-out. `model_path` and `stage1_model` may be checkpoint
    directories (`checkpoint_file`); the T5 encoder comes from whichever of
    the two holds `text_encoder.*`. A `model_path` directory's
    first_stage_model.bin (a converted orbax checkpoint's frozen VAE and
    vocoder) goes over `vae_checkpoint`'s. Only the UNet roles the pipeline
    holds are loaded.
    `random_init_seed`: the seed the pipeline's random init came from, when
    the caller lets that init stand for what no checkpoint holds; with None,
    every UNet role of the pipeline, the VAE and the vocoder must come from a
    checkpoint."""
    first_stage = (os.path.join(model_path, FIRST_STAGE_FILE)
                   if model_path and os.path.isdir(model_path) else None)
    model_path = checkpoint_file(model_path) if model_path else None
    stage1_model = checkpoint_file(stage1_model) if stage1_model else None
    if stage1_model and not tango_model:
        raise ValueError("stage1_model seeds the student roles of a TANGO fan-out: "
                         "pass tango_model with it")
    cfg = pipeline.config
    loaded: Dict[str, str] = {}
    if vae_checkpoint:
        _load_first_stage(pipeline, vae_checkpoint, loaded, require_vae=True)
    if first_stage and os.path.exists(first_stage):
        _load_first_stage(pipeline, first_stage, loaded, require_vae=False)

    roles, ft_trained, ft_ema, source, model_sd = None, None, None, None, None
    if model_path:
        model_sd = load_torch_state_dict(model_path)
        roles = split_consistencytta_checkpoint(model_sd)
        ft_trained, ft_ema = extract_ftvae_decoders(model_sd)
        source = model_path
    elif tango_model:
        model_sd = load_torch_state_dict(stage1_model) if stage1_model else None
        roles = fan_out_tango_checkpoint(load_torch_state_dict(tango_model), model_sd)
        source = tango_model if model_sd is None else f"{tango_model} + {stage1_model}"
    t5_sd = strip_prefix(model_sd, T5_PREFIX) if model_sd else None
    if t5_sd:
        load_into(pipeline.t5, t5_sd, "t5")
        loaded["t5"] = model_path or stage1_model
    for role in list(pipeline.unets):
        role_sd = roles.get(role) if roles else None
        if not role_sd:
            continue
        if role != "teacher" and "guidance_proj.weight" not in role_sd:
            role_sd = {**role_sd, **init_guidance_params(cfg.unet, seed=0)}
        load_into(_own_module(pipeline, role), role_sd, role)
        loaded[role] = source

    # the FTVAE decoder pair goes over whichever base VAE is in place
    if ft_trained is not None:
        if "vae" not in loaded and random_init_seed is None:
            raise ValueError("FTVAE decoder weights found but no base VAE loaded; pass "
                             "vae_checkpoint")
        load_into(pipeline.vae, ft_trained, "FTVAE decoder", ("decoder.", "post_quant_conv."))
        loaded["vae decoder"] = model_path
    if ft_ema is not None:
        with torch.device(pipeline.device):
            vae_ema = AutoencoderKLDecoder(cfg.vae)
        cast_module(vae_ema, pipeline.dtype).eval().requires_grad_(False)
        load_into(vae_ema, ft_ema, "FTVAE EMA decoder")
        pipeline.vae_ema = vae_ema
        loaded["vae_ema"] = model_path

    if random_init_seed is None:
        missing = [m for m in ("vae", "vocoder", *pipeline.unets) if m not in loaded]
        if missing:
            raise ValueError(f"no checkpoint holds {missing}; allow their seeded random "
                             "init (random_init_seed, --random_init) or pass their files")
    return loaded


# -- training checkpoints ------------------------------------------------------


def ftvae_state_dict(dec_sd: Mapping[str, torch.Tensor],
                     ema_sd: Mapping[str, torch.Tensor]) -> StateDict:
    """An FTVAE state's decoder pair and its EMA (state dicts rooted at
    decoder. / post_quant_conv.) under the reference's keys
    (models/audio_consistency_model_ftvae.py:69-91), which
    `extract_ftvae_decoders` reads back."""
    sd = {"vae." + k: v for k, v in dec_sd.items()}
    for k, v in ema_sd.items():
        root, rest = k.split(".", 1)
        sd[("ema_vae_decoder." if root == "decoder" else "ema_vae_pqconv.") + rest] = v
    return sd


def model_state_dict(state, pipeline=None) -> StateDict:
    """pytorch_model_2.bin's tensors: the state's roles (a LoRA state's
    merged into its base), an FTVAE state's decoder pair and its EMA, and,
    with `pipeline`, its teacher and T5."""
    sd: StateDict = {}
    for role in STUDENT_ROLES:
        module = getattr(state, role)
        if module is None:
            continue
        role_sd = module.state_dict() if state.lora_base is None \
            else merged_state_dict(state.lora_base, module)
        sd.update({f"{role}_unet.{k}": v for k, v in role_sd.items()})
    if getattr(state, "vae_dec", None) is not None:
        sd.update(ftvae_state_dict(state.vae_dec.state_dict(), state.vae_dec_ema.state_dict()))
    if pipeline is not None:
        if "teacher" in pipeline.unets:
            sd.update({f"teacher_unet.{k}": v
                       for k, v in pipeline.unets["teacher"].state_dict().items()})
        sd.update({T5_PREFIX + k: v for k, v in pipeline.t5.state_dict().items()})
    return sd


def _save(obj, path: str, retries: int) -> None:
    """torch.save to a temporary name, then renamed into place, so that a
    failed write never leaves a partial file under the checkpoint's name;
    retried `retries` times, 2 s apart."""
    for attempt in range(retries):
        try:
            torch.save(obj, path + ".tmp")
            os.replace(path + ".tmp", path)
            return
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(2.0)


def save_checkpoint(directory: str, state, pipeline=None, config=None,
                    retries: int = 3) -> None:
    """Write a training checkpoint directory (the layout in the module's
    docstring). `pipeline` adds the teacher and the T5; `config` (a
    PipelineConfig or a dict) is written as config.json. A ZeRO-1 state
    (parallel/mesh.py) is gathered first, every rank taking part, and rank
    0 writes the single-rank files."""
    if getattr(state, "zero1", None) is not None:
        state = gathered_state(state)
        if state is None:
            return
    os.makedirs(directory, exist_ok=True)
    _save(model_state_dict(state, pipeline), os.path.join(directory, MODEL_FILE), retries)
    optimizer = state.optimizer.state_dict()
    if state.lora_base is not None:
        optimizer["lora_factors"] = {r: getattr(state, r).state_dict() for r in STUDENT_ROLES}
    _save(optimizer, os.path.join(directory, OPTIMIZER_FILE), retries)
    _save({"lr_scheduler": state.lr_scheduler.state_dict(), "step": state.step},
          os.path.join(directory, SCHEDULER_FILE), retries)
    if config is not None:
        with open(os.path.join(directory, CONFIG_FILE), "w") as f:
            json.dump(config.to_dict() if hasattr(config, "to_dict") else config, f,
                      indent=2, default=str)


def load_checkpoint(directory: str, state) -> Optional[dict]:
    """Restore a `save_checkpoint` directory into `state` in place: the
    roles, an FTVAE state's decoder pair and its EMA, the optimizer, the LR
    schedule and the step. A LoRA state takes its factors from optimizer.bin
    and keeps its base, which must be the one the checkpoint's roles were
    merged from. Returns config.json's dict, or None. A ZeRO-1 state is
    restored before `shard_train_state`, which shards what it restored."""
    if getattr(state, "zero1", None) is not None:
        raise ValueError("load the checkpoint into the replicated state, then shard it")
    dev = next(state.student.parameters()).device
    load = lambda name: torch.load(os.path.join(directory, name), map_location=dev,
                                   weights_only=True)
    model = torch.load(os.path.join(directory, MODEL_FILE), map_location="cpu", mmap=True,
                       weights_only=True)
    optimizer = load(OPTIMIZER_FILE)
    factors = optimizer.pop("lora_factors", None)
    if (factors is None) != (state.lora_base is None):
        raise ValueError(f"{directory}: a {'LoRA' if factors else 'full'} checkpoint cannot "
                         f"resume a {'LoRA' if state.lora_base is not None else 'full'} run")
    trained, ema = extract_ftvae_decoders(model)
    ftvae = getattr(state, "vae_dec", None) is not None
    if (trained is not None) != ftvae or (ftvae and ema is None):
        raise ValueError(f"{directory}: {'an FTVAE' if trained is not None else 'a'} checkpoint "
                         f"cannot resume {'an FTVAE' if ftvae else 'a'} run (--finetune_vae "
                         "must match, and an FTVAE checkpoint holds the EMA decoder pair)")
    for role in STUDENT_ROLES:
        module = getattr(state, role)
        if module is None:
            continue
        if factors is not None:
            module.load_state_dict(factors[role])
        else:
            load_into(module, strip_prefix(model, f"{role}_unet."), role)
    if ftvae:
        load_into(state.vae_dec, trained, "FTVAE decoder")
        load_into(state.vae_dec_ema, ema, "FTVAE EMA decoder")
    if factors is not None:
        saved = strip_prefix(model, "student_unet.")
        merged = merged_state_dict(state.lora_base, state.student)
        if any(not torch.allclose(merged[k], saved[k].to(dev), rtol=1e-6, atol=0)
               for k in merged):
            raise ValueError(f"{directory}: its student is not this run's LoRA base with the "
                             "saved factors; resume with the flags that loaded the base")
    state.optimizer.load_state_dict(optimizer)
    sched = load(SCHEDULER_FILE)
    state.lr_scheduler.load_state_dict(sched["lr_scheduler"])
    state.step = int(sched["step"])
    config_path = os.path.join(directory, CONFIG_FILE)
    if not os.path.exists(config_path):
        return None
    with open(config_path) as f:
        return json.load(f)


class SummaryWriter:
    """The append-only summary.jsonl of a run (the reference's per-epoch
    log), mirrored to wandb where asked for and importable; without wandb
    it writes the file alone."""

    def __init__(self, output_dir: str, use_wandb: bool = False, wandb_kwargs=None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "summary.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception as e:  # wandb is optional: absent, offline or misconfigured
                print(f"summary: wandb unavailable ({type(e).__name__}: {e}); "
                      "logging to summary.jsonl only")

    def log(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(record)
