"""Stage-1 and stage-2 training: the port's counterpart of cli/train.py.

    python -m consistencytta_torch.cli.train --stage 2 --freeze_text_encoder \
        --use_edm --tango_model ckpt/LightweightLDM_pytorch_model_2.bin \
        --stage1_model saved/stage1/best --vae_checkpoint ckpt/audioldm-s-full.ckpt \
        --train_file data/train_audiocaps.json --validation_file data/valid_audiocaps.json \
        --use_bf16 --output_dir saved/stage2

The same flags and defaults as the JAX CLI (recipes/train.sh applies as it
is), plus `--device` (default: the card; "cpu" runs the kernels' plain
versions). Stage 1 distils the CFG teacher into the guided student; stage
2 distils it into the consistency student, along Heun intervals with
`--use_edm`, else DDIM steps, optionally training rank-4 LoRA factors only
(`--use_lora`), with the latent MSE or the `mel` / `stft` losses
(`--loss_type`). Stage 3 is stage 2 with `--loss_type clap` from a stage-2
checkpoint as `--stage1_model`: the CLAP-score loss through the frozen
towers of `--clap_checkpoint` (loaded first; a missing file raises before
any work), with LoRA, or with the VAE decoder trained beside the student
(`--finetune_vae`, which requires the clap loss and excludes LoRA). Each
run appends its flags to `<output_dir>/summary.jsonl` (the replay the
inference CLI reads), trains with a global batch of per-device batch times
devices times accumulation steps, validates every epoch and writes
checkpoint directories (`io/checkpoints.py`): `best`, `epoch_<n>`,
`step_<n>`; `--resume_from_checkpoint` restores one.

`--num_devices N` trains data-parallel on N cards, one process a rank over
NCCL (rank r on cuda:r; N from 1 to the cards present, else ValueError
before any work), or with `--device cpu` on N gloo ranks of the host
(parallel/mesh.py): each rank takes its rows of every global batch, the
gradients are all-reduced, and the AdamW moments and EMA shadows are
ZeRO-1 sharded. Rank 0 writes the log and the checkpoints, in the
single-rank layout, and a checkpoint resumes at any N. Without the flag,
or with 1, the run stays in this process.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional


def _build_parser():
    p = argparse.ArgumentParser(description="Train ConsistencyTTA (PyTorch port)")
    # data
    p.add_argument("--stage", type=int, choices=[1, 2], default=2)
    p.add_argument("--train_file", type=str, default="data/train_audiocaps.json")
    p.add_argument("--validation_file", type=str, default="data/valid_audiocaps.json")
    p.add_argument("--test_file", type=str, default="data/test_audiocaps_subset.json")
    p.add_argument("--num_examples", type=int, default=-1)
    p.add_argument("--text_column", type=str, default="captions")
    p.add_argument("--audio_column", type=str, default="location")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--uncondition", action="store_true")
    p.add_argument("--prefix", type=str, default=None)
    # models
    p.add_argument("--text_encoder_name", type=str, default="google/flan-t5-large")
    p.add_argument("--scheduler_name", type=str, default="stabilityai/stable-diffusion-2-1")
    p.add_argument("--unet_model_config", type=str, default=None)
    p.add_argument("--pipeline_config", type=str, default=None,
                   help='pipeline base config: "tiny" or a config json path')
    p.add_argument("--tango_model", type=str, default=None)
    p.add_argument("--stage1_model", type=str, default=None,
                   help="a stage-1 file or checkpoint directory (seeds the student roles)")
    p.add_argument("--vae_checkpoint", type=str, default=None,
                   help="audioldm-s-full.ckpt (VAE + vocoder weights)")
    p.add_argument("--clap_checkpoint", type=str,
                   default="ckpt/music_audioset_epoch_15_esc_90.14.pt",
                   help="LAION-CLAP checkpoint for --loss_type clap")
    p.add_argument("--random_init", action="store_true",
                   help="let the seeded random init stand for what no checkpoint holds")
    # the text encoder stays frozen (its fine-tuning is not implemented, as in
    # the reference); the flag must be passed, as the reference asserts
    p.add_argument("--freeze_text_encoder", action="store_true", default=False)
    p.add_argument("--use_lora", action="store_true")
    p.add_argument("--finetune_vae", action="store_true")
    # recipe
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--loss_type", type=str, default="mse",
                   choices=["mse", "mel", "stft", "clap"])
    p.add_argument("--use_edm", action="store_true")
    p.add_argument("--use_karras", action="store_true")
    p.add_argument("--use_bf16", action="store_true")
    p.add_argument("--num_diffusion_steps", type=int, default=18)
    p.add_argument("--teacher_guidance_scale", type=float, default=1)
    p.add_argument("--target_ema_decay", type=float, default=0.95)
    p.add_argument("--ema_decay", type=float, default=0.999)
    # optimization
    p.add_argument("--per_device_train_batch_size", type=int, default=2)
    p.add_argument("--per_device_eval_batch_size", type=int, default=2)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--num_devices", type=int, default=None,
                   help="cards to train on data-parallel (with --device cpu: gloo ranks "
                        "of the host); default 1")
    p.add_argument("--no_remat", action="store_true",
                   help="do not recompute the student's forward in its backward")
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--num_train_epochs", type=int, default=40)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--lr_scheduler_type", type=str, default="linear")
    p.add_argument("--num_warmup_steps", type=int, default=0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    # checkpointing / logging
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--checkpointing_steps", type=str, default="best")
    p.add_argument("--save_every", type=int, default=5)
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--starting_epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--with_tracking", action="store_true")
    p.add_argument("--text_len", type=int, default=64,
                   help="fixed tokenized text length")
    p.add_argument("--device", type=str, default="cuda",
                   help='"cuda" (the kernels) or "cpu" (their plain versions)')
    return p


def parse_args(argv=None):
    return _build_parser().parse_args(argv)


def consistency_step_config_from_args(args):
    """The stage-2 step config from the flags (the student's forward is
    recomputed in its backward unless --no_remat, as in the JAX CLI)."""
    from consistencytta_torch.training.step import ConsistencyStepConfig

    return ConsistencyStepConfig(
        snr_gamma=args.snr_gamma,
        teacher_guidance_scale=args.teacher_guidance_scale,
        target_ema_decay=args.target_ema_decay,
        ema_decay=args.ema_decay,
        loss_type=args.loss_type if args.loss_type != "clap" else "mse",
        use_edm=args.use_edm,
        accum_steps=args.gradient_accumulation_steps,
        remat_student=not args.no_remat,
        uncondition=args.uncondition,
    )


def guided_step_config_from_args(args):
    """The stage-1 step config from the flags."""
    from consistencytta_torch.training.step import GuidedStepConfig

    return GuidedStepConfig(
        snr_gamma=args.snr_gamma,
        teacher_guidance_scale=args.teacher_guidance_scale,
        ema_decay=args.ema_decay,
        accum_steps=args.gradient_accumulation_steps,
    )


def optimizer_config_from_args(args, max_steps):
    """AdamW and its LR schedule from the flags."""
    from consistencytta_torch.training.optim import OptimizerConfig

    return OptimizerConfig(
        learning_rate=args.learning_rate,
        adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2,
        adam_epsilon=args.adam_epsilon,
        weight_decay=args.adam_weight_decay,
        num_warmup_steps=args.num_warmup_steps,
        max_train_steps=max_steps,
        lr_scheduler_type=args.lr_scheduler_type,
    )


def schedule_from_args(args, scheduler_config):
    """The solver schedule: DDPM for stage 1, Heun (Karras with
    --use_karras) for --use_edm stage 2, DDIM otherwise."""
    from consistencytta_torch.ops.schedulers import (
        make_ddim_schedule, make_ddpm_schedule, make_heun_schedule,
    )

    if args.stage == 1:
        return make_ddpm_schedule(scheduler_config)
    if args.use_edm:
        return make_heun_schedule(scheduler_config, args.num_diffusion_steps, args.use_karras)
    return make_ddim_schedule(scheduler_config, args.num_diffusion_steps)


def check_args(args) -> None:
    """Refuse what the port does not run, and the JAX CLI's invalid
    combinations, before any work is done."""
    import torch

    from consistencytta_torch.training.optim import SUPPORTED_LR_SCHEDULES

    if args.num_devices is not None:
        cpu = args.device == "cpu"
        present = os.cpu_count() if cpu else torch.cuda.device_count()
        if not 1 <= args.num_devices <= present:
            raise ValueError(f"--num_devices {args.num_devices} out of range (1..{present} "
                             f"{'host cores' if cpu else 'cards present'})")
        if args.num_devices > 1 and args.device not in ("cpu", "cuda"):
            raise ValueError(f"--num_devices {args.num_devices} takes --device cuda (ranks on "
                             f"cuda:0..) or cpu, not {args.device}")
    assert args.freeze_text_encoder, (
        "Text encoder finetuning has not been implemented; pass --freeze_text_encoder.")
    # the SD-2.1 noise-schedule constants are built into PipelineConfig
    if args.scheduler_name != "stabilityai/stable-diffusion-2-1":
        raise ValueError(
            f"--scheduler_name {args.scheduler_name!r} is not supported: the SD-2.1 "
            "schedule constants are built in (stabilityai/stable-diffusion-2-1)")
    if args.use_lora and args.stage == 1:
        raise ValueError("--use_lora applies to stage 2 only")
    if args.use_lora and args.finetune_vae:
        raise ValueError("--use_lora and --finetune_vae are exclusive")
    # the reference's FTVAE model requires the CLAP loss
    # (models/audio_consistency_model_ftvae.py:32); the JAX CLI ignores the
    # flag without it, the port refuses
    if args.finetune_vae and args.loss_type != "clap":
        raise ValueError(f"--finetune_vae requires --loss_type clap, not {args.loss_type}")
    if args.loss_type == "clap" and not os.path.exists(args.clap_checkpoint):
        raise FileNotFoundError(
            f"--loss_type clap needs --clap_checkpoint; {args.clap_checkpoint} does not exist")
    if args.lr_scheduler_type not in SUPPORTED_LR_SCHEDULES:
        raise ValueError(f"--lr_scheduler_type {args.lr_scheduler_type!r} is not supported; "
                         f"choose one of {SUPPORTED_LR_SCHEDULES}")


@dataclass
class TrainRun:
    """Everything `run` needs, as `prepare` built it."""

    args: argparse.Namespace
    pipeline: object
    state: object
    step_fn: Callable
    validate_fn: Callable
    make_train_loader: Callable
    make_eval_loader: Callable
    loop_config: object
    resume_seconds: Optional[float] = None


def prepare(argv=None, mesh=None) -> TrainRun:
    """Parse and check the flags, write the replay, build the pipeline from
    its checkpoints, the loaders, the state and the step functions, and
    restore --resume_from_checkpoint. With `mesh` (parallel/mesh.py), as
    that rank of a --num_devices run: on the mesh's device, the state
    ZeRO-1 sharded after the resume; rank 0 writes the replay."""
    import torch

    from consistencytta_torch.cli.common import append_config_replay, build_pipeline_config
    from consistencytta_torch.io.checkpoints import load_checkpoint, load_frozen_and_roles
    from consistencytta_torch.models.pipeline import Pipeline
    from consistencytta_torch.parallel.mesh import shard_train_state
    from consistencytta_torch.text.tokenizer import load_clap_tokenizer, load_tokenizer
    from consistencytta_torch.training import step as tstep
    from consistencytta_torch.training.clap_loss import build_clap_loss
    from consistencytta_torch.training.ftvae import (
        FTVAETrainState, build_ftvae_train_step, build_ftvae_validation_step,
    )
    from consistencytta_torch.training.data import DataLoader, T2ADataset
    from consistencytta_torch.training.lora import (
        build_lora_consistency_train_step, init_lora_state,
    )
    from consistencytta_torch.training.loop import LoopConfig
    from consistencytta_torch.utils import resolve_device

    args = parse_args(argv)
    check_args(args)
    n_dev = args.num_devices or 1
    if (mesh.world if mesh is not None else 1) != n_dev:
        raise ValueError(f"--num_devices {n_dev} runs one process a rank: through main, or "
                         "prepare(argv, mesh) on each rank of a mesh of that size")
    dev = resolve_device(args.device if mesh is None else mesh.device)
    main_rank = mesh is None or mesh.is_main
    if args.output_dir is None:
        args.output_dir = f"saved/stage{args.stage}_run"
    if main_rank:
        append_config_replay(args.output_dir, args)

    seed = args.seed if args.seed is not None else 0
    towers, clap_tokenizer = None, None
    if args.loss_type == "clap":
        # the towers sized from the checkpoint's shapes, the tokenizer bounded
        # by the text tower's vocabulary (RoBERTa's where local, else the hash
        # stand-in)
        from consistencytta_torch.evaluation.clap_model import load_clap_towers

        towers = load_clap_towers(args.clap_checkpoint, dev)
        clap_tokenizer = load_clap_tokenizer(towers[1].text_branch.config.vocab_size)
        if main_rank:
            print(f"loaded the CLAP towers from {args.clap_checkpoint}")
    config = build_pipeline_config(args)
    dtype = torch.bfloat16 if args.use_bf16 else torch.float32
    if args.use_lora:
        roles = ("student", "teacher")
    elif args.stage == 1:
        roles = ("student", "student_ema", "teacher")
    else:
        roles = ("student", "student_target", "student_ema", "teacher")
    pipeline = Pipeline.create(config, dtype=dtype, device=dev, seed=seed, roles=roles,
                               training=True)
    loaded = load_frozen_and_roles(
        pipeline, tango_model=args.tango_model, stage1_model=args.stage1_model,
        vae_checkpoint=args.vae_checkpoint,
        random_init_seed=seed if args.random_init else None)
    for part, path in loaded.items():
        if main_rank:
            print(f"loaded {part} from {path}")

    tokenizer = load_tokenizer(args.text_encoder_name, vocab_size=config.t5.vocab_size)
    global_batch = args.per_device_train_batch_size * n_dev * args.gradient_accumulation_steps
    train_ds = T2ADataset.from_json(
        args.train_file, args.text_column, args.audio_column, args.num_examples,
        prefix=args.prefix, segment_length=config.segment_samples)
    val_ds = T2ADataset.from_json(
        args.validation_file, args.text_column, args.audio_column,
        prefix=args.prefix, segment_length=config.segment_samples)

    def make_train_loader(epoch):
        return DataLoader(train_ds, tokenizer, global_batch, args.text_len,
                          augment=args.augment, shuffle=True, seed=seed + epoch,
                          clap_tokenizer=clap_tokenizer)

    def make_eval_loader():
        return DataLoader(val_ds, tokenizer, args.per_device_eval_batch_size * n_dev,
                          args.text_len, augment=False, shuffle=False, seed=seed,
                          clap_tokenizer=clap_tokenizer)

    steps_per_epoch = max(len(train_ds) // global_batch, 1)
    max_steps = args.max_train_steps or args.num_train_epochs * steps_per_epoch
    opt_cfg = optimizer_config_from_args(args, max_steps)
    sched = schedule_from_args(args, config.scheduler)
    if args.stage == 1:
        cfg1 = guided_step_config_from_args(args)
        step_fn = tstep.build_guided_train_step(pipeline, sched, cfg1)
        validate_fn = tstep.build_guided_validation_step(pipeline, sched, cfg1)
        state = tstep.TrainState.create(pipeline, opt_cfg, with_target=False)
    else:
        cfg = consistency_step_config_from_args(args)
        clap_loss = None
        if towers is not None:
            # one clip length for the CLAP loss of every step
            clip_seconds = min(10.0, config.segment_samples / config.sample_rate)
            clap_loss = build_clap_loss(pipeline, *towers, clip_seconds=clip_seconds)
        # the 4-loss validation runs for both solvers; a LoRA state's target
        # is merged into the frozen base first (training/step.py:role_unet)
        validate_fn = tstep.build_validation_step(pipeline, sched, cfg)
        if args.use_lora:
            step_fn = build_lora_consistency_train_step(pipeline, sched, cfg, clap_loss)
            state = init_lora_state(pipeline, opt_cfg, seed=seed)
        elif args.finetune_vae:
            step_fn = build_ftvae_train_step(pipeline, sched, cfg, clap_loss)
            validate_fn = build_ftvae_validation_step(pipeline, sched, cfg)
            state = FTVAETrainState.create(pipeline, opt_cfg)
        else:
            step_fn = tstep.build_consistency_train_step(pipeline, sched, cfg, clap_loss)
            state = tstep.TrainState.create(pipeline, opt_cfg)

    resume_seconds = None
    if args.resume_from_checkpoint:
        t0 = time.perf_counter()
        load_checkpoint(args.resume_from_checkpoint, state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        resume_seconds = time.perf_counter() - t0
    if mesh is not None:
        shard_train_state(state, mesh)

    step_every = args.checkpointing_steps
    loop_config = LoopConfig(
        num_epochs=args.num_train_epochs,
        output_dir=args.output_dir,
        save_every=args.save_every,
        eval_batches=max(100 // (args.per_device_eval_batch_size * n_dev), 1),
        starting_epoch=args.starting_epoch,
        seed=seed,
        max_steps=args.max_train_steps,
        save_best=step_every == "best",
        step_checkpoint_every=int(step_every) if str(step_every).isdigit() else None,
        use_wandb=args.with_tracking,
        wandb_kwargs={"project": "consistencytta_torch", "config": vars(args)},
        device=str(dev),
        mesh=mesh,
        accum_steps=args.gradient_accumulation_steps,
    )
    return TrainRun(args, pipeline, state, step_fn, validate_fn, make_train_loader,
                    make_eval_loader, loop_config, resume_seconds)


def run(r: TrainRun):
    """The training loop over a prepared run; returns the final state."""
    from consistencytta_torch.training.loop import train_loop

    return train_loop(r.step_fn, r.validate_fn, r.state, r.pipeline, r.make_train_loader,
                      r.make_eval_loader, r.loop_config, r.pipeline.config)


def _rank_main(mesh, argv):
    run(prepare(argv, mesh))


def main(argv=None):
    """Train; returns the final state, or None from a --num_devices N > 1
    run, whose ranks run in their own processes."""
    from consistencytta_torch.parallel.mesh import spawn

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    check_args(args)
    n = args.num_devices or 1
    if n == 1:
        return run(prepare(argv))
    devices = ["cpu"] * n if args.device == "cpu" else [f"cuda:{i}" for i in range(n)]
    spawn(_rank_main, n, devices, args=(argv,))
    return None


if __name__ == "__main__":
    main()
