"""Test-set generation: the port's counterpart of cli/inference.py.

    python -m consistencytta_torch.cli.inference --model pytorch_model_2.bin \
        --vae_checkpoint audioldm-s-full.ckpt --test_file test.json \
        --use_edm --use_ema --use_bf16 --skip_eval --output_dir outputs/run

Replays a training run's flags from its summary.jsonl (`--original_args`;
flags typed on the command line win), loads reference-format checkpoints,
generates the test set in batches (the last one padded with empty prompts),
writes 16-kHz int16 wavs (`<name>_s<k>.wav` with `--num_samples`), with
`--query_teacher` also the multi-step CFG teacher's into
`<output_dir>_teacher`, saves the evaluation protocol's mels of the written
files as `all_mels.npz`, and appends one line to `summary.jsonl`. `--stage 1`
samples the guided student (DDIM, or Heun with `--use_edm`) instead of the
consistency student. Same flags and defaults as the JAX CLI, plus
`--device` (default: the card). `--use_bf16` selects bf16 weights and
compute; without it the port runs in float32. With `--test_references` and
without `--skip_eval`, the evaluation harness then scores the written files
against the references (the backbones from `ckpt/` under the working
directory, as in the JAX CLI; the stored mels as `mel_path`), writes
`<output_dir>_evaluation_results.json` and adds the metrics to the summary
line.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _build_parser():
    p = argparse.ArgumentParser(description="ConsistencyTTA inference (PyTorch port)")
    p.add_argument("--original_args", type=str, default=None,
                   help="summary.jsonl from training (config replay)")
    p.add_argument("--model", type=str, default=None, help="pytorch_model_2.bin")
    p.add_argument("--vae_checkpoint", type=str, default=None)
    p.add_argument("--unet_model_config", type=str, default=None)
    p.add_argument("--pipeline_config", type=str, default=None,
                   help='pipeline base config: "tiny" or a config json path')
    p.add_argument("--test_file", type=str, default="data/test_audiocaps_subset.json")
    p.add_argument("--test_references", type=str, default=None)
    p.add_argument("--text_column", type=str, default="captions")
    p.add_argument("--audio_column", type=str, default="location")
    p.add_argument("--prefix", type=str, default=None,
                   help="prepended to every test prompt; a training --prefix replays here")
    p.add_argument("--text_encoder_name", type=str, default="google/flan-t5-large")
    p.add_argument("--stage", type=int, default=2)
    p.add_argument("--guidance_scale_input", type=float, default=4.0)
    p.add_argument("--guidance_scale_post", type=float, default=1.0)
    p.add_argument("--num_steps", type=int, default=1)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--use_edm", action="store_true")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--use_bf16", action="store_true")
    p.add_argument("--query_teacher", action="store_true",
                   help="also generate with the multi-step teacher")
    p.add_argument("--num_teacher_steps", type=int, default=18)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--random_init", action="store_true",
                   help="let the seeded random init stand for what no checkpoint holds")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--text_len", type=int, default=64)
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--no_save_mels", action="store_true",
                   help="skip writing the all_mels.npz artifact")
    p.add_argument("--device", type=str, default="cuda",
                   help='"cuda" (the kernels) or "cpu" (their plain versions)')
    return p


def parse_args(argv=None):
    p = _build_parser()
    args = p.parse_args(argv)
    # the flags typed on this command line (re-parsed with the defaults
    # suppressed): they win over the replayed training config
    for action in p._actions:
        action.default = argparse.SUPPRESS
    args._explicit = set(vars(p.parse_args(argv)))
    return args


# keys local to an inference run, never taken from a replayed training
# config: paths, the evaluation's own seed, random init, the manifest's
# column names, and the device
_REPLAY_EXCLUDE = {
    "original_args", "model", "output_dir", "skip_eval", "no_save_mels",
    "test_file", "test_references", "seed",
    "random_init", "text_column", "audio_column", "device",
}


def apply_config_replay(args, replay: dict):
    """Copy the saved flag namespace onto `args`, except run-local keys and
    the flags typed on this command line."""
    explicit = getattr(args, "_explicit", set())
    for key, val in replay.items():
        if key in _REPLAY_EXCLUDE or key in explicit:
            continue
        if hasattr(args, key):
            setattr(args, key, val)
    return args


def generate_config_from_args(args):
    """The stage-2/3 sampler's GenerateConfig from the flags."""
    from consistencytta_torch.inference.generate import GenerateConfig

    return GenerateConfig(num_steps=args.num_steps, guidance_post=args.guidance_scale_post,
                          use_ema=args.use_ema, use_edm=args.use_edm)


def main(argv=None) -> dict:
    """Run the CLI; returns the summary line's result keys (clip count and
    the seconds of each part)."""
    from consistencytta_torch.cli.common import build_pipeline_config, read_config_replay
    from consistencytta_torch.evaluation.mels import (
        eval_mel_frontend, load_wav_16k, normalized_logmel,
    )
    from consistencytta_torch.inference.generate import (
        build_generate_fn, build_guided_student_generate_fn, build_teacher_generate_fn,
    )
    from consistencytta_torch.io.audio import write_wav
    from consistencytta_torch.io.checkpoints import load_frozen_and_roles
    from consistencytta_torch.models.pipeline import Pipeline
    from consistencytta_torch.text.tokenizer import load_tokenizer, tokenize_with_uncond
    from consistencytta_torch.training.data import T2ADataset
    from consistencytta_torch.utils import seed_all

    args = parse_args(argv)
    if args.original_args:
        replay = read_config_replay(args.original_args)
        # an explicitly passed stage must match the training run's
        if "stage" in args._explicit and "stage" in replay:
            assert args.stage == replay["stage"], "Stage mismatch between training and eval."
        apply_config_replay(args, replay)
    config = build_pipeline_config(args)
    dtype = torch.bfloat16 if args.use_bf16 else torch.float32
    if args.stage == 1:
        role = "student_ema" if args.use_ema else "student"
    else:
        role = "student_ema" if args.use_ema else "student_target"
    roles = (role, "teacher") if args.query_teacher else (role,)
    t0 = time.perf_counter()
    pipeline = Pipeline.create(config, dtype=dtype, device=args.device, seed=args.seed,
                               roles=roles)
    loaded = load_frozen_and_roles(
        pipeline, model_path=args.model, vae_checkpoint=args.vae_checkpoint,
        random_init_seed=args.seed if args.random_init else None)
    if pipeline.device.type == "cuda":
        torch.cuda.synchronize(pipeline.device)
    load_seconds = time.perf_counter() - t0
    for part, path in loaded.items():
        print(f"loaded {part} from {path}")

    if args.stage == 1:
        generate = build_guided_student_generate_fn(
            pipeline, num_steps=args.num_steps, guidance_post=args.guidance_scale_post,
            use_ema=args.use_ema, use_edm=args.use_edm)
    else:
        generate = build_generate_fn(pipeline, generate_config_from_args(args))
    teacher_generate = (
        build_teacher_generate_fn(pipeline, args.num_teacher_steps, args.use_edm)
        if args.query_teacher else None)

    dataset = T2ADataset.from_json(args.test_file, args.text_column, args.audio_column,
                                   prefix=args.prefix, segment_length=config.segment_samples)
    tokenizer = load_tokenizer(args.text_encoder_name, vocab_size=config.t5.vocab_size)
    os.makedirs(args.output_dir, exist_ok=True)
    tea_dir = args.output_dir + "_teacher"
    if teacher_generate is not None:
        os.makedirs(tea_dir, exist_ok=True)
    save_mels = not args.no_save_mels
    mel_frontend = eval_mel_frontend(pipeline.device) if save_mels else None

    generator = seed_all(args.seed, pipeline.device)
    guidance = np.float32(args.guidance_scale_input)
    seconds = {"gen_seconds": 0.0, "teacher_seconds": 0.0, "write_seconds": 0.0,
               "teacher_write_seconds": 0.0, "mel_seconds": 0.0}
    all_names, mel_names, mel_arrays = [], [], []
    caption_map = {}
    b = args.batch_size
    for start in range(0, len(dataset), b):
        caps = dataset.captions[start:start + b]
        if args.num_samples > 1:
            caps = [c for c in caps for _ in range(args.num_samples)]
        caps_padded = caps + [""] * (b * args.num_samples - len(caps))
        text = tokenize_with_uncond(tokenizer, caps_padded, args.text_len)
        t0 = time.perf_counter()
        wav = generate(*text, guidance, generator=generator)
        wav = wav.cpu().numpy()
        seconds["gen_seconds"] += time.perf_counter() - t0

        names = []
        for i in range(len(caps)):
            prompt_idx = start + i // args.num_samples
            src = os.path.basename(dataset.paths[prompt_idx])
            name = src if src.endswith(".wav") else f"output_{prompt_idx}.wav"
            if args.num_samples > 1:
                name = f"{name[:-4]}_s{i % args.num_samples}.wav"
            names.append(name)
        t0 = time.perf_counter()
        paths = [os.path.join(args.output_dir, n) for n in names]
        for path, clip in zip(paths, wav):
            write_wav(path, clip, config.sample_rate)
        seconds["write_seconds"] += time.perf_counter() - t0
        all_names.extend(names)
        caption_map.update(zip(names, caps))
        if save_mels:
            # the files as written, read back: one frontend launch a batch
            t0 = time.perf_counter()
            clips = np.stack([load_wav_16k(path, 1000) for path in paths])
            mel_arrays.extend(normalized_logmel(clips, mel_frontend))
            mel_names.extend(names)
            seconds["mel_seconds"] += time.perf_counter() - t0

        if teacher_generate is not None:
            t0 = time.perf_counter()
            tea = teacher_generate(*text, guidance, generator=generator).cpu().numpy()
            seconds["teacher_seconds"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            for name, clip in zip(names, tea):
                write_wav(os.path.join(tea_dir, name), clip, config.sample_rate)
            seconds["teacher_write_seconds"] += time.perf_counter() - t0

    n = len(all_names)
    print(f"Generated {n} clips in {seconds['gen_seconds']:.1f}s "
          f"({n / max(seconds['gen_seconds'], 1e-9):.2f} clips/s)")
    mel_npz = None
    if save_mels and mel_names:
        mel_npz = os.path.join(args.output_dir, "all_mels.npz")
        np.savez(mel_npz, names=np.array(mel_names), mels=np.stack(mel_arrays),
                 target_centisec=1000)

    result = {"num_clips": n, "load_seconds": load_seconds, **seconds}
    if args.test_references and not args.skip_eval:
        from consistencytta_torch.evaluation.harness import EvaluationHelper

        t0 = time.perf_counter()
        helper = EvaluationHelper(sampling_rate=config.sample_rate, device=args.device)
        metrics = helper.main(args.output_dir, args.test_references, captions=caption_map,
                              mel_path=mel_npz)
        result["eval_seconds"] = time.perf_counter() - t0
        result.update(metrics)
        print(json.dumps(metrics, indent=2))
    with open(os.path.join(args.output_dir, "summary.jsonl"), "a") as f:
        f.write(json.dumps({**vars(args), **result}, default=str) + "\n")
    return result


if __name__ == "__main__":
    main()
