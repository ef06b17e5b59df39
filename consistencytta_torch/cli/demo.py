"""Interactive demo: prompts from stdin -> the 1-step student's and the
multi-step teacher's clips, with their wall-clock times (the port's
counterpart of cli/demo.py).

    printf "a dog barks\\n" | python -m consistencytta_torch.cli.demo \\
        --random_init --use_bf16 --output_dir demo_outputs

An empty line or the end of the input ends it. Runs on the card unless
`--device cpu` is passed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ConsistencyTTA demo (PyTorch port)")
    p.add_argument("--original_args", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--vae_checkpoint", type=str, default=None)
    p.add_argument("--unet_model_config", type=str, default=None)
    p.add_argument("--pipeline_config", type=str, default=None,
                   help='pipeline base config: "tiny" or a config json path')
    p.add_argument("--text_encoder_name", type=str, default="google/flan-t5-large")
    p.add_argument("--guidance_scale_input", type=float, default=4.0)
    p.add_argument("--num_teacher_steps", type=int, default=18)
    p.add_argument("--use_bf16", action="store_true")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output_dir", type=str, default="demo_outputs")
    p.add_argument("--skip_teacher", action="store_true")
    p.add_argument("--text_len", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None, stdin=None) -> None:
    from consistencytta_torch.cli.common import build_pipeline_config, read_config_replay
    from consistencytta_torch.inference.generate import (
        GenerateConfig, build_generate_fn, build_teacher_generate_fn,
    )
    from consistencytta_torch.io.audio import write_wav
    from consistencytta_torch.io.checkpoints import load_frozen_and_roles
    from consistencytta_torch.models.pipeline import Pipeline
    from consistencytta_torch.text.tokenizer import load_tokenizer, tokenize_with_uncond
    from consistencytta_torch.utils import seed_all

    args = parse_args(argv)
    if args.original_args:
        replay = read_config_replay(args.original_args)
        if "unet_model_config" in replay and not args.unet_model_config:
            args.unet_model_config = replay["unet_model_config"]

    config = build_pipeline_config(args)
    roles = ("student_ema",) if args.skip_teacher else ("student_ema", "teacher")
    pipeline = Pipeline.create(config, dtype=torch.bfloat16 if args.use_bf16 else torch.float32,
                               device=args.device, seed=args.seed, roles=roles)
    load_frozen_and_roles(pipeline, model_path=args.model, vae_checkpoint=args.vae_checkpoint,
                          random_init_seed=args.seed if args.random_init else None)
    generate = build_generate_fn(pipeline, GenerateConfig(num_steps=1))
    teacher_generate = None if args.skip_teacher else \
        build_teacher_generate_fn(pipeline, args.num_teacher_steps)
    tokenizer = load_tokenizer(args.text_encoder_name, vocab_size=config.t5.vocab_size)
    os.makedirs(args.output_dir, exist_ok=True)
    generator = seed_all(args.seed, pipeline.device)
    guidance = np.float32(args.guidance_scale_input)

    def timed(fn, text):
        t0 = time.perf_counter()
        wav = fn(*text, guidance, generator=generator).cpu().numpy()
        return wav, time.perf_counter() - t0

    count = 0
    print("Enter a prompt (empty line to quit):", flush=True)
    for line in stdin or sys.stdin:
        prompt = line.strip()
        if not prompt:
            break
        text = tokenize_with_uncond(tokenizer, [prompt], args.text_len)
        wav, t_student = timed(generate, text)
        path = os.path.join(args.output_dir, f"student_{count}.wav")
        write_wav(path, wav[0], config.sample_rate)
        print(f"  1-step student: {t_student:.3f}s -> {path}")
        if teacher_generate is not None:
            tea, t_teacher = timed(teacher_generate, text)
            path = os.path.join(args.output_dir, f"teacher_{count}.wav")
            write_wav(path, tea[0], config.sample_rate)
            print(f"  {args.num_teacher_steps}-step teacher: {t_teacher:.3f}s "
                  f"({t_teacher / max(t_student, 1e-9):.1f}x slower) -> {path}")
        count += 1
        print("Enter a prompt (empty line to quit):", flush=True)


if __name__ == "__main__":
    main()
