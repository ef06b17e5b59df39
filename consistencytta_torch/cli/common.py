"""Shared CLI helpers: the pipeline config from flags, and the config
replay through summary.jsonl (the port's copy of cli/common.py:34-53,
237-248)."""

from __future__ import annotations

import dataclasses
import json
import os

from consistencytta_torch.configs import PipelineConfig, UNetConfig


def build_pipeline_config(args) -> PipelineConfig:
    """`--pipeline_config` picks the base ("tiny", the test-scale pipeline,
    or the path of a config json); `--unet_model_config` replaces the UNet
    with a reference-format diffusers config."""
    pc = getattr(args, "pipeline_config", None)
    if pc == "tiny":
        base = PipelineConfig.tiny()
    elif pc:
        with open(pc) as f:
            base = PipelineConfig.from_dict(json.load(f))
    else:
        base = PipelineConfig()
    if getattr(args, "unet_model_config", None):
        unet = UNetConfig.from_diffusers_json(args.unet_model_config)
        base = dataclasses.replace(base, unet=unet)
    return base


def append_config_replay(output_dir: str, args) -> None:
    """Append the whole flag namespace to output_dir/summary.jsonl."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "summary.jsonl"), "a") as f:
        f.write(json.dumps(vars(args), default=str) + "\n")


def read_config_replay(path: str) -> dict:
    """The first line of a summary.jsonl: the training run's flags."""
    with open(path) as f:
        return json.loads(f.readline())
