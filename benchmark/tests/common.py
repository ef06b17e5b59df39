"""Small configurations for the benchmark's CPU tests."""

from __future__ import annotations

import copy

import torch

from benchmark import manifest


def tiny_pipeline() -> dict:
    """PipelineConfig.tiny() as a dict (the port's own tiny shapes)."""
    from consistencytta_torch.configs import PipelineConfig

    return PipelineConfig.tiny().to_dict()


def tiny_unpadded() -> dict:
    """The tiny shapes with head width 64 in the UNet, which the port pads
    to nothing, so that counted and executed operations are the same."""
    p = copy.deepcopy(tiny_pipeline())
    p["unet"].update(block_out_channels=[64, 64, 128, 128], attention_head_dim=[1, 1, 2, 2])
    return p


def tiny_run(name: str, seed: int = 2 ** 33 + 17, seconds: float = 0.3, trace: bool = False,
             dtype=torch.float32, pipeline=None):
    cell = manifest.cell(name)
    from benchmark import harness

    return harness.run_cell(cell, seed, seconds, trace, "cpu", dtype, pipeline or tiny_pipeline())
