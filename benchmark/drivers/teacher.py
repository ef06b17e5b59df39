"""Driver of `inference/generate.py:build_teacher_generate_fn`: the Heun
CFG teacher (LightweightLDM), whose every query runs the stacked
[uncond; cond] batch through the unguided UNet. Set-up, window and check
are the generate driver's; the entry, the UNet role and the reference are
the teacher's."""

from __future__ import annotations

import sys

from benchmark.drivers import generate
from benchmark.reference import generate as reference

TEACHER = True


def entry(pipe, spec: dict):
    from consistencytta_torch.inference.generate import build_teacher_generate_fn

    return build_teacher_generate_fn(pipe, num_steps=spec["entry"]["num_steps"])


def roles():
    return ("teacher",)


def unet_of(pipe):
    return pipe.unets["teacher"]


def reference_call(models, run, req, noise):
    return reference.teacher(models, run.pipeline, req.ids, req.mask, req.uncond_ids,
                             req.uncond_mask, noise, req.guidance,
                             run.cell.spec["entry"]["num_steps"])


def setup(run) -> None:
    generate.setup(run, sys.modules[__name__])


window, free, check, readings, probed = (generate.window, generate.free, generate.check,
                                         generate.readings, generate.probed)
