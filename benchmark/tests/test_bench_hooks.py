"""The in-situ stage hooks see each stage's calls inside the real entry:
one T5, one UNet, one VAE decode and one vocoder call per 1-NFE call, and
35 UNet queries at the stacked batch per 18-step Heun teacher call."""

import pytest
import torch

from benchmark.hooks import StageTimer
from benchmark.tests.common import tiny_pipeline


@pytest.mark.parametrize("teacher", [False, True])
def test_stage_hooks_count_the_calls(teacher):
    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.inference.generate import (
        GenerateConfig, build_generate_fn, build_teacher_generate_fn)
    from consistencytta_torch.models.pipeline import Pipeline

    p = tiny_pipeline()
    roles = ("teacher",) if teacher else ("student_ema",)
    pipe = Pipeline.create(PipelineConfig.from_dict(p), dtype=torch.float32, device="cpu",
                           roles=roles)
    unet = pipe.unets[roles[0]]
    timer = StageTimer("cpu")
    timer.stage("t5", pipe.t5)
    timer.stage("unet", unet)
    timer.stage("vae_decode", pipe.vae.post_quant_conv, pipe.vae.decoder)
    timer.stage("vocoder", pipe.vocoder)
    fn = (build_teacher_generate_fn(pipe, num_steps=18) if teacher
          else build_generate_fn(pipe, GenerateConfig(num_steps=1)))
    ids = torch.randint(2, 200, (3, 5))
    ones = torch.ones_like(ids)
    for request in (0, 1):
        timer.request = request
        fn(ids, ones, ones, ones, 4.0)
    b = 6 if teacher else 3
    for request in (0, 1):
        assert timer.calls("t5")[request] == [b]
        assert timer.calls("unet")[request] == [b] * (35 if teacher else 1)
        assert timer.calls("vae_decode")[request] == [3]
        assert timer.calls("vocoder")[request] == [3]
    assert all(span[4] is True for span in timer.spans)  # every start has its end
    timer.remove()
    timer.request = 2
    fn(ids, ones, ones, ones, 4.0)
    assert 2 not in timer.calls("unet")
