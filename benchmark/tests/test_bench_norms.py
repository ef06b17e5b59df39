"""The normalisation layers' count (`benchmark/norms.py`) against a count
on the meta device over the reference's modules: every native_group_norm
and native_layer_norm the dispatcher sees, and every RMSNorm module's
input, at the published widths and at the tiny ones; and the bound the
metric `norm_roofline.gen` divides by, per call at batch 32."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import norms, yardstick
from benchmark.reference.t5 import RMSNorm
from benchmark.tests.common import tiny_pipeline
from benchmark.weights import reference_models


class NormCounter(TorchDispatchMode):
    """Elements normalised and affine parameters read, by aten op."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        norm = None
        if func is torch.ops.aten.native_group_norm.default:
            norm = args[0], args[1], args[2]  # input, weight, bias, N, C, HxW, group, eps
        elif func is torch.ops.aten.native_layer_norm.default:
            norm = args[0], args[2], args[3]  # input, normalized_shape, weight, bias, eps
        if norm is not None:
            x, w, b = norm
            self.calls.append((x.numel(), sum(t.numel() for t in (w, b) if t is not None)))
        return func(*args, **(kwargs or {}))


def meta_counts(pipeline, batch=2, tokens=7):
    """{stage: [(elements a sample, affine parameters)]} counted on the meta
    device over one call of the reference's T5, UNet and decoder."""
    m = reference_models(pipeline, teacher=False)
    meta, lat = torch.device("meta"), pipeline["latent"]
    out = {}
    rms = []
    for mod in m.t5.modules():
        if isinstance(mod, RMSNorm):
            mod.register_forward_pre_hook(
                lambda mod, args: rms.append((args[0].numel(), mod.weight.numel())))
    ids = torch.zeros(batch, tokens, dtype=torch.long, device=meta)
    with torch.no_grad():
        m.t5(ids, ids)
        out["t5"] = [(e // batch, a) for e, a in rms]
        z = torch.zeros(batch, lat["t"], lat["f"], lat["c"], device=meta)
        text = torch.zeros(batch, tokens, pipeline["t5"]["d_model"], device=meta)
        vec = torch.zeros(batch, device=meta)
        for stage, call in (("unet", lambda: m.unet(z, vec, text, ids, vec)),
                            ("vae_decode", lambda: m.vae.decode_mel(z))):
            with NormCounter() as counter:
                call()
            out[stage] = [(e // batch, a) for e, a in counter.calls]
    return out


@pytest.mark.parametrize("size", ["published", "tiny"])
def test_norm_count_is_the_reference_count_on_the_meta_device(size):
    from consistencytta_torch.configs import PipelineConfig

    p = PipelineConfig().to_dict() if size == "published" else tiny_pipeline()
    counted = meta_counts(p)
    for stage, calls in counted.items():
        assert sorted(norms.stage_norms(p, stage, 7)) == sorted(calls), stage
    if size == "published":
        per_sample = {s: sum(e for e, _ in c) for s, c in counted.items()}
        # a meta-device count (TorchDispatchMode) at the light widths: 36.04 M GroupNorm
        # and 27.61 M LayerNorm elements a UNet query, 119.54 M a VAE decode
        assert per_sample["unet"] == 36_044_800 + 27_613_440
        assert per_sample["vae_decode"] == 119_537_664
        assert per_sample["t5"] == 49 * 7 * 1024


def test_norm_bound_of_a_gen_b32_call():
    """At batch 32, 64 tokens and bf16: 5.97 G elements a call, 7.1 ms of
    bytes at 3.35 TB/s."""
    from consistencytta_torch.configs import PipelineConfig

    p = PipelineConfig().to_dict()
    calls = {s: norms.stage_norms(p, s, 64) for s in ("t5", "unet", "vae_decode")}
    elements = 32 * sum(e for c in calls.values() for e, _ in c)
    assert elements == pytest.approx(5.97e9, rel=1e-3)
    bound = sum(norms.norm_bound_s(c, 32, 2) for c in calls.values())
    assert bound == pytest.approx(4 * elements / yardstick.PEAK_BYTES, rel=1e-4)
    assert bound == pytest.approx(7.12e-3, rel=1e-2)
    with pytest.raises(ValueError):
        norms.stage_norms(p, "vocoder", 64)
