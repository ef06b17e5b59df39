"""The yardstick: the trace reader on a synthetic trace, K1's and K3's
bounds at the shapes of the generate path, and the operations of a
generate call counted on the meta device against FlopCounterMode on the
port itself."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import yardstick
from benchmark.tests.common import tiny_unpadded


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_read_trace_busy_union_kernels_and_gaps(tmp_path):
    trace = {"traceEvents": [
        event("aten::mm", "cpu_op", 0, 100),
        event("k_a", "kernel", 10, 20),
        event("k_b", "kernel", 20, 20),  # overlaps k_a: busy counts 10..40 once
        event("memcpy", "gpu_memcpy", 50, 10),
        event("aten::copy_", "cpu_op", 40, 8),  # the innermost op over the 40..50 gap
        event("k_a", "kernel", 90, 10),
        {"ph": "i", "name": "marker", "ts": 5},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    r = yardstick.read_trace(str(path))
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((30 + 10 + 10) * 1e-6)
    assert r["kernels"] == 3
    assert r["by_name"]["k_a"] == [pytest.approx(30e-6), 2]
    assert yardstick.kernel_seconds(r, "k_") == (pytest.approx(50e-6), 3)
    gaps = dict((round(s * 1e6), op) for op, s in r["gaps"])
    assert gaps[30] == "aten::mm" and gaps[10] in ("aten::mm", "aten::copy_")
    assert r["gaps"][0] == ["aten::mm", pytest.approx(30e-6)]
    with pytest.raises(ValueError):
        yardstick.read_trace({"traceEvents": []})


def test_k1_and_k3_bounds_at_the_generate_shapes():
    from consistencytta_torch.configs import PipelineConfig

    p = PipelineConfig().to_dict()
    shapes = yardstick.k1_shapes(p["unet"], p["latent"])
    assert len(shapes) == 16 and shapes.count((4096, 5, 51)) == 5
    assert shapes.count((64, 20, 51)) == 1
    # PERF.md's K1 bound per generate call at batch 32: 3.22 ms of operations
    assert yardstick.k1_bound_s(p["unet"], p["latent"], 32) == pytest.approx(3.2193e-3, rel=1e-3)
    levels = yardstick.vocoder_levels(p["vocoder"], 1024)
    assert levels[2:] == [(128, 40968), (64, 81936), (32, 163872)]
    # the three fused levels at batch 32: 9.6 ms of operations
    assert yardstick.k3_bound_s(p["vocoder"], 1024, 32, 3) == pytest.approx(9.5776e-3, rel=1e-3)


@pytest.mark.parametrize("teacher", [False, True])
def test_generate_flops_against_the_port(teacher):
    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.inference.generate import (
        GenerateConfig, build_generate_fn, build_teacher_generate_fn)
    from consistencytta_torch.models.pipeline import Pipeline

    p = tiny_unpadded()
    if teacher:
        p["unet"]["guided"] = False
    cfg = PipelineConfig.from_dict(p)
    roles = ("teacher",) if teacher else ("student_ema",)
    pipe = Pipeline.create(cfg, dtype=torch.float32, device="cpu", roles=roles)
    b, n = 2, 6
    ids = torch.randint(2, 200, (b, n))
    ones = torch.ones_like(ids)
    fn = (build_teacher_generate_fn(pipe, num_steps=3) if teacher
          else build_generate_fn(pipe, GenerateConfig(num_steps=1)))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(ids, ones, ones, ones, 4.0)
    queries, ub = (5, 2 * b) if teacher else (1, b)
    assert yardstick.generate_flops(p, b, n, queries, ub, teacher) == counter.get_total_flops()
