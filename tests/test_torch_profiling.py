"""The port's profiling helpers (consistencytta_torch/utils.py) against the
JAX package's where they have a counterpart, the trace reader on a
hand-made trace with known intervals, and the bench and stage-profile tools
at the tiny size on the CPU."""

import json
import random
import time

import numpy as np
import pytest
import torch

from consistencytta_torch.tools import bench, profile_stages
from consistencytta_torch.utils import PhaseTimer, profile_trace, read_trace, seed_all
from consistencytta_tpu.utils import seed_all as jax_seed_all


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_seed_all_gives_the_jax_packages_host_streams():
    jax_seed_all(7)
    want = (random.random(), np.random.rand(3))
    gen = seed_all(7)
    got = (random.random(), np.random.rand(3))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    draws = (torch.randn(4), torch.randn(4, generator=gen))
    gen = seed_all(7)
    np.testing.assert_array_equal(torch.randn(4).numpy(), draws[0].numpy())
    np.testing.assert_array_equal(torch.randn(4, generator=gen).numpy(), draws[1].numpy())


def test_phase_timer_phases_add_up():
    timer = PhaseTimer()
    t0 = time.perf_counter()
    for name in ("a", "b", "a"):
        with timer.phase(name, sync=torch.device("cpu")):
            time.sleep(0.02)
    wall = time.perf_counter() - t0
    phases = timer.summary()
    assert set(phases) == {"a", "b"}
    assert phases["a"] >= 0.04 and phases["b"] >= 0.02
    assert sum(phases.values()) <= wall


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(None) as nothing:
        pass
    assert nothing is None
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path / "log"), "cpu") as path:
        for _ in range(3):
            x = torch.tanh(x @ x)
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"] if e.get("cat") == "cpu_op"}
    assert {"aten::mm", "aten::tanh"} <= names
    summary = read_trace(path)
    assert summary["busy_ms"] == 0 and summary["kernels"] == 0
    assert len(summary["gaps"]) == 1 and summary["gaps"][0]["ms"] == summary["window_ms"]


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def test_read_trace_on_known_intervals():
    """Window 0-100 us. Device: kernels A [10, 30) and B [20, 40) overlap,
    A again [60, 70), a memcpy [70, 75); busy = 30 + 10 + 5 = 45 us. Idle
    gaps: [0, 10), [40, 60), [75, 100). The host: `outer` spans everything,
    `mid` [35, 65) and `inner` [45, 55) lie in the gap [40, 60)."""
    events = [
        _event("cpu_op", "outer", 0, 100),
        _event("cpu_op", "mid", 35, 30),
        _event("cpu_op", "inner", 45, 10),
        _event("cuda_runtime", "cudaLaunchKernel", 80, 5),
        _event("kernel", "A", 10, 20),
        _event("kernel", "B", 20, 20),
        _event("kernel", "A", 60, 10),
        _event("gpu_memcpy", "Memcpy HtoD", 70, 5),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 5, "id": 1},
    ]
    got = read_trace({"traceEvents": events}, top=1, gaps=2)
    assert got["window_ms"] == pytest.approx(0.1)
    assert got["busy_ms"] == pytest.approx(0.045)
    assert got["busy_share"] == pytest.approx(0.45)
    assert got["kernels"] == 3
    assert got["top_kernels"] == [{"name": "A", "ms": pytest.approx(0.03), "launches": 2}]
    gaps = [(g["start_ms"], g["ms"], g["host_op"]) for g in got["gaps"]]
    # [75, 100): outer and the launch both overlap; outer overlaps most
    assert gaps == [(pytest.approx(0.075), pytest.approx(0.025), "outer"),
                    (pytest.approx(0.04), pytest.approx(0.02), "mid")]
    every = read_trace({"traceEvents": events}, top=None, gaps=10)
    assert [k["name"] for k in every["top_kernels"]] == ["A", "B"]
    assert [round(g["ms"] * 1e3) for g in every["gaps"]] == [25, 20, 10]
    # a gap wholly inside two host ops of equal overlap names the shorter one
    tied = read_trace({"traceEvents": [_event("cpu_op", "long", 0, 100),
                                       _event("cpu_op", "short", 10, 80),
                                       _event("kernel", "K", 0, 20),
                                       _event("kernel", "K", 80, 20)]})
    assert tied["gaps"][0]["host_op"] == "short"
    with pytest.raises(ValueError, match="no complete events"):
        read_trace({"traceEvents": []})


def test_profile_stages_at_the_tiny_size(capsys):
    out = profile_stages.main(["--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [set(line) & {"stages_ms", "profile"} for line in lines] == [{"stages_ms"}, {"profile"}]
    assert set(out["stages_ms"]) == {"t5_ms", "unet_ms", "vae_decode_ms", "vocoder_ms"}
    assert all(v > 0 for v in out["stages_ms"].values())
    profile = out["profile"]
    assert profile["kernels"] == 0 and profile["busy_share"] == 0  # no card, no kernels
    assert profile["window_ms"] > 0 and "trace" not in profile
    assert set(out["kernels_ms"]) == {"K1", "K2", "K3", "K7", "GEGLU", "unaligned_gemm"}
    # on the CPU every stage call runs eagerly: the timed calls and their
    # warm-up, then the traced call and its warm-up
    stages = ("t5", "unet", "vae_decode", "vocoder")
    for part, calls in (("stage_times", 1 + profile_stages.ITERS), ("profile", 2)):
        assert out["graphs"][part] == {s: {"captures": 0, "replays": 0, "eager": calls}
                                       for s in stages}
    assert [line["graphs"] for line in lines] == [out["graphs"]["stage_times"],
                                                   out["graphs"]["profile"]]


def test_profile_stages_takes_a_configuration_file(tmp_path, capsys, monkeypatch):
    """An unguided UNet in the file (here as a benchmark configuration file
    holds it, under "pipeline") is timed in the 18-step Heun CFG teacher's
    calls: 35 UNet queries a call; the first line gives them and the rows
    kernel's launches a call by instantiation (none on the CPU). One timed
    call, to keep the test short."""
    from consistencytta_torch.configs import PipelineConfig

    monkeypatch.setattr(profile_stages, "ITERS", 1)
    tiny = PipelineConfig.tiny().to_dict()
    tiny["unet"]["guided"] = False
    path = tmp_path / "teacher.json"
    path.write_text(json.dumps({"name": "tiny-teacher", "pipeline": tiny}))
    out = profile_stages.main(["--device", "cpu", "--config", str(path), "--batch", "1"])
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["batch"] == 1 and first["unet_queries"] == out["unet_queries"] == 35
    assert out["graphs"]["stage_times"]["unet"]["eager"] == 35 * 2
    assert out["graphs"]["profile"]["unet"]["eager"] == 35 * 2
    assert {int(k): v for k, v in first["norm_rows_launches"].items()} == {
        256: 0, 512: 0, 1024: 0, 1280: 0}
    loaded = profile_stages.load_config(str(path)).to_dict()
    assert json.loads(json.dumps(loaded)) == json.loads(json.dumps(tiny))


def test_profile_stages_kernel_share():
    profile = {"top_kernels": [
        {"name": "void mha_packed_kernel<1>(...)", "ms": 1.0, "launches": 4},
        {"name": "void mha_packed_kernel<2>(...)", "ms": 0.5, "launches": 12},
        {"name": "void mrf_level_kernel<128, 2, true>(...)", "ms": 2.0, "launches": 3},
        {"name": "void ctta_conv_nlc_kernel<256>(...)", "ms": 20.0, "launches": 36},
        {"name": "void ctta_conv_nlc_enter_kernel(...)", "ms": 0.5, "launches": 2},
        {"name": "void ctta_conv_nlc_leave_kernel(...)", "ms": 0.25, "launches": 2},
        {"name": "void ctta_geglu_kernel(uint4 const*, ...)", "ms": 1.25, "launches": 16},
        {"name": "cutlass_gemm", "ms": 9.0, "launches": 100},
        {"name": "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_32x1_nn"
                 "_align1>(...)", "ms": 3.0, "launches": 7},
        {"name": "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_"
                 "64x4_tn_align2>(...)", "ms": 0.25, "launches": 2},
        {"name": "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_"
                 "64x4_tn_align8>(...)", "ms": 4.0, "launches": 5},
        {"name": "some_kernel_align16", "ms": 1.0, "launches": 1}]}
    assert profile_stages.kernel_share(profile) == {
        "K1": {"ms": 1.5, "launches": 16}, "K2": {"ms": 0, "launches": 0},
        "K3": {"ms": 2.0, "launches": 3}, "K7": {"ms": 20.75, "launches": 40},
        "GEGLU": {"ms": 1.25, "launches": 16}, "unaligned_gemm": {"ms": 3.25, "launches": 9}}


def test_bench_prints_one_line_with_the_jax_benchs_keys(capsys):
    line = bench.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["metric"] == "10s_clips_per_sec_per_chip_1nfe"
    assert line["platform"] == "cpu" and line["device_ms_per_call"] is None
    assert line["value"] > 0 and line["teacher_clips_per_sec"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / line["teacher_clips_per_sec"])
