"""The reader of the program's spans (`benchmark/spans.py`): a synthetic
Chrome trace with known intervals gives known launches, device and busy
time per span and per innermost span; the per-layer numbers made from it
and from the program's Tracer; a trace without program spans reads None;
and a CPU trace of the port's own generate call holds its spans."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans
from benchmark.harness import Record
from benchmark.spans import LAUNCH_CATEGORIES


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, low_level=False, tid=1):
    return ev(LAUNCH_CATEGORIES[1] if low_level else LAUNCH_CATEGORIES[0],
              "cuLaunchKernel" if low_level else "cudaLaunchKernel", ts, 1, tid, corr)


# Two profiler steps on thread 1. Step 1: generate [0, 90) holds t5 [5, 30)
# (norm [10, 20) in it) and unet [35, 80) (resnet [40, 70), norm [45, 55)).
# Step 2: generate [100, 150) holds unet [110, 140).
TRACE = {"traceEvents": [
    ev("user_annotation", "ProfilerStep#1", 0, 100),
    ev("user_annotation", "ProfilerStep#2", 100, 100),
    ev("user_annotation", "generate", 0, 90),
    ev("user_annotation", "t5", 5, 25),
    ev("user_annotation", "norm", 10, 10),
    ev("user_annotation", "unet", 35, 45),
    ev("user_annotation", "resnet", 40, 30),
    ev("user_annotation", "norm", 45, 10),
    ev("user_annotation", "generate", 100, 50),
    ev("user_annotation", "unet", 110, 30),
    ev("cpu_op", "aten::mm", 12, 2),
    launch(12, 1),                      # in norm in t5
    launch(25, 2, low_level=True),      # in t5: K1 launches by cuLaunchKernel
    launch(47, 3),                      # in norm in resnet in unet
    launch(60, 4),                      # in resnet: a copy
    launch(85, 5),                      # generate's own
    launch(95, 6),                      # outside every span
    launch(120, 7),                     # step 2, in unet
    launch(47, 8, tid=2),               # another thread: in no span
    ev("kernel", "k_norm", 50, 10, corr=1),
    ev("kernel", "mha_packed_kernel", 60, 15, corr=2),
    ev("kernel", "k_norm", 80, 10, corr=3),
    ev("gpu_memcpy", "Memcpy DtoD", 88, 7, corr=4),  # overlaps the k_norm before it
    ev("kernel", "k_glue", 96, 2, corr=5),
    ev("kernel", "k_out", 99, 1, corr=6),
    ev("kernel", "k_unet", 125, 10, corr=7),
    ev("kernel", "k_other", 50, 1, corr=8),
    ev("kernel", "k_orphan", 150, 5, corr=99),  # no launch: not counted
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 12, "id": 1},
]}


def test_read_gives_known_launches_busy_and_device_time_per_span():
    got = spans.read(TRACE)
    assert got["requests"] == 2
    s = got["spans"]
    want = {  # name: (ranges, kernels, device us, busy us)
        "generate": (2, 5, 10 + 15 + 10 + 7 + 2 + 10, 25 + 15 + 2 + 10),
        "t5": (1, 2, 25, 25),
        "unet": (2, 2, 10 + 7 + 10, 15 + 10),
        "resnet": (1, 1, 17, 15),
        "norm": (2, 2, 20, 20),
        "vae_decode": (0, 0, 0, 0),
        "vocoder": (0, 0, 0, 0),
        "transformer": (0, 0, 0, 0),
        "mrf": (0, 0, 0, 0),
    }
    assert set(s) == set(want)
    for name, (count, launches, device_us, busy_us) in want.items():
        assert s[name]["count"] == count, name
        assert s[name]["launches"] == launches, name
        assert s[name]["device_ms"] == pytest.approx(device_us / 1e3), name
        assert s[name]["busy_ms"] == pytest.approx(busy_us / 1e3), name


def test_read_splits_each_op_by_its_innermost_span():
    ops = spans.read(TRACE)["ops"]
    assert ops == {
        "k_norm": {"norm": [pytest.approx(0.020), 2]},
        "mha_packed_kernel": {"t5": [pytest.approx(0.015), 1]},
        "Memcpy DtoD": {"resnet": [pytest.approx(0.007), 0]},
        "k_glue": {"generate": [pytest.approx(0.002), 1]},
        "k_out": {"none": [pytest.approx(0.001), 1]},
        "k_unet": {"unet": [pytest.approx(0.010), 1]},
        "k_other": {"none": [pytest.approx(0.001), 1]},
    }


def test_launches_correlate_through_either_cuda_api():
    low_level_only = [e for e in TRACE["traceEvents"] if e.get("cat") != LAUNCH_CATEGORIES[0]]
    got = spans.read({"traceEvents": low_level_only})
    assert got["spans"]["t5"]["launches"] == 1 and got["spans"]["norm"]["launches"] == 0
    assert set(got["ops"]) == {"mha_packed_kernel"}


def test_a_trace_without_program_spans_reads_none(tmp_path):
    bare = [e for e in TRACE["traceEvents"]
            if e.get("cat") != "user_annotation" or e["name"].startswith("ProfilerStep")]
    assert spans.read({"traceEvents": bare}) is None
    path = tmp_path / "t.json"
    path.write_text('{"traceEvents": []}')
    assert spans.read(str(path)) is None
    run = SimpleNamespace(state={}, records=[])
    assert spans.norm_ms(run) is None and spans.idle_ms(run, "unet") is None
    assert spans.stage_ms(run, "unet") is None


def test_stage_ms_norm_ms_and_idle_ms_from_the_tracer_and_the_trace():
    from consistencytta_torch.utils import Tracer, span

    records = []
    with Tracer() as tracer:
        for i, pause in enumerate((0.004, 0.012, 0.008)):
            t0 = time.perf_counter()
            with span("generate"), span("unet"):
                time.sleep(pause)
            records.append(Record(i, t0, time.perf_counter(), 1, 8))
        with span("generate"), span("unet"):  # after the window: not a record's
            time.sleep(0.05)
    run = SimpleNamespace(state={"tracer": tracer, "spans": spans.read(TRACE)},
                          records=records)
    unet = spans.stage_ms(run, "unet")
    assert 8.0 <= unet < 30.0  # the median request's host ms on the CPU
    assert spans.stage_ms(run, "t5") is None
    assert spans.norm_ms(run) == pytest.approx(0.020 / 2)
    assert spans.idle_ms(run, "unet") == pytest.approx(unet - 0.025 / 2)
    assert spans.idle_ms(run, "vocoder") is None


def test_attach_installs_the_programs_tracer_and_a_cpu_trace_holds_its_spans(tmp_path):
    from consistencytta_torch import utils
    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn
    from consistencytta_torch.models.pipeline import Pipeline

    pipe = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu")
    run = SimpleNamespace(state={})
    spans.attach(run, pipe)
    try:
        assert utils._tracer is run.state["tracer"]
        fn = build_generate_fn(pipe, GenerateConfig(truncate_seconds=0.5))
        ids = torch.randint(2, 100, (1, 8))
        with utils.profile_trace(str(tmp_path), "cpu") as path:
            fn(ids, torch.ones_like(ids), torch.ones_like(ids), torch.ones_like(ids), 3.0)
    finally:
        run.state["tracer"].remove()
    assert [s.name for s in run.state["tracer"].spans] == list(spans.STAGES)
    got = spans.read(path)
    assert got["requests"] == 1 and got["ops"] == {}
    counts = {k: v["count"] for k, v in got["spans"].items()}
    assert counts["generate"] == counts["t5"] == counts["unet"] == 1
    assert counts["norm"] > counts["resnet"] > 0
    assert counts["mrf"] == len(pipe.config.vocoder.upsample_rates)
