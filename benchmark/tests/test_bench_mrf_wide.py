"""mrf_wide_roofline.gen on a synthetic trace: the bound's arithmetic (the
widest levels, those K3 did not run, at each traced vocoder call's batch),
None without K7's kernels, and the levels it counts following K3's
launches a call."""

from types import SimpleNamespace

import pytest

from benchmark import manifest, yardstick
from benchmark.reading import roofline_pct

NAME = "mrf_wide_roofline.gen"


def _module():
    read = manifest.reader(NAME)
    return read, read.__globals__


def _run(by_name, batches):
    from consistencytta_torch.configs import PipelineConfig

    calls = {i: [b] for i, b in enumerate(batches)}
    return SimpleNamespace(
        pipeline=PipelineConfig().to_dict(), profiled=list(calls),
        timer=SimpleNamespace(calls=lambda stage: calls if stage == "vocoder" else {}),
        trace_read={"by_name": by_name})


def test_the_bound_of_the_wide_levels_at_the_generate_shapes():
    _, mod = _module()
    from consistencytta_torch.configs import PipelineConfig

    voc = PipelineConfig().to_dict()["vocoder"]
    levels = yardstick.vocoder_levels(voc, 1024)
    assert levels[:2] == [(512, 5121), (256, 20484)]
    # 2 b L C^2 126 operations a level at 989 TFLOP/s: 10.95 ms each at batch 32
    per_level = 2.0 * 32 * 5121 * 512 ** 2 * 126 / yardstick.PEAK_FLOPS
    assert per_level == pytest.approx(10.946e-3, rel=1e-3)
    got = mod["wide_bound_s"](voc, 1024, 32, 3)
    want = sum(yardstick.bound_s(2.0 * 32 * n * c * c * 126, 0.0) for c, n in levels[:2])
    assert got == pytest.approx(want, rel=1e-9) == pytest.approx(2 * per_level, rel=1e-3)
    # the levels K3 did not run: one more when K3 ran two a call
    assert mod["wide_bound_s"](voc, 1024, 32, 2) == pytest.approx(
        got + yardstick.k3_bound_s(voc, 1024, 32, 3) - yardstick.k3_bound_s(voc, 1024, 32, 2))


def test_reads_k7_time_against_the_bound_of_each_traced_call():
    read, mod = _module()
    from consistencytta_torch.configs import PipelineConfig

    voc = PipelineConfig().to_dict()["vocoder"]
    by_name = {
        "void (anonymous namespace)::ctta_conv_nlc_kernel<256>(CUtensorMap_st, ...)": [0.030, 72],
        "void (anonymous namespace)::ctta_conv_nlc_enter_kernel(...)": [0.001, 4],
        "void (anonymous namespace)::ctta_conv_nlc_leave_kernel(...)": [0.001, 4],
        "void (anonymous namespace)::mrf_level_kernel<128, 2, true>(...)": [0.040, 6],
        "void (anonymous namespace)::ctta_norm_groups_kernel<...>(...)": [0.009, 100],
    }
    run = _run(by_name, [32, 8])
    bound = mod["wide_bound_s"](voc, 1024, 32, 3) + mod["wide_bound_s"](voc, 1024, 8, 3)
    assert read(run) == pytest.approx(100.0 * bound / 0.032, rel=1e-9)
    assert read(run) == pytest.approx(roofline_pct(run, "ctta_conv_nlc", bound))
    assert 0 < read(run) < 100


def test_none_without_k7_or_traced_vocoder_calls():
    read, _ = _module()
    parent = {"void (anonymous namespace)::mrf_level_kernel<128, 2, true>(...)": [0.040, 6],
              "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc": [0.1, 50]}
    assert read(_run(parent, [32, 32])) is None
    assert read(_run({"ctta_conv_nlc_kernel<256>": [0.03, 72]}, [])) is None
    no_trace = _run({}, [32])
    no_trace.trace_read = None
    assert read(no_trace) is None
    # K3's launches that no count of calls divides: no level split to read
    assert read(_run({"ctta_conv_nlc_kernel<256>": [0.03, 72],
                      "mrf_level_kernel<128, 2, true>": [0.04, 5]}, [32, 32])) is None
