"""The port's spans (consistencytta_torch/utils.py `span` and `Tracer`) on
the generate path, at `PipelineConfig.tiny()` in float32 on the CPU: off
they are one shared no-op and record nothing; no mode of them changes a
generated waveform by a bit; an installed Tracer keeps each call's stage
spans as a tree under one root `generate` span, one `unet` span a UNet
call;
and a profiler's Chrome trace holds the stage and module ranges as
`user_annotation` events."""

import json

import numpy as np
import pytest
import torch

from consistencytta_torch import utils
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.inference import generate as gen
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.utils import NO_SPAN, STAGE_SPANS, Tracer, profile_trace, span

BATCH, TEXT_LEN = 2, 8
MODULE_SPANS = ("norm", "resnet", "transformer", "mrf")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port():
    return Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                           roles=STUDENT_ROLES + ("teacher",))


def _inputs(port):
    rng = np.random.default_rng(3)
    ids = rng.integers(2, port.config.t5.vocab_size, size=(BATCH, TEXT_LEN)).astype(np.int64)
    ones = np.ones_like(ids)
    noise = torch.from_numpy(rng.standard_normal(port.latent_shape(BATCH)).astype(np.float32))
    return (ids, ones, ones.copy(), ones.copy()), noise


def _call(fn, port):
    text, noise = _inputs(port)
    return fn(*text, 3.0, noise=noise)


def _generate_fns(port):
    return {
        "student": gen.build_generate_fn(port, gen.GenerateConfig(num_steps=1,
                                                                  truncate_seconds=0.5)),
        "teacher": gen.build_teacher_generate_fn(port, 2, truncate_seconds=0.5),
        "guided": gen.build_guided_student_generate_fn(port, 2, truncate_seconds=0.5),
    }


def test_off_spans_are_one_shared_no_op():
    assert utils._tracer is None
    assert span("norm") is NO_SPAN and span("t5") is NO_SPAN
    with span("unet") as inner:
        assert inner is None
    with Tracer() as tracer:
        # a Tracer keeps its stage spans only; the module spans stay no-ops
        assert span("norm") is NO_SPAN and span("generate") is not NO_SPAN
        assert utils._tracer is tracer
    assert utils._tracer is None and tracer.spans == []


def test_off_generate_records_nothing(port):
    tracer = Tracer()
    _call(_generate_fns(port)["student"], port)
    assert tracer.spans == [] and tracer.requests == 0 and utils._tracer is None


def test_one_tracer_at_a_time():
    first, second = Tracer(), Tracer()
    with first:
        second.install()
        assert utils._tracer is second
        with span("generate"):
            pass
    assert utils._tracer is second  # removing first leaves second in place
    second.remove()
    assert utils._tracer is None and first.spans == [] and len(second.spans) == 1


@pytest.mark.parametrize("sampler", ["student", "teacher", "guided"])
@pytest.mark.parametrize("mode", ["off", "tracer", "profiler"])
def test_generate_is_bit_identical_under_every_mode(port, tmp_path, sampler, mode):
    fn = _generate_fns(port)[sampler]
    want = _call(fn, port)
    if mode == "off":
        got = _call(fn, port)
    elif mode == "tracer":
        with Tracer() as tracer:
            got = _call(fn, port)
        assert tracer.requests == 1
    else:
        with profile_trace(str(tmp_path), "cpu"):
            got = _call(fn, port)
    assert torch.equal(got, want)


def test_a_1nfe_call_is_one_generate_root_over_its_stages(port):
    fn = _generate_fns(port)["student"]
    with Tracer() as tracer:
        _call(fn, port)
        _call(fn, port)
    spans = tracer.spans
    assert [s.name for s in spans] == list(STAGE_SPANS) * 2
    assert tracer.requests == 2 and [s.request for s in spans] == [0] * 5 + [1] * 5
    assert [s.parent for s in spans] == [None, 0, 0, 0, 0, None, 5, 5, 5, 5]
    for s in spans:
        assert s.events is None and s.start <= s.end
    root, stages = spans[0], spans[1:5]
    assert all(root.start <= s.start <= s.end <= root.end for s in stages)
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
    per = tracer.per_request()
    assert set(per) == {0, 1} and set(per[0]) == set(STAGE_SPANS)
    assert per[0]["generate"] >= sum(per[0][k] for k in STAGE_SPANS[1:]) > 0


@pytest.mark.parametrize("num_steps", [2, 3])
def test_a_teacher_call_queries_the_unet_2n_minus_1_times_at_2b(port, num_steps):
    fn = gen.build_teacher_generate_fn(port, num_steps, truncate_seconds=0.5)
    seen = []  # (rows, index of the open span) of each teacher UNet call

    def log_call(module, args):
        seen.append((args[0].shape[0], tracer._stack[-1]))

    hook = port.unets["teacher"].register_forward_pre_hook(log_call)
    try:
        with Tracer() as tracer:
            _call(fn, port)
    finally:
        hook.remove()
    names = [s.name for s in tracer.spans]
    unets = [i for i, s in enumerate(tracer.spans) if s.name == "unet"]
    assert names == ["generate", "t5"] + ["unet"] * (2 * num_steps - 1) + ["vae_decode",
                                                                          "vocoder"]
    assert all(tracer.spans[i].parent == 0 for i in unets)
    assert seen == [(2 * BATCH, i) for i in unets]


def test_the_profilers_trace_holds_stage_and_module_ranges(port, tmp_path):
    with profile_trace(str(tmp_path), "cpu") as path:
        _call(_generate_fns(port)["student"], port)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    names = {n for n, _, _ in ranges}
    assert set(STAGE_SPANS) | set(MODULE_SPANS) <= names

    def inside(child, parent):
        return any(p0 <= c0 and c1 <= p1 for n, c0, c1 in ranges if n == child
                   for m, p0, p1 in ranges if m == parent)

    for child, parent in (("norm", "unet"), ("norm", "t5"), ("resnet", "unet"),
                          ("resnet", "vae_decode"), ("transformer", "unet"),
                          ("mrf", "vocoder"), ("norm", "transformer"), ("norm", "resnet")):
        assert inside(child, parent), (child, parent)
    assert not inside("mrf", "unet")
