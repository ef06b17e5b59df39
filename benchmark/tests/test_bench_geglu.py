"""geglu_roofline.gen: the GEGLUs it counts against those the reference's
UNet computes on the meta device at the published widths and those the
port's UNet query calls at the tiny ones; the bound's arithmetic at
`teacher-b8`'s and `tango-b8`'s shapes; the reading on a synthetic trace,
and None without the GEGLU kernel (the parent's trace)."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import manifest, yardstick
from benchmark.reading import roofline_pct
from benchmark.tests.common import tiny_pipeline
from benchmark.weights import reference_models

NAME = "geglu_roofline.gen"
KERNEL = "void (anonymous namespace)::ctta_geglu_kernel(uint4 const*, uint4*, unsigned int, ...)"


def _module():
    read = manifest.reader(NAME)
    return read, read.__globals__


def _reference_geglus(pipeline, batch=2, tokens=7):
    """(tokens a sample, N) of each GEGLU module call of one query of the
    reference's UNet on the meta device."""
    from benchmark.reference.unet import GEGLU

    unet = reference_models(pipeline, teacher=True).unet
    seen = []
    for m in unet.modules():
        if isinstance(m, GEGLU):
            m.register_forward_pre_hook(
                lambda m, args: seen.append((args[0].shape[1], m.proj.out_features // 2)))
    meta, lat = torch.device("meta"), pipeline["latent"]
    z = torch.zeros(batch, lat["t"], lat["f"], lat["c"], device=meta)
    text = torch.zeros(batch, tokens, pipeline["unet"]["cross_attention_dim"], device=meta)
    ids, vec = torch.zeros(batch, tokens, dtype=torch.long, device=meta), torch.zeros(batch, device=meta)
    with torch.no_grad():
        unet(z, vec, text, ids, vec)
    return seen


@pytest.mark.parametrize("cell", ["teacher-b8", "tango-b8"])
def test_geglus_are_the_reference_unets_at_the_published_widths(cell):
    _, mod = _module()
    p = manifest.cell(cell).pipeline
    counted = mod["geglu_shapes"](p["unet"], p["latent"])
    assert sorted(counted) == sorted(_reference_geglus(p))
    # five at each of levels 0-2 and one in the mid block; N four times the
    # inner width: 1020 / 2040 / 4080 (heads of 51), TANGO's 1280 / 2560 / 5120
    widths = {"teacher-b8": (1020, 2040, 4080), "tango-b8": (1280, 2560, 5120)}[cell]
    assert sorted(counted) == sorted([(4096, widths[0])] * 5 + [(1024, widths[1])] * 5
                                     + [(256, widths[2])] * 5 + [(64, widths[2])])


def test_geglus_are_the_calls_of_a_tiny_port_query(monkeypatch):
    """The (M, N) of each `ops.geglu.geglu` call of one UNet query of the
    port at the tiny shapes (nothing padded there) and batch 2."""
    _, mod = _module()
    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.models.pipeline import Pipeline
    from consistencytta_torch.nn import attention

    p = tiny_pipeline()
    port = Pipeline.create(PipelineConfig.from_dict(p), dtype=torch.float32, device="cpu",
                           roles=("teacher",))
    seen, geglu = [], attention.geglu

    def spy(y):
        seen.append((y.numel() // y.shape[-1], y.shape[-1] // 2))
        return geglu(y)

    monkeypatch.setattr(attention, "geglu", spy)
    b, text = 2, torch.randn(2, 7, p["unet"]["cross_attention_dim"])
    with torch.no_grad():
        port.unets["teacher"](torch.randn(port.latent_shape(b)), torch.full((b,), 500.0), text,
                              torch.ones(b, 7), None)
    counted = mod["geglu_shapes"](p["unet"], p["latent"])
    assert len(seen) == len(counted) == 16
    assert sorted(seen) == sorted((b * s, n) for s, n in counted)


def test_the_bound_at_the_teacher_cells_shapes():
    """A query at the UNet batch of 16 in bf16: 589.1 M output elements
    at the light widths (739.2 M at TANGO's), 6 bytes each at 3.35 TB/s."""
    _, mod = _module()
    for cell, elements in (("teacher-b8", 589_086_720), ("tango-b8", 739_246_080)):
        p = manifest.cell(cell).pipeline
        assert sum(16 * s * n for s, n in mod["geglu_shapes"](p["unet"], p["latent"])) == elements
        got = mod["geglu_bound_s"](p["unet"], p["latent"], 16, 2)
        assert got == pytest.approx(6 * elements / yardstick.PEAK_BYTES, rel=1e-12)
    # 35 queries a teacher-b8 call: 36.9 ms
    p = manifest.cell("teacher-b8").pipeline
    assert 35 * mod["geglu_bound_s"](p["unet"], p["latent"], 16, 2) == pytest.approx(
        36.93e-3, rel=1e-3)


def _run(by_name, batches, pipeline, dtype=torch.bfloat16):
    calls = {i: [b] * 35 for i, b in enumerate(batches)}
    return SimpleNamespace(
        pipeline=pipeline, dtype=dtype, profiled=list(calls),
        timer=SimpleNamespace(calls=lambda stage: calls if stage == "unet" else {}),
        trace_read={"by_name": by_name})


def test_reads_the_kernel_time_against_the_bound_of_each_traced_query():
    read, mod = _module()
    p = manifest.cell("teacher-b8").pipeline
    by_name = {KERNEL: [0.090, 2 * 35 * 16],
               "void (anonymous namespace)::mha_packed_kernel<128, 2, 3, 1, 24>(...)": [0.2, 560],
               "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernel"
               "Impl(...)": [0.14, 1120]}
    run = _run(by_name, [16, 16], p)
    bound = 70 * mod["geglu_bound_s"](p["unet"], p["latent"], 16, 2)
    assert read(run) == pytest.approx(100.0 * bound / 0.090, rel=1e-9)
    assert read(run) == pytest.approx(roofline_pct(run, "ctta_geglu", bound))
    assert 0 < read(run) < 100
    # float32 moves twice the bytes
    assert read(_run(by_name, [16, 16], p, torch.float32)) == pytest.approx(2 * read(run))


def test_none_without_the_kernel_or_traced_unet_calls():
    read, _ = _module()
    p = manifest.cell("teacher-b8").pipeline
    parent = {"void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernel"
              "Impl(...)": [0.14, 1120],
              "void at::native::elementwise_kernel<128, 4, ...direct_copy_kernel_cuda...>":
              [0.15, 1120]}
    assert read(_run(parent, [16], p)) is None
    assert read(_run({KERNEL: [0.05, 560]}, [], p)) is None
    no_trace = _run({KERNEL: [0.05, 560]}, [16], p)
    no_trace.trace_read = None
    assert read(no_trace) is None
