"""The GEGLU wrapper (consistencytta_torch/ops/geglu.py) on the CPU.

On a CPU tensor `geglu` is the expression the UNet's GEGLU computed before
the kernel, h * gelu(gate.float()).to(h.dtype) on the two halves of the
`proj` output, bit for bit, in bf16 and float32 at the transformer's aligned
widths and at the tiny ones; the autograd Function that a call with a
gradient takes on the card gives the output and gradient of autograd
through that expression, bit for bit; the card's refusals (dtype, width,
layout, alignment) are raised before anything is launched; the module calls
the wrapper once a GEGLU, 16 times a UNet query. The kernel itself is held
to the plain version on the card (tests/test_torch_cuda_kernels.py -k geglu).
"""

import pytest
import torch
import torch.nn.functional as F

from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.nn import attention
from consistencytta_torch.ops import geglu as ops

# N a half: the light UNet's padded 1024 / 2048 / 4096, TANGO's 1280, the
# tiny UNet's 64 / 128, the published 1020 the light UNet pads, and 8
WIDTHS = (1024, 2048, 4096, 1280, 64, 128, 1020, 8)
DTYPES = (torch.bfloat16, torch.float32)


def _y(n, dtype, rows=37, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (3.0 * torch.randn(2, rows, 2 * n, generator=g)).to(dtype)


def _before(y):
    """The GEGLU module's expression before the kernel."""
    h, gate = y.chunk(2, dim=-1)
    return h * F.gelu(gate.float()).to(h.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", WIDTHS)
def test_plain_path_is_the_expression_it_replaced(n, dtype):
    y = _y(n, dtype)
    got = ops.geglu(y)
    assert got.dtype == dtype and got.shape == (2, 37, n) and got.is_contiguous()
    assert torch.equal(got, _before(y))
    assert torch.equal(ops.geglu_plain(y), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", (1024, 64))
def test_autograd_function_is_autograd_through_the_plain_version(n, dtype, monkeypatch):
    """The Function's backward on the CPU, its forward (the kernel on the
    card, equal to the plain version there bit for bit) standing in as the
    plain version."""
    monkeypatch.setattr(ops, "_geglu_cuda", ops.geglu_plain)
    y0 = _y(n, dtype, seed=1)
    g = torch.randn(2, 37, n, generator=torch.Generator().manual_seed(2)).to(dtype)

    def grad(fn):
        y = y0.clone().requires_grad_()
        out = fn(y)
        return out, torch.autograd.grad(out, y, g)[0]

    out, got = grad(ops._Geglu.apply)
    want_out, want = grad(_before)
    assert torch.equal(out, want_out)
    assert got.dtype == dtype and torch.equal(got, want)
    # the wrapper itself on a CPU tensor with a gradient: autograd through the plain version
    assert torch.equal(grad(ops.geglu)[1], want)


@pytest.mark.parametrize("case", ["float32", "n_1020_halves", "odd_width", "strided",
                                  "misaligned", "empty"])
def test_card_path_refuses_what_the_kernel_does_not_take(case):
    """`_geglu_cuda`'s checks, which run before any launch, on CPU tensors."""
    y = _y(1024, torch.bfloat16, rows=4)[0]
    if case == "float32":
        y, error = y.float(), TypeError
    elif case == "n_1020_halves":
        y, error = y[:, :2040].contiguous(), ValueError
    elif case == "odd_width":
        y, error = y[:, :2047].contiguous(), ValueError
    elif case == "strided":
        y, error = y.t().contiguous().t(), ValueError
    elif case == "misaligned":
        longer = torch.empty(y.numel() + 1, dtype=y.dtype)
        y, error = longer[1:].view(y.shape).copy_(y), ValueError
        assert y.is_contiguous() and y.data_ptr() % 16
    else:
        y, error = y[:0], ValueError
    before = ops.geglu.launches
    with pytest.raises(error):
        ops._geglu_cuda(y)
    assert ops.geglu.launches == before


def test_a_unet_query_calls_the_wrapper_once_a_geglu(monkeypatch):
    """16 GEGLUs a query (five at each of levels 0-2, one in the mid block),
    each one call of `ops.geglu.geglu` on the whole `proj` output."""
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                        roles=("teacher",))
    seen = []

    def spy(y):
        seen.append(tuple(y.shape))
        return ops.geglu(y)

    monkeypatch.setattr(attention, "geglu", spy)
    b, cfg = 2, p.config
    z = torch.randn(p.latent_shape(b), generator=torch.Generator().manual_seed(0))
    text = torch.randn(b, 7, cfg.unet.cross_attention_dim)
    with torch.no_grad():
        p.unets["teacher"](z, torch.full((b,), 500.0), text, torch.ones(b, 7), None)
    assert len(seen) == 16
    lat = cfg.latent
    per_level = {lat.t * lat.f // 4 ** i: 4 * c for i, c in enumerate(cfg.unet.block_out_channels)}
    assert sorted(seen) == sorted([(b, px, 2 * n) for px, n in per_level.items()
                                   for _ in range(1 if px == min(per_level) else 5)])


def _load_chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("unet", ["light", "tango-full"])
def test_chip_smoke_checks_the_geglus_of_a_full_size_query(unet, monkeypatch):
    """chip_smoke.py's (positions, N, launches a query) of the GEGLU kernel,
    `GEGLU_LEVELS` and `GEGLU_TANGO_LEVELS`, are those of one query of the
    full-size UNet, traced on the meta device: N as the module runs it
    (the light UNet's 1020 padded to 1024, its 2040 and 4080 as they are)."""
    from consistencytta_torch.configs import TANGO_FULL_UNET, UNetConfig
    from consistencytta_torch.nn.unet import UNet2DConditionGuided

    smoke = _load_chip_smoke()
    cfg = PipelineConfig()
    unet_cfg, want = {"light": (cfg.unet, smoke.GEGLU_LEVELS),
                      "tango-full": (TANGO_FULL_UNET, smoke.GEGLU_TANGO_LEVELS)}[unet]
    meta = torch.device("meta")
    with meta:
        module = UNet2DConditionGuided(UNetConfig.from_dict({**unet_cfg.to_dict(),
                                                             "guided": False}))
    seen = []

    def spy(y):
        seen.append((y.shape[1], y.shape[-1] // 2))
        return ops.geglu(y)

    monkeypatch.setattr(attention, "geglu", spy)
    b, lat = 2, cfg.latent
    with torch.no_grad():
        module(torch.zeros(b, lat.t, lat.f, lat.c, device=meta), torch.full((b,), 500.0, device=meta),
               torch.zeros(b, 7, unet_cfg.cross_attention_dim, device=meta),
               torch.ones(b, 7, device=meta), None)
    assert sorted(want) == sorted((px, n, seen.count((px, n))) for px, n in set(seen))
    assert sum(k for _, _, k in want) == 16
