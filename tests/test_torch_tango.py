"""TANGO's full UNet (320/640/1280/1280, heads 5/10/20/20: every head 64
wide, so the transformers pad nothing) in the port, on the CPU in float32,
against the benchmark's plain reference (`benchmark/reference/unet.py`),
with seeded weights from `benchmark.weights.make_state` loaded strictly
into both; and the configuration against the JAX package's and the
benchmark's file.

Tolerance: the largest |port - reference| at most TOL of the reference's
largest magnitude. Both run the same float32 arithmetic; only the order of
the sums differs (the port's attention, its upsampling), which moves a
whole query by ~2e-6 of it; the transformer reads 0. The same module in
bfloat16 reads ~1e-2 of it or more, and must fail TOL: the comparison tells
the configuration's precision from the one below.
"""

import dataclasses
import json
import os

import pytest
import torch

from benchmark.reference.unet import Transformer2D as RefTransformer2D
from benchmark.reference.unet import UNet as RefUNet
from benchmark.weights import make_state
from consistencytta_torch.configs import TANGO_FULL_UNET, TANGO_LIGHT_UNET, UNetConfig
from consistencytta_torch.nn.attention import Transformer2D
from consistencytta_torch.nn.unet import UNet2DConditionGuided
from consistencytta_tpu import configs as jax_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # of the largest magnitude: float32 sums in another order (module doc)
SEED = 2 ** 31 + 22
DTYPES = (torch.float32, torch.bfloat16)

# a TANGO-shaped UNet with fewer channels: heads 64 wide at every level, the
# published depth, block types, cross-attention width, groups and eps
SMALL_TANGO = UNetConfig(block_out_channels=(64, 128, 256, 256),
                         attention_head_dim=(1, 2, 4, 4), guided=False)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(ref_cls, port, *args, salt):
    """The reference module `ref_cls(*args)` and `port`, both holding
    make_state's weights for it (norm affines drawn off their 1 / 0, so
    that the affine is checked too)."""
    with torch.device("meta"):
        ref = ref_cls(*args)
    state = make_state(ref, SEED, salt, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(3)
    for k, v in state.items():
        if ".norm" in k or k.startswith("norm") or "conv_norm_out" in k:
            v.add_(0.3 * torch.randn(v.shape, generator=gen))
    ref.to_empty(device="cpu")
    ref.load_state_dict(state, strict=True)
    port.load_state_dict(state, strict=True)
    return ref.eval().requires_grad_(False), port.eval().requires_grad_(False)


def _text(batch, tokens, width):
    """Text states and a mask whose second prompt is padded after 5 tokens."""
    gen = torch.Generator().manual_seed(1)
    text = torch.randn(batch, tokens, width, generator=gen)
    mask = torch.ones(batch, tokens)
    mask[1, 5:] = 0
    return text, mask


def _error(got, want) -> float:
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _check(dtype, err):
    if dtype == torch.float32:
        assert err <= TOL, err
    else:  # the same module in bfloat16 fails the float32 tolerance
        assert not err <= TOL, err


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_at_tangos_level_2_widths(dtype):
    """One Transformer2D at TANGO's level 2 and mid block: 1280 channels, 20
    heads of 64, cross-attention 1024 (rows of 1280 in its LayerNorms), on a
    4 x 4 latent at batch 2 with 8 text tokens, one prompt padded."""
    ch, heads, cross = 1280, 20, 1024
    ref, port = _pair(RefTransformer2D, Transformer2D(ch, heads, cross, groups=32),
                      ch, heads, cross, 32, salt="transformer")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, ch, 4, 4, generator=gen)
    text, mask = _text(2, 8, cross)
    bias = (1.0 - mask) * -10000.0
    with torch.no_grad():
        want = ref(x, text, bias[:, None, None, :])
        got = port.to(dtype)(x.to(dtype), text.to(dtype), bias[:, None, :])
    assert got.shape == want.shape and got.dtype == dtype
    _check(dtype, _error(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_unet_query_of_a_tango_shaped_unet(dtype):
    """A whole teacher query of SMALL_TANGO (every head 64 wide, unpadded as
    TANGO's are; full depth and block types) on a 16 x 8 latent at batch 2.
    In bfloat16 it reads ~0.2 of the largest magnitude, or NaN: torch's own
    bf16 convolution on the CPU (2.13) returns non-finite values now and
    then for channels-last inputs at two threads, which fails as well."""
    ref, port = _pair(RefUNet, UNet2DConditionGuided(SMALL_TANGO),
                      dataclasses.asdict(SMALL_TANGO), salt="unet")
    gen = torch.Generator().manual_seed(4)
    z = torch.randn(2, 16, 8, SMALL_TANGO.in_channels, generator=gen)
    t = torch.tensor([981.0, 17.0])
    text, mask = _text(2, 8, SMALL_TANGO.cross_attention_dim)
    with torch.no_grad():
        want = ref(z, t, text, mask)
        got = port.to(dtype)(z.to(dtype), t, text.to(dtype), mask)
    assert got.shape == want.shape
    _check(dtype, _error(got, want))


def _fields(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_tango_configs_are_the_jax_packages_and_the_benchmarks():
    assert _fields(TANGO_FULL_UNET) == _fields(jax_configs.TANGO_FULL_UNET)
    assert _fields(TANGO_LIGHT_UNET) == _fields(jax_configs.TANGO_LIGHT_UNET)
    assert TANGO_FULL_UNET.block_out_channels == (320, 640, 1280, 1280)
    assert [c // h for c, h in zip(TANGO_FULL_UNET.block_out_channels,
                                   TANGO_FULL_UNET.attention_head_dim)] == [64] * 4
    with open(os.path.join(REPO, "benchmark", "configs", "tango-full.json")) as f:
        tango = json.load(f)
    with open(os.path.join(REPO, "benchmark", "configs", "lightweightldm-teacher.json")) as f:
        teacher = json.load(f)
    assert tango["pipeline"]["unet"] == _fields(dataclasses.replace(TANGO_FULL_UNET,
                                                                    guided=False))
    assert tango["reduced"] == [] and tango["dtype"] == teacher["dtype"]
    # the UNet's widths are all that differs from the light teacher
    light = dict(teacher["pipeline"], unet=tango["pipeline"]["unet"])
    assert tango["pipeline"] == light
