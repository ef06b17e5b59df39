"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and `nvcc`; without them they skip. The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(`--noconftest`: tests/conftest.py sets up JAX.) Inputs are bf16. The
tolerances scale with the plain output's own size, as in chip_smoke.py: the
largest error at most 2e-2 (attention) or 3e-2 (the 18-conv MRF chain) of
the output's largest magnitude, and the relative L2 error at most 1e-2.
bf16 rounding alone moves these outputs by about 0.5% on both measures; a
wrong softmax scale or a dropped key tile moves them by 9% or more.
"""

import pytest
import torch

from consistencytta_torch.ops import attention as ops
from consistencytta_torch.ops import mrf

KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3
TOL_L2 = 1e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def assert_close_rel(got, want, tol_max):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol_max * want.abs().max().item()
    assert ((got - want).norm() / want.norm()).item() <= TOL_L2


@pytest.mark.parametrize("b,h,s", [(2, 5, 1024), (1, 20, 200), (2, 20, 64), (1, 3, 77)])
def test_flash_mha_packed(gen, b, h, s):
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.split(h * 64, dim=-1)
    before = ops.flash_mha_packed.launches
    got = ops.flash_mha_packed(q, k, v, h, 51 ** -0.5)
    torch.cuda.synchronize()
    assert ops.flash_mha_packed.launches == before + 1
    assert_close_rel(got, ops.flash_mha_packed_plain(q, k, v, h, 51 ** -0.5), 2e-2)


@pytest.mark.parametrize("b,s", [(2, 4096), (1, 300), (1, 200), (2, 77)])
def test_flash_self_attention(gen, b, s):
    qkv = torch.randn(b, s, 3 * 512, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.split(512, dim=-1)
    got = ops.flash_self_attention(q, k, v, 512 ** -0.5)
    assert_close_rel(got, ops.attention_plain(q, k, v, 512 ** -0.5), 2e-2)


def test_kernels_refuse_what_they_do_not_take(gen):
    x = torch.randn(1, 64, 128, device="cuda")
    with pytest.raises(TypeError):
        ops.flash_mha_packed(x, x, x, 2, 0.1)  # fp32
    y = x.bfloat16()
    with pytest.raises(ValueError):
        ops.flash_self_attention(y, y, y, 0.1)  # D other than 512
    with pytest.raises(ValueError):
        mrf.fused_mrf_level(torch.zeros(1, 48, 10, device="cuda", dtype=torch.bfloat16),
                            [], [], KS, DS, 0.1)


@pytest.mark.parametrize("c,length", [(32, 3000), (64, 1000), (128, 700), (512, 300)])
def test_fused_mrf_level(gen, c, length):
    x = (torch.randn(2, c, length, device="cuda", generator=gen) * 0.5).bfloat16()
    ws = [(torch.randn(c, c, k, device="cuda", generator=gen) / (c * k) ** 0.5).bfloat16()
          for k in KS for _ in range(6)]
    bs = [(torch.randn(c, device="cuda", generator=gen) * 0.05).bfloat16() for _ in range(18)]
    got = mrf.fused_mrf_level(x, ws, bs, KS, DS, 0.1)
    assert_close_rel(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 3e-2)
