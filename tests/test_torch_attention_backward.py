"""The analytic attention backward of kernels K1 and K2
(`consistencytta_torch/ops/attention.py`: `attention_backward`,
`mha_packed_backward`) against autograd through the plain versions and
against the JAX package's `_flash_bwd` / `_flash_nhd_bwd` on the same seeded
inputs, float32 on the CPU.

S = 1024 with chunks of 384 queries (the last one short) and of the JAX
package's 512, so that the chunking is exercised on both sides. Tolerance:
1e-5 of each gradient's largest magnitude (float32 products in another
summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_torch.ops import attention as att
from consistencytta_tpu.ops import pallas_attention as jatt

S, SCALE, TOL = 1024, 0.3, 1e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def _autograd(fn, q, k, v, g):
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, torch.from_numpy(g))


@pytest.mark.parametrize("chunk", [384, 512, S])
def test_self_attention_backward(chunk):
    q, k, v, g = _inputs((3, S, 16), 0)
    got = att.attention_backward(*map(torch.from_numpy, (q, k, v, g)), SCALE, chunk)
    want = _autograd(lambda a, b, c: att.attention_plain(a, b, c, SCALE), q, k, v, g)
    jax_grads = jatt._flash_bwd(SCALE, None, None, True, tuple(map(jnp.asarray, (q, k, v))),
                                jnp.asarray(g))
    for a, b, c in zip(got, want, jax_grads):
        _close(a, b)
        _close(a, c)


@pytest.mark.parametrize("chunk", [384, 512])
def test_packed_backward(chunk):
    heads, d = 3, 16
    q, k, v, g = _inputs((2, S, heads * d), 1)
    got = att.mha_packed_backward(*map(torch.from_numpy, (q, k, v, g)), heads, SCALE, chunk)
    want = _autograd(lambda a, b, c: att.flash_mha_packed_plain(a, b, c, heads, SCALE),
                     q, k, v, g)
    jax_grads = jatt._flash_nhd_bwd(heads, SCALE, None, None, True,
                                    tuple(map(jnp.asarray, (q, k, v))), jnp.asarray(g))
    for a, b, c in zip(got, want, jax_grads):
        _close(a, b)
        _close(a, c)


def test_backward_keeps_dtypes_and_strided_views():
    """bf16 slices of one projection, as the UNet hands them: the gradients
    come back in bf16, equal to the float32 analytic gradients rounded once."""
    heads, d = 2, 64
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 256, 3 * heads * d)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 256, heads * d)).astype(np.float32))
    q, k, v = qkv.bfloat16().split(heads * d, dim=-1)
    got = att.mha_packed_backward(q, k, v, g.bfloat16(), heads, SCALE, chunk=96)
    ref = att.mha_packed_backward(q.float(), k.float(), v.float(), g.bfloat16().float(),
                                  heads, SCALE, chunk=96)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        torch.testing.assert_close(a, b.bfloat16(), rtol=0, atol=0)
