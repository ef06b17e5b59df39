"""The standalone dilated conv (consistencytta_torch/ops/dilated_conv.py,
kernel K5): its plain version against the JAX package's block-space conv
(`nn/layers.py:conv1d_rechanneled_pre`) and against the Pallas kernel it
replaces (`ops/pallas_blockconv.py:_forward`) run in interpret mode, after
unblocking. float32 on the CPU, inputs from a numpy seed.

Layouts: the JAX functions take the signal blocked by s = 2,
[B, L/2, 2*C] (block m holds positions 2m and 2m + 1, channels side by
side), and the kernel as [k, C_in, C_out]; the port takes natural
[B, C, L] and [C_out, C_in, k].

Tolerance: the JAX test's own for these two functions (atol 1e-4, rtol 1e-5
on sums of up to 704 products of unit-normal values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.nn.layers import conv1d_rechanneled_pre
from consistencytta_tpu.ops.pallas_blockconv import _forward as pallas_forward
from consistencytta_tpu.ops.pallas_blockconv import blockconv1d_dense_supported
from consistencytta_torch.ops import dilated_conv as dc

C, S = 64, 2
PAIRS = [(3, 3), (3, 5), (7, 3), (7, 5), (11, 3), (11, 5)]


def _inputs(k, m, seed=7):
    rng = np.random.default_rng(seed)
    x_blocked = rng.standard_normal((2, m, S * C)).astype(np.float32)
    w = rng.standard_normal((k, C, C)).astype(np.float32)
    x = torch.from_numpy(x_blocked).reshape(2, m * S, C).transpose(1, 2).contiguous()
    return x_blocked, w, x, torch.from_numpy(w).permute(2, 1, 0).contiguous()


def _blocked(y: torch.Tensor) -> np.ndarray:
    """natural [B, C, L] -> block space [B, L/2, 2*C]."""
    b, c, length = y.shape
    return y.transpose(1, 2).reshape(b, length // S, S * c).numpy()


@pytest.mark.parametrize("k,d", PAIRS)
def test_plain_matches_the_block_space_conv(k, d):
    p = d * (k - 1) // 2
    m = 136  # ragged against every tile of the TPU kernel
    assert blockconv1d_dense_supported(k, d, S, C, C, m)
    x_blocked, w, x, w_t = _inputs(k, m)
    want = np.asarray(conv1d_rechanneled_pre(jnp.asarray(x_blocked), jnp.asarray(w), d, p, S))
    got = dc.dilated_conv1d(x, w_t, d, p)  # a CPU tensor: the plain version
    assert got.shape == x.shape
    np.testing.assert_allclose(_blocked(got), want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("k,d", PAIRS)
def test_plain_matches_the_pallas_kernel_in_interpret_mode(k, d):
    p = d * (k - 1) // 2
    x_blocked, w, x, w_t = _inputs(k, 131, seed=8)
    want = np.asarray(pallas_forward(jnp.asarray(x_blocked), jnp.asarray(w), d, p, S,
                                     interpret=True))
    got = dc.dilated_conv1d_plain(x, w_t, d, p)
    np.testing.assert_allclose(_blocked(got), want, atol=1e-4, rtol=1e-5)


def test_zero_padding_and_output_length():
    """y[j] = sum_t w[t] x[j - p + t d], x zero outside the signal, for any
    padding: a one-tap-at-a-time check on an impulse."""
    k, d, p, length = 3, 5, 2, 40
    x = torch.zeros(1, 1, length)
    x[0, 0, 0] = 1.0
    w = torch.tensor([[[1.0, 10.0, 100.0]]])
    y = dc.dilated_conv1d_plain(x, w, d, p)
    assert y.shape == (1, 1, length + 2 * p - d * (k - 1))
    want = torch.zeros_like(y)
    want[0, 0, p] = 1.0  # tap 0 sees the impulse at j = p; the others lie left of 0
    assert torch.equal(y, want)


def test_gradient_on_the_cpu_is_the_plain_conv_gradient():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 32, 50)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((32, 32, 3)).astype(np.float32)).requires_grad_()
    dc.dilated_conv1d(x, w, 3, 3).square().sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    torch.nn.functional.conv1d(x, w, dilation=3, padding=3).square().sum().backward()
    assert torch.equal(gx, x.grad) and torch.equal(gw, w.grad)


def test_flops_count():
    assert dc.dilated_conv_flops(32, 64, 81936, 11) == 2 * 32 * 81936 * 64 * 64 * 11
    assert dc.dilated_conv1d.launches == 0  # nothing on the CPU launches the kernel
