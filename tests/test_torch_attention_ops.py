"""The port's attention kernels' plain versions (K1 flash_mha_packed, K2
flash_self_attention, consistencytta_torch/ops/attention.py) and its
Attention module, held against the JAX package: `attention_reference`, the
Pallas kernels in interpret mode (as tests/test_pallas_attention.py runs
them), and nn/attention.py's Attention.

Tolerances: fp32 cases agree to 1e-5 (same math, another summation order);
the bf16 case to 2e-2 absolute (bf16 rounding of the inputs and the
probabilities, in different places in the two frameworks).

The kernels themselves run only on the card: tests/test_torch_cuda_kernels.py
holds them against their plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.nn.attention import Attention as JaxAttention
from consistencytta_tpu.ops.pallas_attention import (
    attention_reference,
    flash_mha_packed as jax_flash_mha_packed,
    flash_self_attention as jax_flash_self_attention,
)
from consistencytta_torch.nn.attention import Attention
from consistencytta_torch.ops import attention as ops


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _fold(x, heads):  # [B, S, H*d] -> [B*H, S, d]
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(0, 2, 1, 3).reshape(b * heads, s, -1)


@pytest.mark.parametrize("b,h,s,d", [(1, 2, 256, 64), (2, 3, 200, 51), (1, 5, 64, 51)])
def test_k1_plain_matches_reference(b, h, s, d):
    """Packed layout, including a ragged S and the UNet's head width 51."""
    rng = np.random.default_rng(s + d)
    q, k, v = (_rand(rng, b, s, h * d) for _ in range(3))
    scale = d ** -0.5
    got = ops.flash_mha_packed_plain(*map(torch.from_numpy, (q, k, v)), h, scale)
    want = attention_reference(_fold(q, h), _fold(k, h), _fold(v, h), scale)
    np.testing.assert_allclose(_fold(got.numpy(), h), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_k1_plain_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    b, h, s, d = 1, 2, 256, 64
    q, k, v = (_rand(rng, b, s, h * d) for _ in range(3))
    want = jax_flash_mha_packed(*map(jnp.asarray, (q, k, v)), h, 0.125,
                                block_q=128, block_k=128, interpret=True)
    got = ops.flash_mha_packed(*map(torch.from_numpy, (q, k, v)), h, 0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bh,s,d", [(2, 256, 128), (1, 100, 64)])
def test_k2_plain_matches_reference_and_pallas(bh, s, d):
    rng = np.random.default_rng(bh * s)
    q, k, v = (_rand(rng, bh, s, d) for _ in range(3))
    scale = d ** -0.5
    got = ops.flash_self_attention(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    want = attention_reference(q, k, v, scale)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    if s % 128 == 0:
        pallas = jax_flash_self_attention(*map(jnp.asarray, (q, k, v)), scale,
                                          block_q=128, block_k=128, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)


def test_plain_bf16_matches_reference():
    rng = np.random.default_rng(11)
    b, h, s, d = 2, 2, 128, 64
    q, k, v = (_rand(rng, b, s, h * d) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = ops.flash_mha_packed(tq, tk, tv, h, d ** -0.5)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(_fold(a, h), jnp.bfloat16) for a in (q, k, v))
    want = attention_reference(jq, jk, jv, d ** -0.5).astype(jnp.float32)
    np.testing.assert_allclose(_fold(got.float().numpy(), h), np.asarray(want),
                               atol=2e-2, rtol=0)


def _port_attention(jparams, query_dim, heads, head_dim, cross_dim=None):
    m = Attention(query_dim, heads, head_dim, cross_dim)
    sd = {f"{n}.weight": torch.from_numpy(np.asarray(jparams[n]["kernel"]).T.copy())
          for n in ("to_q", "to_k", "to_v")}
    sd["to_out.0.weight"] = torch.from_numpy(np.asarray(jparams["to_out"]["kernel"]).T.copy())
    sd["to_out.0.bias"] = torch.from_numpy(np.asarray(jparams["to_out"]["bias"]).copy())
    m.load_state_dict(sd)
    return m


@pytest.mark.parametrize("cross", [False, True])
def test_attention_module_matches_jax(cross):
    """Self-attention (through the padded packed K1 path) and masked
    cross-attention against the JAX module, fp32."""
    rng = np.random.default_rng(5 + cross)
    heads, head_dim, b, s, klen, cdim = 2, 51, 2, 40, 7, 24
    x = _rand(rng, b, s, heads * head_dim)
    enc = _rand(rng, b, klen, cdim) if cross else None
    mask_bias = None
    if cross:
        keep = np.ones((b, klen), np.float32)
        keep[1, 4:] = 0
        mask_bias = ((1.0 - keep) * -10000.0)[:, None, :]
    jm = JaxAttention(heads, head_dim, heads * head_dim)
    params = jm.init(jax.random.PRNGKey(0), x, enc, mask_bias)["params"]
    want = jm.apply({"params": params}, x, enc, mask_bias)
    m = _port_attention(params, heads * head_dim, heads, head_dim, cdim if cross else None)
    with torch.no_grad():
        got = m(torch.from_numpy(x),
                None if enc is None else torch.from_numpy(enc),
                None if mask_bias is None else torch.from_numpy(mask_bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)



# -- the layout the wrappers hand the kernels (pure, runs on CPU tensors) ------

def _projection(b, s, width, longer=0):
    """q, k, v as the modules make them: thirds of one fused projection of
    s + longer rows, cut back to s rows."""
    qkv = torch.zeros(b, s + longer, 3 * width, dtype=torch.bfloat16)
    return qkv[:, :s].split(width, dim=-1)


@pytest.mark.parametrize("b,s,heads,longer", [(2, 200, 5, 0), (1, 64, 20, 0), (3, 77, 2, 51)])
def test_kernel_layout_of_split_views(b, s, heads, longer):
    """Thirds of a fused projection, whole or cut from a longer one (batch
    stride other than S x row stride), and a contiguous output."""
    width = heads * 64
    q, k, v = _projection(b, s, width, longer)
    out = torch.empty(b, s, width, dtype=torch.bfloat16)
    layout = ops.kernel_layout("flash_mha_packed", (q, k, v, out), (b, s, width))
    row = 3 * width * 2
    assert layout == {
        "dims": (width, s, b),
        "row_bytes": [row, row, row, width * 2],
        "batch_bytes": [(s + longer) * row] * 3 + [s * width * 2],
    }
    assert (k.data_ptr() - q.data_ptr(), v.data_ptr() - q.data_ptr()) == (width * 2, width * 4)


def test_kernel_layout_of_a_sliced_batch_and_of_k2():
    q, k, v = (t[1:3] for t in _projection(4, 100, 512))
    layout = ops.kernel_layout("flash_self_attention", (q, k, v), (2, 100, 512))
    assert layout["dims"] == (512, 100, 2)
    assert layout["row_bytes"] == [3 * 512 * 2] * 3
    assert layout["batch_bytes"] == [100 * 3 * 512 * 2] * 3
    assert q.data_ptr() % 16 == 0


def _refused_views():
    q, k, v = _projection(2, 40, 128)
    fp32 = torch.zeros(2, 40, 128)
    transposed = torch.zeros(2, 128, 40, dtype=torch.bfloat16).transpose(1, 2)
    misaligned = torch.zeros(2, 40, 136, dtype=torch.bfloat16)[..., 4:132]
    odd_rows = torch.zeros(2, 40, 132, dtype=torch.bfloat16)[..., :128]
    broadcast = torch.zeros(1, 40, 128, dtype=torch.bfloat16).expand(2, 40, 128)
    return {
        "float32": ((fp32, fp32, fp32), TypeError, "bfloat16"),
        "another_shape": ((q, k[:, :32], v), ValueError, "shape"),
        "features_not_contiguous": ((q, transposed, v), ValueError, "strides"),
        "row_stride_not_a_multiple_of_8": ((q, k, odd_rows), ValueError, "strides"),
        "batch_stride_zero": ((broadcast, k, v), ValueError, "strides"),
        "pointer_not_16_byte_aligned": ((q, k, misaligned), ValueError, "aligned"),
    }


@pytest.mark.parametrize("case", sorted(_refused_views()))
def test_kernel_layout_refuses(case):
    tensors, exception, match = _refused_views()[case]
    with pytest.raises(exception, match=match):
        ops.kernel_layout("flash_mha_packed", tensors, (2, 40, 128))


def test_parse_ptxas_log():
    from consistencytta_torch.ops import _build

    log = """ptxas info    : 0 bytes gmem
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Compiling entry function '_Z6kernelILi128EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi128EEvPf
    64 bytes stack frame, 48 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 64 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem
"""
    assert _build.parse_ptxas(log) == {
        "_Z6kernelILi128EEvPf": {"stack_bytes": 64, "spill_store_bytes": 48,
                                 "spill_load_bytes": 56, "registers": 168,
                                 "static_smem_bytes": 0},
        "_Z5otherv": {"stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
                      "registers": 40, "static_smem_bytes": 4096},
    }
