"""The port's fused MRF level (kernel K3, consistencytta_torch/ops/mrf.py):
its plain version against the JAX package's `plain_mrf_level` at s=1
(NWC, transposed to NCL) with a ragged length, and the port's
HiFiGANGenerator as a whole against the JAX one.

Tolerance: fp32 throughout, 1e-5 relative to the output's scale (the same
convolutions summed in another order). The kernel itself runs only on the
card: tests/test_torch_cuda_kernels.py holds it against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.configs import HiFiGANConfig as JaxHiFiGANConfig
from consistencytta_tpu.nn.hifigan import HiFiGANGenerator as JaxHiFiGAN
from consistencytta_tpu.ops.pallas_mrf import plain_mrf_level
from consistencytta_torch.configs import HiFiGANConfig
from consistencytta_torch.io.from_jax import hifigan_state_dict
from consistencytta_torch.nn.hifigan import HiFiGANGenerator, vocoder_postprocess
from consistencytta_torch.ops import mrf

KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _level(rng, c, scale=0.08):
    kernels, biases = [], []  # JAX WIO [k, C_in, C_out]
    for k, ds in zip(KS, DS):
        for _ in range(2 * len(ds)):
            kernels.append((rng.standard_normal((k, c, c)) * scale).astype(np.float32))
            biases.append((rng.standard_normal((c,)) * scale).astype(np.float32))
    return kernels, biases


@pytest.mark.parametrize("b,c,length", [(2, 32, 300), (1, 16, 97)])
def test_plain_level_matches_jax(b, c, length):
    rng = np.random.default_rng(c + length)
    kernels, biases = _level(rng, c)
    x = (rng.standard_normal((b, length, c)) * 0.5).astype(np.float32)
    want = plain_mrf_level(jnp.asarray(x), [jnp.asarray(k) for k in kernels],
                           [jnp.asarray(bb) for bb in biases], KS, DS, 1, 0.1)
    got = mrf.fused_mrf_level(
        torch.from_numpy(x.transpose(0, 2, 1).copy()),
        [torch.from_numpy(k.transpose(2, 1, 0).copy()) for k in kernels],
        [torch.from_numpy(bb) for bb in biases], KS, DS, 0.1,
    )
    want = np.asarray(want).transpose(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(),
                               rtol=1e-5)


@pytest.mark.parametrize("length,d,k", [(97, 3, 11), (300, 5, 7), (64, 1, 3)])
def test_dilated_conv1d_matches_conv1d(length, d, k):
    """Both formulations of the dilated conv equal torch's dilated conv1d
    (float64, exact up to summation order)."""
    g = torch.Generator().manual_seed(length)
    x = torch.randn(2, 16, length, generator=g, dtype=torch.float64)
    w = torch.randn(8, 16, k, generator=g, dtype=torch.float64)
    want = torch.nn.functional.conv1d(x, w, dilation=d, padding=d * (k - 1) // 2)
    for phase_split in (False, True):
        torch.testing.assert_close(mrf.dilated_conv1d(x, w, d, phase_split), want,
                                   rtol=1e-12, atol=1e-12)


def test_level_grad_flows_through_plain_chain():
    rng = np.random.default_rng(1)
    kernels, biases = _level(rng, 8)
    x = torch.from_numpy(rng.standard_normal((1, 8, 40)).astype(np.float32))
    x.requires_grad_()
    ws = [torch.from_numpy(k.transpose(2, 1, 0).copy()) for k in kernels]
    out = mrf.fused_mrf_level(x, ws, [torch.from_numpy(b) for b in biases], KS, DS, 0.1)
    out.square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_halo_and_tile_plan():
    assert mrf.halo(KS, DS) == 60
    assert mrf.tile_plan(32, 163840, 60) == (512, 648, True)
    assert mrf.tile_plan(64, 81920, 60) == (512, 648, True)
    assert mrf.tile_plan(128, 40960, 60) == (224, 360, True)
    assert mrf.tile_plan(32, 100, 60) == (128, 264, True)  # no more than L needs
    assert mrf.tile_plan(512, 5120, 60) == (64, 200, False)
    for c, length in ((32, 163840), (64, 81920), (128, 40960)):
        t, rows, _ = mrf.tile_plan(c, length, 60)
        assert mrf.smem_bytes(c, rows, True) <= mrf.SMEM_LIMIT


def test_hifigan_generator_matches_jax():
    jcfg = JaxHiFiGANConfig(upsample_initial_channel=64)
    cfg = HiFiGANConfig(upsample_initial_channel=64)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, 12, jcfg.num_mels)).astype(np.float32)
    jm = JaxHiFiGAN(jcfg)
    params = jm.init(jax.random.PRNGKey(1), mel)["params"]
    want = np.asarray(jm.apply({"params": params}, mel))
    port = HiFiGANGenerator(cfg)
    port.load_state_dict(hifigan_state_dict(params, cfg))
    with torch.no_grad():
        got = port(torch.from_numpy(mel.transpose(0, 2, 1).copy())).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-4)
    centred = vocoder_postprocess(torch.from_numpy(got))
    assert abs(float(centred.max() + centred.min())) < 1e-6

