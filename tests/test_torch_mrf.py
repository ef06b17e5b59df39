"""The port's MRF levels (kernels K3 and K7, consistencytta_torch/ops/mrf.py):
the plain version against the JAX package's `plain_mrf_level` at s=1
(NWC, transposed to NCL) with a ragged length, K7's weight pack and launch
plan (emulated in channels-last on the CPU), the vocoder's routing of its
levels by width, and the port's HiFiGANGenerator as a whole against the JAX
one, with and without a level wider than 128 channels.

Tolerance: fp32 throughout, 1e-5 relative to the output's scale (the same
convolutions summed in another order). The kernel itself runs only on the
card: tests/test_torch_cuda_kernels.py holds it against the plain version.
"""

import gc

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
from consistencytta_torch.nn import hifigan
from consistencytta_torch.nn.hifigan import HiFiGANGenerator, vocoder_postprocess
from consistencytta_torch.ops import mrf
from consistencytta_torch.ops._packs import Pack

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
    # the generate path's levels at batch 32: C = 32, 64, 128 in shared memory
    assert mrf.tile_plan(32, 163872, KS, DS) == (656, 776, True)
    assert mrf.tile_plan(64, 81936, KS, DS) == (400, 520, True)
    assert mrf.tile_plan(128, 40968, KS, DS) == (144, 264, True)
    assert mrf.tile_plan(32, 100, KS, DS) == (104, 224, True)  # no more than L needs
    assert mrf.tile_plan(512, 5121, KS, DS) == (144, 264, False)


@pytest.mark.parametrize("c,length", [(32, 163872), (64, 81936), (128, 40968), (256, 20484),
                                      (512, 5121), (512, 2048), (128, 700), (32, 3000)])
def test_tile_plan_fits_the_block(c, length):
    """At every width the vocoder gives the kernel: the block's shared memory
    fits SMEM_LIMIT, its rows hold every ResBlock's T + 2 H_k, and the widest
    conv range (the first conv's output) fits the consumers' m-tiles."""
    t, rows, in_smem = mrf.tile_plan(c, length, KS, DS)
    assert t % 8 == 0 and 8 <= t <= -(-length // 8) * 8
    assert mrf.smem_bytes(c, rows, in_smem) <= mrf.SMEM_LIMIT
    for k, ds in zip(KS, DS):
        hk = sum((d + 1) * (k - 1) // 2 for d in ds)
        assert t + 2 * hk <= rows
        assert t + 2 * hk - 2 * ds[0] * (k - 1) // 2 <= 2 * 64 * mrf.m_tiles(c)


def _unpack(packed, kernel_sizes, c):
    """The inverse of the kernel's weight pack: 18 [C_out, C_in, k]."""
    return [packed[i * c:(i + 1) * c, :k * c].reshape(c, k, c).permute(0, 2, 1)
            for i, k in enumerate(kernel_sizes[i // 6] for i in range(18))]


@pytest.mark.parametrize("c", [32, 64, 128])
def test_weight_pack_round_trips(c):
    """The K-major pack (row conv * C + c_out, column t * C + c_in, zeros
    after the last tap) gives back every torch [C_out, C_in, k] weight."""
    g = torch.Generator().manual_seed(c)
    ws = [torch.randn(c, c, k, generator=g) for k in KS for _ in range(6)]
    bs = [torch.randn(c, generator=g) for _ in range(18)]
    w_packed, b_packed = mrf.pack_weights(ws, bs, KS)
    assert w_packed.shape == (18 * c, -(-11 * c // 64) * 64) and w_packed.dtype == torch.bfloat16
    for got, want in zip(_unpack(w_packed, KS, c), ws):
        assert torch.equal(got, want.bfloat16())
    assert torch.equal(w_packed[c + 5, 2 * c + 7], ws[1][5, 7, 2].bfloat16())
    assert not w_packed[:6 * c, 3 * c:].any()  # past the k = 3 convs' last tap
    assert torch.equal(b_packed, torch.stack(bs).bfloat16())


def test_pack_cache_repacks_after_in_place_update():
    """The K-major pack in the caller's `Pack` (the vocoder holds one a level)."""
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(32, 32, k, generator=g) for k in KS for _ in range(6)]
    bs = [torch.randn(32, generator=g) for _ in range(18)]
    pack = Pack()

    def get(ws, bs):
        return pack.get((*ws, *bs), lambda: mrf.pack_weights(ws, bs, KS))

    first = get(ws, bs)
    assert get(ws, bs) is first  # same version: the same pack
    ptr = first[0].data_ptr()
    with torch.no_grad():
        ws[7].mul_(2.0)  # an optimizer step updates in place
    second = get(ws, bs)
    assert second[0].data_ptr() == ptr  # made anew into the same storage
    assert torch.equal(_unpack(second[0], KS, 32)[7], ws[7].bfloat16())
    bs[3].add_(1.0)
    assert torch.equal(get(ws, bs)[1][3], bs[3].bfloat16())
    # new tensors with the same values are packed anew, never confused with the old
    clones = [w.clone() for w in ws]
    assert get(clones, bs)[0].data_ptr() != ptr
    # the pack holds no tensor it was made from alive
    refs = pack.refs
    del ws, bs, clones, first, second
    gc.collect()
    assert refs and all(r() is None for r in refs)


@pytest.mark.parametrize("channels,frames", [(64, 12), (512, 5)])
def test_hifigan_generator_matches_jax(channels, frames):
    """At 64 initial channels every level takes K3's route; at 512 the first
    level (C = 256) takes K7's, which on the CPU runs the plain chain."""
    jcfg = JaxHiFiGANConfig(upsample_initial_channel=channels)
    cfg = HiFiGANConfig(upsample_initial_channel=channels)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, frames, jcfg.num_mels)).astype(np.float32)
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



# -- K7: the wide levels ----------------------------------------------------

def test_nlc_weight_pack_round_trips():
    """K7's pack (each conv's [C_out, k * C_in], tap t and input channel c_in
    at column t * C + c_in, back to back) gives back every torch weight, and
    the biases as float32 of their bf16 values."""
    c = 192
    g = torch.Generator().manual_seed(c)
    ws = [torch.randn(c, c, k, generator=g) for k in KS for _ in range(6)]
    bs = [torch.randn(c, generator=g) for _ in range(18)]
    w_flat, b_flat = mrf.pack_nlc_weights(ws, bs)
    assert w_flat.dtype == torch.bfloat16 and w_flat.numel() == sum(w.numel() for w in ws)
    off = 0
    for w in ws:
        k = w.shape[-1]
        block = w_flat[off:off + c * k * c].view(c, k * c)
        assert torch.equal(block.view(c, k, c).permute(0, 2, 1), w.bfloat16())
        assert torch.equal(block[5, 2 * c + 7], w[5, 7, 2].bfloat16())
        off += c * k * c
    assert b_flat.dtype == torch.float32
    assert torch.equal(b_flat, torch.stack(bs).bfloat16().float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_level_on_the_cpu_is_the_plain_level(dtype):
    rng = np.random.default_rng(3)
    kernels, biases = _level(rng, 192)
    x = torch.from_numpy(rng.standard_normal((2, 192, 45)).astype(np.float32)).to(dtype)
    ws = [torch.from_numpy(k.transpose(2, 1, 0).copy()).to(dtype) for k in kernels]
    bs = [torch.from_numpy(b).to(dtype) for b in biases]
    before = mrf.wide_mrf_level.launches
    got = mrf.wide_mrf_level(x, ws, bs, KS, DS, 0.1)
    assert torch.equal(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1))
    assert mrf.wide_mrf_level.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("ks,ds", [(KS, DS), ((3, 5), ((1, 2), (1, 3, 5, 7))), ((7,), ((2,),))])
def test_wide_plan_in_channels_last_is_the_plain_level(ks, ds):
    """K7's launches (`wide_plan`) run as their epilogues say, each conv a
    sum over taps of row-shifted [B, L, C] products, in float64: the plain
    level to rounding, for any count of ResBlocks and dilations."""
    g = torch.Generator().manual_seed(len(ks))
    b, c, length = 2, 8, 37
    x = torch.randn(b, c, length, generator=g, dtype=torch.float64)
    ws = [torch.randn(c, c, k, generator=g, dtype=torch.float64) / (c * k) ** 0.5
          for k, d in zip(ks, ds) for _ in range(2 * len(d))]
    bs = [torch.randn(c, generator=g, dtype=torch.float64) * 0.05 for _ in ws]
    lrelu = lambda t: torch.where(t > 0, t, t * 0.1)
    bufs = {"xt": x.transpose(1, 2), "u0": lrelu(x.transpose(1, 2))}
    plan = mrf.wide_plan(ks, ds)
    assert [s.conv for s in plan] == list(range(len(ws)))
    for s in plan:
        assert ws[s.conv].shape[-1] == s.k and s.y0 != s.src and s.y1 != s.src
        h = (s.k - 1) // 2
        src = torch.nn.functional.pad(bufs[s.src], (0, 0, h * s.d, h * s.d))
        t = sum(src[:, j * s.d:j * s.d + length] @ ws[s.conv][:, :, j].T for j in range(s.k))
        t = t + bs[s.conv]
        t = (t + (bufs[s.res] if s.res else 0) + (bufs[s.total] if s.total else 0)) * s.scale
        bufs[s.y0] = lrelu(t) if s.act0 else t
        if s.y1:
            bufs[s.y1] = lrelu(t)
    want = mrf.mrf_level_plain(x, ws, bs, ks, ds, 0.1)
    torch.testing.assert_close(bufs["u"].transpose(1, 2), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("c,b,length,want", [
    (256, 32, 20484, 256), (512, 32, 5121, 256), (512, 8, 5121, 256), (256, 1, 20484, 256),
    (512, 1, 5121, 128), (512, 1, 1031, 64), (384, 32, 700, 128), (384, 2, 700, 64),
    (192, 4, 5000, 64)])
def test_wide_tile_n(c, b, length, want):
    """The widest tile that divides C and still gives each of 132 SMs a tile."""
    assert mrf.wide_tile_n(c, b, length, 132) == want


def test_hifigan_routes_levels_by_width(monkeypatch):
    """C <= 128 to fused_mrf_level (K3), wider to wide_mrf_level (K7), each
    with the level's own Pack."""
    calls = []

    def recorder(name, fn):
        def wrapper(x, ws, bs, ks, ds, slope, pack):
            calls.append((name, x.shape[1], pack))
            return fn(x, ws, bs, ks, ds, slope, pack)
        return wrapper

    monkeypatch.setattr(hifigan, "fused_mrf_level", recorder("fused", mrf.fused_mrf_level))
    monkeypatch.setattr(hifigan, "wide_mrf_level", recorder("wide", mrf.wide_mrf_level))
    torch.manual_seed(0)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=1024,
                                         upsample_rates=(2, 2, 2, 2, 2),
                                         upsample_kernel_sizes=(4, 4, 4, 4, 4)))
    with torch.no_grad():
        voc(torch.randn(1, 64, 3))
    assert [(n, c) for n, c, _ in calls] == [
        ("wide", 512), ("wide", 256), ("fused", 128), ("fused", 64), ("fused", 32)]
    assert [p for _, _, p in calls] == voc.level_packs
