"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and `nvcc`; without them they skip. The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(`--noconftest`: tests/conftest.py sets up JAX.) The attention, MRF (K3 and
the wide levels' K7) and dilated-conv inputs are bf16. Their tolerances
scale with the plain output's own size, as in chip_smoke.py: the largest
error at most 2e-2 (attention, one conv) or 3e-2 (the 18-conv MRF chain) of
the output's largest magnitude, and the relative L2 error at most 1e-2.
bf16 rounding alone moves these outputs by about 0.5% on both measures; a
wrong softmax scale or a dropped key tile moves them by 9% or more.

The norm kernel (GroupNorm with or without its SiLU, LayerNorm, RMSNorm;
bf16 and float32) is held in bf16 ulps of the output against its plain
float32 version: 1 ulp in bf16 (each side rounds once), half a bf16 ulp in
float32 (float32 sums in another order); the reasons and the planted
faults it rejects are in consistencytta_torch/tools/norm_cases.py.

The GEGLU kernel (bf16 in and out) computes what the four PyTorch passes
it replaced compute, the float32 gelu rounded to bf16 before the product,
and is held to them bit for bit (CUDA 12.9's nvcc contracts the gelu as
the card's PyTorch build does); the tanh-approximate gelu and the halves
exchanged move the output by many bf16 steps.

The STFT magnitude (filters of 1024 and 512 samples) is float32 in and out
and is held to float32 grade: the largest error at most 1e-5 of the output's
largest magnitude (a float32 FFT and a float32 product of 1024 terms differ
by about 1e-6 of it), which a
single bf16 or TF32 pass (1e-3 to 1e-4 of it), zero padding or a dropped
window tail all fail.
"""

import ctypes
import hashlib

import pytest
import torch
import torch.nn.functional as F

from consistencytta_torch.configs import STFTConfig
from consistencytta_torch.ops import attention as ops
from consistencytta_torch.ops import dilated_conv as dc
from consistencytta_torch.ops import geglu, mrf, norm, stft
from consistencytta_torch.ops._packs import Pack
from consistencytta_torch.tools import mrf_cases as mc
from consistencytta_torch.tools import norm_cases as nc

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


@pytest.mark.parametrize("b,h,s", [(2, 5, 1024), (1, 20, 200), (2, 20, 64), (1, 3, 77),
                                   (2, 5, 4096), (1, 2, 127), (1, 2, 129), (1, 5, 4095),
                                   (2, 20, 256), (1, 3, 300)])
def test_flash_mha_packed(gen, b, h, s):
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.split(h * 64, dim=-1)
    before = ops.flash_mha_packed.launches
    got = ops.flash_mha_packed(q, k, v, h, 51 ** -0.5)
    torch.cuda.synchronize()
    assert ops.flash_mha_packed.launches == before + 1
    assert_close_rel(got, ops.flash_mha_packed_plain(q, k, v, h, 51 ** -0.5), 2e-2)


@pytest.mark.parametrize("s,h", [(4096, 5), (1024, 10), (256, 20), (64, 20)])
def test_flash_mha_packed_at_batch_64(gen, s, h):
    """The CFG teacher's shapes at a generate batch of 32: the stacked
    [uncond; cond] batch of 64 (grid and tensor maps sized by B x H). The
    plain version runs in chunks of 8 rows to bound its [S, S] logits."""
    b = 64
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.split(h * 64, dim=-1)
    before = ops.flash_mha_packed.launches
    got = ops.flash_mha_packed(q, k, v, h, 51 ** -0.5)
    torch.cuda.synchronize()
    assert ops.flash_mha_packed.launches == before + 1
    want = torch.cat([ops.flash_mha_packed_plain(q[i:i + 8], k[i:i + 8], v[i:i + 8], h, 51 ** -0.5)
                      for i in range(0, b, 8)])
    assert_close_rel(got, want, 2e-2)
    assert_close_rel(got[32:], ops.flash_mha_packed(q[32:], k[32:], v[32:], h, 51 ** -0.5), 2e-2)


@pytest.mark.parametrize("b,h,s", [(8, 10, 1024), (2, 5, 333)])
def test_flash_mha_packed_gradient_under_autocast_is_the_plain_gradient(gen, b, h, s):
    """As the student's backward takes it: q, k, v are slices of one
    projection that requires grad and the kernel runs under autocast; the
    gradient equals autograd through the plain version outside autocast, and
    the tolerance rejects the k and v gradients exchanged."""
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen).bfloat16()
    g = torch.randn(b, s, h * 64, device="cuda", generator=gen).bfloat16()

    def grad(fn, autocast):
        leaf = qkv.clone().requires_grad_()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = fn(*leaf.split(h * 64, dim=-1), h, 51 ** -0.5)
        return torch.autograd.grad(out, leaf, g)[0]

    before = ops.flash_mha_packed.launches
    got = grad(ops.flash_mha_packed, True)
    assert ops.flash_mha_packed.launches == before + 1
    want = grad(ops.flash_mha_packed_plain, False)
    assert_close_rel(got, want, 2e-2)
    dq, dk, dv = want.split(h * 64, dim=-1)
    with pytest.raises(AssertionError):
        assert_close_rel(torch.cat([dq, dv, dk], dim=-1), want, 2e-2)


@pytest.mark.parametrize("b,s", [(2, 4096), (1, 333)])
def test_flash_self_attention_gradient_under_autocast_is_the_plain_gradient(gen, b, s):
    """As the stage-3 decoder's backward takes it (the VAE mid-block under
    autocast, q, k, v slices of one projection): the gradient equals
    autograd through the plain version outside autocast, in bf16, and the
    tolerance rejects the gradient at 1.1 x the scale and dk, dv exchanged."""
    qkv = torch.randn(b, s, 3 * 512, device="cuda", generator=gen).bfloat16()
    g = torch.randn(b, s, 512, device="cuda", generator=gen).bfloat16()

    def grad(fn, autocast, scale=512 ** -0.5):
        leaf = qkv.clone().requires_grad_()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = fn(*leaf.split(512, dim=-1), scale)
        return torch.autograd.grad(out, leaf, g)[0]

    before = ops.flash_self_attention.launches
    got = grad(ops.flash_self_attention, True)
    assert ops.flash_self_attention.launches == before + 1 and got.dtype == torch.bfloat16
    want = grad(ops.attention_plain, False)
    assert_close_rel(got, want, 2e-2)
    dq, dk, dv = want.split(512, dim=-1)
    for bad in (grad(ops.attention_plain, False, 1.1 * 512 ** -0.5),
                torch.cat([dq, dv, dk], dim=-1)):
        with pytest.raises(AssertionError):
            assert_close_rel(bad, want, 2e-2)


@pytest.mark.parametrize("b,s", [(2, 4096), (1, 300), (1, 200), (2, 77), (1, 4095), (1, 64)])
def test_flash_self_attention(gen, b, s):
    qkv = torch.randn(b, s, 3 * 512, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.split(512, dim=-1)
    before = ops.flash_self_attention.launches
    got = ops.flash_self_attention(q, k, v, 512 ** -0.5)
    assert ops.flash_self_attention.launches == before + 1
    assert_close_rel(got, ops.attention_plain(q, k, v, 512 ** -0.5), 2e-2)


@pytest.mark.parametrize("s,longer", [(200, 56), (1000, 24), (129, 1)])
def test_attention_on_views_of_a_longer_projection(gen, s, longer):
    """q, k, v cut from a projection of s + longer rows and from the middle of
    its batch: the batch stride is not S x the row stride, and the kernel
    must not read the rows beyond S (they hold large values here)."""
    for width, heads in ((5 * 64, 5), (512, None)):
        qkv = torch.randn(4, s + longer, 3 * width, device="cuda", generator=gen).bfloat16()
        qkv[:, s:] = 1e4
        q, k, v = qkv[1:3, :s].split(width, dim=-1)
        assert q.stride(0) != s * q.stride(1)
        if heads:
            got = ops.flash_mha_packed(q, k, v, heads, 51 ** -0.5)
            want = ops.flash_mha_packed_plain(q, k, v, heads, 51 ** -0.5)
        else:
            got = ops.flash_self_attention(q, k, v, 512 ** -0.5)
            want = ops.attention_plain(q, k, v, 512 ** -0.5)
        assert_close_rel(got, want, 2e-2)


@pytest.mark.parametrize("entry,name,width,extra,s", [
    ("flash_mha_packed_fwd", "flash_mha_packed", 3 * 64, (3, 64), 77),
    ("flash_mha_packed_fwd", "flash_mha_packed", 2 * 64, (2, 64), 333),
    ("flash_self_attention_fwd", "flash_self_attention", 512, (512,), 77),
    ("flash_self_attention_fwd", "flash_self_attention", 512, (512,), 300),
])
def test_rows_at_or_beyond_s_are_never_written(gen, entry, name, width, extra, s):
    """The output of a ragged S lands in the first S rows of a longer buffer
    filled with a sentinel; every row from S on keeps the sentinel."""
    b, rows = 2, 512
    qkv = torch.randn(b, s, 3 * width, device="cuda", generator=gen).bfloat16()
    q, k, v = qkv.split(width, dim=-1)
    buffer = torch.full((b, rows, width), -7.0, device="cuda", dtype=torch.bfloat16)
    scale = 51 ** -0.5 if len(extra) == 2 else 512 ** -0.5
    ops._launch(entry, name, (q, k, v, buffer[:, :s]), extra, scale)
    torch.cuda.synchronize()
    assert (buffer[:, s:] == -7.0).all()
    want = ops.flash_mha_packed_plain(q, k, v, extra[0], scale) if len(extra) == 2 \
        else ops.attention_plain(q, k, v, scale)
    assert_close_rel(buffer[:, :s], want, 2e-2)


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


# per width: below one tile, across a tile's edge (T + 5), a prime length, and
# batch 32 over several tiles; then the wider levels (workspace at C = 512)
MRF_CASES = [(1, 32, 97), (2, 32, 661), (1, 32, 2003), (32, 32, 2 * 656 + 9),
             (1, 64, 97), (2, 64, 405), (1, 64, 2003), (32, 64, 2 * 400 + 9),
             (1, 128, 97), (2, 128, 245), (1, 128, 2003), (32, 128, 2 * 240 + 9),
             (2, 256, 700), (2, 512, 300), (1, 512, 1031)]


@pytest.mark.parametrize("b,c,length", MRF_CASES)
def test_fused_mrf_level(gen, b, c, length):
    x, ws, bs = mc.inputs(gen, b, c, length)
    before = mrf.fused_mrf_level.launches
    got = mrf.fused_mrf_level(x, ws, bs, KS, DS, 0.1)
    torch.cuda.synchronize()
    assert mrf.fused_mrf_level.launches == before + 1
    assert_close_rel(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 3e-2)


@pytest.mark.parametrize("c", [32, 64, 128])
def test_mrf_tolerance_rejects_planted_faults(gen, c):
    """The kernel passes, and the plain level with a tile of 64 positions
    left at x, without the zero padding at the edges, or without its biases
    fails the same tolerance."""
    x, ws, bs = mc.inputs(gen, 2, c, 1500)
    want = mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1)
    assert_close_rel(mrf.fused_mrf_level(x, ws, bs, KS, DS, 0.1), want, 3e-2)
    tile = want.clone()
    tile[..., 700:764] = x[..., 700:764]
    unzeroed = torch.nn.functional.pad(x, (64, 64), mode="replicate")
    faults = {
        "tile_skipped": tile,
        "edges_not_zeroed": mrf.mrf_level_plain(unzeroed, ws, bs, KS, DS, 0.1)[..., 64:-64],
        "biases_dropped": mrf.mrf_level_plain(x, ws, [bb * 0 for bb in bs], KS, DS, 0.1),
    }
    for name, bad in faults.items():
        with pytest.raises(AssertionError):
            assert_close_rel(bad, want, 3e-2)
            pytest.fail(name)  # not reached when the fault is caught


@pytest.mark.parametrize("b,c,length", [(2, 128, 4099), (1, 32, 1500)])
def test_mrf_gradient_wrt_x_is_the_plain_gradient(gen, b, c, length):
    """As the stage-3 losses' backward takes it through a frozen vocoder:
    the gradient with respect to x equals autograd through the plain level,
    the weights get none, and the tolerance rejects the plain gradient with
    the slope 0.2 or one dilation triple reversed."""
    x, ws, bs = mc.inputs(gen, b, c, length)
    g = torch.randn(b, c, length, device="cuda", generator=gen).bfloat16()

    def grad(fn, ds=DS, slope=0.1):
        leaf = x.clone().requires_grad_()
        return torch.autograd.grad(fn(leaf, ws, bs, KS, ds, slope), leaf, g)[0]

    got = grad(mrf.fused_mrf_level)
    want = grad(mrf.mrf_level_plain)
    assert got.dtype == torch.bfloat16 and all(w.grad is None for w in ws)
    assert_close_rel(got, want, 3e-2)
    for bad in (grad(mrf.mrf_level_plain, slope=0.2),
                grad(mrf.mrf_level_plain, ds=((5, 3, 1),) + DS[1:])):
        with pytest.raises(AssertionError):
            assert_close_rel(bad, want, 3e-2)


@pytest.mark.parametrize("b,c,length", [(2, 32, 661), (1, 128, 245), (1, 512, 300)])
def test_mrf_writes_nothing_outside_its_output(gen, b, c, length):
    """The output lands inside a longer buffer filled with a sentinel; every
    element before and after [B, C, L] keeps it."""
    x, ws, bs = mc.inputs(gen, b, c, length)
    n, pad = x.numel(), 4096
    buffer = torch.full((n + 2 * pad,), -7.0, device="cuda", dtype=torch.bfloat16)
    out = buffer[pad:pad + n].view(b, c, length)
    mrf._mrf_cuda(x, ws, bs, KS, DS, 0.1, out=out)
    torch.cuda.synchronize()
    assert (buffer[:pad] == -7.0).all() and (buffer[pad + n:] == -7.0).all()
    assert_close_rel(out, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 3e-2)


def test_mrf_repacks_after_an_in_place_weight_update(gen):
    x, ws, bs = mc.inputs(gen, 1, 64, 500)
    pack = Pack()  # held across the calls, as the vocoder holds its levels'
    mrf.fused_mrf_level(x, ws, bs, KS, DS, 0.1, pack)
    ws[4].mul_(-1.0)
    got = mrf.fused_mrf_level(x, ws, bs, KS, DS, 0.1, pack)
    assert_close_rel(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 3e-2)


# -- K7: the wide MRF levels ------------------------------------------------

# at the cells' levels (C = 256 at L = 20,484; C = 512 at 5,121) at batch 1,
# 8 and 32, at a prime length, and at C = 192 (tiles of 64 channels)
WIDE_CASES = [(b, c, length) for c, length in ((256, 20484), (512, 5121)) for b in (1, 8, 32)] + [
    (2, 256, 4099), (1, 512, 4099), (2, 192, 997)]


@pytest.mark.parametrize("b,c,length", WIDE_CASES)
def test_wide_mrf_level(gen, b, c, length):
    x, ws, bs = mc.inputs(gen, b, c, length)
    before = mrf.wide_mrf_level.launches
    got = mrf.wide_mrf_level(x, ws, bs, KS, DS, 0.1)
    torch.cuda.synchronize()
    assert mrf.wide_mrf_level.launches == before + 20  # 18 convs, the two layout passes
    assert_close_rel(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 3e-2)


@pytest.mark.parametrize("c,length", [(256, 4099), (512, 1031)])
def test_wide_mrf_tolerance_rejects_planted_faults(gen, c, length):
    """The kernel passes, and the plain level with each of mrf_cases' planted
    faults (dilations reversed, a bias dropped, slope 0.2, a tap's row
    offset off by one) fails the same tolerance."""
    x, ws, bs = mc.inputs(gen, 2, c, length)
    want = mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1)
    assert mc.close(mrf.wide_mrf_level(x, ws, bs, KS, DS, 0.1), want)
    for name in mc.FAULTS:
        assert not mc.close(mc.fault(x, ws, bs, name), want), name


@pytest.mark.parametrize("b,c,length", [(2, 256, 4099), (1, 512, 5121)])
def test_wide_mrf_gradient_wrt_x_is_the_plain_gradient(gen, b, c, length):
    """Through the autograd.Function (stage 3 decodes with gradients on x):
    the gradient with respect to x equals autograd through the plain level,
    the weights get none, and the tolerance rejects the plain gradient with
    the slope 0.2 or the dilations reversed."""
    x, ws, bs = mc.inputs(gen, b, c, length)
    g = torch.randn(b, c, length, device="cuda", generator=gen).bfloat16()

    def grad(fn, ds=DS, slope=0.1):
        leaf = x.clone().requires_grad_()
        return torch.autograd.grad(fn(leaf, ws, bs, KS, ds, slope), leaf, g)[0]

    got = grad(mrf.wide_mrf_level)
    want = grad(mrf.mrf_level_plain)
    assert got.dtype == torch.bfloat16 and all(w.grad is None for w in ws)
    assert_close_rel(got, want, 3e-2)
    for bad in (grad(mrf.mrf_level_plain, slope=0.2),
                grad(mrf.mrf_level_plain, ds=tuple(d[::-1] for d in DS))):
        with pytest.raises(AssertionError):
            assert_close_rel(bad, want, 3e-2)


def test_wide_mrf_repacks_after_an_in_place_weight_update(gen):
    x, ws, bs = mc.inputs(gen, 1, 256, 700)
    pack = Pack()  # held across the calls, as the vocoder holds its levels'
    mrf.wide_mrf_level(x, ws, bs, KS, DS, 0.1, pack)
    ws[4].mul_(-1.0)
    bs[7].add_(0.5)
    got = mrf.wide_mrf_level(x, ws, bs, KS, DS, 0.1, pack)
    assert_close_rel(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 3e-2)


def test_wide_mrf_level_refuses_what_it_does_not_take(gen):
    x, ws, bs = mc.inputs(gen, 1, 256, 100)
    with pytest.raises(TypeError):
        mrf.wide_mrf_level(x.float(), [w.float() for w in ws], [b.float() for b in bs],
                           KS, DS, 0.1)
    y, ws224, bs224 = mc.inputs(gen, 1, 224, 100)  # not a multiple of 64
    with pytest.raises(ValueError):
        mrf.wide_mrf_level(y, ws224, bs224, KS, DS, 0.1)
    z, ws128, bs128 = mc.inputs(gen, 1, 128, 100)  # K3's width
    with pytest.raises(ValueError):
        mrf.wide_mrf_level(z, ws128, bs128, KS, DS, 0.1)
    even = [torch.zeros(256, 256, 4, device="cuda", dtype=torch.bfloat16)] * 6 + ws[6:]
    with pytest.raises(ValueError):
        mrf.wide_mrf_level(x, even, bs, (4, 7, 11), DS, 0.1)


# -- K4: STFT magnitude ------------------------------------------------------

STFT_TOL = 1e-5


def _stft_close(got, want):
    return bool(torch.isfinite(got).all()) and \
        (got - want).abs().max().item() <= STFT_TOL * want.abs().max().item()


@pytest.mark.parametrize("t", [513, 32007, 160000])
@pytest.mark.parametrize("b", [1, 8, 32])
def test_stft_magnitude(gen, b, t):
    fe = stft.MelFrontend(STFTConfig(), device="cuda")
    wav = torch.randn(b, t, device="cuda", generator=gen) * 0.3
    before = stft.stft_magnitude_cuda.launches
    got = fe.magnitude(wav)  # a CUDA tensor: the kernel
    torch.cuda.synchronize()
    assert stft.stft_magnitude_cuda.launches == before + 1
    want = stft.stft_magnitude(wav, fe.cos_basis, fe.sin_basis, 160, 512)
    assert got.shape == want.shape == (b, t // 160 + 1, 513)
    assert _stft_close(got, want)


def test_stft_tolerance_rejects_planted_faults(gen):
    fe = stft.MelFrontend(STFTConfig(), device="cuda")
    wav = torch.randn(2, 32000, device="cuda", generator=gen) * 0.3
    cos_b, sin_b = fe.cos_basis, fe.sin_basis
    want = stft.stft_magnitude(wav, cos_b, sin_b, 160, 512)
    rounded = lambda t: t.bfloat16().float()
    zero_padded = torch.nn.functional.pad(wav, (512, 512))
    tail = torch.ones(1024, 1, device="cuda")
    tail[-64:] = 0
    frames = stft.frame_signal(stft.reflect_pad(wav, 512), 1024, 160)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        re, im = torch.matmul(frames, torch.cat([cos_b, sin_b], 1)).split(513, -1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    faults = {
        "single_bf16_pass": stft.stft_magnitude(rounded(wav), rounded(cos_b), rounded(sin_b), 160, 512),
        "single_tf32_pass": torch.sqrt(re * re + im * im),
        "zero_padding": stft.stft_magnitude(zero_padded, cos_b, sin_b, 160, 0),
        "window_tail_dropped": stft.stft_magnitude(wav, cos_b * tail, sin_b * tail, 160, 512),
    }
    for name, bad in faults.items():
        assert not _stft_close(bad, want), name


EVAL_STFT = STFTConfig(filter_length=512, hop_length=160, win_length=512, mel_fmin=50.0)


@pytest.mark.parametrize("t", [257, 32007, 160000])
@pytest.mark.parametrize("b", [1, 3, 32])
def test_stft_magnitude_512(gen, b, t):
    """The evaluation frontend's 512-point filter (32 x 16 FFT, two frame
    pairs a warp): 257 bins; 1, 3 and 32 rows, a clip a little longer than
    half a filter, a ragged length and 10 s."""
    fe = stft.MelFrontend(EVAL_STFT, device="cuda")
    wav = torch.randn(b, t, device="cuda", generator=gen) * 0.3
    before = stft.stft_magnitude_cuda.launches
    got = fe.magnitude(wav)
    torch.cuda.synchronize()
    assert stft.stft_magnitude_cuda.launches == before + 1
    want = stft.stft_magnitude(wav, fe.cos_basis, fe.sin_basis, 160, 256)
    assert got.shape == want.shape == (b, t // 160 + 1, 257)
    assert _stft_close(got, want)


def test_stft_512_tolerance_rejects_planted_faults(gen):
    fe = stft.MelFrontend(EVAL_STFT, device="cuda")
    wav = torch.randn(2, 32000, device="cuda", generator=gen) * 0.3
    cos_b, sin_b = fe.cos_basis, fe.sin_basis
    want = stft.stft_magnitude(wav, cos_b, sin_b, 160, 256)
    assert _stft_close(fe.magnitude(wav), want)
    rounded = lambda t: t.bfloat16().float()
    tail = torch.ones(512, 1, device="cuda")
    tail[-32:] = 0
    frames = stft.frame_signal(stft.reflect_pad(wav, 256), 512, 160)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        re, im = torch.matmul(frames, torch.cat([cos_b, sin_b], 1)).split(257, -1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    faults = {
        "single_bf16_pass": stft.stft_magnitude(rounded(wav), rounded(cos_b), rounded(sin_b), 160, 256),
        "single_tf32_pass": torch.sqrt(re * re + im * im),
        "zero_padding": stft.stft_magnitude(torch.nn.functional.pad(wav, (256, 256)), cos_b,
                                            sin_b, 160, 0),
        "window_tail_dropped": stft.stft_magnitude(wav, cos_b * tail, sin_b * tail, 160, 256),
    }
    for name, bad in faults.items():
        assert not _stft_close(bad, want), name


def test_stft_kernel_refuses_what_it_does_not_take(gen):
    fe = stft.MelFrontend(STFTConfig(), device="cuda")
    with pytest.raises(ValueError, match="reflect"):
        fe.magnitude(torch.zeros(1, 512, device="cuda"))
    with pytest.raises(RuntimeError, match="no gradient"):
        fe.magnitude(torch.zeros(1, 4000, device="cuda", requires_grad=True))
    with pytest.raises(TypeError):
        fe.magnitude(torch.zeros(1, 4000, device="cuda", dtype=torch.float64))
    wav = torch.zeros(1, 4000, device="cuda")
    other = stft.MelFrontend(STFTConfig(filter_length=768, win_length=768), device="cuda")
    with pytest.raises(ValueError, match="filter of 512 or 1024"):  # neither 32 x 16 nor 32 x 32
        other.magnitude(wav)
    with pytest.raises(ValueError, match="window"):  # longer than the filter
        stft.stft_magnitude_cuda(wav, fe.cos_basis, fe.sin_basis, 160, 512,
                                 torch.ones(2048, device="cuda"))
    with pytest.raises(ValueError, match="shared memory"):
        stft.stft_magnitude_cuda(torch.zeros(1, 200000, device="cuda"), fe.cos_basis,
                                 fe.sin_basis, 5000, 512)


# -- K5: dilated conv1d ------------------------------------------------------

PAIRS = [(3, 3), (3, 5), (7, 3), (7, 5), (11, 3), (11, 5)]


def _conv_inputs(gen, b, c, length, k):
    x = (torch.randn(b, c, length, device="cuda", generator=gen) * 0.5).bfloat16()
    w = (torch.randn(c, c, k, device="cuda", generator=gen) / (c * k) ** 0.5).bfloat16()
    return x, w


@pytest.mark.parametrize("k,d", PAIRS)
@pytest.mark.parametrize("c,length", [(64, 5003), (32, 700), (128, 1000)])
def test_dilated_conv1d(gen, c, length, k, d):
    x, w = _conv_inputs(gen, 2, c, length, k)
    p = d * (k - 1) // 2
    before = dc.dilated_conv1d.launches
    got = dc.dilated_conv1d(x, w, d, p)
    torch.cuda.synchronize()
    assert dc.dilated_conv1d.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert_close_rel(got, dc.dilated_conv1d_plain(x, w, d, p), 2e-2)


def test_dilated_conv1d_other_paddings(gen):
    x, w = _conv_inputs(gen, 1, 64, 999, 7)
    for p in (0, 4, 20):
        got = dc.dilated_conv1d(x, w, 3, p)
        assert got.shape == (1, 64, 999 + 2 * p - 18)
        assert_close_rel(got, dc.dilated_conv1d_plain(x, w, 3, p), 2e-2)


def test_dilated_conv1d_gradient_is_the_plain_gradient(gen):
    x, w = _conv_inputs(gen, 1, 64, 600, 3)
    x.requires_grad_()
    w.requires_grad_()
    dc.dilated_conv1d(x, w, 5, 5).float().square().sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    dc.dilated_conv1d_plain(x, w, 5, 5).float().square().sum().backward()
    assert_close_rel(gx, x.grad, 2e-2)
    assert_close_rel(gw, w.grad, 2e-2)


# (B, C, L, k, d, p) by the path each takes through the kernel; `check`
# names the tile plan it must get (ops/dilated_conv.py:tile_plan)
K5_PATHS = {
    "ragged_last_tile": ((2, 64, 1096, 7, 3, 9), lambda pl: pl.xs > 0),
    "shorter_than_the_halo_tma": ((1, 64, 24, 11, 5, 25), lambda pl: pl.xs > 0),
    "shorter_than_the_halo_gather": ((1, 32, 13, 11, 5, 25), lambda pl: pl.xs == 0),
    "batch_1": ((1, 128, 2048, 11, 3, 15), lambda pl: pl.xs > 0 and pl.ws < 11),
    "l_mod_8_gather": ((2, 64, 4097, 3, 5, 5), lambda pl: pl.xs == 0),
    "tma_in_plain_out": ((1, 64, 1024, 3, 3, 0), lambda pl: pl.xs > 0),
    "one_consumer": ((1, 64, 2048, 3, 700, 700), lambda pl: pl.ncw == 1),
    "streamed_taps_at_c64": ((1, 64, 2000, 31, 1, 15), lambda pl: 1 < pl.ws < 31),
    "streamed_taps_gather": ((4, 128, 9001, 11, 3, 15),
                             lambda pl: pl.ws == 3 and pl.xs == 0 and pl.ncw == 2),
    "streamed_taps_one_consumer": ((4, 128, 9000, 5, 100, 200),
                                   lambda pl: pl.ws == 3 and pl.ncw == 1),
    "one_tap_slot": ((4, 128, 9000, 3, 250, 250), lambda pl: pl.ws == 1),
}


@pytest.mark.parametrize("case", sorted(K5_PATHS))
def test_dilated_conv1d_paths(gen, case):
    """Each of the kernel's load and store paths: TMA or gathered windows,
    TMA or plain stores of y, a ragged last tile, a signal shorter than the
    halo, one consumer warpgroup, weights streamed per tap through three
    slots (with and without TMA, with one and two consumers) or through one,
    the last over several tiles a block."""
    (b, c, length, k, d, p), check = K5_PATHS[case]
    x, w = _conv_inputs(gen, b, c, length, k)
    assert check(dc.check_args(x, w, d, p))
    before = dc.dilated_conv1d.launches
    got = dc.dilated_conv1d(x, w, d, p)
    torch.cuda.synchronize()
    assert dc.dilated_conv1d.launches == before + 1
    assert got.shape == (b, c, length + 2 * p - d * (k - 1))
    assert_close_rel(got, dc.dilated_conv1d_plain(x, w, d, p), 2e-2)


def test_dilated_conv1d_on_unaligned_x(gen):
    """x at an address that is not 16-byte aligned: the consumers gather it."""
    x, w = _conv_inputs(gen, 2, 64, 1024, 7)
    flat = torch.empty(x.numel() + 1, device="cuda", dtype=torch.bfloat16)
    shifted = flat[1:].view_as(x)
    shifted.copy_(x)
    assert dc.check_args(shifted, w, 3, 9).xs == 0
    assert_close_rel(dc.dilated_conv1d(shifted, w, 3, 9), dc.dilated_conv1d_plain(x, w, 3, 9),
                     2e-2)


@pytest.mark.parametrize("c,length,p", [(64, 1000, 9), (32, 701, 4), (128, 1024, 0),
                                        (128, 1032, 9)])
def test_dilated_conv1d_writes_nothing_outside_its_output(gen, c, length, p):
    """The output lands inside a longer buffer filled with a sentinel; every
    element before and after [B, C, L_out] keeps it (TMA stores at L_out =
    1000 and 1032, plain stores at 691 and 1006)."""
    x, w = _conv_inputs(gen, 2, c, length, 7)
    l_out = length + 2 * p - 18
    n, pad = 2 * c * l_out, 4096
    buffer = torch.full((n + 2 * pad,), -7.0, device="cuda", dtype=torch.bfloat16)
    out = buffer[pad:pad + n].view(2, c, l_out)
    dc._dilated_conv_cuda(x, w, 3, p, out=out)
    torch.cuda.synchronize()
    assert (buffer[:pad] == -7.0).all() and (buffer[pad + n:] == -7.0).all()
    assert_close_rel(out, dc.dilated_conv1d_plain(x, w, 3, p), 2e-2)


def test_dilated_conv1d_repacks_after_an_in_place_weight_update(gen):
    x, w = _conv_inputs(gen, 1, 64, 512, 3)
    pack = Pack()
    dc.dilated_conv1d(x, w, 3, 3, pack)
    w.mul_(-1.0)
    assert_close_rel(dc.dilated_conv1d(x, w, 3, 3, pack), dc.dilated_conv1d_plain(x, w, 3, 3),
                     2e-2)


def test_dilated_conv1d_refuses_what_it_does_not_take(gen):
    x, w = _conv_inputs(gen, 1, 48, 100, 3)
    with pytest.raises(ValueError):
        dc.dilated_conv1d(x, w, 3, 3)  # C other than 32, 64, 128
    x, w = _conv_inputs(gen, 1, 64, 100, 3)
    with pytest.raises(TypeError):
        dc.dilated_conv1d(x.float(), w.float(), 3, 3)
    with pytest.raises(ValueError):
        dc.dilated_conv1d(x, w[:32], 3, 3)  # C_out != C_in
    before = dc.dilated_conv1d.launches
    with pytest.raises(ValueError, match="shared memory"):
        dc.dilated_conv1d(x, w, 1000, 1000)  # a window of 2135 positions at C = 64
    assert dc.dilated_conv1d.launches == before


# -- the norm kernel -------------------------------------------------------------

NORM_DTYPES = (torch.bfloat16, torch.float32)
NORM_COUNTERS = {"group": norm.group_norm, "layer": norm.layer_norm, "rms": norm.rms_norm}


def _norm_check(kind, shape, groups, eps, silu, dtype, gen, n=0):
    x, w, b = nc.inputs(kind, shape, groups, dtype, gen, n)
    counter = NORM_COUNTERS[kind]
    before = counter.launches
    got = nc.kernel_call(kind, x, w, b, groups, eps, silu, n)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and got.dtype == dtype and got.shape == x.shape
    want = nc.plain_call(kind, x, w, b, groups, eps, silu, n)
    err = nc.ulps(got, want)
    assert err <= nc.TOL_ULPS[dtype], (kind, shape, silu, dtype, err)
    return x, w, b, got, want


@pytest.mark.parametrize("dtype", NORM_DTYPES)
@pytest.mark.parametrize("calls", sorted(nc.CALLS))
def test_norm_at_every_shape_the_cells_send(gen, calls, dtype):
    """Every distinct GroupNorm (with and without its SiLU), LayerNorm (over
    the transformer's padded rows) and RMSNorm call of one generate call of
    the cell, at its batch."""
    for kind, shape, groups, eps, silu, n in sorted(set(nc.generate_norms(*nc.CALLS[calls]))):
        _norm_check(kind, shape, groups, eps, silu, dtype, gen, n)
        torch.cuda.empty_cache()


@pytest.mark.parametrize("kind,shape,groups,silu", [
    ("group", (3, 48, 5, 3), 16, True),  # 45-element groups: no group starts aligned
    ("group", (2, 64, 77), 32, False),  # NCL, 154-element groups
    ("group", (1, 4, 1024, 1024), 1, True),  # 8 MB groups: streamed through shared memory
    ("group", (1, 8, 5, 5), 8, False),  # a group of one channel
    ("layer", (3, 77, 255), 0, False),  # rows not a whole number of blocks
    ("layer", (1, 1, 1), 0, False),
    ("rms", (4, 33, 96), 0, False)])
@pytest.mark.parametrize("dtype", NORM_DTYPES)
def test_norm_at_shapes_off_the_path(gen, kind, shape, groups, silu, dtype):
    _norm_check(kind, shape, groups, 1e-5, silu, dtype, gen)


@pytest.mark.parametrize("kind,shape,groups,silu,eps", [
    ("group", (2, 128, 256, 64), 32, True, 1e-6),  # VAE decoder groups: eight blocks each
    ("group", (2, 256, 64, 64), 32, True, 1e-5),
    ("group", (2, 1024, 8, 8), 32, False, 1e-6),
    ("layer", (2, 1024, 255), 0, False, 1e-5),
    ("rms", (4, 64, 1024), 0, False, 1e-6)])
@pytest.mark.parametrize("dtype", NORM_DTYPES)
def test_norm_tolerance_rejects_planted_faults(gen, kind, shape, groups, silu, eps, dtype):
    """The kernel passes; the plain version with eps outside the square
    root, one group or row normalised with its neighbour's statistics, a
    one-pass variance (float32 inputs: tools/norm_cases.py) or the
    SiLU left off fails the same tolerance."""
    x, w, b, _, want = _norm_check(kind, shape, groups, eps, silu, dtype, gen)
    faults = nc.GROUP_FAULTS if kind == "group" else nc.ROW_FAULTS
    for fault in faults:
        if (fault == "silu_left_off" and not silu) or (
                fault == "one_pass_variance" and (dtype != torch.float32 or kind == "rms")):
            continue
        if kind == "group":
            bad = nc.group_norm_fault(x, groups, w, b, eps, silu, fault)
        else:
            bad = nc.row_norm_fault(x, w, b, eps, kind == "rms", fault)
        assert not nc.close(bad, want), fault


@pytest.mark.parametrize("n,width", [(255, 256), (510, 512), (1020, 1024)])
@pytest.mark.parametrize("dtype", NORM_DTYPES)
def test_layer_norm_of_padded_rows(gen, n, width, dtype):
    """The UNet transformer's rows: the statistics over the first n
    features, zeros after them whatever x held there, every true feature the
    kernel's output on the unpadded rows bit for bit; the statistics divided
    by the width fail the tolerance (on zero pads, as on the path)."""
    x, w, b, got, want = _norm_check("layer", (2, 1000, width), 0, 1e-5, False, dtype, gen, n)
    assert (x[..., n:] != 0).any() and (got[..., n:] == 0).all()
    assert torch.equal(got[..., :n], norm.layer_norm(x[..., :n].contiguous(), w, b, 1e-5))
    x[..., n:] = 0
    want = norm.layer_norm_plain(x, w, b, 1e-5, n)
    assert nc.close(norm.layer_norm(x, w, b, 1e-5, n), want)
    assert not nc.close(nc.row_norm_fault(x, w, b, 1e-5, False, nc.PAD_FAULT, n), want)


@pytest.mark.parametrize("n", [1280, 1275])
@pytest.mark.parametrize("dtype", NORM_DTYPES)
def test_layer_norm_of_rows_of_1280(gen, n, dtype):
    """TANGO's level-2 LayerNorms: rows of 1280 take the two-warp
    instantiation (counted under it), every row within the tolerance of the
    plain version, zeros after n whatever x held there; the statistics
    taken over the first 1024 features alone fail the tolerance."""
    before = {e: c.launches for e, c in norm.rows_launches.items()}
    x, w, b, got, want = _norm_check("layer", (2, 1000, 1280), 0, 1e-5, False, dtype, gen, n)
    assert {e: c.launches - before[e] for e, c in norm.rows_launches.items()} == {
        256: 0, 512: 0, 1024: 0, 1280: 1}
    assert (got[..., n:] == 0).all() and (n == 1280 or (x[..., n:] != 0).any())
    bad = nc.row_norm_fault(x, w, b, 1e-5, False, nc.WIDE_FAULT, n)
    assert not nc.close(bad, want)


@pytest.mark.parametrize("width", [1280, 1275])
@pytest.mark.parametrize("dtype", NORM_DTYPES)
def test_rms_norm_of_rows_of_1280(gen, width, dtype):
    """RMSNorm on rows of 1025-1280 takes the two-warp instantiation too,
    which makes one sum a row where a LayerNorm makes two. Each pair of
    warps takes two rows or more of a block (8 rows a block in bf16), so a
    pair's exchange slot rewritten before the partner read it would put a
    row off the plain version; the statistics over the first 1024 features
    alone fail the tolerance."""
    before = {e: c.launches for e, c in norm.rows_launches.items()}
    x, w, _, got, want = _norm_check("rms", (2, 1000, width), 0, 1e-6, False, dtype, gen)
    assert {e: c.launches - before[e] for e, c in norm.rows_launches.items()} == {
        256: 0, 512: 0, 1024: 0, 1280: 1}
    # more rows a block than the block's 4 pairs of warps
    assert norm.rows_plan(2000, width, x.element_size(), 132) > 4
    bad = nc.row_norm_fault(x, w, None, 1e-6, True, nc.WIDE_FAULT)
    assert not nc.close(bad, want)


def _rows_digest(gen, kind, width, n, dtype):
    x, w, b = nc.inputs(kind, (4, 333, width), 0, dtype, gen, n)
    y = nc.kernel_call(kind, x, w, b, 0, 1e-5 if kind == "layer" else 1e-6, False, n)
    raw = y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


# SHA-256 (first 16 hex digits) of the rows kernel's outputs on fixed seeds at
# the widths the light configurations send (the transformer's padded rows,
# whole rows of 1020 and 1024, T5's RMSNorm), as the one-warp
# instantiations gave them before rows of 1280 were added (NVIDIA H100 80GB
# HBM3, torch 2.11.0+cu128, CUDA 12.8; the same on the tree before and after)
ROWS_DIGESTS = {
    "layer/256/255/bfloat16": "49f5b83d87287ec6",
    "layer/512/510/bfloat16": "c8b2583512a48b65",
    "layer/1024/1020/bfloat16": "aad5ce9fafa36ad1",
    "layer/1020/1020/bfloat16": "27752fe4f687dc8a",
    "layer/1024/1024/bfloat16": "a31008159ce32981",
    "rms/1024/1024/bfloat16": "556b8c674a0ffa4b",
    "layer/256/255/float32": "b1433d693d9810a2",
    "layer/512/510/float32": "dd36f2ba59fcc3b6",
    "layer/1024/1020/float32": "751348f69d638f3f",
    "layer/1020/1020/float32": "ce4e2e0fe882407b",
    "layer/1024/1024/float32": "3cc4a4861cea7d88",
    "rms/1024/1024/float32": "68f03064054a8879"}


def test_rows_of_1024_or_fewer_are_the_bytes_they_were(gen):
    """Widening the rows kernel to 1280 leaves every narrower row's output
    bit for bit as it was (ROWS_DIGESTS)."""
    got = {}
    for dtype in NORM_DTYPES:
        for kind, width, n in (("layer", 256, 255), ("layer", 512, 510), ("layer", 1024, 1020),
                               ("layer", 1020, 1020), ("layer", 1024, 1024),
                               ("rms", 1024, 1024)):
            gen.manual_seed(width + n)
            got[f"{kind}/{width}/{n}/{str(dtype)[6:]}"] = _rows_digest(gen, kind, width, n, dtype)
    assert got == ROWS_DIGESTS


@pytest.mark.parametrize("kind,shape,groups", [("group", (2, 96, 33, 7), 32),
                                               ("group", (1, 128, 512, 64), 32),
                                               ("layer", (2, 301, 255), 0),
                                               ("rms", (3, 5, 1024), 0)])
def test_norm_writes_nothing_outside_its_output(gen, kind, shape, groups):
    """The output lands inside a longer buffer filled with a sentinel; every
    element before and after it keeps it."""
    x, w, b = nc.inputs(kind, shape, groups, torch.bfloat16, gen)
    n, pad = x.numel(), 4096
    buffer = torch.full((n + 2 * pad,), -7.0, device="cuda", dtype=torch.bfloat16)
    out = buffer[pad:pad + n].view(shape)
    if kind == "group":
        norm._group_cuda(x, groups, w, b, 1e-5, True, out=out)
        want = norm.group_norm_plain(x, groups, w, b, 1e-5, True)
    elif kind == "layer":
        norm._layer_cuda(x, w, b, 1e-5, out=out)
        want = norm.layer_norm_plain(x, w, b, 1e-5)
    else:
        norm._rms_cuda(x, w, 1e-6, out=out)
        want = norm.rms_norm_plain(x, w, 1e-6)
    torch.cuda.synchronize()
    assert (buffer[:pad] == -7.0).all() and (buffer[pad + n:] == -7.0).all()
    assert nc.close(out, want)


def test_norm_on_an_unaligned_view(gen):
    x, w, b = nc.inputs("layer", (2, 50, 255), 0, torch.bfloat16, gen)
    longer = torch.empty(x.numel() + 1, device="cuda", dtype=torch.bfloat16)
    shifted = longer[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    assert nc.close(norm.layer_norm(shifted, w, b, 1e-5), norm.layer_norm_plain(x, w, b, 1e-5))


def test_norm_capture_and_replay_equal_the_eager_call(gen):
    """One GroupNorm + SiLU, LayerNorm and RMSNorm captured in a CUDA graph:
    the replay equals the eager calls bit for bit, on the captured inputs and
    on new values copied into them; two eager calls are equal too."""
    xg, wg, bg = nc.inputs("group", (2, 128, 128, 32), 32, torch.bfloat16, gen)
    xl, wl, bl = nc.inputs("layer", (2, 1024, 510), 0, torch.bfloat16, gen)
    xr, wr, _ = nc.inputs("rms", (2, 64, 1024), 0, torch.bfloat16, gen)

    def calls():
        return (norm.group_norm(xg, 32, wg, bg, 1e-6, True), norm.layer_norm(xl, wl, bl, 1e-5),
                norm.rms_norm(xr, wr, 1e-6))

    eager = calls()
    assert all(torch.equal(a, e) for a, e in zip(calls(), eager))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = calls()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, e) for a, e in zip(static, eager))
    for t in (xg, xl, xr):
        t.copy_(t.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, e) for a, e in zip(static, calls()))


@pytest.mark.parametrize("kind,shape,groups,silu", [("group", (2, 64, 32, 16), 32, True),
                                                    ("group", (2, 128, 64, 64), 32, False),
                                                    ("layer", (2, 256, 255), 0, False),
                                                    ("rms", (2, 64, 1024), 0, False)])
def test_norm_gradient_is_the_plain_gradient(gen, kind, shape, groups, silu):
    """As the student's backward takes it: bf16 x and the float32 affine
    require grad; the forward launches the kernel, and the gradients are
    autograd through the plain version, bit for bit."""
    x0, w0, b0 = nc.inputs(kind, shape, groups, torch.bfloat16, gen)
    g = torch.randn(shape, device="cuda", generator=gen).bfloat16()

    def grads(call):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        b = None if b0 is None else b0.clone().requires_grad_()
        out = call(kind, x, w, b, groups, 1e-5, silu)
        return out, torch.autograd.grad(out, [t for t in (x, w, b) if t is not None], g)

    before = NORM_COUNTERS[kind].launches
    out, got = grads(nc.kernel_call)
    assert NORM_COUNTERS[kind].launches == before + 1
    want_out, want = grads(nc.plain_call)
    assert nc.close(out, want_out)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


def test_norm_refuses_what_it_does_not_take(gen):
    x = torch.randn(2, 64, 10, device="cuda", generator=gen)
    w = torch.ones(64, device="cuda")
    before = {k: f.launches for k, f in NORM_COUNTERS.items()}
    rows_before = {e: c.launches for e, c in norm.rows_launches.items()}
    with pytest.raises(TypeError):
        norm.group_norm(x.half(), 32, w, w, 1e-5)
    with pytest.raises(ValueError):
        norm.group_norm(x, 24, w, w, 1e-5)  # 24 groups do not divide 64 channels
    with pytest.raises(ValueError):
        norm.group_norm(x.transpose(1, 2).contiguous().transpose(1, 2), 32, w, w, 1e-5)
    with pytest.raises(ValueError):
        norm.layer_norm(x, w, w, 1e-5)  # an affine of 64 over rows of 10
    with pytest.raises(ValueError):
        norm.rms_norm(x, w[:10].cpu(), 1e-6)
    # rows wider than the rows kernel holds (1280)
    wide = torch.randn(2, 5, 1500, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="the rows kernel holds"):
        norm.layer_norm(wide, torch.ones(1500, device="cuda"), None, 1e-5)
    with pytest.raises(ValueError, match="the rows kernel holds"):
        norm.rms_norm(wide[..., :1288].contiguous(), torch.ones(1288, device="cuda"), 1e-6)
    with pytest.raises(ValueError, match="the rows kernel holds"):
        norm.layer_norm(wide[..., :1288].contiguous(), torch.ones(1281, device="cuda"), None,
                        1e-5, 1281)
    # more true features than the row holds
    with pytest.raises(ValueError, match="true features"):
        norm.layer_norm(x, torch.ones(11, device="cuda"), None, 1e-5, 11)
    assert {k: f.launches for k, f in NORM_COUNTERS.items()} == before
    assert all(c.launches == rows_before[e] for e, c in norm.rows_launches.items())


# -- the GEGLU kernel ------------------------------------------------------------

# (M, N) of every GEGLU the cells send: N the half at UNet levels 0, 1, 2 and
# the mid block (the light UNet's 1024 (1020 padded) / 2040 / 4080, TANGO's
# 1280 / 2560 / 5120; 2048 and 4096 besides), M = batch x the level's 4096 /
# 1024 / 256 / 64 positions at the UNet batches 1 (gen-b1), 16 (teacher-b8,
# tango-b8) and 32 (gen-b32)
GEGLU_LEVELS = ((4096, 1024, 1280), (1024, 2040, 2048, 2560), (256, 4080, 4096, 5120),
                (64, 4080, 4096, 5120))
GEGLU_CASES = sorted({(b * px, n) for b in (1, 16, 32) for px, *ns in GEGLU_LEVELS for n in ns})
# M x N / 8 not a whole number of the kernel's blocks (512 vectors), and the smallest N
GEGLU_RAGGED = [(77, 1024), (3, 5120), (1, 8), (4099, 1280)]


def _geglu_input(gen, m, n):
    return (3.0 * torch.randn(m, 2 * n, device="cuda", generator=gen)).bfloat16()


def _bf16_steps(a, b):
    """The largest distance between a and b in representable bf16 steps."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs().max().item()


def _geglu_check(gen, m, n):
    y = _geglu_input(gen, m, n)
    before = geglu.geglu.launches
    got = geglu.geglu(y)
    torch.cuda.synchronize()
    assert geglu.geglu.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16 and got.is_contiguous()
    want = geglu.geglu_plain(y)
    return y, got, want


@pytest.mark.parametrize("m,n", GEGLU_CASES + GEGLU_RAGGED)
def test_geglu_is_the_plain_version(gen, m, n):
    """The kernel against the four PyTorch passes it replaced, on the card:
    bit for bit."""
    _, got, want = _geglu_check(gen, m, n)
    assert torch.equal(got, want)


def test_geglu_of_every_bf16_gate_is_torchs_gelu(gen):
    """h = 1 and each of the 65,280 finite bf16 gates: the kernel's gelu,
    rounded to bf16, is torch's float32 gelu rounded to bf16, bit for bit."""
    every = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda").to(torch.int16)
    gate = every.view(torch.bfloat16)
    gate = gate[torch.isfinite(gate.float())]
    gate = gate[:gate.numel() // 8 * 8].view(-1, 8)
    got = geglu.geglu(torch.cat([torch.ones_like(gate), gate], dim=1).contiguous())
    assert gate.numel() == 65_280
    assert torch.equal(got, F.gelu(gate.float()).bfloat16())


def test_geglu_tolerance_rejects_planted_faults(gen):
    """The tanh-approximate gelu and the halves exchanged each move the
    output by many bf16 steps."""
    y, got, _ = _geglu_check(gen, 4096, 1024)
    h, gate = y.chunk(2, dim=-1)
    tanh = h * F.gelu(gate.float(), approximate="tanh").to(h.dtype)
    swapped = gate * F.gelu(h.float()).to(h.dtype)
    for fault in (tanh, swapped):
        assert _bf16_steps(got, fault) > 1


def test_geglu_refuses_what_it_does_not_take(gen):
    y = _geglu_input(gen, 64, 1024)
    longer = torch.empty(y.numel() + 1, device="cuda", dtype=y.dtype)
    misaligned = longer[1:].view(y.shape)
    before = geglu.geglu.launches
    for bad, error in ((y.float(), TypeError), (y[:, :2040].contiguous(), ValueError),
                       (y.t().contiguous().t(), ValueError), (misaligned, ValueError)):
        with pytest.raises(error):
            geglu.geglu(bad)
    assert geglu.geglu.launches == before


def test_geglu_writes_nothing_outside_its_output(gen):
    y = _geglu_input(gen, 77, 1024)
    buffer = torch.full((77 * 1024 + 2 * 4096,), -7.0, device="cuda", dtype=torch.bfloat16)
    out = buffer[4096:4096 + 77 * 1024].view(77, 1024)
    fn = geglu._build.load("geglu").geglu_fwd
    fn.restype = ctypes.c_int
    code = fn(ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(out.data_ptr()),
              ctypes.c_longlong(77), ctypes.c_int(1024), geglu._build.stream_ptr(y.device))
    torch.cuda.synchronize()
    assert code == 0
    assert (buffer[:4096] == -7.0).all() and (buffer[4096 + 77 * 1024:] == -7.0).all()
    assert torch.equal(out, geglu.geglu(y))


def test_geglu_capture_and_replay_equal_the_eager_call(gen):
    y = _geglu_input(gen, 16 * 256, 4096)
    eager = geglu.geglu(y)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        geglu.geglu(y)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = geglu.geglu(y)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager)
    y.copy_(y.flip(0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, geglu.geglu(y))


def test_geglu_gradient_under_autocast_is_the_plain_gradient(gen):
    """As the student's backward takes it: the `proj` output of a linear
    that requires grad, under autocast; the forward launches the kernel and
    the gradient is autograd through the plain version, bit for bit."""
    x = torch.randn(2, 256, 512, device="cuda", generator=gen)
    w = (0.05 * torch.randn(2 * 2048, 512, device="cuda", generator=gen)).requires_grad_()
    g = torch.randn(2, 256, 2048, device="cuda", generator=gen).bfloat16()

    def grad(fn):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = fn(F.linear(x, w))
        return out, torch.autograd.grad(out, w, g)[0]

    before = geglu.geglu.launches
    out, got = grad(geglu.geglu)
    assert geglu.geglu.launches == before + 1
    want_out, want = grad(geglu.geglu_plain)
    assert torch.equal(out, want_out) and torch.equal(got, want)
