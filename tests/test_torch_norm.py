"""The norm wrapper (ops/norm.py) on the CPU: its plain route is the
float32 code the modules ran before the kernel, bit for bit; the fused
SiLU is the SiLU of the float32 norm; a LayerNorm over a padded row's first
n features is torch's over those features with zeros after them; the
autograd.Function's gradient is autograd through the plain version; the
launch plans cover every row; and the card tests' tolerance
(tools/norm_cases.py) rejects each planted fault on their inputs.
The kernel itself runs only on the card (tests/test_torch_cuda_kernels.py)."""

import pytest
import torch
import torch.nn.functional as F

from consistencytta_torch.nn.layers import GroupNorm, LayerNorm
from consistencytta_torch.nn.t5 import RMSNorm
from consistencytta_torch.ops import norm
from consistencytta_torch.tools import norm_cases as common

DTYPES = (torch.float32, torch.bfloat16)


def _module(kind, width, gen):
    m = {"group": lambda: GroupNorm(8, width, eps=1e-6), "layer": lambda: LayerNorm(width),
         "rms": lambda: RMSNorm(width, 1e-6)}[kind]()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return m


def _before(kind, m, x):
    """The modules' forward before the kernel, as it was written."""
    if kind == "group":
        return F.group_norm(x.float(), m.num_groups, m.weight.float(), m.bias.float(),
                            m.eps).to(x.dtype)
    if kind == "layer":
        return F.layer_norm(x.float(), m.normalized_shape, m.weight.float(), m.bias.float(),
                            m.eps).to(x.dtype)
    x32 = x.float()
    var = x32.pow(2).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + m.eps) * m.weight.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,shape", [("group", (2, 64, 6, 5)), ("group", (3, 32, 77)),
                                        ("layer", (2, 37, 255)), ("rms", (2, 9, 64))])
def test_plain_route_is_the_modules_code_before_the_kernel(kind, shape, dtype):
    gen = torch.Generator().manual_seed(1)
    m = _module(kind, shape[1] if kind == "group" else shape[-1], gen)
    x = common.structured(shape, dtype, gen, 8 if kind == "group" else shape[1])
    with torch.no_grad():
        assert torch.equal(m(x), _before(kind, m, x))
    if kind == "group":  # non-contiguous input: the module's copy, same numbers
        xt = x.transpose(-1, -2).contiguous().transpose(-1, -2)
        with torch.no_grad():
            assert torch.equal(m(xt), _before(kind, m, x))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_silu_is_the_silu_of_the_float32_norm(dtype):
    """SiLU as y * sigmoid(y), the VAE's swish before the kernel and the JAX
    package's form in both networks."""
    gen = torch.Generator().manual_seed(2)
    x = common.structured((2, 64, 40), dtype, gen, 32)
    w, b = common.affine(64, gen)
    y = F.group_norm(x.float(), 32, w, b, 1e-5)
    want = (y * torch.sigmoid(y)).to(dtype)
    assert torch.equal(norm.group_norm(x, 32, w, b, 1e-5, silu=True), want)
    m = GroupNorm(32, 64, eps=1e-5)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
        assert torch.equal(m(x, silu=True), want)
    # not the SiLU of the rounded norm (the modules' order before the kernel)
    if dtype == torch.bfloat16:
        assert not torch.equal(want, F.silu(norm.group_norm(x, 32, w, b, 1e-5)))
    # the VAE's float32 path before the kernel, bit for bit
    x32 = x.float()
    assert torch.equal(norm.group_norm(x32, 32, w, b, 1e-5, silu=True),
                       (lambda h: h * torch.sigmoid(h))(F.group_norm(x32, 32, w, b, 1e-5)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["group", "group_silu", "layer", "rms"])
@pytest.mark.parametrize("needs", ["x", "params", "all"])
def test_function_gradient_is_autograd_through_the_plain_version(kind, dtype, needs):
    gen = torch.Generator().manual_seed(3)
    base = kind.split("_")[0]
    shape = {"group": (2, 16, 5, 7), "layer": (2, 11, 24), "rms": (3, 5, 32)}[base]
    x0 = common.structured(shape, dtype, gen, 4 if base == "group" else shape[1])
    w0, b0 = common.affine(shape[1] if base == "group" else shape[-1], gen, bias=base != "rms")
    g = torch.randn(shape, generator=gen).to(dtype)
    args = {"group": (4, 1e-5, kind.endswith("silu")), "layer": (1e-5,), "rms": (1e-6,)}[base]

    def grads(fn):
        x, w = x0.clone().requires_grad_(needs != "params"), w0.clone().requires_grad_(
            needs != "x")
        b = None if b0 is None else b0.clone().requires_grad_(needs != "x")
        out = fn(x, w, b)
        leaves = [t for t in (x, w, b) if t is not None and t.requires_grad]
        return out, torch.autograd.grad(out, leaves, g)

    got_out, got = grads(lambda x, w, b: norm._Norm.apply(x, w, b, base, args))
    want_out, want = grads(lambda x, w, b: norm._PLAIN[base](x, w, b, *args))
    assert torch.equal(got_out, want_out)
    assert len(got) == len(want)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and torch.equal(a, e)


@pytest.mark.parametrize("n_rows,row_len,itemsize", [
    (1024, 262144, 2), (32, 262144, 2), (8, 262144, 2), (32, 262144, 4), (1024, 32768, 2),
    (32, 32768, 2), (1024, 2048, 2), (16, 65536, 2), (3, 7, 2), (5, 77, 4), (1, 4_000_000, 2),
    (2, 1024, 4)])
def test_group_plan_covers_each_row(n_rows, row_len, itemsize):
    split, chunk, tile = norm.group_plan(n_rows, row_len, itemsize, 132)
    vec = 16 // itemsize
    assert split in (1, 2, 4, 8) and chunk % vec == 0 and tile % vec == 0
    assert split * chunk >= row_len and (split - 1) * chunk < row_len
    assert (tile + 2 * vec) * itemsize <= norm.RESIDENT_BYTES + 64
    resident = chunk <= tile
    assert resident == (chunk * itemsize <= norm.RESIDENT_BYTES)
    if chunk * itemsize > norm.CHUNK_BYTES:
        assert split == norm.MAX_SPLIT
    if n_rows * split < 2 * 132 and split < norm.MAX_SPLIT:
        assert -(-row_len // (2 * split * vec)) * vec * itemsize < norm.MIN_CHUNK_BYTES


def test_group_plan_at_the_paths_shapes():
    # VAE decoder groups (4 channels x 65,536 positions): eight blocks of 64 KB
    assert norm.group_plan(32 * 32, 4 * 65536, 2, 132) == (8, 32768, 32768)
    # batch 1 still gives 256 blocks; UNet level 0 at batch 32 two blocks a group
    assert norm.group_plan(32, 8 * 4096, 2, 132) == (8, 4096, 4096)
    assert norm.group_plan(32 * 32, 8 * 4096, 2, 132) == (2, 16384, 16384)


@pytest.mark.parametrize("n_rows,width,itemsize", [(131072, 255, 2), (4096, 255, 2),
                                                   (2048, 1024, 2), (64, 1020, 2),
                                                   (5, 1024, 4), (1, 1, 2), (4096, 1280, 2),
                                                   (1024, 1280, 4)])
def test_rows_plan_fits_the_block(n_rows, width, itemsize):
    r = norm.rows_plan(n_rows, width, itemsize, 132)
    assert r >= 1 and (r * width <= norm.ROWS_SPAN_BYTES // itemsize or r == 1)
    assert r >= min(8, norm.ROWS_SPAN_BYTES // (width * itemsize))


@pytest.mark.parametrize("width,held", [(1, 256), (256, 256), (257, 512), (512, 512),
                                        (1020, 1024), (1024, 1024), (1025, 1280),
                                        (1275, 1280), (1280, 1280)])
def test_rows_of_up_to_1280_take_the_narrowest_instantiation_that_holds_them(width, held):
    """TANGO's level-2 LayerNorms run on rows of 1280 (two warps a row);
    rows of 1024 or fewer keep their one-warp instantiations."""
    assert norm.ROWS_MAX_WIDTH == 1280
    assert norm.rows_instantiation(width) == held
    assert norm.rows_plan(4096, width, 2, 132) >= 8


@pytest.mark.parametrize("width", [1281, 1288, 2048])
def test_rows_wider_than_1280_are_refused(width):
    """By the plan and by the wrapper's width check, before any launch."""
    with pytest.raises(ValueError, match="the rows kernel holds"):
        norm.rows_plan(16, width, 2, 132)
    with pytest.raises(ValueError, match="the rows kernel holds"):
        norm.rows_instantiation(width, "layer_norm")


def test_rows_launches_are_counted_by_instantiation_and_kept_by_graphs():
    """One counter a rows instantiation, each among the counters a graph's
    capture restores and its replays add to (graphs.py)."""
    from consistencytta_torch import graphs

    assert sorted(norm.rows_launches) == list(norm.ROWS_WIDTHS)
    counters = graphs._launch_counters()
    assert all(any(c is r for c in counters) for r in norm.rows_launches.values())


@pytest.mark.parametrize("fault", common.GROUP_FAULTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tolerance_rejects_group_norm_faults(fault, dtype):
    """On the card tests' inputs the plain version meets its own tolerance
    and each planted fault fails it (the one-pass variance on float32
    inputs: module doc of tools/norm_cases.py)."""
    if fault == "one_pass_variance" and dtype == torch.bfloat16:
        dtype = torch.float32
    gen = torch.Generator().manual_seed(4)
    x = common.structured((2, 256, 16, 16), dtype, gen, 32)
    w, b = common.affine(256, gen)
    want = norm.group_norm_plain(x, 32, w, b, 1e-6, True)
    assert common.close(common.group_norm_fault(x, 32, w, b, 1e-6, True, "none"), want)
    assert not common.close(common.group_norm_fault(x, 32, w, b, 1e-6, True, fault), want)


@pytest.mark.parametrize("rms,fault", [(False, f) for f in common.ROW_FAULTS] +
                         [(True, f) for f in common.ROW_FAULTS if f != "one_pass_variance"])
def test_tolerance_rejects_row_norm_faults(fault, rms):
    """As for GroupNorm; RMSNorm takes no mean, so it has no one-pass
    variance to plant."""
    gen = torch.Generator().manual_seed(5)
    dtype = torch.float32 if fault == "one_pass_variance" else torch.bfloat16
    x = common.structured((2, 64, 255), dtype, gen, 64)
    w, b = common.affine(255, gen, bias=not rms)
    want = norm.rms_norm_plain(x, w, 1e-6) if rms else norm.layer_norm_plain(x, w, b, 1e-5)
    eps = 1e-6 if rms else 1e-5
    assert common.close(common.row_norm_fault(x, w, b, eps, rms, "none"), want)
    assert not common.close(common.row_norm_fault(x, w, b, eps, rms, fault), want)


def test_a_generate_call_sends_the_counted_norms():
    """The meta-device enumeration the card tests sweep: at batch 32 and 64
    tokens, 85 GroupNorms (61 UNet, 24 VAE; 68 with the SiLU), 48
    LayerNorms and 49 RMSNorms, 5.97 G elements, 29 distinct calls."""
    calls = common.generate_norms(*common.CALLS["generate-b32"])
    count = lambda kind, silu=None: sum(1 for c in calls if c[0] == kind
                                        and (silu is None or c[4] == silu))
    assert (count("group"), count("layer"), count("rms")) == (85, 48, 49)
    assert count("group", True) == 45 + 23  # every resnet norm, conv_norm_out, norm_out
    elements = sum(torch.Size(c[1]).numel() for c in calls)
    assert elements == pytest.approx(5.97e9, rel=1e-3)
    assert len(set(calls)) == 29
    # the transformer's rows are zero-padded to 16-byte multiples (nn/attention.py)
    assert sorted({c[1][-1] for c in calls if c[0] == "layer"}) == [256, 512, 1024]
    assert sorted({c[5] for c in calls if c[0] == "layer"}) == [255, 510, 1020]
    assert {c[5] for c in calls if c[0] != "layer"} == {0}


PADDED_ROWS = [(255, 256), (510, 512), (1020, 1024)]  # the UNet transformer's rows


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,width", PADDED_ROWS)
def test_layer_norm_over_the_true_features_of_a_padded_row(n, width, dtype):
    """torch's LayerNorm over the first n features, then zeros, whatever
    the pads held; the module takes n from its affine's length."""
    gen = torch.Generator().manual_seed(n)
    x, w, b = common.inputs("layer", (2, 9, width), 0, dtype, gen, n)
    assert (x[..., n:] != 0).any()
    want = F.layer_norm(x[..., :n].float(), (n,), w, b, 1e-5).to(dtype)
    got = norm.layer_norm(x, w, b, 1e-5, n)
    assert got.shape == x.shape and torch.equal(got[..., :n], want)
    assert (got[..., n:] == 0).all()
    m = LayerNorm(n)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
        assert torch.equal(m(x), got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [255, 256, 1024])
def test_layer_norm_of_a_whole_row_is_unchanged(width, dtype):
    """n == width is the code before the count, bit for bit."""
    gen = torch.Generator().manual_seed(width)
    x, w, b = common.inputs("layer", (3, 7, width), 0, dtype, gen)
    before = F.layer_norm(x.float(), x.shape[-1:], w, b, 1e-5).to(dtype)
    assert torch.equal(norm.layer_norm(x, w, b, 1e-5, width), before)
    assert torch.equal(norm.layer_norm(x, w, b, 1e-5), before)


@pytest.mark.parametrize("n,width", PADDED_ROWS)
def test_tolerance_rejects_statistics_over_the_width(n, width):
    """The statistics divided by the padded width in place of n fail the
    card tests' tolerance on rows whose pads are zero, as on the path."""
    gen = torch.Generator().manual_seed(6)
    x, w, b = common.inputs("layer", (2, 64, width), 0, torch.bfloat16, gen, n)
    x[..., n:] = 0
    want = norm.layer_norm_plain(x, w, b, 1e-5, n)
    assert common.close(common.row_norm_fault(x, w, b, 1e-5, False, "none", n), want)
    assert not common.close(common.row_norm_fault(x, w, b, 1e-5, False, common.PAD_FAULT, n),
                            want)


@pytest.mark.parametrize("n", [0, 257, 248, 200])
def test_layer_norm_refuses_a_count_outside_the_row(n):
    """A count past the row, or one whose padding to a multiple of 8 is not
    the row's width (a row of the wrong width handed by mistake)."""
    x = torch.randn(2, 3, 256)
    w = torch.ones(max(n, 1))
    with pytest.raises(ValueError, match="true features"):
        norm.layer_norm(x, w, None, 1e-5, n)
    if n:
        with pytest.raises(ValueError, match="true features"):
            LayerNorm(n)(x)


@pytest.mark.parametrize("needs", ["x", "params", "all"])
def test_padded_row_gradient_is_autograd_through_the_plain_version(needs):
    """The student's LayerNorms: the gradient of the first n features, and
    none into the pads."""
    gen = torch.Generator().manual_seed(7)
    x0, w0, b0 = common.inputs("layer", (2, 5, 256), 0, torch.float32, gen, 255)
    g = torch.randn(2, 5, 256, generator=gen)
    x = x0.clone().requires_grad_(needs != "params")
    w, b = (t.clone().requires_grad_(needs != "x") for t in (w0, b0))
    out = norm._Norm.apply(x, w, b, "layer", (1e-5, 255))
    leaves = [t for t in (x, w, b) if t.requires_grad]
    got = torch.autograd.grad(out, leaves, g)
    xs = x0[..., :255].clone().requires_grad_(needs != "params")
    ws, bs = (t.clone().requires_grad_(needs != "x") for t in (w0, b0))
    want = torch.autograd.grad(F.layer_norm(xs, (255,), ws, bs, 1e-5),
                               [t for t in (xs, ws, bs) if t.requires_grad], g[..., :255])
    skip = int(x.requires_grad)
    if skip:
        assert torch.equal(got[0][..., :255], want[0]) and (got[0][..., 255:] == 0).all()
    for a, e in zip(got[skip:], want[skip:]):
        assert torch.equal(a, e)
