"""The UNet transformer at 16-byte-aligned widths (nn/attention.py) against
the JAX package's `Transformer2D`, which runs at the published widths, on
the CPU in float32, with the JAX module's parameters (biases and norm
affines drawn off their init) loaded through `io/from_jax`.

At heads / channels 5/256, 10/512 and 20/1024 (inner 255/510/1020, carried
at 256/512/1024, head width 51 padded to 64), 2/16 (aligned: nothing to
pad) and TANGO's full UNet's 5/320 and 20/1280 (64-wide heads, unpadded):
the output, the input's gradient and the gradient of every
published-shape parameter agree with the JAX module's to 1e-5 of their
largest magnitude (float32, sums in another order: they read at most
2e-6); the pad features are exact zeros after proj_in,
after each block and its parts, and in the cross-attention heads; state
dicts keep their keys and shapes; the padded weights of a frozen module are
made once per weight version and held by their module (`ops._packs.Pack`),
made anew into the same storage after an in-place update and freed with
the module, and a trainable module's are made at every call.
Planted faults are caught: a nonzero pad feature out of proj_in (by the
zero check: every consumer reads the pads through zero columns, so the
output does not show it) and the softmax scale taken from the padded head
width 64 (by the comparison).
"""

import copy
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from consistencytta_torch.configs import UNetConfig
from consistencytta_torch.io import from_jax
from consistencytta_torch.nn import attention
from consistencytta_torch.nn.attention import Transformer2D
from consistencytta_torch.ops._packs import Pack
from consistencytta_tpu.nn.attention import Transformer2D as JaxTransformer2D

CROSS, TEXT, BATCH, HW = 24, 7, 2, (3, 4)
CASES = [(5, 256), (10, 512), (20, 1024), (2, 16), (5, 320), (20, 1280)]
TOL = 1e-5  # of the largest magnitude
GROUPS = 8


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _model(heads, channels, seed=0, trainable=False):
    """A port module of torch's init, its norm affines off their 1 / 0."""
    torch.manual_seed(seed)
    m = Transformer2D(channels, heads, CROSS, groups=GROUPS)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if "norm" in name:
                p.add_(0.3 * torch.randn(p.shape))
    return m.requires_grad_(trainable)


def _inputs(channels, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(BATCH, channels, *HW, generator=g)
    text = torch.randn(BATCH, TEXT, CROSS, generator=g)
    keep = torch.ones(BATCH, TEXT)
    keep[1, 4:] = 0
    return x, text, ((1.0 - keep) * -10000.0)[:, None, :]


def _state_dict(tree):
    """The port's state dict of a JAX Transformer2D tree (parameters, or
    their gradients: the map is linear)."""
    sd = {}
    from_jax._unet_transformer(sd, "t", tree)
    return {k[2:]: v for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def _jax(heads, channels):
    """(parameters, output, gradients of the parameters, gradient of x) of
    the JAX module on `_inputs`, the output's cotangent `_cotangent`."""
    x, text, bias = (t.numpy() for t in _inputs(channels))
    x = x.transpose(0, 2, 3, 1)  # NHWC
    jm = JaxTransformer2D(heads, channels // heads, groups=GROUPS)
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(heads), x, text, bias)["params"])
    rng = np.random.default_rng(channels)
    flat = traverse_util.flatten_dict(params)
    for key, v in flat.items():  # biases and norm affines off their init
        if key[-1] in ("bias", "scale"):
            flat[key] = np.asarray(v) + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    g = _cotangent(heads, channels).numpy().transpose(0, 2, 3, 1)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, text, bias) * g)

    out = jm.apply({"params": params}, x, text, bias)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    return (params, np.asarray(out).transpose(0, 3, 1, 2),
            jax.device_get(gp), np.asarray(gx).transpose(0, 3, 1, 2))


def _cotangent(heads, channels):
    return torch.randn(BATCH, channels, *HW, generator=torch.Generator().manual_seed(2))


def _pair(heads, channels, trainable=False):
    """(the port's module on the JAX module's parameters, the JAX output)."""
    params, out, _, _ = _jax(heads, channels)
    m = Transformer2D(channels, heads, CROSS, groups=GROUPS)
    m.load_state_dict(_state_dict(params), strict=True)
    return m.requires_grad_(trainable), torch.from_numpy(out.copy())


def _close(got, want):
    return (got - want).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.parametrize("heads,channels", CASES)
def test_output_and_gradients_match_the_unpadded_formulation(heads, channels):
    """The unpadded formulation is the JAX package's module."""
    m, want = _pair(heads, channels, trainable=True)
    _, _, jax_grads, jax_dx = _jax(heads, channels)
    x, text, bias = _inputs(channels)
    x.requires_grad_(True)
    got = m(x, text, bias)
    assert got.shape == want.shape and _close(got.detach(), want)
    (got * _cotangent(heads, channels)).sum().backward()
    assert _close(x.grad, torch.from_numpy(jax_dx.copy()))
    want_grads = _state_dict(jax_grads)
    assert set(want_grads) == {n for n, _ in m.named_parameters()}
    for n, p in m.named_parameters():
        assert p.grad.shape == want_grads[n].shape, n
        assert _close(p.grad, want_grads[n]), n


def _cross_logits(a, b):
    """Whether torch.matmul(a, b) is q k^T of the cross-attention's padded
    heads (and not the self-attention's, whose keys are the tokens)."""
    return a.shape[-1] == b.shape[-2] == 64 and b.shape[-1] == TEXT


def _pad_report(m, args):
    """The tensors of a frozen call whose pad features are not all zero:
    the blocks' inputs and outputs, each part's output and the cross
    heads' q, k, v and attention output (captured at torch.matmul)."""
    inner = m.proj_in.out_features
    hd = m.transformer_blocks[0].attn2.head_dim
    bad, seen = [], []

    def check(name, t, start):
        seen.append(name)
        if (t[..., start:] != 0).any():
            bad.append(name)

    hooks = []
    for i, blk in enumerate(m.transformer_blocks):
        hooks.append(blk.register_forward_pre_hook(
            lambda mod, a, i=i: check(f"block{i}.in", a[0], inner)))
        for name in ("", "norm1", "attn1", "norm2", "attn2", "norm3", "ff"):
            mod = blk.get_submodule(name) if name else blk
            hooks.append(mod.register_forward_hook(
                lambda mod, a, out, n=f"block{i}.{name or 'out'}": check(n, out, inner)))
    matmul = torch.matmul

    def spy(a, b):
        out = matmul(a, b)
        if _cross_logits(a, b):
            check("cross.q", a, hd)
            check("cross.k", b.transpose(-1, -2), hd)
        elif a.shape[-1] == TEXT and b.shape[-1] == 64:  # probabilities times v
            check("cross.v", b, hd)
            check("cross.out", out, hd)
        return out

    torch.matmul = spy
    try:
        with torch.no_grad():
            m(*args)
    finally:
        torch.matmul = matmul
        for h in hooks:
            h.remove()
    return bad, seen


@pytest.mark.parametrize("heads,channels", CASES[:3])
def test_pad_features_are_exact_zeros(heads, channels):
    bad, seen = _pad_report(_model(heads, channels), _inputs(channels))
    assert not bad
    assert {"block0.in", "block0.out", "block0.attn2", "block0.ff", "cross.q", "cross.k",
            "cross.v", "cross.out"} <= set(seen)


def test_zero_check_catches_a_nonzero_pad_out_of_proj_in(monkeypatch):
    heads, channels = CASES[0]
    m, want = _pair(heads, channels)
    args = _inputs(channels)
    padded_linear = attention.padded_linear

    def faulty(lin, rows, cols, pack):
        w, b = padded_linear(lin, rows, cols, pack)
        if lin is m.proj_in:
            b = b.clone()
            b[-1] = 0.5
        return w, b

    monkeypatch.setattr(attention, "padded_linear", faulty)
    bad, _ = _pad_report(m, args)
    assert "block0.in" in bad
    with torch.no_grad():  # why the zero check is needed: the output hides it
        assert _close(m(*args), want)


@pytest.mark.parametrize("where", ["self", "cross"])
def test_comparison_catches_a_scale_from_the_padded_head_width(monkeypatch, where):
    heads, channels = CASES[0]
    m, want = _pair(heads, channels)
    args = _inputs(channels)
    with torch.no_grad():
        if where == "self":
            k1 = attention.flash_mha_packed
            monkeypatch.setattr(attention, "flash_mha_packed",
                                lambda q, k, v, h, scale: k1(q, k, v, h, 64 ** -0.5))
        else:
            matmul = torch.matmul

            def scaled(a, b):  # logits * 51 ** -0.5 becomes logits * 64 ** -0.5
                out = matmul(a, b)
                return out * math.sqrt(51 / 64) if _cross_logits(a, b) else out

            monkeypatch.setattr(torch, "matmul", scaled)
        assert not _close(m(*args), want)


def test_state_dict_keeps_published_keys_and_shapes():
    m = Transformer2D(256, 5, 1024)
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    b = "transformer_blocks.0."
    published = {
        "norm.weight": (256,), "norm.bias": (256,),
        "proj_in.weight": (255, 256), "proj_in.bias": (255,),
        "proj_out.weight": (256, 255), "proj_out.bias": (256,),
        **{f"{b}norm{i}.{p}": (255,) for i in (1, 2, 3) for p in ("weight", "bias")},
        **{f"{b}attn1.to_{p}.weight": (255, 255) for p in "qkv"},
        f"{b}attn2.to_q.weight": (255, 255),
        f"{b}attn2.to_k.weight": (255, 1024), f"{b}attn2.to_v.weight": (255, 1024),
        **{f"{b}attn{i}.to_out.0.weight": (255, 255) for i in (1, 2)},
        **{f"{b}attn{i}.to_out.0.bias": (255,) for i in (1, 2)},
        f"{b}ff.net.0.proj.weight": (2040, 255), f"{b}ff.net.0.proj.bias": (2040,),
        f"{b}ff.net.2.weight": (255, 1020), f"{b}ff.net.2.bias": (255,),
    }
    assert shapes == published
    m.load_state_dict({k: torch.randn(s) for k, s in published.items()}, strict=True)


def _packs(m):
    """The six `Pack`s of a padded Transformer2D, in call order: proj_in,
    attn1, attn2, the GEGLU, net.2, proj_out."""
    blk = m.transformer_blocks[0]
    return [m.proj_in_pack, blk.attn1.pack, blk.attn2.pack, blk.ff.net[0].pack, blk.ff.pack,
            m.proj_out_pack]


def _copies(m):
    return [t for p in _packs(m) if p.copy is not None for t in p.copy]


def test_frozen_calls_pad_once_per_weight_version():
    heads, channels = CASES[0]
    m = _model(heads, channels)
    args = _inputs(channels)
    with torch.no_grad():
        first = m(*args)
        copies = _copies(m)
        assert all(p.copy is not None for p in _packs(m))
        assert torch.equal(m(*args), first)
        assert all(a is b for a, b in zip(_copies(m), copies))  # the same tensors
        w, b = attention.padded_linear(m.proj_in, 256, 256, m.proj_in_pack)
        assert w.shape == (256, 256) and not w[255:].any() and not b[255:].any()
        m.proj_in.weight.mul_(2)  # an in-place update: a new version
        w2, _ = attention.padded_linear(m.proj_in, 256, 256, m.proj_in_pack)
        assert w2.data_ptr() == w.data_ptr() and torch.equal(w2[:255], m.proj_in.weight)
    # trainable weights are padded anew at every call, and the gradient reaches them
    m.proj_in.requires_grad_(True)
    w3, _ = attention.padded_linear(m.proj_in, 256, 256, m.proj_in_pack)
    assert w3.grad_fn is not None
    with torch.no_grad():
        w4, _ = attention.padded_linear(m.proj_in, 256, 256, m.proj_in_pack)
        assert w4 is not attention.padded_linear(m.proj_in, 256, 256, m.proj_in_pack)[0]


def test_a_trainable_module_without_grad_reads_its_weights_after_an_update():
    """A trained student queried under no_grad (validation) between
    optimizer steps that move no version counter (the fused AdamW; here
    an update through .data): each call pads the weights as they are, and
    no module keeps a copy."""
    heads, channels = CASES[0]
    m = _model(heads, channels, trainable=True)
    args = _inputs(channels)
    with torch.no_grad():
        first = m(*args)
        for p in m.parameters():
            p.data.mul_(1.5)  # the tensors' versions stay
        second = m(*args)
        assert not _copies(m)
        frozen = copy.deepcopy(m).requires_grad_(False)
        assert torch.equal(second, frozen(*args))
        assert not torch.equal(second, first)


def test_a_dropped_unets_padded_copies_are_freed_at_once():
    """The copies live and die with the module whose weights they are: a
    UNet's are gone once it is dropped, with no later call to clear them."""
    import gc
    import weakref

    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.nn.unet import UNet2DConditionGuided

    tiny = PipelineConfig.tiny()
    cfg, ls = tiny.unet, tiny.latent
    torch.manual_seed(0)
    unet = UNet2DConditionGuided(cfg).requires_grad_(False)
    sample = torch.randn(1, ls.t, ls.f, ls.c)
    text = torch.randn(1, 5, cfg.cross_attention_dim)
    with torch.no_grad():
        unet(sample, torch.full((1,), 999.0), text, torch.ones(1, 5, dtype=torch.long),
             torch.full((1,), 4.0))
    refs = [weakref.ref(t) for m in unet.modules() if isinstance(m, attention.Attention)
            and m.pack.copy is not None for t in m.pack.copy]
    assert refs
    del unet
    gc.collect()
    assert all(r() is None for r in refs)


def test_aligned_widths_pad_nothing_but_the_self_attention_heads():
    """The tiny configuration's widths (inner 16, head width 8): the only
    padded copy is K1's fused QKV, as before; every other GEMM reads the
    parameters themselves."""
    m = _model(2, 16)
    with torch.no_grad():
        m(*_inputs(16))
    held = [p for p in _packs(m) if p.copy is not None]
    assert held == [m.transformer_blocks[0].attn1.pack]
    assert held[0].copy[0].shape == (3 * 2 * 64, 16)
    lin = m.transformer_blocks[0].ff.net[2]
    assert attention.padded_linear(lin, 16, 64, Pack()) == (lin.weight, lin.bias)


def test_a_graphs_padded_weights_follow_an_in_place_update():
    """As a CUDA graph reads them, at fixed addresses: after the weights
    change in place, the next call makes each module's padded copies anew
    into the same storage, equal to the copies the new weights give."""
    m = _model(5, 256)
    args = _inputs(256)
    with torch.no_grad():
        m(*args)  # the warm-up before a capture makes them
        ptrs = [t.data_ptr() for t in _copies(m)]
        # weight and bias each, but attn1's fused qkv, w, b and attn2's q, k, v, w, b
        assert len(ptrs) == 4 * 2 + 3 + 5
        for p in m.parameters():
            p.mul_(1.5)
        m(*args)
        fresh = copy.deepcopy(m)  # a deepcopy holds no copy: it makes its own
        assert not _copies(fresh)
        fresh(*args)
    assert [t.data_ptr() for t in _copies(m)] == ptrs
    for kept, new in zip(_copies(m), _copies(fresh)):
        assert torch.equal(kept, new)


def test_a_pack_of_weights_changed_in_place_leaves_the_cache():
    """A training run's frozen-call copies: each in-place update (an EMA
    step) makes each module's copies anew in place, so a module holds one
    set, at the same addresses, however many updates it sees."""
    m = _model(5, 256)
    args = _inputs(256)
    with torch.no_grad():
        m(*args)
        ptrs = [t.data_ptr() for t in _copies(m)]
        for _ in range(3):
            for p in m.parameters():
                p.mul_(0.99)
            m(*args)
            assert [t.data_ptr() for t in _copies(m)] == ptrs


def test_a_frozen_shadow_reads_its_ema_update(monkeypatch):
    """A training run's target network, queried without gradients between
    EMA steps, pads the weights the EMA left: with the CUDA fused lerp,
    which moves no version counter, emulated here."""
    from consistencytta_torch.training.ema import ema_update

    def lerp_keeping_versions(shadow, module, weight):
        for s, p in zip(shadow, module):
            s.data.lerp_(p, weight)  # .data: the tensor's version stays

    target, student = _model(5, 256, seed=0), _model(5, 256, seed=1)
    args = _inputs(256)
    monkeypatch.setattr(torch, "_foreach_lerp_", lerp_keeping_versions)
    with torch.no_grad():
        target(*args)
        ema_update(target, student, 0.5)
        got = target(*args)
        assert torch.equal(got, copy.deepcopy(target)(*args))  # copies made from scratch
