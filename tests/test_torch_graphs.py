"""CUDA-graph replay of the four stage modules (consistencytta_torch/graphs.py).

On the CPU, at `PipelineConfig.tiny()` in float32: every call stays eager,
gives the waveform it gave under `graphs.eager()` bit for bit and counts one
eager call per stage call; the eligibility rule refuses a call for each of
its conditions, weights changed in place since the module's last call among
them; the key changes with a shape, a replaced parameter or a new
submodule, and not with an in-place update.

On the card (marker `cuda`, skipped without one), at the published widths in
bf16, with random weights: a replay equals the eager call bit for bit for
each module and end to end at batch 1 (text lengths 8, 40, 8 interleaved) and
at batch 32; a returned waveform outlives the next call; forward hooks fire
around a replay and their events bracket its kernels; after weights change
in place (a load, an update of the vocoder's or the UNet's), one call runs
eagerly and remakes the kernel-layout copies in their storage, and the
replays after it equal eager calls; the graph and launch counters read what
the calls imply, every norm of a call launches the norm kernel and every
GEGLU of a UNet query the GEGLU kernel (16 a query); a UNet's
capture makes none of the transformer's padded copies, and a traced UNet query
launches none of cuBLAS's unaligned GEMM fallbacks, which one GEMM on the
transformer's unpadded width does. The file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py -q
"""

import contextlib

import numpy as np
import pytest
import torch
from torch import nn

from consistencytta_torch import graphs, utils
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.inference import generate as gen
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline, set_trainable

STAGES = ("t5", "unet", "vae_decode", "vocoder")
BATCH, TEXT_LEN = 2, 8


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port():
    return Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                           roles=STUDENT_ROLES + ("teacher",))


def _text(config, batch, length, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, min(32000, config.t5.vocab_size), size=(batch, length))
    ones = np.ones_like(ids)
    return ids, ones, ones.copy(), ones.copy()


def _unet_args(port, batch=BATCH, length=TEXT_LEN, **change):
    dev = port.device
    g = torch.Generator(device=dev).manual_seed(0)
    args = {
        "sample": torch.randn(port.latent_shape(batch), generator=g, device=dev),
        "timestep": torch.full((batch,), 999.0, device=dev),
        "text": torch.randn(batch, length, port.config.unet.cross_attention_dim,
                            generator=g, device=dev),
        "mask": torch.ones(batch, length, dtype=torch.long, device=dev),
        "guidance": torch.full((batch,), 4.0, device=dev),
    }
    args.update(change)
    return tuple(args.values())


# -- CPU ----------------------------------------------------------------------

# sampler -> (builder, UNet queries a call)
SAMPLERS = {
    "student": (lambda p: gen.build_generate_fn(p, gen.GenerateConfig(truncate_seconds=0.5)), 1),
    "teacher": (lambda p: gen.build_teacher_generate_fn(p, 2, truncate_seconds=0.5), 3),
    "guided": (lambda p: gen.build_guided_student_generate_fn(p, 2, truncate_seconds=0.5), 2),
}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_cpu_calls_stay_eager_and_bit_identical(port, sampler):
    build, queries = SAMPLERS[sampler]
    fn = build(port)
    text = _text(port.config, BATCH, TEXT_LEN, 3)
    noise = torch.randn(port.latent_shape(BATCH), generator=torch.Generator().manual_seed(4))
    with graphs.eager():
        want = fn(*text, 3.0, noise=noise)
    utils.reset_graph_counts()
    got = fn(*text, 3.0, noise=noise)
    assert torch.equal(got, want)
    calls = {"t5": 1, "unet": queries, "vae_decode": 1, "vocoder": 1}
    assert utils.graph_counts() == {
        s: {"captures": 0, "replays": 0, "eager": calls[s]} for s in STAGES}


REFUSAL_CASES = ("none", "eager", "grad", "autocast", "trainable", "scalar", "updated")


@pytest.mark.parametrize("case", REFUSAL_CASES)
def test_eligibility_refuses_each_condition(port, case):
    unet = port.unets["teacher"]
    args = _unet_args(port, timestep=999.0) if case == "scalar" else _unet_args(port)
    if case == "trainable":
        set_trainable(unet)
    if case == "updated":
        with torch.no_grad():
            unet(*args)  # the module's last call, at these versions
            unet.conv_in.weight.mul_(1.0)  # an in-place update: a new version
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.enable_grad() if case == "grad" else torch.no_grad())
            if case == "eager":
                stack.enter_context(graphs.eager())
            if case == "autocast":
                stack.enter_context(torch.autocast("cpu", dtype=torch.bfloat16))
            found = graphs.refusals(unet, *args)
            utils.reset_graph_counts()
            unet(*args)
    finally:
        unet.requires_grad_(False)
    # on the CPU "cpu" always stands against a graph; each case adds its own
    want = ("cpu",) if case == "none" else tuple(sorted(("cpu", case)))
    assert tuple(sorted(found)) == want
    assert utils.graph_counts() == {"unet": {"captures": 0, "replays": 0, "eager": 1}}


def _replace_weight(unet):
    unet.conv_in.weight = nn.Parameter(unet.conv_in.weight.detach().clone(),
                                       requires_grad=False)


def _new_submodule(unet):
    old = unet.conv_out
    unet.conv_out = nn.Conv2d(old.in_channels, old.out_channels, 3, padding=1).requires_grad_(False)
    unet.conv_out.load_state_dict(old.state_dict())


def _in_place(unet):
    with torch.no_grad():
        unet.conv_in.weight.mul_(1.5)


def _load_in_place(unet):
    unet.load_state_dict({k: v * 2 for k, v in unet.state_dict().items()})


# case -> (what it does to the UNet or its arguments, whether the key changes)
KEY_CASES = {
    "shape": (None, True),
    "replaced_parameter": (_replace_weight, True),
    "new_submodule": (_new_submodule, True),
    "in_place_update": (_in_place, False),
    "load_state_dict_in_place": (_load_in_place, False),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_key_changes_with_shape_and_replaced_weights_only(case):
    port = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu")
    unet = port.unets["student_ema"]
    args = _unet_args(port)
    before = graphs.key(unet, *args)
    assert graphs.key(unet, *_unet_args(port)) == before
    change, moves = KEY_CASES[case]
    if change is None:
        after = graphs.key(unet, *_unet_args(port, length=TEXT_LEN + 1))
    else:
        change(unet)
        after = graphs.key(unet, *args)
    assert (after != before) == moves


# -- on the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Pipeline.create(PipelineConfig(), dtype=torch.bfloat16, device="cuda", seed=0)


def _stage_calls(p, batch, length, seed=0):
    """stage -> (module, arguments) as the generate path calls them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(2, 32000, (batch, length), device="cuda", generator=g)
    mask = torch.ones_like(ids)
    unet_args = (torch.randn(p.latent_shape(batch), generator=g, device="cuda"),
                 torch.full((batch,), 999.0, device="cuda"),
                 torch.randn(batch, length, p.config.unet.cross_attention_dim,
                             generator=g, device="cuda"),
                 mask, torch.full((batch,), 4.0, device="cuda"))
    z = torch.randn(p.latent_shape(batch), generator=g, device="cuda")
    with torch.no_grad(), graphs.eager():
        zc = p.vae.post_quant_conv((z / p.config.vae.scale_factor).permute(0, 3, 1, 2)
                                   .to(torch.bfloat16))
        mel = p.vae.decode_first_stage(z)[..., 0].transpose(1, 2)
    return {"t5": (p.t5, (ids, mask)), "unet": (p.unets["student_ema"], unet_args),
            "vae_decode": (p.vae.decoder, (zc,)), "vocoder": (p.vocoder, (mel,))}


def _launches():
    from consistencytta_torch.ops import attention, geglu, mrf

    return {"flash_mha_packed": attention.flash_mha_packed.launches,
            "flash_self_attention": attention.flash_self_attention.launches,
            "fused_mrf_level": mrf.fused_mrf_level.launches,
            "wide_mrf_level": mrf.wide_mrf_level.launches, "geglu": geglu.geglu.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("stage", STAGES)
def test_replay_equals_eager_per_module(card, stage):
    module, args = _stage_calls(card, 1, 17)[stage]
    with torch.no_grad():
        with graphs.eager():
            want = module(*args)
        first, second = module(*args), module(*args)
    assert torch.equal(first, want) and torch.equal(second, want)


def _generate(p, text, seed):
    fn = gen.build_generate_fn(p, gen.GenerateConfig(num_steps=1))
    noise = torch.randn(p.latent_shape(text[0].shape[0]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
    return fn(*text, 4.0, noise=noise)


@pytest.mark.cuda
def test_replay_equals_eager_end_to_end(card):
    runs = [(1, 8), (1, 40), (1, 8), (32, 64)]
    for i, (batch, length) in enumerate(runs):
        text = _text(card.config, batch, length, i)
        got = _generate(card, text, i)
        with graphs.eager():
            want = _generate(card, text, i)
        assert torch.equal(got, want), (batch, length)


@pytest.mark.cuda
def test_returned_waveform_outlives_the_next_call(card):
    first = _generate(card, _text(card.config, 1, 12, 0), 0)
    kept = first.clone()
    second = _generate(card, _text(card.config, 1, 12, 1), 1)
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", STAGES)
def test_hooks_fire_around_a_replay(card, stage):
    module, args = _stage_calls(card, 1, 9)[stage]
    events = []

    def record(*_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)

    handles = [module.register_forward_pre_hook(record), module.register_forward_hook(record)]
    try:
        with torch.no_grad():
            module(*args)  # captures
            events.clear()
            utils.reset_graph_counts()
            module(*args)
    finally:
        for h in handles:
            h.remove()
    assert utils.graph_counts()[stage]["replays"] == 1 and len(events) == 2
    # the same graph replayed alone, between events of its own
    rec = graphs._STATES[module].graphs[graphs._call_key(args)]
    alone = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        rec.graph.replay()
        b.record()
        b.synchronize()
        alone.append(a.elapsed_time(b))
    hooked = events[0].elapsed_time(events[1])
    assert hooked >= 0.9 * min(alone), (hooked, alone)


def _scale_in_place(module, factor):
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(factor)


def _settle(module, args):
    """Call `module` once, so that the versions its weights moved to are
    recorded and its next call replays again."""
    with torch.no_grad():
        module(*args)


@pytest.mark.cuda
def test_replay_outlives_the_pack_cache(card):
    """The vocoder's weight packs (K3's at the three fused levels, K7's at the
    two wide ones), which its levels' `Pack`s hold: after the weights change
    in place, one eager call makes them anew into the storage the graph
    reads, and the replays after it equal eager calls."""
    module, args = _stage_calls(card, 1, 8)["vocoder"]
    ptrs = lambda: [t.data_ptr() for p in module.level_packs if p.copy for t in p.copy]
    try:
        with torch.no_grad():
            module(*args)  # captured, reading the packs
            held = ptrs()
            assert len(held) == 2 * 5  # weights and biases of the five levels
            _scale_in_place(module, 0.5)
            utils.reset_graph_counts()
            first = module(*args)
            assert utils.graph_counts()["vocoder"] == {"captures": 0, "replays": 0, "eager": 1}
            assert ptrs() == held
            # NaN in blocks of the packs' sizes: a pack whose storage was
            # freed and taken again would be overwritten here
            from consistencytta_torch.ops import mrf

            junk = [torch.full(shape, float("nan"), dtype=torch.bfloat16, device="cuda")
                    for c in (128, 64, 32)
                    for shape in ((18 * c, -(-11 * c // mrf.UNIT_K) * mrf.UNIT_K), (18, c))]
            junk += [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
                     for c in (512, 256)
                     for shape, dtype in (((126 * c * c,), torch.bfloat16),
                                          ((18, c), torch.float32))]
            got = module(*args)
            del junk
            assert utils.graph_counts()["vocoder"]["replays"] == 1
            with graphs.eager():
                want = module(*args)
    finally:
        _scale_in_place(module, 2.0)
        _settle(module, args)
    assert torch.equal(first, want) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", STAGES)
def test_replay_reads_weights_loaded_in_place(card, stage):
    module, args = _stage_calls(card, 1, 11)[stage]
    saved = {k: v.clone() for k, v in module.state_dict().items()}
    try:
        with torch.no_grad():
            before = module(*args)
            g = torch.Generator(device="cuda").manual_seed(5)
            module.load_state_dict({k: v * (1 + 0.05 * torch.rand(v.shape, device="cuda",
                                                                    generator=g)).to(v.dtype)
                                    if v.is_floating_point() else v
                                    for k, v in saved.items()})
            utils.reset_graph_counts()
            first = module(*args)  # eager: the weights' versions moved
            got = module(*args)
            counts = utils.graph_counts()[stage]
            with graphs.eager():
                want = module(*args)
    finally:
        module.load_state_dict(saved)
        _settle(module, args)
    assert counts == {"captures": 0, "replays": 1, "eager": 1}
    assert torch.equal(first, want) and torch.equal(got, want) and not torch.equal(got, before)


@pytest.mark.cuda
def test_counters_read_what_the_calls_imply(card):
    text = _text(card.config, 3, 21, 0)  # a shape no other test calls
    per_call = {"flash_mha_packed": 16, "flash_self_attention": 1, "fused_mrf_level": 3,
                "wide_mrf_level": 40, "geglu": 16}
    utils.reset_graph_counts()
    start = _launches()
    for i, (event, ctx) in enumerate((("captures", None), ("replays", None),
                                      ("eager", graphs.eager()))):
        if ctx is None:
            _generate(card, text, i)
        else:
            with ctx:
                _generate(card, text, i)
        done = i + 1
        assert _launches() == {k: start[k] + done * n for k, n in per_call.items()}
        counts = utils.graph_counts()
        for s in STAGES:
            assert counts[s][event] == 1, (s, counts)
    assert utils.graph_counts() == {s: {"captures": 1, "replays": 1, "eager": 1} for s in STAGES}


@pytest.mark.cuda
def test_every_norm_of_a_call_launches_the_norm_kernel(card):
    """Every GroupNorm, LayerNorm and RMSNorm of a 1-NFE generate call is
    one launch of the norm kernel (ops/norm.py), captured, replayed or
    eager: 85, 48 and 49 a call."""
    from consistencytta_torch.ops import norm

    text = _text(card.config, 2, 19, 0)  # a shape no other test calls
    counters = (norm.group_norm, norm.layer_norm, norm.rms_norm)
    for i, ctx in enumerate((None, None, graphs.eager())):
        start = [f.launches for f in counters]
        if ctx is None:
            _generate(card, text, i)
        else:
            with ctx:
                _generate(card, text, i)
        assert [f.launches - n for f, n in zip(counters, start)] == [85, 48, 49]


@pytest.mark.cuda
def test_unet_query_launches_the_geglu_kernel_once_a_geglu(card):
    """Every GEGLU of a UNet query is one launch of the GEGLU kernel
    (ops/geglu.py), 16 a query, captured, replayed or eager; at the
    teacher's batch of 16 the replay equals the eager query bit for bit."""
    from consistencytta_torch.ops import geglu

    module, args = _stage_calls(card, 16, 23)["unet"]  # a shape no other test calls
    with torch.no_grad():
        outs = []
        for ctx in (contextlib.nullcontext(), contextlib.nullcontext(), graphs.eager()):
            before = geglu.geglu.launches
            with ctx:
                outs.append(module(*args))
            assert geglu.geglu.launches == before + 16
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[2])


@pytest.mark.cuda
def test_unet_graph_holds_the_padded_weights_made_before_its_capture(card):
    """The transformer's zero-padded weights (nn/attention.py), 6 copies a
    transformer, held by their modules: made eagerly before a capture, so
    the capture makes none; after the weights change in place, one eager
    call makes them anew in the same storage, and the replays after it
    equal eager calls."""
    from consistencytta_torch.nn import attention

    module, args = _stage_calls(card, 1, 13)["unet"]  # a shape no other test calls
    packs = [p for m in module.modules()
             for p in ((m.proj_in_pack, m.proj_out_pack) if isinstance(m, attention.Transformer2D)
                       else (m.pack,) if isinstance(m, (attention.Attention, attention.GEGLU,
                                                        attention.FeedForward)) else ())]
    ptrs = lambda: [t.data_ptr() for p in packs if p.copy for t in p.copy]
    try:
        with torch.no_grad():
            with graphs.eager():
                module(*args)
            held = ptrs()
            assert len(packs) == 6 * 16 and all(p.copy for p in packs)
            utils.reset_graph_counts()
            module(*args)  # captured
            assert utils.graph_counts()["unet"]["captures"] == 1 and ptrs() == held
            _scale_in_place(module, 0.5)
            first = module(*args)
            got = module(*args)
            assert utils.graph_counts()["unet"] == {"captures": 1, "replays": 1, "eager": 1}
            assert ptrs() == held
            with graphs.eager():
                want = module(*args)
    finally:
        _scale_in_place(module, 2.0)
        _settle(module, args)
    assert torch.equal(first, want) and torch.equal(got, want)


@pytest.mark.cuda
def test_unet_query_takes_no_unaligned_gemm(card, tmp_path):
    """A traced UNet query at batch 2 and text length 64 launches no kernel
    of cuBLAS's unaligned fallbacks (`profile_stages.UNALIGNED_GEMM`), where
    one bf16 GEMM on 255-wide rows, the transformer's width before its
    padding, launches them; the query's bf16 output lies within 2.5% (relative
    L2) of a float32 run on the CPU: bf16 rounding through the whole UNet
    reads 1.16% on an H100, so this catches gross faults; the transformer's
    small ones are the CPU tests' (tests/test_torch_transformer_pad.py)."""
    import copy

    import torch.nn.functional as F

    from consistencytta_torch.tools import profile_stages

    def unaligned(name, fn):
        with torch.no_grad(), graphs.eager():
            fn()
            with utils.profile_trace(str(tmp_path / name)) as path:
                out = fn()
        return out, profile_stages.kernel_share(utils.read_trace(path, top=None))["unaligned_gemm"]

    x, w = (torch.randn(shape, device="cuda", dtype=torch.bfloat16)
            for shape in ((4096, 255), (255, 255)))
    _, fallback = unaligned("linear", lambda: F.linear(x, w))
    assert fallback["launches"] > 0, fallback
    module, args = _stage_calls(card, 2, 64)["unet"]
    got, query = unaligned("unet", lambda: module(*args))
    assert query == {"ms": 0, "launches": 0}, query
    with torch.no_grad():
        ref = copy.deepcopy(module).float().cpu()(*(a.cpu() for a in args))
    dist = ((got.cpu().float() - ref).norm() / ref.norm()).item()
    assert dist <= 0.025, dist
