#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `consistencytta_torch/csrc/` (one nvcc per
source, in parallel, into `build/`), then runs four phases, each printing
JSON lines:

  env      card name and power limit (nvidia-smi), torch / CUDA versions,
           kernel build seconds;
  kernel   each kernel against its plain PyTorch version on the same inputs
           at the main path's shapes (bf16, batch 32), with the error and
           the tolerance (both scaled by the plain output's own size), the
           same tolerance applied to planted faults (the plain version with a
           wrong scale, a dropped tile, ...), which it must reject, and
           CUDA-event times of the kernel, the plain version,
           one PyTorch library call computing the same function (SDPA for
           attention; none for the MRF level) and the bound (the larger of
           bytes over 3.35 TB/s and operations over 989 TFLOP/s);
  main     the main path: Pipeline.create at the full PipelineConfig
           (random weights from a seed, bf16) and build_generate_fn(num_steps=1)
           answering hash-tokenized prompts at batch 1 and batch 32, with the
           kernels' launch counters set to 0 just before and read just after;
           the waveform's shape and finiteness; a batch-1 clip against the same
           weights run in fp32 on the CPU through the plain versions; clips/s
           and latency (median, least and largest of 10 timed calls per batch
           size), peak memory and per-stage times;
  kernels  one line naming every kernel with its launches, error and times.

Then the nvidia-smi line, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero, and without a CUDA card the script exits 2.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
BATCH = 32
TEXT_LEN = 64
HEAD_WIDTH = 51  # the UNet's attention heads (inner dims 255/510/1020)
TOL_L2 = 1e-2  # relative L2 error allowed for every kernel against its plain version
TIMED_CALLS = 10  # timed generate calls per batch size, after one warm-up
PROMPTS = [
    "a dog barks in the distance", "rain falls on a tin roof",
    "a crowd cheers at a stadium", "an engine idles then revs",
    "birds chirp at dawn", "a door creaks open slowly",
    "waves crash on the shore", "a man speaks over a radio",
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unavailable"


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def spread(seconds) -> dict:
    """Median, least and largest of a list of times, in ms."""
    ms = [1e3 * t for t in seconds]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card", 2)
    import torch.nn.functional as F
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from consistencytta_torch.configs import PipelineConfig
        from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn
        from consistencytta_torch.models.pipeline import Pipeline
        from consistencytta_torch.ops import _build
        from consistencytta_torch.ops import attention as att
        from consistencytta_torch.ops import mrf
        from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})", 3)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")

    # -- env ------------------------------------------------------------------
    t0 = time.perf_counter()
    build_s = _build.build()
    emit({
        "phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "build_seconds": {k: round(v, 2) for k, v in build_s.items()},
        "build_wall_seconds": round(time.perf_counter() - t0, 2),
        "clocks_power": nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"),
    })

    # -- kernels against their plain versions ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def compare(got, want):
        """(max abs error, largest |want|, relative L2 error)."""
        got, want = got.float(), want.float()
        return ((got - want).abs().max().item(), want.abs().max().item(),
                ((got - want).norm() / want.norm()).item())

    def within(got, want, tol_max):
        """The kernel's tolerance: the largest error at most tol_max of the
        plain output's largest magnitude, and the relative L2 error at most
        TOL_L2. Both scale with the output, however small it is."""
        err, scale, l2 = compare(got, want)
        return bool(torch.isfinite(got).all().item()) and err <= tol_max * scale \
            and l2 <= TOL_L2

    def record(name, shape, got, want, tol_max, mutants, ms, plain_ms, lib_ms,
               flops, nbytes, per_call, **extra):
        """Check got against want, and check that each mutant (the plain
        version with a planted fault: a wrong scale, a dropped tile, ...)
        fails the same tolerance, so that the tolerance can tell a broken
        kernel from bf16 rounding at this shape."""
        err, scale, l2 = compare(got, want)
        ok = within(got, want, tol_max)
        caught = {}
        for fault, bad in mutants.items():
            e, _, m_l2 = compare(bad, want)
            caught[fault] = {"max_abs_err": e, "rel_l2": m_l2,
                             "caught": not within(bad, want, tol_max)}
        b_ms, b_by = bound(flops, nbytes)
        emit({"phase": "kernel", "name": name, "shape": shape, "max_abs_err": err,
              "max_abs_plain": scale, "tol_max_abs": tol_max * scale, "rel_l2": l2,
              "tol_rel_l2": TOL_L2, "ok": ok, "mutants": caught, "ms": ms,
              "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
              "bound_by": b_by, "launches_per_call": per_call, **extra})
        if not ok:
            fail(f"{name} {shape}: max abs err {err} (tol {tol_max * scale}), "
                 f"rel L2 {l2} (tol {TOL_L2})")
        missed = [f for f, c in caught.items() if not c["caught"]]
        if missed:
            fail(f"{name} {shape}: the tolerance passes the planted faults {missed}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "library_ms": 0.0, "bound_ms": 0.0,
                                      "flops": 0.0, "bytes": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if per_call:
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                           ("flops", flops), ("bytes", nbytes)):
                r[key] += per_call * v
            r["library_ms"] = None if lib_ms is None or r["library_ms"] is None \
                else r["library_ms"] + per_call * lib_ms

    def launch(kernel, call):
        """call() once, checking that it launched `kernel` exactly once."""
        before = kernel.launches
        out = call()
        if kernel.launches != before + 1:
            fail(f"{kernel.__name__} did not launch its kernel")
        return out

    def chunked(fn, n, *ts):
        """Run fn over batch chunks of n rows: bounds the plain version's
        [S, S] logits at the large shapes."""
        return torch.cat([fn(*(t[i:i + n] for t in ts)) for i in range(0, ts[0].shape[0], n)])

    sdpa = torch.nn.functional.scaled_dot_product_attention
    # K1: the UNet's self-attention shapes; launches per UNet query in brackets.
    # Heads are 51 wide, padded to the kernel's 64 with zero columns (as the
    # UNet's projections pad them); the bound counts the 51 the function needs.
    for s, h, per_call in ((4096, 5, 5), (1024, 10, 5), (256, 20, 5), (64, 20, 1)):
        qkv = torch.randn(BATCH, s, 3, h, 64, device=dev, generator=gen)
        qkv[..., HEAD_WIDTH:] = 0
        q, k, v = qkv.flatten(-2).bfloat16().unbind(2)
        scale = HEAD_WIDTH ** -0.5

        def plain(q=q, k=k, v=v, h=h, scale=scale):
            return chunked(lambda a, b, c: att.flash_mha_packed_plain(a, b, c, h, scale),
                           4, q, k, v)
        kern = lambda: att.flash_mha_packed(q, k, v, h, scale)
        heads = lambda t: t.unflatten(-1, (h, 64)).transpose(1, 2)
        lib = lambda: sdpa(heads(q), heads(k), heads(v), scale=scale)
        got, want = launch(att.flash_mha_packed, kern), plain()
        mutants = {"scale_of_width_64": plain(scale=64 ** -0.5),
                   "last_32_keys_dropped": plain(k=k[:, :-32], v=v[:, :-32])}
        iters = max(2, int(2e4 // s))
        record("flash_mha_packed", f"B={BATCH} S={s} H={h} d={HEAD_WIDTH} (64 padded)",
               got, want, 2e-2, mutants,
               cuda_ms(torch, kern, iters), cuda_ms(torch, plain, 1), cuda_ms(torch, lib, iters),
               4.0 * BATCH * h * s * s * HEAD_WIDTH, 4.0 * BATCH * s * h * HEAD_WIDTH * 2,
               per_call)
        del qkv, q, k, v, got, want, mutants
    # K2: the VAE mid-block attention, one launch per decode chunk
    qkv = torch.randn(BATCH, 4096, 3 * 512, device=dev, generator=gen).bfloat16()
    q, k, v = qkv.split(512, dim=-1)
    scale = 512 ** -0.5

    def plain(k=k, v=v, scale=scale):
        return chunked(lambda a, b, c: att.attention_plain(a, b, c, scale), 8, q, k, v)
    kern = lambda: att.flash_self_attention(q, k, v, scale)
    lib = lambda: sdpa(q[:, None], k[:, None], v[:, None], scale=scale)
    got, want = launch(att.flash_self_attention, kern), plain()
    mutants = {"scale_x1.1": plain(scale=1.1 * scale),
               "last_32_keys_dropped": plain(k=k[:, :-32], v=v[:, :-32])}
    record("flash_self_attention", f"B={BATCH} S=4096 D=512", got, want, 2e-2, mutants,
           cuda_ms(torch, kern, 3), cuda_ms(torch, plain, 1), cuda_ms(torch, lib, 3),
           4.0 * BATCH * 4096 * 4096 * 512, 4.0 * BATCH * 4096 * 512 * 2, 1)
    del qkv, q, k, v, got, want, mutants
    # K3: the vocoder's MRF levels; the fused levels (C <= 128) once per chunk.
    # The plain chain has two formulations of its dilated convs (direct, and
    # split into phases); plain_ms is the faster of the two at each shape.
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    for c, length, b, per_call in ((128, 40968, BATCH, 1), (64, 81936, BATCH, 1),
                                   (32, 163872, BATCH, 1), (512, 2048, 2, 0)):
        x = (torch.randn(b, c, length, device=dev, generator=gen) * 0.5).bfloat16()
        ws = [(torch.randn(c, c, kk, device=dev, generator=gen) / (c * kk) ** 0.5).bfloat16()
              for kk in ks for _ in range(6)]
        bs = [(torch.randn(c, device=dev, generator=gen) * 0.05).bfloat16() for _ in range(18)]
        kern = lambda: mrf.fused_mrf_level(x, ws, bs, ks, ds, 0.1)
        direct = lambda: mrf.mrf_level_plain(x, ws, bs, ks, ds, 0.1)
        split = lambda: mrf.mrf_level_plain(x, ws, bs, ks, ds, 0.1, phase_split=True)
        got, want = launch(mrf.fused_mrf_level, kern), direct()
        mid = length // 2
        tile = want.clone()
        tile[..., mid:mid + 64] = x[..., mid:mid + 64]
        unzeroed = F.pad(x, (64, 64))
        mutants = {
            "tile_skipped": tile,
            "edges_not_zeroed": mrf.mrf_level_plain(unzeroed, ws, bs, ks, ds, 0.1)[..., 64:-64],
            "biases_dropped": mrf.mrf_level_plain(x, ws, [bb * 0 for bb in bs], ks, ds, 0.1),
        }
        direct_ms, split_ms = cuda_ms(torch, direct, 2), cuda_ms(torch, split, 2)
        wbytes = sum(w.numel() * 2 for w in ws) + 18 * c * 2
        record("fused_mrf_level", f"B={b} C={c} L={length}", got, want, 3e-2, mutants,
               cuda_ms(torch, kern, 2), min(direct_ms, split_ms), None,
               float(mrf.mrf_flops(b, c, length, ks, ds)), 2.0 * x.numel() * 2 + wbytes,
               per_call, plain_direct_ms=direct_ms, plain_phase_split_ms=split_ms)
        del x, ws, bs, got, want, tile, unzeroed, mutants
    torch.cuda.empty_cache()

    # -- main path --------------------------------------------------------------
    config = PipelineConfig()
    t0 = time.perf_counter()
    pipe = Pipeline.create(config, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    generate = build_generate_fn(pipe, GenerateConfig(num_steps=1))
    tok = HashTokenizer(vocab_size=config.t5.vocab_size)
    n_samples = int(config.sample_rate * 10.0)

    def request(batch, seed):
        prompts = [PROMPTS[(seed + i) % len(PROMPTS)] for i in range(batch)]
        ids, mask, uids, umask = tokenize_with_uncond(tok, prompts, TEXT_LEN)
        g = torch.Generator(device=dev).manual_seed(seed)
        return (ids, mask, uids, umask), g

    counters = (att.flash_mha_packed, att.flash_self_attention, mrf.fused_mrf_level)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    calls = 0
    times = {}
    for batch in (1, BATCH):  # per batch size, the first call warms up
        times[batch] = []
        for i in range(1 + TIMED_CALLS):
            text, g = request(batch, 100 * batch + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = generate(*text, 4.0, generator=g)
            torch.cuda.synchronize()
            if i:
                times[batch].append(time.perf_counter() - t0)
            calls += 1
            if wav.shape != (batch, n_samples) or not torch.isfinite(wav).all():
                fail(f"batch-{batch} waveform shape {tuple(wav.shape)} or non-finite values")
    wav32 = wav
    launches = {fn.__name__: fn.launches for fn in counters}
    expected = {"flash_mha_packed": 16 * calls, "flash_self_attention": calls,
                "fused_mrf_level": 3 * calls}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if launches != expected:
        fail(f"launch counts {launches} != expected {expected}")

    # per-stage times at batch 32 (outside the counted run)
    text, _ = request(BATCH, 7)
    ids, mask = text[0], text[1]
    z = torch.randn(pipe.latent_shape(BATCH), device=dev, generator=gen)
    tt = torch.full((BATCH,), 999.0, device=dev)
    emb = pipe.encode_text(ids, mask)
    mask_t = torch.as_tensor(mask, device=dev)
    mel = pipe.vae.decode_first_stage(z)
    with torch.no_grad():
        stages = {
            "t5_ms": cuda_ms(torch, lambda: pipe.encode_text(ids, mask), 3),
            "unet_ms": cuda_ms(torch, lambda: pipe.query_student(z, tt, emb, mask_t, tt * 0 + 4.0), 3),
            "vae_decode_ms": cuda_ms(torch, lambda: pipe.vae.decode_first_stage(z), 2),
            "vocoder_ms": cuda_ms(torch, lambda: pipe.vocoder(mel[..., 0].transpose(1, 2)), 2),
        }

    # agreement with a reference: the same weights in fp32 on the CPU through
    # the plain versions, batch 1, the same noise
    ref = Pipeline(config, {}, None, None, None, torch.device("cpu"), torch.float32)
    student = copy.deepcopy(pipe.unets["student_ema"]).to("cpu", torch.float32)
    ref.unets = {"student_ema": student}
    ref.vae = copy.deepcopy(pipe.vae).to("cpu", torch.float32)
    ref.vocoder = copy.deepcopy(pipe.vocoder).to("cpu", torch.float32)
    ref.t5 = copy.deepcopy(pipe.t5).to("cpu", torch.float32)
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    text, _ = request(1, 0)
    noise = torch.randn(pipe.latent_shape(1), generator=torch.Generator().manual_seed(5))
    t0 = time.perf_counter()
    want = build_generate_fn(ref, GenerateConfig(num_steps=1))(*text, 4.0, noise=noise)
    ref_s = time.perf_counter() - t0
    got = generate(*text, 4.0, noise=noise.to(dev)).cpu()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0).item()
    ref_tol = 0.1
    main = {
        "phase": "main", "config": "PipelineConfig() light UNet, T5-large, bf16",
        "create_seconds": create_s, "calls": calls, "launches": launches,
        "expected_launches": expected,
        "timed_calls": TIMED_CALLS,
        "batch1_latency_ms": spread(times[1]),
        "batch32_ms": spread(times[BATCH]),
        "clips_per_s": BATCH / statistics.median(times[BATCH]),
        "peak_memory_gb": peak_gb, "stages_batch32": stages,
        "wave_shape": list(wav32.shape), "wave_abs_max": wav32.abs().max().item(),
        "reference": {"rel_l2": rel_l2, "cosine": cos, "tol_rel_l2": ref_tol,
                      "cpu_fp32_seconds": ref_s},
    }
    emit(main)
    if not rel_l2 <= ref_tol:
        fail(f"batch-1 clip differs from the fp32 CPU reference: rel L2 {rel_l2}")

    # -- summary ----------------------------------------------------------------
    sources = {
        "flash_mha_packed": ("consistencytta_torch/csrc/flash_attention.cu",
                             "consistencytta_tpu/ops/pallas_attention.py:362"),
        "flash_self_attention": ("consistencytta_torch/csrc/flash_attention.cu",
                                 "consistencytta_tpu/ops/pallas_attention.py:420"),
        "fused_mrf_level": ("consistencytta_torch/csrc/mrf.cu",
                            "consistencytta_tpu/ops/pallas_mrf.py:508"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        r = results[name]
        b_ms, b_by = bound(r["flops"], r["bytes"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": r["library_ms"],
            "per": f"times per generate call at batch {BATCH}; launches over the "
                   f"main-path run's {calls} calls",
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
