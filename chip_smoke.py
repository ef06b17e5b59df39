#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `consistencytta_torch/csrc/` (one nvcc per
source, in parallel, into `build/`), then runs seven phases, each printing
JSON lines:

  env      card name and power limit (nvidia-smi), torch / CUDA versions,
           kernel build seconds, and the attention, MRF and STFT kernels'
           registers, spills and shared memory;
  kernel   each kernel against its plain PyTorch version on the same inputs
           at the shapes the driven paths give it (bf16; batch 32 and 1 for
           the generate path, 16 and 8 for the train step, 4 and 2 for the
           validation step; only batch 32 enters the summed times; the
           attention kernels' batch-1 lines also give the host time of one
           launch beside the library call's), with the
           gradient of the UNet attention kernel under autocast against the
           plain version's at S = 1024, and with the error and
           the tolerance (both scaled by the plain output's own size), the
           same tolerance applied to planted faults (the plain version with a
           wrong scale, a dropped tile, ...), which it must reject, and
           CUDA-event times of the kernel, the plain version,
           one PyTorch library call computing the same function (SDPA for
           attention; none for the MRF level) and the bound (the larger of
           bytes over 3.35 TB/s and operations over 989 TFLOP/s). The MRF
           level also runs at the C = 256 and 512 levels of batch 32, which
           the generate path leaves to the plain chain. The STFT
           magnitude (float32, B = 8, 2 and 32 ten-second clips) is held to
           float32 grade, 1e-5 of the largest output, against planted
           single-pass bf16 and TF32 products, zero padding and a dropped
           window tail; its library call is torch.stft, its kernel is an FFT
           whose operations are counted at the 67 TFLOP/s FP32 rate (the
           bytes bound it), and a replayed CUDA graph gives its device time
           without the host's launch; the same at the evaluation frontend's
           512-point filter (B = 32 and 1). The attention kernel also runs at
           batch 64, the CFG teacher's batch behind a generate batch of 32. The
           standalone dilated conv runs at B = 32, C = 64, L = 81936 for its
           six (k, d) pairs, beside F.conv1d;
  main     the main path: Pipeline.create at the full PipelineConfig
           (random weights from a seed, bf16) and build_generate_fn(num_steps=1)
           answering hash-tokenized prompts at batch 1 and batch 32, with the
           kernels' launch counters set to 0 just before and read just after;
           the waveform's shape and finiteness; a batch-1 clip against the same
           weights run in fp32 on the CPU through the plain versions; clips/s
           and latency (median, least and largest of 10 timed calls per batch
           size), peak memory and per-stage times;
  train    the training path: Pipeline.create(..., training=True) with the
           teacher, an 18-step Heun schedule, seeded synthetic 10-s
           waveforms and hash-tokenized prompts; one warm-up and ten timed
           stage-2 optimizer steps at micro-batch 8 (constant learning rate
           1e-4, so that the first steps move the weights) and one validation
           step at batch 2, with the launch counters set to 0 before and
           read after and compared with the counts the code implies; finite
           losses; the student and both EMAs moved as their decays imply;
           the forward loss of a batch-2 micro-batch with given draws
           against the same weights in fp32 on the CPU through the plain
           versions; seconds per step, samples/s, peak memory and the time
           of each part of a step;
  serve    the test-set CLI (consistencytta_torch.cli.inference.main, in
           this process) at full width from reference-format checkpoints
           (the full model with its legacy role names, the AudioLDM VAE with
           its vocoder) of seeded random bf16 weights, written under
           outputs/ and deleted at the end: a 32-row manifest at batch 32
           with the 18-step Heun CFG teacher (--use_edm --use_ema
           --query_teacher), then --stage 1 with 20 DDIM steps, evaluated
           against the teacher's files through --test_references (the
           eval phase's backbones under ckpt/ in its working directory,
           all_mels.npz as mel_path); the wavs
           (int16, 16 kHz, 10 s, not silent), all_mels.npz ([32, 1001, 64]
           in [0, 1]) and the summary.jsonl line; the launch counters against
           the counts the code implies; every tensor the loader fills equal
           to the saved one; a 2-step teacher and a 2-step guided student at
           batch 1 against the same weights in fp32 on the CPU; the seconds
           of each part and the peak memory;
  eval     the evaluation harness at the backbones' published widths (Cnn14,
           VGGish, CLAP HTSAT-base + RoBERTa-base; seeded random weights
           written as the reference's three checkpoint files under the serve
           phase's directory): the serve phase's 32 student wavs against its
           32 teacher wavs through the port's evaluate_existing, with the K4
           launches against the count the code implies; every metric present
           and finite except the CLAP scores, which are NaN where no RoBERTa
           tokenizer files are (as in the JAX harness), for this run and the
           serve phase's evaluating CLI run; the CLAP towers through a
           stand-in tokenizer; each backbone's embeddings of 4 clips (the
           text tower's of 4 captions) against fp32 on the CPU, whole and
           after removing the across-set mean, each within its own limit
           (TOL_EVAL; the convolutions run in TF32, PyTorch's default), with
           the set's embeddings apart and a bf16 control over the limit; the
           seconds of each part (FD's sqrtm on its own), clips/s and peak
           memory;
  kernels  one line naming every kernel with its launches, error and times.

Then the nvidia-smi line, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero, and without a CUDA card the script exits 2.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FLOPS_3XTF32 = 495e12 / 3  # float32-grade products as three TF32 passes
PEAK_FLOPS_FP32 = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
BATCH = 32
TEXT_LEN = 64
HEAD_WIDTH = 51  # the UNet's attention heads (inner dims 255/510/1020)
TOL_L2 = 1e-2  # relative L2 error allowed for every kernel against its plain version
TIMED_CALLS = 10  # timed generate calls per batch size, after one warm-up
TOL_STFT = 1e-5  # largest STFT error allowed, as a share of the largest magnitude
TRAIN_BATCH = 8  # micro-batch of the stage-2 steps
TRAIN_STEPS = 10  # timed optimizer steps, after one warm-up
VAL_BATCH = 2  # batch of the validation step and of the agreement check
TRAIN_LR = 1e-4  # constant: the default schedule's warm-up starts at 0
HEUN_STEPS = 18
TOL_TRAIN_LOSS = 0.05  # card (bf16, kernels) against CPU fp32, relative
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


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


SERVE_TEACHER_STEPS = 18  # the CLI's default --num_teacher_steps (Heun: 35 queries)
SERVE_STAGE1_STEPS = 20  # --stage 1 --num_steps 20 (DDIM: 20 queries)
LEGACY_PREFIX = {"student": "consistency_unet.", "student_target": "consistency_ema_unet.",
                 "student_ema": "consistency_slow_ema_unet.", "teacher": "diffusion_unet."}
SERVE_PLACES = ["", " nearby", " far away", " at night"]


def serve_phase(torch, config, serve_dir, reset_counters, read_counters, fused_levels, tok,
                dev):
    """The test-set CLI at full width from reference-format checkpoints of
    seeded random bf16 weights: stage 2 with the 18-step Heun CFG teacher,
    then stage 1 (the guided student, 20 DDIM steps), both at batch 32 on a
    32-row manifest; the files they write; every tensor the loader fills
    against the saved one; and a 2-step teacher and a 2-step guided student
    at batch 1 against the same weights in fp32 on the CPU. Returns the
    phase's JSON line and its launch counts."""
    import numpy as np
    from scipy.io import wavfile

    from consistencytta_torch.cli import inference as cli
    from consistencytta_torch.inference.generate import (
        build_guided_student_generate_fn, build_teacher_generate_fn,
    )
    from consistencytta_torch.io import checkpoints
    from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
    from consistencytta_torch.text.tokenizer import tokenize_with_uncond
    from consistencytta_torch.tools.random_eval_checkpoints import write_eval_checkpoints

    torch.cuda.reset_peak_memory_stats()
    roles = STUDENT_ROLES + ("teacher",)
    src = Pipeline.create(config, dtype=torch.bfloat16, device="cuda", seed=1, roles=roles)
    # the reference formats: the full model with its legacy role names, the
    # AudioLDM checkpoint with its vocoder; the student roles share one module,
    # so one CPU copy of it stands for all three (torch.save stores it once)
    t0 = time.perf_counter()
    cpu_sd = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}
    by_module = {}
    unet_sd = {r: by_module.setdefault(id(m), cpu_sd(m)) for r, m in src.unets.items()}
    vae_sd, voc_sd = cpu_sd(src.vae), cpu_sd(src.vocoder)
    model_path = os.path.join(serve_dir, "pytorch_model_2.bin")
    vae_path = os.path.join(serve_dir, "audioldm-s-full.ckpt")
    torch.save({LEGACY_PREFIX[r] + k: v for r, sd in unet_sd.items() for k, v in sd.items()},
               model_path)
    torch.save({"state_dict": {**{"first_stage_model." + k: v for k, v in vae_sd.items()},
                               **{"first_stage_model.vocoder." + k: v
                                  for k, v in voc_sd.items()}}}, vae_path)
    save_s = time.perf_counter() - t0
    checkpoint_gb = (os.path.getsize(model_path) + os.path.getsize(vae_path)) / 1e9
    names = [f"audiocaps_{i:02d}.wav" for i in range(BATCH)]
    manifest = os.path.join(serve_dir, "test.jsonl")
    captions = {}
    with open(manifest, "w") as f:
        for i, name in enumerate(names):
            captions[name] = PROMPTS[i % len(PROMPTS)] + SERVE_PLACES[i // len(PROMPTS) % 4]
            f.write(json.dumps({"captions": captions[name], "location": f"clips/{name}"}) + "\n")
    common = ["--model", model_path, "--vae_checkpoint", vae_path, "--test_file", manifest,
              "--batch_size", str(BATCH), "--use_bf16", "--text_len", str(TEXT_LEN)]

    def run(argv, expected):
        reset_counters()
        t0 = time.perf_counter()
        result = cli.main(common + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
        if counts != expected:
            fail(f"serve {argv}: launch counts {counts} != expected {expected}")
        return result, wall, counts

    def check_wavs(directory):
        listing = sorted(n for n in os.listdir(directory) if n.endswith(".wav"))
        if listing != names:
            fail(f"serve: {directory} holds {listing[:3]}..., not the manifest's names")
        for n in names:
            sr, data = wavfile.read(os.path.join(directory, n))
            if sr != 16000 or data.dtype != np.int16 or data.shape != (160000,) \
                    or not np.abs(data).max() > 0:
                fail(f"serve: {n}: {sr} Hz, {data.dtype}, {data.shape}, peak {np.abs(data).max()}")

    # stage 2: the consistency student (1 query) and the teacher (2 x 18 - 1
    # queries at the CFG batch of 64), 16 attention launches a query; a decode
    # each (K2 once, K3 at each fused level); one 512-point frontend launch
    # for the batch's mels
    out = os.path.join(serve_dir, "stage2")
    queries = 1 + 2 * SERVE_TEACHER_STEPS - 1
    expected = {"flash_mha_packed": 16 * queries, "flash_self_attention": 2,
                "fused_mrf_level": 2 * fused_levels, "stft_magnitude": 1, "dilated_conv1d": 0}
    res2, wall2, counts2 = run(["--use_edm", "--use_ema", "--query_teacher", "--num_teacher_steps",
                                str(SERVE_TEACHER_STEPS), "--skip_eval", "--output_dir", out],
                               expected)
    check_wavs(out)
    check_wavs(out + "_teacher")
    mels = np.load(os.path.join(out, "all_mels.npz"))
    if list(mels["names"]) != names or mels["mels"].shape != (BATCH, 1001, 64) \
            or not (np.isfinite(mels["mels"]).all() and mels["mels"].min() >= 0
                    and mels["mels"].max() <= 1) or int(mels["target_centisec"]) != 1000:
        fail(f"serve: all_mels.npz {mels['mels'].shape} in [{mels['mels'].min()}, "
             f"{mels['mels'].max()}]")
    with open(os.path.join(out, "summary.jsonl")) as f:
        lines = f.read().splitlines()
    if len(lines) != 1 or json.loads(lines[0])["num_clips"] != BATCH:
        fail(f"serve: summary.jsonl holds {len(lines)} lines")

    # stage 1: the guided student, DDIM, no teacher, evaluated against the
    # teacher's files (--test_references, no --skip_eval) with the backbones
    # that the CLI looks for under ckpt/ in the working directory: seeded
    # random weights at the published widths. Its K4 launches: the batch's
    # mels, and the references' mels (32 files of one length, one launch);
    # the generated mels come from all_mels.npz.
    t0 = time.perf_counter()
    eval_ckpt = write_eval_checkpoints(os.path.join(serve_dir, "ckpt"), seed=EVAL_SEED)
    eval_ckpt_s = time.perf_counter() - t0
    out1 = os.path.join(serve_dir, "stage1")
    expected1 = {"flash_mha_packed": 16 * SERVE_STAGE1_STEPS, "flash_self_attention": 1,
                 "fused_mrf_level": fused_levels, "stft_magnitude": 2, "dilated_conv1d": 0}
    cwd = os.getcwd()
    os.chdir(serve_dir)
    try:
        res1, wall1, counts1 = run(["--stage", "1", "--num_steps", str(SERVE_STAGE1_STEPS),
                                    "--test_references", out + "_teacher", "--output_dir", out1],
                                   expected1)
    finally:
        os.chdir(cwd)
    check_wavs(out1)
    launches = {k: counts2[k] + counts1[k] for k in counts2}

    # the loader fills every tensor a checkpoint holds: NaN first, then load
    for m in (*{id(m): m for m in src.unets.values()}.values(), src.vae, src.vocoder):
        for t in m.state_dict().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = checkpoints.load_frozen_and_roles(src, model_path=model_path,
                                               vae_checkpoint=vae_path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = [(f"{r}.{k}", v, unet_sd[r][k]) for r, m in src.unets.items()
             for k, v in m.state_dict().items()]
    pairs += [(f"vae.{k}", v, vae_sd[k]) for k, v in src.vae.state_dict().items()]
    pairs += [(f"vocoder.{k}", v, voc_sd[k]) for k, v in src.vocoder.state_dict().items()]
    unequal = [name for name, got, want in pairs if not torch.equal(got.cpu(), want)]
    if unequal or set(loaded) != {"vae", "vocoder", *roles}:
        fail(f"serve: loaded {sorted(loaded)}; tensors unequal to the saved ones: {unequal[:5]}")

    # agreement: 2-step samplers at batch 1 with given noise, on the card and
    # with the same weights in fp32 on the CPU through the plain versions
    cpu = lambda m: copy.deepcopy(m).to("cpu", torch.float32)
    ref = Pipeline(config, {r: cpu(src.unets[r]) for r in ("teacher", "student_ema")},
                   cpu(src.vae), cpu(src.vocoder), cpu(src.t5), torch.device("cpu"),
                   torch.float32)
    ids, mask, uids, umask = tokenize_with_uncond(tok, PROMPTS[:1], TEXT_LEN)
    noise = torch.randn(src.latent_shape(1), generator=torch.Generator().manual_seed(11))
    agreement = {}
    for name, build in (
            ("teacher_heun_2_steps", lambda p: build_teacher_generate_fn(p, 2, use_edm=True)),
            ("guided_student_ddim_2_steps",
             lambda p: build_guided_student_generate_fn(p, 2, use_ema=True, use_edm=False))):
        got = build(src)(ids, mask, uids, umask, 4.0, noise=noise.to(dev)).cpu()
        t0 = time.perf_counter()
        want = build(ref)(ids, mask, uids, umask, 4.0, noise=noise)
        agreement[name] = {"rel_l2": ((got - want).norm() / want.norm()).item(),
                           "cpu_fp32_seconds": time.perf_counter() - t0}
    line = {
        "phase": "serve", "config": "PipelineConfig() light UNet + teacher, T5-large, bf16; "
        "reference-format checkpoints of seeded random weights; hash tokenizer",
        "manifest_rows": BATCH, "batch": BATCH,
        "checkpoint_gb": checkpoint_gb, "checkpoint_save_seconds": save_s,
        "stage2": {"argv": "--use_edm --use_ema --query_teacher --use_bf16", **res2,
                   "wall_seconds": wall2,
                   "student_clips_per_s_with_io": BATCH / (res2["gen_seconds"]
                                                           + res2["write_seconds"]
                                                           + res2["mel_seconds"]),
                   "teacher_clips_per_s_with_io": BATCH / (res2["teacher_seconds"]
                                                           + res2["teacher_write_seconds"]),
                   "teacher_queries": 2 * SERVE_TEACHER_STEPS - 1},
        "stage1": {"argv": f"--stage 1 --num_steps {SERVE_STAGE1_STEPS} --use_bf16", **res1,
                   "wall_seconds": wall1},
        "launches": launches, "launches_stage2": counts2, "launches_stage1": counts1,
        "reload_seconds": load_s, "reloaded_tensors_equal": len(pairs),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "reference": {**agreement, "tol_rel_l2": 0.1},
    }
    bad = {k: v["rel_l2"] for k, v in agreement.items() if not v["rel_l2"] <= 0.1}
    if bad:
        emit(line)
        fail(f"serve: samplers differ from the fp32 CPU reference: {bad}")
    context = {"names": names, "captions": captions, "gen_dir": out, "ref_dir": out + "_teacher", "stage1_dir": out1,
               "stage1": res1, "checkpoints": eval_ckpt, "checkpoint_write_seconds": eval_ckpt_s}
    return line, launches, context


EVAL_SEED = 3  # the random backbone checkpoints
# Backbone embeddings on the card against the same weights in float32 on the
# CPU, on a set of 4 clips (2 of the serve run, 2 seeded tones): the larger of
# the relative L2 and the relative L2 after removing the across-set mean (the
# input's part of the embeddings). Each limit is near the geometric mean of
# the sound reading and a bf16 control's (the backbone under bf16 autocast),
# both read on an H100 80GB HBM3 at 700 W (PERF.md): 1.7e-3 / 2.2e-2 (Cnn14
# embedding; cuDNN's TF32 convs make all of the sound reading), 1.7e-3 /
# 2.6e-2 (logits), 1.4e-3 / 1.6e-2 (VGGish), 6.3e-6 / 0.90 (CLAP audio),
# 6.9e-6 / 3.3e-2 (CLAP text). The control must exceed its limit.
TOL_EVAL = {"cnn14_embedding": 6e-3, "cnn14_logits": 6e-3, "vggish": 4e-3,
            "clap_audio": 2e-3, "clap_text": 4e-4}
EVAL_MIN_SPREAD = 0.05  # the set's embeddings must lie apart (see _agreement)


def _rel_l2(got, want) -> float:
    import numpy as np

    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _agreement(card, host) -> dict:
    """A set's embeddings on the card against the CPU's: the relative L2,
    the same after removing the across-set mean, and the CPU set's spread
    (its norm after removing that mean over its norm). An embedding that
    is mostly one vector for every input shows a small relative L2 whatever
    its input-dependent part does; the centred reading holds that part."""
    import numpy as np

    card, host = np.asarray(card, np.float64), np.asarray(host, np.float64)
    centred = lambda e: e - e.mean(axis=0)
    return {"rel_l2": _rel_l2(card, host),
            "centred_rel_l2": _rel_l2(centred(card), centred(host)),
            "spread": float(np.linalg.norm(centred(host)) / np.linalg.norm(host))}


def _agreement_err(reading: dict) -> float:
    return max(reading["rel_l2"], reading["centred_rel_l2"])


def eval_agreement(torch, ckpt, clap, standin, gen_path, ref_path, caps):
    """Each backbone's embeddings of 4 clips (a generated and a reference
    file of the serve run, and 2 seeded tones with noise written beside
    them) and the text tower's of `caps`, on the card in float32 (cuDNN
    TF32 on, PyTorch's default), with TF32 off, under bf16 autocast (the
    control), and with the same weights in float32 on the CPU. Returns the
    clips, the captions and the readings (_agreement) by backbone."""
    import numpy as np

    from consistencytta_torch.evaluation import panns, vggish
    from consistencytta_torch.evaluation.clap_model import CLAPWrapper, load_clap_towers
    from consistencytta_torch.evaluation.mels import load_wav_16k
    from consistencytta_torch.io.audio import write_wav

    rng = np.random.default_rng(EVAL_SEED)
    t = np.arange(160000) / 16000
    tones = []
    for i, f0 in enumerate((220.0, 1661.2)):
        tones.append(os.path.join(os.path.dirname(os.path.dirname(gen_path)), f"tone_{i}.wav"))
        write_wav(tones[-1], (0.25 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
            4 * np.pi * f0 * t) + 0.05 * rng.standard_normal(t.size)).astype(np.float32))
    few = [gen_path, ref_path, *tones]

    class Bf16(torch.nn.Module):
        """A CLAP tower under bf16 autocast, giving float32 (the control)."""

        def __init__(self, tower):
            super().__init__()
            self.tower, self.config = tower, getattr(tower, "config", None)

        def forward(self, *args):
            with torch.autocast("cuda", torch.bfloat16):
                return self.tower(*args).float()

    def card_modes(fn, bf16_fn=None):
        """fn() on the card in float32, with cuDNN TF32 off, and under
        bf16 autocast (bf16_fn() where given)."""
        out = {"fp32": fn()}
        torch.backends.cudnn.allow_tf32 = False
        try:
            out["tf32_off"] = fn()
        finally:
            torch.backends.cudnn.allow_tf32 = True
        with torch.autocast("cuda", torch.bfloat16):
            out["bf16"] = (bf16_fn or fn)()
        return out

    wav = torch.from_numpy(np.stack([load_wav_16k(p, 1000) for p in few]))
    examples = torch.from_numpy(np.concatenate(
        [vggish.waveform_to_examples(vggish.load_audio_fad(p, 1000)) for p in few]))
    cnn14_card, cnn14_host = (panns.load_cnn14(ckpt["cnn14"], d) for d in ("cuda", "cpu"))
    vggish_card, vggish_host = (vggish.load_vggish(ckpt["vggish"], d) for d in ("cuda", "cpu"))
    clap_host = CLAPWrapper(*load_clap_towers(ckpt["clap"], "cpu"), standin)
    clap_bf16 = CLAPWrapper(Bf16(clap.audio_tower), Bf16(clap.text_tower), standin)
    np_ = lambda x: x.float().cpu().numpy()
    with torch.no_grad():
        runs = {
            "cnn14": (card_modes(lambda: cnn14_card(wav.cuda())), cnn14_host(wav)),
            "vggish": (card_modes(lambda: np_(vggish_card(examples.cuda()))),
                       np_(vggish_host(examples))),
            "clap_audio": (card_modes(lambda: clap.audio_embeddings(few),
                                      lambda: clap_bf16.audio_embeddings(few)),
                           clap_host.audio_embeddings(few)),
            "clap_text": (card_modes(lambda: clap.text_embeddings(caps),
                                     lambda: clap_bf16.text_embeddings(caps)),
                          clap_host.text_embeddings(caps)),
        }
    for name, key in (("cnn14_embedding", "2048"), ("cnn14_logits", "logits")):
        card, host = runs["cnn14"]
        runs[name] = ({m: np_(v[key]) for m, v in card.items()}, np_(host[key]))
    agreement = {}
    for name in TOL_EVAL:
        card, host = runs[name]
        reading = _agreement(card["fp32"], host)
        reading["tf32_off"] = _agreement(card["tf32_off"], host)
        reading["tf32_vs_tf32_off_centred_rel_l2"] = _agreement(
            card["fp32"], card["tf32_off"])["centred_rel_l2"]
        reading["bf16_control"] = _agreement(card["bf16"], host)
        reading["tol"] = TOL_EVAL[name]
        reading["ok"] = _agreement_err(reading) <= TOL_EVAL[name] and \
            reading["spread"] >= EVAL_MIN_SPREAD
        reading["control_caught"] = _agreement_err(reading["bf16_control"]) > TOL_EVAL[name]
        agreement[name] = reading
    return few, caps, agreement


def eval_phase(torch, ctx, reset_counters, read_counters):
    """The evaluation harness at the backbones' published widths (Cnn14 at
    16 kHz, VGGish, CLAP HTSAT-base with RoBERTa-base and a joint width of
    512; seeded random weights as the reference's three checkpoint files):
    the serve phase's 32 student wavs against its 32 teacher wavs with the
    manifest's captions, through the port's evaluate_existing (the generated
    mels through K4 too), with the launch counts; the serve phase's stage-1
    CLI run, which evaluated through --test_references with all_mels.npz as
    mel_path; the CLAP towers through a CLAPWrapper with a stand-in tokenizer
    (the card's host has no RoBERTa files, so the harness gives NaN for the
    CLAP scores there, as the JAX package does); and each backbone's
    embeddings of 4 clips (the text tower's of 4 captions) against the same
    weights in fp32 on the CPU, with a bf16 control (_agreement, TOL_EVAL). The backbones run in float32 with cuDNN's
    TF32 convolutions, PyTorch's default and the reference's setting; the
    matrix products stay full float32. Returns the phase's line and its
    launch counts."""
    import numpy as np

    from consistencytta_torch.cli import evaluate_existing
    from consistencytta_torch.evaluation import metrics
    from consistencytta_torch.evaluation.clap_model import (
        CLAPWrapper, RobertaConfig, load_clap_towers,
    )
    from consistencytta_torch.evaluation.harness import MEL_BATCH, RESULT_KEYS
    from consistencytta_torch.evaluation.mels import (
        eval_mel_frontend, load_wav_16k, normalized_logmel,
    )
    from consistencytta_torch.io.audio import write_wav
    from consistencytta_torch.text.tokenizer import HashTokenizer, _tokenizer_files_present

    names, captions, ckpt = ctx["names"], ctx["captions"], ctx["checkpoints"]
    gen_dir, ref_dir = ctx["gen_dir"], ctx["ref_dir"]
    gen_paths = [os.path.join(gen_dir, n) for n in names]
    ref_paths = [os.path.join(ref_dir, n) for n in names]
    caps_path = os.path.join(os.path.dirname(gen_dir), "captions.json")
    with open(caps_path, "w") as f:
        json.dump(captions, f)
    # the harness's CLAP scores are NaN where the RoBERTa tokenizer's files
    # are absent, as the JAX harness's would be
    clap_nan = not _tokenizer_files_present("roberta-base")
    clap_keys = {"gt_text_clap_score", "gen_text_clap_score", "gen_gt_clap_score"}

    def check_result(what, result):
        missing = [k for k in RESULT_KEYS if k not in result]
        bad = [k for k in RESULT_KEYS if k in result and not np.isfinite(result[k])
               and not (clap_nan and k in clap_keys)]
        if missing or bad or (clap_nan and not all(np.isnan(result[k]) for k in clap_keys)):
            fail(f"eval: {what}: keys missing {missing}, not finite {bad}: {result}")

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        argv = ["--gen_dir", gen_dir, "--ref_dir", ref_dir, "--captions_json", caps_path,
                "--cnn14_checkpoint", ckpt["cnn14"], "--vggish_checkpoint", ckpt["vggish"],
                "--clap_checkpoint", ckpt["clap"]]
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        result, parts = evaluate_existing.evaluate(evaluate_existing.parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        # K4: one 512-point launch for the 32 generated files' mels and one for
        # the references' (one length, at most MEL_BATCH rows a launch)
        batches = -(-len(names) // MEL_BATCH)
        expected = {"flash_mha_packed": 0, "flash_self_attention": 0, "fused_mrf_level": 0,
                    "stft_magnitude": 2 * batches, "dilated_conv1d": 0}
        if counts != expected:
            fail(f"eval: launch counts {counts} != expected {expected}")
        check_result("evaluate_existing", result)
        with open(gen_dir + "_evaluation_results.json") as f:
            if json.dumps(json.load(f)) != json.dumps(result):
                fail("eval: the results file differs from the returned metrics")

        # the CLI path: the serve phase's stage-1 run with --test_references
        cli_result = {k: ctx["stage1"].get(k) for k in RESULT_KEYS}
        check_result("the CLI's --test_references run", cli_result)
        with open(ctx["stage1_dir"] + "_evaluation_results.json") as f:
            if json.dumps(json.load(f)) != json.dumps(cli_result):
                fail("eval: the CLI's results file differs from its summary line")

        # CLAP through a stand-in tokenizer (the hash tokenizer's ids, padded
        # to 77): the towers at full width on the 64 files and 32 captions
        standin = HashTokenizer(vocab_size=RobertaConfig().vocab_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clap = CLAPWrapper(*load_clap_towers(ckpt["clap"], "cuda"), standin)
        clap_load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clap_gen, clap_ref = clap.audio_embeddings(gen_paths), clap.audio_embeddings(ref_paths)
        clap_audio_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clap_text = clap.text_embeddings([captions[n] for n in names])
        clap_text_s = time.perf_counter() - t0
        scores = metrics.clap_scores(clap_ref, clap_gen, clap_text)
        if not all(np.isfinite(v) for v in scores.values()):
            fail(f"eval: stand-in CLAP scores {scores}")

        t0 = time.perf_counter()
        few, caps, agreement = eval_agreement(torch, ckpt, clap, standin, gen_paths[0],
                                              ref_paths[0], [captions[n] for n in names[:4]])
        agree_s = time.perf_counter() - t0

        # the harness's batched K4 launch against one launch a file: each
        # frame is computed on its own, so the magnitudes agree bit for bit;
        # the mel product after it is cuBLAS's at another row count
        frontend = eval_mel_frontend("cuda")
        wavs = np.stack([load_wav_16k(p, 1000) for p in gen_paths[:4]])
        with torch.no_grad():
            batch_mag = frontend.magnitude(torch.from_numpy(wavs).cuda())
            file_mag = torch.cat([frontend.magnitude(torch.from_numpy(w[None]).cuda())
                                  for w in wavs])
        mag_equal = bool(torch.equal(batch_mag, file_mag))
        mel_diff = float(np.abs(normalized_logmel(wavs, frontend) - np.stack(
            [normalized_logmel(w, frontend) for w in wavs])).max())
        if not mag_equal or not mel_diff <= 1e-5:
            fail(f"eval: batched K4 rows differ from per-file launches (magnitudes equal "
                 f"{mag_equal}, normalised mels {mel_diff})")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    paired = parts.get("lsd", 0.0) + parts.get("psnr_ssim", 0.0)
    line = {
        "phase": "eval", "config": "Cnn14 16 kHz, VGGish, CLAP HTSAT-base + RoBERTa-base "
        "(joint 512); seeded random weights as the reference's checkpoint files",
        "precision": "float32; cuDNN convolutions in TF32 (PyTorch's default), matrix "
        "products in full float32",
        "pairs": len(names), "gen": "serve stage-2 student", "ref": "serve stage-2 teacher",
        "metrics": result, "cli_metrics": cli_result,
        "cli_eval_seconds": ctx["stage1"]["eval_seconds"],
        "wall_seconds": wall, "clips_per_s": len(names) / wall,
        "seconds": {"wav_load": parts.get("wav_load"), "paired_metrics": paired,
                    "mels": parts.get("mels"), "cnn14": parts.get("cnn14"),
                    "vggish": parts.get("vggish"), "clap_audio_64_files": clap_audio_s,
                    "clap_text_32_captions": clap_text_s, "clap_load": clap_load_s,
                    "fd_sqrtm": parts.get("frechet_distance"),
                    "metric_math": parts.get("frechet_distance", 0.0)
                    + parts.get("kl_isc_kid", 0.0) + parts.get("frechet_audio_distance", 0.0),
                    "harness_parts": parts,
                    "checkpoint_write": ctx["checkpoint_write_seconds"],
                    "cpu_agreement": agree_s},
        "peak_memory_gb": peak_gb, "launches": counts, "expected_launches": expected,
        "clap_scores_nan_without_tokenizer_files": clap_nan, "standin_clap_scores": scores,
        "reference": {"files": len(few), "captions": len(caps), "min_spread": EVAL_MIN_SPREAD,
                      **agreement},
        "batched_k4_rows": {"files": len(wavs), "magnitudes_bit_equal": mag_equal,
                            "normalised_mel_max_abs_diff": mel_diff, "tol": 1e-5},
    }
    bad = {k: v for k, v in agreement.items() if not (v["ok"] and v["control_caught"])}
    if bad:
        emit(line)
        fail(f"eval: backbones on the card against the fp32 CPU reference (a reading over its "
             f"limit, a set that does not lie apart, or a bf16 control under it): {bad}")
    return line, counts


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
        from consistencytta_torch.evaluation.mels import EVAL_STFT
        from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn
        from consistencytta_torch.models.pipeline import Pipeline
        from consistencytta_torch.nn.hifigan import FUSE_MAX_CHANNELS
        from consistencytta_torch.ops import _build
        from consistencytta_torch.ops import attention as att
        from consistencytta_torch.ops import dilated_conv as dconv
        from consistencytta_torch.ops import mrf, schedulers, stft
        from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
        from consistencytta_torch.training import step as tstep
        from consistencytta_torch.training.optim import OptimizerConfig
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})", 3)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi("name,power.limit")

    # -- env ------------------------------------------------------------------
    import numpy
    import scipy

    t0 = time.perf_counter()
    build_s = _build.build()
    emit({
        "phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
        "numpy_scipy": [numpy.__version__, scipy.__version__],
        "build_seconds": {k: round(v, 2) for k, v in build_s.items()},
        "build_wall_seconds": round(time.perf_counter() - t0, 2),
        "clocks_power": nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"),
        # registers, spills and shared memory of the attention kernels: what the
        # loaded library reports, and what ptxas printed when it was built; of
        # the MRF and STFT kernels, what ptxas printed
        "attention_kernels": att.kernel_resources(),
        "attention_ptxas": _build.resources("flash_attention"),
        "mrf_ptxas": _build.resources("mrf"),
        "stft_ptxas": _build.resources("stft"),
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
               flops, nbytes, per_call, weight=None, peak=PEAK_FLOPS, **extra):
        """Check got against want, and check that each mutant (the plain
        version with a planted fault: a wrong scale, a dropped tile, ...)
        fails the same tolerance, so that the tolerance can tell a broken
        kernel from rounding at this shape. The kernel's summed times count
        this shape `weight` times (default: its launches per main-path call)."""
        weight = per_call if weight is None else weight
        err, scale, l2 = compare(got, want)
        ok = within(got, want, tol_max)
        caught = {}
        for fault, bad in mutants.items():
            e, _, m_l2 = compare(bad, want)
            caught[fault] = {"max_abs_err": e, "rel_l2": m_l2,
                             "caught": not within(bad, want, tol_max)}
        b_ms, b_by = bound(flops, nbytes, peak)
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
                                      "flops": 0.0, "bytes": 0.0, "peak": peak})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if weight:
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                           ("flops", flops), ("bytes", nbytes)):
                r[key] += weight * v
            r["library_ms"] = None if lib_ms is None or r["library_ms"] is None \
                else r["library_ms"] + weight * lib_ms

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

    def graph_ms(fn, launches: int = 20):
        """Device time of one call with the host out of the way: `launches`
        calls captured in a CUDA graph, the graph replayed and timed. None,
        with the reason, where the capture is refused."""
        try:
            fn()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(launches):
                    fn()
            return cuda_ms(torch, graph.replay, 5) / launches, None
        except RuntimeError as e:
            return None, str(e)[:200]

    def host_us(fn, calls: int = 200) -> float:
        """Microseconds of host time one call takes to queue its work (the
        wrapper's checks, the tensor maps and the launch), card not waited for."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * dt / calls

    sdpa = torch.nn.functional.scaled_dot_product_attention
    # K1: the UNet's self-attention shapes; launches per UNet query in brackets.
    # Heads are 51 wide, padded to the kernel's 64 with zero columns (as the
    # UNet's projections pad them); the bound counts the 51 the function needs.
    # Every batch a driven path hands the kernel is checked; the summed times
    # count the generate path's batch only.
    k1_batches = ((BATCH, "generate"),
                  (1, "generate at batch 1, the interactive shape"),
                  (2 * BATCH, "serve: the CFG teacher's [uncond; cond] queries at batch 32"),
                  (2 * TRAIN_BATCH, "train: the CFG teacher's [uncond; cond] queries"),
                  (TRAIN_BATCH, "train: target and student queries"),
                  (2 * VAL_BATCH, "validation: the CFG teacher's queries"),
                  (VAL_BATCH, "validation: target queries"))
    for b, path in k1_batches:
        for s, h, per_call in ((4096, 5, 5), (1024, 10, 5), (256, 20, 5), (64, 20, 1)):
            qkv = torch.randn(b, s, 3, h, 64, device=dev, generator=gen)
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
            host = {"host_us": host_us(kern), "library_host_us": host_us(lib)} if b == 1 else {}
            record("flash_mha_packed", f"B={b} S={s} H={h} d={HEAD_WIDTH} (64 padded)",
                   got, want, 2e-2, mutants,
                   cuda_ms(torch, kern, iters), cuda_ms(torch, plain, 1),
                   cuda_ms(torch, lib, iters),
                   4.0 * b * h * s * s * HEAD_WIDTH, 4.0 * b * s * h * HEAD_WIDTH * 2,
                   per_call, weight=per_call if b == BATCH else 0, path=path, **host)
            del qkv, q, k, v, got, want, mutants
    # K1's gradient as the student's backward takes it: q, k and v are slices
    # of one projection that requires grad, the kernel runs under autocast,
    # and the backward of its autograd.Function is held against autograd
    # through the plain version outside autocast. S = 1024, where the plain
    # version's [B, H, S, S] logits are small. The faults: the plain gradient
    # at the scale of width 64, and with the k and v thirds exchanged.
    b, s, h = TRAIN_BATCH, 1024, 10
    qkv = torch.randn(b, s, 3, h, 64, device=dev, generator=gen)
    qkv[..., HEAD_WIDTH:] = 0
    qkv = qkv.flatten(2).bfloat16()
    g_out = torch.randn(b, s, h * 64, device=dev, generator=gen).bfloat16()

    def qkv_grad(fn, scale, autocast):
        leaf = qkv.clone().requires_grad_()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = fn(*leaf.split(h * 64, dim=-1), h, scale)
        return torch.autograd.grad(out, leaf, g_out)[0]

    got = launch(att.flash_mha_packed,
                 lambda: qkv_grad(att.flash_mha_packed, HEAD_WIDTH ** -0.5, True))
    want = qkv_grad(att.flash_mha_packed_plain, HEAD_WIDTH ** -0.5, False)
    dq, dk, dv = want.split(h * 64, dim=-1)
    grad_mutants = {
        "scale_of_width_64": qkv_grad(att.flash_mha_packed_plain, 64 ** -0.5, False),
        "dk_dv_exchanged": torch.cat([dq, dv, dk], dim=-1),
    }
    err, scale, l2 = compare(got, want)
    caught = {f: not within(bad, want, 2e-2) for f, bad in grad_mutants.items()}
    emit({"phase": "kernel", "name": "flash_mha_packed", "check": "gradient under autocast",
          "shape": f"B={b} S={s} H={h} d={HEAD_WIDTH} (64 padded)", "max_abs_err": err,
          "max_abs_plain": scale, "tol_max_abs": 2e-2 * scale, "rel_l2": l2,
          "tol_rel_l2": TOL_L2, "ok": within(got, want, 2e-2), "mutants_caught": caught})
    if not within(got, want, 2e-2):
        fail(f"flash_mha_packed gradient: max abs err {err} (tol {2e-2 * scale}), rel L2 {l2}")
    if not all(caught.values()):
        fail(f"flash_mha_packed gradient: the tolerance passes planted faults {caught}")
    del qkv, g_out, got, want, dq, dk, dv, grad_mutants
    # K2: the VAE mid-block attention, one launch per decode chunk (generate)
    # and one per encoded micro-batch (train, validation)
    for b, path in ((BATCH, "generate"), (1, "generate at batch 1, the interactive shape"),
                    (TRAIN_BATCH, "train: the VAE encoder"),
                    (VAL_BATCH, "validation: the VAE encoder")):
        qkv = torch.randn(b, 4096, 3 * 512, device=dev, generator=gen).bfloat16()
        q, k, v = qkv.split(512, dim=-1)
        scale = 512 ** -0.5

        def plain(q=q, k=k, v=v, scale=scale):
            return chunked(lambda a, b, c: att.attention_plain(a, b, c, scale), 8, q, k, v)
        kern = lambda: att.flash_self_attention(q, k, v, scale)
        lib = lambda: sdpa(q[:, None], k[:, None], v[:, None], scale=scale)
        got, want = launch(att.flash_self_attention, kern), plain()
        mutants = {"scale_x1.1": plain(scale=1.1 * scale),
                   "last_32_keys_dropped": plain(k=k[:, :-32], v=v[:, :-32])}
        host = {"host_us": host_us(kern), "library_host_us": host_us(lib)} if b == 1 else {}
        record("flash_self_attention", f"B={b} S=4096 D=512", got, want, 2e-2, mutants,
               cuda_ms(torch, kern, 3), cuda_ms(torch, plain, 1), cuda_ms(torch, lib, 3),
               4.0 * b * 4096 * 4096 * 512, 4.0 * b * 4096 * 512 * 2, 1,
               weight=1 if b == BATCH else 0, path=path, **host)
        del qkv, q, k, v, got, want, mutants
    # K3: the vocoder's MRF levels; the fused levels (C <= FUSE_MAX_CHANNELS)
    # once per generate call, the wider ones (C = 256, 512) measured beside
    # the plain chain they run on. The plain chain has two formulations of its
    # dilated convs (direct, and split into phases); plain_ms is the faster of
    # the two at each shape. weight_l2_gb: the weight units the kernel
    # streams from L2 at the shape (every unit once per tile).
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    for c, length, b in ((128, 40968, BATCH), (64, 81936, BATCH), (32, 163872, BATCH),
                         (256, 20484, BATCH), (512, 5121, BATCH), (512, 2048, 2)):
        per_call = int(c <= FUSE_MAX_CHANNELS and b == BATCH)
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
        t_plan, rows, in_smem = mrf.tile_plan(c, length, ks, ds)
        record("fused_mrf_level", f"B={b} C={c} L={length}", got, want, 3e-2, mutants,
               cuda_ms(torch, kern, 2), min(direct_ms, split_ms), None,
               float(mrf.mrf_flops(b, c, length, ks, ds)), 2.0 * x.numel() * 2 + wbytes,
               per_call, plain_direct_ms=direct_ms, plain_phase_split_ms=split_ms,
               tile=t_plan, buffers_in_smem=in_smem,
               smem_bytes=mrf.smem_bytes(c, rows, in_smem),
               weight_l2_gb=mrf.weight_l2_bytes(b, c, length, ks, ds) / 1e9)
        del x, ws, bs, got, want, tile, unzeroed, mutants
    # K4: the mel frontend's STFT magnitude on 10-s clips, float32 in and out;
    # once per train micro-batch (B = 8). The plain version is one float32
    # matmul with TF32 off; the faults are that product in one low-precision
    # pass, zero padding in place of reflect, and a window cut 64 samples short.
    # The kernel is an FFT: its bound is the bytes it must move (the waveform
    # read once, the magnitudes written once; its FFT operations at the FP32
    # rate take less), and dft_bound_ms keeps the bound of the DFT product
    # that the plain version and K4's earlier design computed. device_ms: the
    # kernel's time from a replayed CUDA graph, without the host's launch.
    stft_cfg = PipelineConfig().stft
    frontend = stft.MelFrontend(stft_cfg, device=dev)
    cos_b, sin_b = frontend.cos_basis, frontend.sin_basis
    win, hop, half = stft_cfg.filter_length, stft_cfg.hop_length, stft_cfg.filter_length // 2
    hann = torch.hann_window(win, periodic=True, device=dev)
    samples = int(PipelineConfig().sample_rate * 10.0)

    def magnitude_tf32(w):
        frames = stft.frame_signal(stft.reflect_pad(w, half), win, hop)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            re, im = torch.matmul(frames, torch.cat([cos_b, sin_b], 1)).split(cos_b.shape[1], -1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return torch.sqrt(re * re + im * im)

    for b, per_call in ((TRAIN_BATCH, 1), (VAL_BATCH, 0), (BATCH, 0)):
        wav = (torch.randn(b, samples, device=dev, generator=gen) * 0.3).clamp(-1, 1)
        kern = lambda: frontend.magnitude(wav)
        plain = lambda w=wav, c=cos_b, s_=sin_b, pad=half: stft.stft_magnitude(w, c, s_, hop, pad)
        lib = lambda: torch.stft(wav, win, hop, win, hann, center=True, pad_mode="reflect",
                                 return_complex=True).abs().transpose(1, 2)
        got, want = launch(stft.stft_magnitude_cuda, kern), plain()
        lib_err = (lib() - want).abs().max().item()
        if not lib_err <= 1e-4 * want.abs().max().item():
            fail(f"torch.stft does not compute the STFT magnitude: max abs diff {lib_err}")
        rounded = lambda t: t.bfloat16().float()
        tail = torch.ones(win, 1, device=dev)
        tail[-64:] = 0
        mutants = {
            "single_bf16_pass": plain(w=rounded(wav), c=rounded(cos_b), s_=rounded(sin_b)),
            "single_tf32_pass": magnitude_tf32(wav),
            "zero_padding": plain(w=F.pad(wav, (half, half)), pad=0),
            "window_tail_dropped": plain(c=cos_b * tail, s_=sin_b * tail),
        }
        n_frames, n_bins = want.shape[1:]
        nbytes = 4.0 * (wav.numel() + want.numel())
        device_ms, graph_error = graph_ms(kern)
        record("stft_magnitude", f"B={b} T={samples} frames={n_frames} bins={n_bins}",
               got, want, TOL_STFT, mutants,
               cuda_ms(torch, kern, 20), cuda_ms(torch, plain, 3), cuda_ms(torch, lib, 20),
               float(stft.stft_fft_flops(b, n_frames, win)), nbytes,
               per_call, peak=PEAK_FLOPS_FP32, library_max_abs_diff=lib_err,
               operations_rate="67 TFLOP/s FP32", device_ms=device_ms,
               device_ms_error=graph_error, host_us=host_us(kern),
               smem_bytes=stft.fft_smem_bytes(hop),
               dft_bound_ms=bound(float(stft.stft_flops(b, n_frames, win, n_bins)),
                                  nbytes + 8.0 * cos_b.numel(), PEAK_FLOPS_3XTF32)[0])
        del wav, got, want, mutants
    # K4 at N = 512: the evaluation frontend (hop 160, fmin 50) that the serve
    # path's all_mels.npz runs once per generate batch of 32 (B = 1: one file
    # of the eval harness). Its kernel is the 32 x 16 FFT; the faults are those
    # of N = 1024, the window tail cut by 32 samples (the same share).
    efront = stft.MelFrontend(EVAL_STFT, device=dev)
    ewin, ehalf = EVAL_STFT.filter_length, EVAL_STFT.filter_length // 2
    ecos, esin = efront.cos_basis, efront.sin_basis
    ehann = torch.hann_window(ewin, periodic=True, device=dev)
    for b, per_call in ((BATCH, 1), (1, 0)):
        wav = (torch.randn(b, samples, device=dev, generator=gen) * 0.3).clamp(-1, 1)
        kern = lambda: efront.magnitude(wav)
        plain = lambda w=wav, c=ecos, s_=esin, pad=ehalf: stft.stft_magnitude(w, c, s_, hop, pad)
        lib = lambda: torch.stft(wav, ewin, hop, ewin, ehann, center=True, pad_mode="reflect",
                                 return_complex=True).abs().transpose(1, 2)
        got, want = launch(stft.stft_magnitude_cuda, kern), plain()
        lib_err = (lib() - want).abs().max().item()
        if not lib_err <= 1e-4 * want.abs().max().item():
            fail(f"torch.stft does not compute the 512-point magnitude: max abs diff {lib_err}")
        frames = stft.frame_signal(stft.reflect_pad(wav, ehalf), ewin, hop)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            re, im = torch.matmul(frames, torch.cat([ecos, esin], 1)).split(ecos.shape[1], -1)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        rounded = lambda t: t.bfloat16().float()
        tail = torch.ones(ewin, 1, device=dev)
        tail[-32:] = 0
        mutants = {
            "single_bf16_pass": plain(w=rounded(wav), c=rounded(ecos), s_=rounded(esin)),
            "single_tf32_pass": torch.sqrt(re * re + im * im),
            "zero_padding": plain(w=F.pad(wav, (ehalf, ehalf)), pad=0),
            "window_tail_dropped": plain(c=ecos * tail, s_=esin * tail),
        }
        n_frames, n_bins = want.shape[1:]
        nbytes = 4.0 * (wav.numel() + want.numel())
        device_ms, graph_error = graph_ms(kern)
        record("stft_magnitude_n512", f"B={b} T={samples} N={ewin} frames={n_frames} "
               f"bins={n_bins}", got, want, TOL_STFT, mutants,
               cuda_ms(torch, kern, 20), cuda_ms(torch, plain, 3), cuda_ms(torch, lib, 20),
               float(stft.stft_fft_flops(b, n_frames, ewin)), nbytes,
               per_call, peak=PEAK_FLOPS_FP32, library_max_abs_diff=lib_err,
               operations_rate="67 TFLOP/s FP32", device_ms=device_ms,
               device_ms_error=graph_error, host_us=host_us(kern),
               smem_bytes=stft.fft_smem_bytes(hop, ewin))
        del wav, got, want, mutants, frames, re, im
    # K5: the standalone dilated conv at the vocoder's C = 64 level; nothing
    # dispatches it, so it has no launches on any path and its summed times
    # are those of the six convs run once each.
    b, c, length = BATCH, 64, 81936
    x = (torch.randn(b, c, length, device=dev, generator=gen) * 0.5).bfloat16()
    for kk, d in ((3, 3), (3, 5), (7, 3), (7, 5), (11, 3), (11, 5)):
        w = (torch.randn(c, c, kk, device=dev, generator=gen) / (c * kk) ** 0.5).bfloat16()
        p = d * (kk - 1) // 2
        kern = lambda: dconv.dilated_conv1d(x, w, d, p)
        plain = lambda: dconv.dilated_conv1d_plain(x, w, d, p)
        got, want = launch(dconv.dilated_conv1d, kern), plain()
        one_less = w.clone()
        one_less[..., 0] = 0
        p_off = (d + 1) * (kk - 1) // 2
        mutants = {
            "edges_not_zeroed": F.conv1d(F.pad(x, (p, p), mode="replicate"), w, dilation=d),
            "one_tap_dropped": dconv.dilated_conv1d_plain(x, one_less, d, p),
            "dilation_off_by_one": dconv.dilated_conv1d_plain(x, w, d + 1, p_off),
        }
        plain_ms = cuda_ms(torch, plain, 3)
        record("dilated_conv1d", f"B={b} C={c} L={length} k={kk} d={d}", got, want, 2e-2,
               mutants, cuda_ms(torch, kern, 3), plain_ms, plain_ms,
               float(dconv.dilated_conv_flops(b, c, length, kk)),
               2.0 * (2 * x.numel() + w.numel()), 0, weight=1)
        del w, got, want, one_less, mutants
    del x
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

    counters = {"flash_mha_packed": att.flash_mha_packed,
                "flash_self_attention": att.flash_self_attention,
                "fused_mrf_level": mrf.fused_mrf_level,
                "stft_magnitude": stft.stft_magnitude_cuda,
                "dilated_conv1d": dconv.dilated_conv1d}

    def reset_counters():
        for fn in counters.values():
            fn.launches = 0

    def read_counters():
        return {name: fn.launches for name, fn in counters.items()}

    reset_counters()
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
    launches = read_counters()
    voc = config.vocoder
    fused_levels = sum(voc.upsample_initial_channel // 2 ** (i + 1) <= FUSE_MAX_CHANNELS
                       for i in range(len(voc.upsample_rates)))
    expected = {"flash_mha_packed": 16 * calls, "flash_self_attention": calls,
                "fused_mrf_level": fused_levels * calls, "stft_magnitude": 0, "dilated_conv1d": 0}
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

    # -- training path ------------------------------------------------------------
    del pipe, generate, ref, student, z, emb, mel, wav, wav32, got, want
    torch.cuda.empty_cache()
    roles = ("student", "student_target", "student_ema", "teacher")
    t0 = time.perf_counter()
    tpipe = Pipeline.create(config, dtype=torch.bfloat16, device="cuda", seed=0,
                            roles=roles, training=True)
    torch.cuda.synchronize()
    train_create_s = time.perf_counter() - t0
    heun = schedulers.make_heun_schedule(config.scheduler, HEUN_STEPS)
    state = tstep.TrainState.create(
        tpipe, OptimizerConfig(learning_rate=TRAIN_LR, lr_scheduler_type="constant"))
    step_cfg = tstep.ConsistencyStepConfig()
    train_step = tstep.build_consistency_train_step(tpipe, heun, step_cfg)
    validate = tstep.build_validation_step(tpipe, heun, step_cfg)

    def train_batch(batch, seed):
        """Seeded synthetic clips (a tone, its octave and noise) with prompts."""
        g = torch.Generator(device=dev).manual_seed(1000 + seed)
        t = torch.arange(n_samples, device=dev) / config.sample_rate
        f0 = 110.0 * 2.0 ** (4.0 * torch.rand(batch, 1, device=dev, generator=g))
        wav = 0.3 * torch.sin(2 * torch.pi * f0 * t) + 0.1 * torch.sin(4 * torch.pi * f0 * t) \
            + 0.05 * torch.randn(batch, n_samples, device=dev, generator=g)
        prompts = [PROMPTS[(seed + i) % len(PROMPTS)] for i in range(batch)]
        ids, mask, uids, umask = tokenize_with_uncond(tok, prompts, TEXT_LEN)
        return {"wav": wav, "ids": ids, "mask": mask, "uncond_ids": uids,
                "uncond_mask": umask}, g

    def weights():
        return [m.conv_in.weight.detach().clone()
                for m in (state.student, state.student_target, state.student_ema)]

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for i in range(1 + TRAIN_STEPS):  # the first step warms up
        batch, g = train_batch(TRAIN_BATCH, i)
        before = weights()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(state, batch, generator=g)
        torch.cuda.synchronize()
        if i:
            step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        if not metrics["loss_finite"]:
            fail(f"train step {i}: non-finite loss or gradient")
        # the student moved; each shadow moved to lerp(shadow, student, 1 - decay)
        after = weights()
        moved = [(x1 - x0).abs().max().item() for x0, x1 in zip(before, after)]
        ulp = 4 * torch.finfo(torch.float32).eps * after[0].abs().max().item()
        ema_err = [(torch.lerp(before[j], after[0], 1 - decay) - after[j]).abs().max().item()
                   for j, decay in ((1, step_cfg.target_ema_decay), (2, step_cfg.ema_decay))]
        if not (all(m > 0 for m in moved) and all(e <= ulp for e in ema_err)):
            fail(f"train step {i}: moved {moved}, EMA errors {ema_err} (allowed {ulp})")
    peak_train_gb = torch.cuda.max_memory_allocated() / 2**30
    vbatch, g = train_batch(VAL_BATCH, 20)
    t0 = time.perf_counter()
    val = {k: v.item() for k, v in validate(state, vbatch, generator=g).items()}
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    train_launches = read_counters()
    n_train_steps = 1 + TRAIN_STEPS
    if state.step != n_train_steps:
        fail(f"step count {state.step} after {n_train_steps} steps")
    if not all(v == v and abs(v) != float("inf") for v in (*losses, *val.values())):
        fail(f"non-finite loss: train {losses}, validation {val}")
    # per step: the frontend and the encoder's attention once; 16 attention
    # launches per UNet query, over two teacher queries, one target query
    # and the student's forward (its backward is the plain version's).
    # Validation: two teacher queries and two target queries on the first
    # interval, two teacher queries on each later one, one for the last step.
    unet_queries = n_train_steps * 4 + (4 + 2 * (HEUN_STEPS - 2) + 1)
    calls_t = n_train_steps + 1
    train_expected = {"flash_mha_packed": 16 * unet_queries, "flash_self_attention": calls_t,
                      "fused_mrf_level": 0, "stft_magnitude": calls_t, "dilated_conv1d": 0}
    if train_launches != train_expected:
        fail(f"train launch counts {train_launches} != expected {train_expected}")

    # the parts of one step at the micro-batch, one by one (outside the counted run)
    from consistencytta_torch.training.ema import ema_update

    batch, g = train_batch(TRAIN_BATCH, 30)
    ids_t = [batch[k] for k in ("ids", "mask", "uncond_ids", "uncond_mask")]
    with torch.no_grad():
        mel_img = tpipe.frontend.wav_to_mel_image(batch["wav"], config.target_mel_frames)
        noise8 = torch.randn(tpipe.latent_shape(TRAIN_BATCH), device=dev, generator=g)
        z0 = tpipe.vae.encode_to_latent(mel_img, noise8)
        text_cf, mask_cf, text_c, mask_c = tpipe.encode_text_cfg(*ids_t)
        w8 = torch.full((TRAIN_BATCH,), 3.0, device=dev)
        t_a, t_b, s_a, s_b = heun.interval(5, TRAIN_BATCH, dev)
        z_in = heun.add_noise(z0, noise8, s_a)
        teacher_fn = lambda zs, t, sigma: tpipe.query_teacher_cfg(zs, t, text_cf, mask_cf, w8)
        z_scaled = heun.scale_model_input(z_in, s_a)
        parts = {
            "frontend_ms": cuda_ms(torch, lambda: tpipe.frontend.wav_to_mel_image(
                batch["wav"], config.target_mel_frames), 3),
            "encoder_ms": cuda_ms(torch, lambda: tpipe.vae.encode_to_latent(mel_img, noise8), 2),
            "t5_ms": cuda_ms(torch, lambda: tpipe.encode_text_cfg(*ids_t), 3),
            "teacher_heun_interval_ms": cuda_ms(
                torch, lambda: heun.heun_pair(z_in, s_a, s_b, teacher_fn, t_a, t_b), 2),
            "target_ms": cuda_ms(torch, lambda: tpipe.query_unet(
                state.student_target, z_scaled, t_a, text_c, mask_c, w8), 2),
        }

    def student_forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        pred = tpipe.query_unet(state.student, z_scaled, t_a, text_c, mask_c, w8)
        loss = tstep.mse_instance(pred, z0).mean()
        loss.backward()
        return loss.detach()

    parts["student_forward_backward_ms"] = cuda_ms(torch, student_forward_backward, 2)
    update_ms = []
    for _ in range(3):
        loss = student_forward_backward()
        update_ms.append(cuda_ms(torch, lambda: (
            tstep.guarded_update(state, loss),
            ema_update(state.student_target, state.student, step_cfg.target_ema_decay),
            ema_update(state.student_ema, state.student, step_cfg.ema_decay)), 1, warmup=0))
    parts["optimizer_and_ema_ms"] = statistics.median(update_ms)
    state.optimizer.zero_grad(set_to_none=True)

    # agreement: the forward loss of a batch-2 micro-batch with given draws, on
    # the card against the same weights in fp32 on the CPU (plain versions)
    vbatch, _ = train_batch(VAL_BATCH, 40)
    cpu_gen = torch.Generator().manual_seed(6)
    draws = {"posterior_noise": torch.randn(tpipe.latent_shape(2), generator=cpu_gen),
             "eps": torch.randn(tpipe.latent_shape(2), generator=cpu_gen),
             "u": torch.tensor([3, 12]), "w": torch.tensor([0.3, 0.8])}

    def forward_loss(p, micro):
        with torch.no_grad():
            pred, target, snr = tstep.consistency_forward(
                p, heun, step_cfg, p.unets["student"], p.unets["student_target"], micro,
                draws=draws)
            inst = tstep.mse_instance(pred, target) \
                * schedulers.min_snr_weights_stage2(snr, step_cfg.snr_gamma)
        return inst.mean().item(), pred.float().cpu(), target.float().cpu()

    got_loss, got_pred, got_target = forward_loss(tpipe, vbatch)
    cpu = lambda m: copy.deepcopy(m).to("cpu", torch.float32)
    ref = Pipeline(config, {r: cpu(tpipe.unets[r]) for r in ("student", "student_target", "teacher")},
                   cpu(tpipe.vae), None, cpu(tpipe.t5), torch.device("cpu"), torch.float32)
    t0 = time.perf_counter()
    want_loss, want_pred, want_target = forward_loss(
        ref, {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in vbatch.items()})
    train_ref_s = time.perf_counter() - t0
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    median_s = statistics.median(step_s)
    emit({
        "phase": "train", "config": "PipelineConfig() light UNet + teacher, T5-large; "
        "fp32 student/target/EMA under bf16 autocast, bf16 frozen modules",
        "create_seconds": train_create_s, "micro_batch": TRAIN_BATCH,
        "heun_steps": HEUN_STEPS, "learning_rate": TRAIN_LR, "timed_steps": TRAIN_STEPS,
        "step_ms": spread(step_s), "samples_per_s": TRAIN_BATCH / median_s,
        "peak_memory_gb": peak_train_gb, "losses": losses,
        "validation": val, "validation_batch": VAL_BATCH, "validation_ms": 1e3 * validate_s,
        "launches": train_launches, "expected_launches": train_expected,
        "parts_ms": parts,
        "reference": {"loss": got_loss, "cpu_fp32_loss": want_loss, "loss_rel_err": loss_rel,
                      "tol_loss_rel_err": TOL_TRAIN_LOSS,
                      "student_rel_l2": rel(got_pred, want_pred),
                      "target_rel_l2": rel(got_target, want_target),
                      "tol_rel_l2": ref_tol, "cpu_fp32_seconds": train_ref_s},
    })
    if not loss_rel <= TOL_TRAIN_LOSS:
        fail(f"train forward loss {got_loss} differs from the fp32 CPU reference {want_loss}")
    if not max(rel(got_pred, want_pred), rel(got_target, want_target)) <= ref_tol:
        fail("train forward predictions differ from the fp32 CPU reference")
    del tpipe, state, train_step, validate, ref, batch, vbatch, mel_img, z0, noise8, text_cf, \
        text_c, z_in, z_scaled
    torch.cuda.empty_cache()

    # -- serve: the test-set CLI at full width ------------------------------------
    serve_dir = os.path.join(root, "outputs", f"chip_smoke_serve_{os.getpid()}")
    os.makedirs(serve_dir)
    try:
        serve, serve_launches, serve_ctx = serve_phase(torch, config, serve_dir, reset_counters,
                                                       read_counters, fused_levels, tok, dev)
        emit(serve)
        torch.cuda.empty_cache()
        # -- eval: the evaluation harness on the serve phase's files ------------
        evaluation, eval_launches = eval_phase(torch, serve_ctx, reset_counters, read_counters)
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    emit(evaluation)

    # -- summary ----------------------------------------------------------------
    sources = {
        "flash_mha_packed": ("consistencytta_torch/csrc/flash_attention.cu",
                             "consistencytta_tpu/ops/pallas_attention.py:362"),
        "flash_self_attention": ("consistencytta_torch/csrc/flash_attention.cu",
                                 "consistencytta_tpu/ops/pallas_attention.py:420"),
        "fused_mrf_level": ("consistencytta_torch/csrc/mrf.cu",
                            "consistencytta_tpu/ops/pallas_mrf.py:508"),
        "stft_magnitude": ("consistencytta_torch/csrc/stft.cu",
                           "consistencytta_tpu/ops/pallas_stft.py:89"),
        "stft_magnitude_n512": ("consistencytta_torch/csrc/stft.cu",
                                "consistencytta_tpu/ops/pallas_stft.py:89"),
        "dilated_conv1d": ("consistencytta_torch/csrc/dilated_conv.cu",
                           "consistencytta_tpu/ops/pallas_blockconv.py:204"),
    }
    per = {
        "stft_magnitude": f"N = 1024: times per train step at micro-batch {TRAIN_BATCH}",
        "stft_magnitude_n512": f"N = 512, the eval frontend: times per batch of {BATCH} "
                               "clips' mels (all_mels.npz)",
        "dilated_conv1d": f"times of the six (k, d) convs at batch {BATCH}, C=64, L=81936, "
                          "once each; on no path, as in the JAX package",
    }
    # K4's one counter counts both filter lengths: the train path runs only
    # N = 1024, the serve and eval paths only N = 512, so each row takes its paths'
    runs = {"generate": f"the generate run's {calls} calls",
            "train": f"the train run's {n_train_steps} steps and one validation",
            "serve": "the serve run's two CLI runs (the second evaluating)",
            "eval": "the eval run's evaluate_existing"}
    kernels = []
    for name, (src, rep) in sources.items():
        r = results[name]
        b_ms, b_by = bound(r["flops"], r["bytes"], r["peak"])
        counter = "stft_magnitude" if name.startswith("stft") else name
        paths = {"generate": launches[counter], "train": train_launches[counter],
                 "serve": serve_launches[counter], "eval": eval_launches[counter]}
        if counter == "stft_magnitude":
            paths = {k: v for k, v in paths.items()
                     if (k in ("serve", "eval")) == (name != counter)}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(paths.values()), **{f"launches_{k}": v for k, v in paths.items()},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": r["library_ms"],
            "per": per.get(name, f"times per generate call at batch {BATCH}")
            + "; launches over " + ", ".join(runs[k] for k in paths),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
