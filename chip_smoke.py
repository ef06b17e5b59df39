#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `consistencytta_torch/csrc/` (one nvcc per
source, in parallel, into `build/`), then runs thirteen phases, each printing
JSON lines:

  env      card name and power limit (nvidia-smi), torch / CUDA versions,
           kernel build seconds, and the attention, MRF, STFT, dilated-conv,
           norm and GEGLU kernels' registers, spills and shared memory;
  kernel   each kernel against its plain PyTorch version on the same inputs
           at the shapes the driven paths give it (bf16; batch 32 and 1 for
           the generate path, 16 and 8 for the train step, 4 and 2 for the
           validation step; only batch 32 enters the summed times; the
           attention kernels' batch-1 lines also give the host time of one
           launch beside the library call's), with the
           gradient of the UNet attention kernel under autocast against the
           plain version's at S = 1024, of the VAE attention kernel under
           autocast at the stage-3 batch of 2 (S = 4096), and of the MRF
           level with respect to x at C = 128 and batch 2 (each with two
           planted faults: a wrong scale and dk, dv exchanged; the slope
           0.2 and one dilation triple reversed), and with the error and
           the tolerance (both scaled by the plain output's own size), the
           same tolerance applied to planted faults (the plain version with a
           wrong scale, a dropped tile, ...), which it must reject, and
           CUDA-event times of the kernel, the plain version,
           one PyTorch library call computing the same function (SDPA for
           attention; none for the MRF level) and the bound (the larger of
           bytes over 3.35 TB/s and operations over 989 TFLOP/s). K3 also
           runs at the C = 256 and 512 levels of batch 32, which the
           generate path gives to K7 (csrc/conv_nlc.cu, one launch a conv);
           K7 runs there and at C = 512 at batch 1, against the planted
           faults of tools/mrf_cases.py (dilations reversed, a bias
           dropped, slope 0.2, a tap's row off by one). The STFT
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
           six (k, d) pairs, beside F.conv1d, with its CUDA-graph device time
           and host time a launch. The norm kernel (csrc/norm.cu) runs at
           every distinct GroupNorm (+ SiLU), LayerNorm and RMSNorm call of a
           batch-32 generate call, held to 1 bf16 ulp of its plain float32
           version, with torch's own norm on the bf16 input as its library
           call and a CUDA-graph device time. The GEGLU kernel
           (csrc/geglu.cu) runs at every (M, N) of a batch-32 generate call,
           of gen-b1 and of tango-b8, held bit for bit to its plain version
           (the four PyTorch passes it replaced) against the tanh gelu and the
           halves exchanged, with a CUDA-graph device time and no library
           call. A kernel's summed bound is the sum of
           its shapes' bounds, each shape taken alone (not one roofline of
           the summed bytes and operations, which is lower where some shapes
           are bound by bytes and others by operations);
  main     the main path: Pipeline.create at the full PipelineConfig
           (random weights from a seed, bf16) and build_generate_fn(num_steps=1)
           answering hash-tokenized prompts at batch 1 and batch 32, with the
           kernels' launch counters set to 0 just before and read just after
           (the norm kernel's too: one launch per GroupNorm, LayerNorm and
           RMSNorm module of the three stages that hold them, per call; every
           later phase holds it to the launches its module calls imply,
           NormCalls);
           the waveform's shape and finiteness; a batch-1 clip against the same
           weights run in fp32 on the CPU through the plain versions; clips/s
           and latency (median, least and largest of 10 timed calls per batch
           size), peak memory and per-stage times;
  profile  consistencytta_torch/tools/profile_stages.py on the main phase's
           pipeline: the T5, UNet, VAE-decode and vocoder stages' median
           CUDA-event ms from the stage spans of 10 back-to-back 1-NFE
           generate calls at batch 32 (CUDA-graph replays), then one
           torch.profiler trace of a whole eager 1-NFE generate call (after
           a warm-up call), read by utils.read_trace: the card's busy share of
           the call, the PROFILE_TOP kernels by summed time and the
           PROFILE_GAPS longest idle gaps with the host operation during
           each; K1, K2 and K3 must be in the trace under their launch names
           with the launches of one call, the counters must show the
           launches of the phase's calls, and the graph counters that every
           timed stage call was captured or replayed and every traced one
           eager; the norm kernel's launches and ms in the trace, one
           launch per norm module of the traced call;
  bench    consistencytta_torch/tools/bench.py's main in this process: its
           one JSON line (clips/s at 1 NFE, batch 32, bf16; vs_baseline
           against the 18-step Heun CFG teacher measured in the same run;
           host and CUDA-event ms per call; the card's name and power limit),
           re-emitted with the launch counts its calls imply;
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
  fit      the training CLI (consistencytta_torch.cli.train, in this
           process) at full width from reference-format files (a TANGO
           teacher, the AudioLDM VAE; seeded random bf16 weights) and a
           synthetic manifest of 24 training and 8 validation 10-s clips,
           with the recipe's flags (recipes/train.sh; epochs and
           accumulation cut, FIT_CUTS): stage 1 (--augment) writing `best`;
           stage 2 (Heun) seeded from that directory, writing `step_2`; a
           resume from `step_2` whose restored roles, optimizer moments and
           step must equal the files bit for bit, and which takes exactly
           one more step; stage 2 with DDIM, writing nothing, with a batch-2
           forward loss with given draws against fp32 on the CPU; stage 2
           with --use_lora, whose `best` must load as plain modules equal to
           the merged roles; the inference CLI on stage 2's `best` with its
           config replay (4 non-silent 10-s wavs). Per run: the K1, K2 and
           K4 launches against the counts the flags imply (fit_expected),
           seconds per optimizer step, the loader's host seconds per step,
           validation and checkpoint seconds, GB on disk, peak memory. At
           most two checkpoints (~13 GB each) are on disk at once, under
           outputs/, all deleted at the end;
  stage3   stage 3 through the same CLI (recipes/train.sh's stage-3 flags,
           cuts in STAGE3_CUTS) from the fit phase's stage-2 `best` as
           --stage1_model, with a CLAP checkpoint of seeded random weights at
           published widths: --loss_type clap (2 steps), with a batch-2
           forward loss with given draws against fp32 on the CPU and the
           seconds and peak memory of the parts of one micro-batch;
           --finetune_vae (2 steps, `step_2` written) and its resume, whose
           restored roles, decoder pair, EMA decoder pair and optimizer
           moments must equal the files bit for bit; one step each of
           --loss_type mel, stft and --use_lora with clap; the inference CLI
           on the FTVAE `step_2` through its EMA decoder (--use_ema). Per
           run, the K1-K4 launches against the counts the flags imply
           (fit_expected with the loss's decodes), seconds per optimizer
           step, validation and checkpoint seconds, GB, peak memory;
  ddp      data-parallel training (parallel/mesh.py) at full width, stage 2
           Heun at a global batch of DDP_WORLD x DDP_MICRO with the draws of
           one seeded generator: the single-rank step on the whole batch
           (DDP_STEPS steps), one NCCL group of world size 1 through the
           sharded step (one step), then DDP_WORLD gloo ranks sharing cuda:0
           (spawned; NCCL takes one rank a card): the sound run of DDP_STEPS
           steps and one step under each of three planted faults (rank 1
           skips the all-reduce, the mean drops its 1/N, rank 1's shard is
           updated twice). Each against the single-rank run at every
           DDP_STRIDE-th element of the flat student: the loss, the AdamW
           moments and the EMA shadow (held to TOL_DDP, a limit between the
           sound reading and the faults', which must all exceed it), the
           student's and the EMA's updates; the ranks' students equal bit
           for bit; each rank's K1, K2 and K4 launches against the counts the
           steps imply, its peak memory and the moment and EMA bytes it holds
           beside the single-rank run's. Where several cards are present,
           the training CLI with --num_devices <cards> over NCCL (2 steps);
  kernels  one line naming every kernel with its launches on each path,
           error and times (the norm kernel's launches summed over its three
           counters).

Then the nvidia-smi line, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero, and without a CUDA card the script exits 2.

Not run here: tools/orbax_to_torch.py, which converts the JAX package's
orbax checkpoints into the port's layout, needs JAX and orbax, which the
card's host does not have; tests/test_torch_orbax_convert.py holds it on
the CPU.
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
STAGE3_BATCH = 2  # the stage-3 recipe's micro-batch (recipes/train.sh)
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


NORM_COUNTERS = ("group_norm", "layer_norm", "rms_norm")  # ops/norm.py's launch counters
MRF_LEVELS = 5  # the vocoder's MRF levels (len(HiFiGANConfig().upsample_rates))
WIDE_LEVEL_LAUNCHES = 20  # K7 at a level wider than K3's: 18 convs, two layout passes
# K8's (positions, half N, launches a UNet query) at UNet levels 0, 1, 2 and
# the mid block: the light UNet's halves (1020 padded to 1024, then 2040 and
# 4080, already multiples of 8), TANGO's
GEGLU_LEVELS = ((4096, 1024, 5), (1024, 2040, 5), (256, 4080, 5), (64, 4080, 1))
GEGLU_TANGO_LEVELS = ((4096, 1280, 5), (1024, 2560, 5), (256, 5120, 5), (64, 5120, 1))


class NormCalls:
    """The norm kernel's launches that a run's module calls imply. Every
    GroupNorm, LayerNorm and RMSNorm of the port sits in one of four modules
    (T5Encoder, the UNet, the VAE Encoder and Decoder), and a call of one of
    them on CUDA tensors runs each of its norms once, one launch each.
    `install` wraps the four modules' forward (a call that replays a CUDA
    graph goes through it too, and so does a student forward recomputed in
    the backward); `implied` has the launches per counter that the calls
    since `reset` imply."""

    def __init__(self):
        self.counts = dict.fromkeys(NORM_COUNTERS, 0)
        self.held = None

    def install(self):
        import weakref

        import torch

        from consistencytta_torch.nn.layers import GroupNorm, LayerNorm
        from consistencytta_torch.nn.t5 import RMSNorm, T5Encoder
        from consistencytta_torch.nn.unet import UNet2DConditionGuided
        from consistencytta_torch.nn.vae import Decoder, Encoder

        if self.held is not None:
            return
        self.held = weakref.WeakKeyDictionary()  # module -> its norms per counter
        kinds = tuple(zip((GroupNorm, LayerNorm, RMSNorm), NORM_COUNTERS))

        def counted(forward):
            def wrapper(module, *args, **kwargs):
                first = next((a for a in (*args, *kwargs.values()) if torch.is_tensor(a)), None)
                if first is not None and first.is_cuda:
                    held = self.held.get(module)
                    if held is None:
                        held = self.held[module] = {
                            k: sum(isinstance(m, cls) for m in module.modules()) for cls, k in kinds}
                    for k, n in held.items():
                        self.counts[k] += n
                return forward(module, *args, **kwargs)
            return wrapper

        for cls in (T5Encoder, UNet2DConditionGuided, Encoder, Decoder):
            cls.forward = counted(cls.forward)

    def reset(self):
        self.counts = dict.fromkeys(NORM_COUNTERS, 0)

    def implied(self) -> dict:
        return dict(self.counts)


NORMS = NormCalls()


def mrf_launches(vocoder_calls: int, fused_levels: int) -> dict:
    """K3's and K7's launches in `vocoder_calls` vocoder calls: one at each of
    the `fused_levels` narrowest levels, WIDE_LEVEL_LAUNCHES at each wider."""
    return {"fused_mrf_level": vocoder_calls * fused_levels,
            "wide_mrf_level": vocoder_calls * (MRF_LEVELS - fused_levels) * WIDE_LEVEL_LAUNCHES}


def unet_launches(queries: int) -> dict:
    """K1's and K8's launches in `queries` UNet queries: one of each a
    transformer block, 16 a query (their backwards are the plain versions')."""
    return {"flash_mha_packed": 16 * queries, "geglu": 16 * queries}


def with_norms(expected: dict) -> dict:
    """`expected` (K1-K5) with the norm launches the module calls since the
    last reset imply (NormCalls)."""
    return {**expected, **NORMS.implied()}


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
        expected = with_norms(expected)
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
    expected = {**unet_launches(queries), "flash_self_attention": 2,
                **mrf_launches(2, fused_levels), "stft_magnitude": 1, "dilated_conv1d": 0}
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
    expected1 = {**unet_launches(SERVE_STAGE1_STEPS), "flash_self_attention": 1,
                 **mrf_launches(1, fused_levels), "stft_magnitude": 2, "dilated_conv1d": 0}
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
        expected = with_norms({**unet_launches(0), "flash_self_attention": 0,
                               **mrf_launches(0, 0), "stft_magnitude": 2 * batches,
                               "dilated_conv1d": 0})
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


FIT_TRAIN_CLIPS = 24  # synthetic 10-s training clips (the manifest's cut)
FIT_VAL_CLIPS = 8
FIT_SEED = 2  # the reference-format teacher and VAE files
# the recipe's flags (recipes/train.sh), verbatim but for the cuts listed on
# the phase's line: stage 1, then stage 2 (EDM)
FIT_STAGE1 = ["--stage", "1", "--augment", "--per_device_train_batch_size", "4",
              "--gradient_accumulation_steps", "2", "--per_device_eval_batch_size", "6",
              "--teacher_guidance_scale", "-1", "--target_ema_decay", ".95", "--ema_decay",
              ".999", "--learning_rate", "1e-4", "--adam_weight_decay", "0",
              "--num_diffusion_steps", "18", "--num_warmup_steps", "900", "--use_bf16",
              "--snr_gamma", "5"]
FIT_STAGE2 = ["--stage", "2", "--augment", "--per_device_train_batch_size", "6",
              "--gradient_accumulation_steps", "2", "--per_device_eval_batch_size", "8",
              "--teacher_guidance_scale", "-1", "--target_ema_decay", ".95", "--ema_decay",
              ".999", "--learning_rate", "1e-5", "--adam_weight_decay", "1e-4", "--use_bf16",
              "--num_diffusion_steps", "18", "--num_warmup_steps", "750", "--snr_gamma", "5",
              "--loss_type", "mse"]
FIT_CUTS = ["--num_train_epochs: --max_train_steps 2 (stage 1, stage 2), 3 (resume), 1 (DDIM, "
            "LoRA)", "--gradient_accumulation_steps 8 -> 2 (stage 1), 5 -> 2 (stage 2)",
            f"{FIT_TRAIN_CLIPS} training and {FIT_VAL_CLIPS} validation clips (synthetic)",
            "--unet_model_config omitted: PipelineConfig() is its light UNet"]


# per micro-batch, the decodes each loss type makes: (VAE decoder passes,
# vocoder passes); clap decodes the prediction to a waveform, mel both latents
# to mels, stft both to waveforms
LOSS_DECODES = {"mse": (0, 0), "clap": (1, 1), "mel": (2, 0), "stft": (2, 2)}


def fit_expected(stage, use_edm, accum, steps, val_batches, n=HEUN_STEPS, remat=True,
                 loss="mse", ftvae=False, fused_levels=3):
    """The launches a training CLI run implies. Per micro-batch: the mel
    frontend (K4) and the VAE encoder's mid-block attention (K2) once; 16 K1
    launches per UNet query: stage 1 the CFG teacher and the student; stage
    2 the teacher's interval (2 queries with Heun, 1 with DDIM), the target,
    the student, and the student again when its forward is recomputed in the
    backward (the backward itself is the plain version's); the loss's
    decodes (LOSS_DECODES): K2 once per VAE decoder pass, K3 once per fused
    vocoder level per vocoder pass (their backwards are the plain versions').
    Per validation batch: K4 and K2 once, and with FTVAE K4 and K2 again
    (the ground truth's mel and posterior mode) and K2 for the trainable
    decoder; stage 1 the teacher and the student; stage 2 the teacher over
    the whole schedule (Heun 2 (n - 1) + 1 queries, DDIM n) and the target
    twice."""
    if stage == 1:
        per_micro, per_val = 2, 2
    elif use_edm:
        per_micro, per_val = 4 + remat, 2 * (n - 1) + 1 + 2
    else:
        per_micro, per_val = 3 + remat, n + 2
    micro = steps * accum
    decoder, vocoder = LOSS_DECODES[loss]
    return {**unet_launches(micro * per_micro + val_batches * per_val),
            "flash_self_attention": micro * (1 + decoder) + val_batches * (1 + 2 * ftvae),
            **mrf_launches(micro * vocoder, fused_levels),
            "stft_magnitude": micro + val_batches * (1 + ftvae), "dilated_conv1d": 0}


def _du_gb(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path)
               for f in fs) / 1e9


class CliRuns:
    """Runs of the training CLI (consistencytta_torch.cli.train) in this
    process, each with the launch counters set to 0 before and read after:
    `run` prepares (the pipeline, the loaders, the state, a resume) and runs
    one invocation, prints its line and checks its launches against the
    expected counts and its losses for finiteness; `lines` keeps the lines
    and `totals` sums the launches."""

    def __init__(self, torch, phase, common, reset_counters, read_counters):
        self.torch, self.phase, self.common = torch, phase, common
        self.reset_counters, self.read_counters = reset_counters, read_counters
        self.lines, self.totals = [], {}

    def run(self, name, argv, expected, checked=None):
        import numpy as np

        from consistencytta_torch.cli import train

        torch = self.torch
        output_dir = argv[argv.index("--output_dir") + 1]
        summary = os.path.join(output_dir, "summary.jsonl")
        n_before = len(open(summary).readlines()) if os.path.exists(summary) else 0
        self.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = train.prepare(self.common + argv)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        extra = checked(r) if checked else {}
        # each step's seconds, the first (a fresh pipeline's) apart: the loop
        # keeps only their sum
        step_fn, each = r.step_fn, []

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            metrics = step_fn(*args, **kwargs)
            float(metrics["loss"])
            each.append(time.perf_counter() - t0)
            return metrics

        r.step_fn = timed
        t0 = time.perf_counter()
        train.run(r)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = self.read_counters()
        expected = with_norms(expected)
        with open(summary) as f:
            records = [json.loads(x) for x in f.readlines()[n_before:]]
        epochs = [x for x in records if "epoch_seconds" in x]
        steps = sum(x["steps"] for x in epochs)
        ckpts = sorted(d for d in os.listdir(output_dir)
                       if os.path.isdir(os.path.join(output_dir, d)))
        line = {
            "phase": self.phase, "run": name, "argv": " ".join(argv), "steps": steps,
            "launches": counts, "expected_launches": expected,
            "prepare_seconds": prepare_s, "run_seconds": run_s,
            "seconds_per_optimizer_step": sum(x["step_seconds"] for x in epochs) / steps,
            "step_seconds_each": each,
            "loader_seconds_per_step": sum(x["loader_seconds"] for x in epochs) / steps,
            "validation_seconds": sum(x.get("validation_seconds", 0.0) for x in epochs),
            "checkpoint_save_seconds": sum(x["checkpoint_seconds"] for x in epochs),
            "checkpoints": {d: _du_gb(os.path.join(output_dir, d)) for d in ckpts},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "losses": {k: v for k, v in epochs[-1].items() if "loss" in k},
            "resume_seconds": r.resume_seconds, **extra,
        }
        self.lines.append(line)
        emit(line)
        if counts != expected:
            fail(f"{self.phase} {name}: launch counts {counts} != expected {expected}")
        if not all(np.isfinite(v) for v in line["losses"].values()):
            fail(f"{self.phase} {name}: non-finite losses {line['losses']}")
        for k, v in counts.items():
            self.totals[k] = self.totals.get(k, 0) + v
        return r


def fit_phase(torch, config, fit_dir, reset_counters, read_counters, fused_levels):
    """The training CLI in this process at full width, from reference-format
    files (a TANGO teacher and the AudioLDM VAE of seeded random bf16
    weights) and a synthetic manifest: stage 1, stage 2 (Heun) seeded from
    stage 1's `best` directory, a resume of its `step_2` checked bit for bit,
    stage 2 with DDIM (with a forward loss against fp32 on the CPU) and with
    --use_lora, then the inference CLI on stage 2's `best`. Returns the
    phase's lines and the launch counts of its training runs and of its
    inference run."""
    import numpy as np
    from scipy.io import wavfile

    from consistencytta_torch.cli import inference, train
    from consistencytta_torch.io import checkpoints
    from consistencytta_torch.io.audio import write_wav
    from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
    from consistencytta_torch.training import lora
    from consistencytta_torch.training import step as tstep
    from consistencytta_torch.training.data import to_device

    t_phase = time.perf_counter()
    free_gb = shutil.disk_usage(fit_dir).free / 1e9
    if free_gb < 40:
        fail(f"fit: {free_gb:.1f} GB free under {fit_dir}; two checkpoints take ~26 GB")
    t0 = time.perf_counter()
    src = Pipeline.create(config, dtype=torch.bfloat16, device="cuda", seed=FIT_SEED,
                          roles=("teacher",))
    cpu_sd = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}
    tango, vae = os.path.join(fit_dir, "tango.bin"), os.path.join(fit_dir, "audioldm.ckpt")
    torch.save({"unet." + k: v for k, v in cpu_sd(src.unets["teacher"]).items()}, tango)
    torch.save({"state_dict": {**{"first_stage_model." + k: v
                                  for k, v in cpu_sd(src.vae).items()},
                               **{"first_stage_model.vocoder." + k: v
                                  for k, v in cpu_sd(src.vocoder).items()}}}, vae)
    del src
    torch.cuda.empty_cache()
    rng = np.random.default_rng(FIT_SEED)
    t = np.arange(config.segment_samples) / config.sample_rate
    manifests = {}
    for split, n in (("train", FIT_TRAIN_CLIPS), ("valid", FIT_VAL_CLIPS)):
        manifests[split] = os.path.join(fit_dir, f"{split}.jsonl")
        with open(manifests[split], "w") as f:
            for i in range(n):
                path = os.path.join(fit_dir, f"{split}_{i:02d}.wav")
                f0 = 110.0 * 2.0 ** (4.0 * rng.random())
                write_wav(path, 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(4 * np.pi * f0 * t)
                          + 0.05 * rng.standard_normal(t.size))
                cap = PROMPTS[i % len(PROMPTS)] + SERVE_PLACES[(i // len(PROMPTS)) % 4]
                f.write(json.dumps({"captions": cap, "location": path}) + "\n")
    setup_s = time.perf_counter() - t0
    common = ["--freeze_text_encoder", "--train_file", manifests["train"],
              "--validation_file", manifests["valid"], "--test_file", manifests["valid"],
              "--tango_model", tango, "--vae_checkpoint", vae, "--seed", "0"]
    out = {k: os.path.join(fit_dir, k) for k in ("stage1", "stage2", "ddim", "lora", "gen")}

    runs = CliRuns(torch, "fit", common, reset_counters, read_counters)
    lines, totals, fit_run = runs.lines, runs.totals, runs.run

    # 1. stage 1, best tracked on val_loss: 2 steps of 2 micro-batches of 4
    # (3 originals and their mixes), one validation batch of 6
    s1 = fit_run("stage1", FIT_STAGE1 + ["--max_train_steps", "2", "--checkpointing_steps",
                                         "best", "--output_dir", out["stage1"]],
                 fit_expected(1, False, 2, 2, 1))
    del s1
    torch.cuda.empty_cache()
    # 2. stage 2, Heun, seeded from stage 1's best directory; step_2 written
    s2_argv = FIT_STAGE2 + ["--tango_model", tango, "--use_edm"]
    s2 = fit_run("stage2_heun", s2_argv + [
        "--stage1_model", os.path.join(out["stage1"], "best"), "--max_train_steps", "2",
        "--checkpointing_steps", "2", "--output_dir", out["stage2"]],
                 fit_expected(2, True, 2, 2, 1))
    del s2
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(out["stage1"], "best"))

    # 3. resume from step_2: the restored state against the files, bit for
    # bit, then exactly one more step (step 3), and best written
    step2 = os.path.join(out["stage2"], "step_2")

    def check_resume(r):
        t0 = time.perf_counter()
        load = lambda f: torch.load(os.path.join(step2, f), map_location="cpu", mmap=True,
                                    weights_only=True)
        model, opt, sched = (load(f) for f in (checkpoints.MODEL_FILE,
                                               checkpoints.OPTIMIZER_FILE,
                                               checkpoints.SCHEDULER_FILE))
        unequal, n = [], 0
        for role in STUDENT_ROLES:
            for k, v in getattr(r.state, role).state_dict().items():
                n += 1
                if not torch.equal(v.cpu(), model[f"{role}_unet.{k}"]):
                    unequal.append(f"{role}.{k}")
        for i, s in r.state.optimizer.state_dict()["state"].items():
            for k, v in s.items():
                n += 1
                if not torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(opt["state"][i][k])):
                    unequal.append(f"optimizer.{i}.{k}")
        if unequal or r.state.step != 2 or sched["step"] != 2 \
                or r.state.lr_scheduler.state_dict() != sched["lr_scheduler"]:
            fail(f"fit resume: restored state differs from step_2: {unequal[:5]}, "
                 f"step {r.state.step}")
        return {"restored_tensors_equal": n, "restored_step": r.state.step,
                "resume_check_seconds": time.perf_counter() - t0}

    resumed = fit_run("stage2_resume", s2_argv + [
        "--stage1_model", step2, "--max_train_steps", "3", "--checkpointing_steps", "best",
        "--resume_from_checkpoint", step2, "--output_dir", out["stage2"]],
                      fit_expected(2, True, 2, 1, 1), check_resume)
    if resumed.state.step != 3 or lines[-1]["steps"] != 1:
        fail(f"fit resume: step {resumed.state.step} after {lines[-1]['steps']} steps")
    del resumed
    torch.cuda.empty_cache()
    shutil.rmtree(step2)
    best2 = os.path.join(out["stage2"], "best")

    # 4. stage 2, DDIM: one step and its validation, writing nothing; then a
    # batch-2 forward loss with given draws against fp32 on the CPU
    ddim_argv = FIT_STAGE2 + ["--tango_model", tango, "--stage1_model", best2,
                              "--max_train_steps", "1", "--checkpointing_steps", "none",
                              "--save_every", "1000", "--output_dir", out["ddim"]]
    r = fit_run("stage2_ddim", ddim_argv, fit_expected(2, False, 2, 1, 1))
    if os.listdir(out["ddim"]) != ["summary.jsonl"]:
        fail(f"fit ddim: wrote {os.listdir(out['ddim'])}")
    p = r.pipeline
    sched = train.schedule_from_args(r.args, config.scheduler)
    cfg = train.consistency_step_config_from_args(r.args)
    batch = next(iter(r.make_eval_loader()))
    micro = to_device({k: v[:2] for k, v in batch.items() if k != "captions"}, "cuda")
    cpu_gen = torch.Generator().manual_seed(7)
    draws = {"posterior_noise": torch.randn(p.latent_shape(2), generator=cpu_gen),
             "eps": torch.randn(p.latent_shape(2), generator=cpu_gen),
             "u": torch.tensor([3, 12]), "w": torch.tensor([0.3, 0.8])}

    def forward_loss(pipe, m):
        with torch.no_grad():
            pred, target, snr = tstep.consistency_forward(
                pipe, sched, cfg, pipe.unets["student"], pipe.unets["student_target"], m,
                draws=draws)
            inst = tstep.mse_instance(pred, target) \
                * tstep.min_snr_weights_stage2(snr, cfg.snr_gamma)
        return inst.mean().item(), pred.float().cpu(), target.float().cpu()

    got = forward_loss(p, micro)
    cpu = lambda m: copy.deepcopy(m).to("cpu", torch.float32)
    ref = Pipeline(config, {k: cpu(p.unets[k]) for k in ("student", "student_target", "teacher")},
                   cpu(p.vae), None, cpu(p.t5), torch.device("cpu"), torch.float32)
    t0 = time.perf_counter()
    want = forward_loss(ref, {k: v.cpu() for k, v in micro.items()})
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    reference = {"loss": got[0], "cpu_fp32_loss": want[0],
                 "loss_rel_err": abs(got[0] - want[0]) / abs(want[0]),
                 "tol_loss_rel_err": TOL_TRAIN_LOSS, "student_rel_l2": rel(got[1], want[1]),
                 "target_rel_l2": rel(got[2], want[2]), "tol_rel_l2": 0.1,
                 "cpu_fp32_seconds": time.perf_counter() - t0}
    lines[-1]["reference"] = reference
    emit({"phase": "fit", "run": "stage2_ddim", "reference": reference})
    if not reference["loss_rel_err"] <= TOL_TRAIN_LOSS \
            or not max(reference["student_rel_l2"], reference["target_rel_l2"]) <= 0.1:
        fail(f"fit ddim: the forward on the card differs from fp32 on the CPU: {reference}")
    del r, p, ref, micro, batch
    torch.cuda.empty_cache()

    # 5. stage 2 with --use_lora: one step; its best holds the merged roles,
    # which load as plain modules
    r = fit_run("stage2_lora", FIT_STAGE2 + [
        "--tango_model", tango, "--use_edm", "--use_lora", "--stage1_model", best2,
        "--max_train_steps", "1", "--checkpointing_steps", "best", "--output_dir", out["lora"]],
                fit_expected(2, True, 2, 1, 1))
    gen = Pipeline.create(config, dtype=torch.bfloat16, device="cuda", seed=5)
    t0 = time.perf_counter()
    loaded = checkpoints.load_frozen_and_roles(gen, model_path=os.path.join(out["lora"], "best"),
                                               vae_checkpoint=vae)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    unequal = []
    for role in STUDENT_ROLES:
        want = lora.merged_state_dict(r.state.lora_base, getattr(r.state, role))
        got = gen.unets[role].state_dict()
        unequal += [f"{role}.{k}" for k, v in want.items()
                    if not torch.equal(got[k], v.to(got[k].dtype))]
    if unequal or not {"t5", *STUDENT_ROLES} <= set(loaded):
        fail(f"fit lora: loaded {sorted(loaded)}; unequal to the merged roles: {unequal[:5]}")
    lines[-1].update(lora_factors=lora.lora_param_count(r.state.student),
                     lora_load_seconds=load_s)
    del r, gen
    torch.cuda.empty_cache()

    # 6. the inference CLI on stage 2's best with its config replay, 4 rows
    # in one batch: one student query, one decode, the batch's eval mels
    test = os.path.join(fit_dir, "test.jsonl")
    with open(manifests["valid"]) as f, open(test, "w") as g:
        g.writelines(f.readlines()[:4])
    line, infer_counts = inference_run(torch, "fit", best2, os.path.join(out["stage2"],
                                       "summary.jsonl"), vae, test, out["gen"], fused_levels,
                                       reset_counters, read_counters)
    lines.append(line)
    summary = {"phase": "fit", "config": "PipelineConfig() light UNet + teacher, T5-large, "
               "bf16 frozen / fp32 trained; reference-format TANGO teacher and AudioLDM VAE "
               "of seeded random weights; hash tokenizer", "cuts": FIT_CUTS,
               "setup_seconds": setup_s, "disk_free_gb": free_gb,
               "phase_seconds": time.perf_counter() - t_phase, "launches_training_runs": totals,
               "launches_inference": infer_counts}
    emit(summary)
    ctx = {"common": common, "tango": tango, "vae": vae, "stage2_best": best2,
           "train": manifests["train"], "valid": manifests["valid"], "test": test}
    return lines, totals, infer_counts, ctx


def inference_run(torch, phase, model, replay, vae, test, out_dir, fused_levels,
                  reset_counters, read_counters):
    """The inference CLI (`--use_edm --use_ema`, the run's config replay) on
    a checkpoint, 4 rows in one batch: one student query (16 K1 launches),
    one decode (K2 once, K3 once per fused level), the batch's eval mels (K4
    at N = 512 once); 4 non-silent 10-s wavs. Returns its line and its
    launches."""
    import numpy as np
    from scipy.io import wavfile

    from consistencytta_torch.cli import inference

    reset_counters()
    t0 = time.perf_counter()
    res = inference.main(["--model", model, "--original_args", replay, "--use_edm",
                          "--use_ema", "--vae_checkpoint", vae, "--test_file", test,
                          "--batch_size", "4", "--skip_eval", "--output_dir", out_dir])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    counts = read_counters()
    expected = with_norms({**unet_launches(1), "flash_self_attention": 1,
                           **mrf_launches(1, fused_levels), "stft_magnitude": 1,
                           "dilated_conv1d": 0})
    wavs = sorted(n for n in os.listdir(out_dir) if n.endswith(".wav"))
    for n in wavs:
        sr, data = wavfile.read(os.path.join(out_dir, n))
        if sr != 16000 or data.shape != (160000,) or not np.abs(data).max() > 0:
            fail(f"{phase} inference: {n}: {sr} Hz, {data.shape}, peak {np.abs(data).max()}")
    line = {"phase": phase, "run": "inference", "rows": res["num_clips"], "wavs": len(wavs),
            "wall_seconds": infer_s, "launches": counts, "expected_launches": expected,
            **{k: v for k, v in res.items() if k.endswith("seconds")}}
    emit(line)
    if counts != expected or len(wavs) != 4:
        fail(f"{phase} inference: {len(wavs)} wavs, launch counts {counts} != {expected}")
    return line, counts


STAGE3_VAL_CLIPS = 2
# the stage-3 recipe's flags (recipes/train.sh), verbatim but for the cuts
# listed on the phase's line
STAGE3 = ["--stage", "2", "--augment", "--per_device_train_batch_size", str(STAGE3_BATCH),
          "--gradient_accumulation_steps", "2", "--per_device_eval_batch_size", "2",
          "--teacher_guidance_scale", "-1", "--target_ema_decay", ".95", "--ema_decay", ".999",
          "--learning_rate", "1e-6", "--adam_weight_decay", "1e-4", "--use_edm", "--use_bf16",
          "--checkpointing_steps", "best", "--num_diffusion_steps", "18",
          "--num_warmup_steps", "250", "--snr_gamma", "5"]
STAGE3_CUTS = ["--num_train_epochs: --max_train_steps 2 (clap, FTVAE), 3 (the FTVAE resume), "
               "1 (mel, stft, LoRA)", "--gradient_accumulation_steps 15 -> 2",
               f"validation: {STAGE3_VAL_CLIPS} clips, one batch of 2",
               f"{FIT_TRAIN_CLIPS} training clips (synthetic, the fit phase's)",
               "--unet_model_config omitted: PipelineConfig() is its light UNet",
               "CLAP towers: seeded random weights at published widths (HTSAT-base, "
               "RoBERTa-base), hash CLAP tokenizer",
               "checkpoint written: FTVAE's step_2 only"]
TOL_STAGE3_LOSS = 0.05  # card (bf16, kernels) against CPU fp32, relative


def stage3_phase(torch, config, ctx, stage3_dir, reset_counters, read_counters, fused_levels):
    """Stage 3 through the training CLI in this process at full width, from
    the fit phase's stage-2 `best` as --stage1_model (recipes/train.sh) and
    its TANGO and VAE files, with seeded random CLAP towers at published
    widths: --loss_type clap (2 steps), with a card-vs-CPU forward loss at
    batch 2 and the parts of one micro-batch;
    --finetune_vae (2 steps, `step_2`) and its resume, checked bit for bit
    with the decoder pair and its EMA, for one step; one step each of
    --loss_type mel and stft and of --use_lora with clap; the inference CLI
    on the FTVAE `step_2` through its EMA decoder. Returns the phase's lines,
    the launches of its training runs and of its inference run."""
    import numpy as np

    from consistencytta_torch.cli import train
    from consistencytta_torch.evaluation.clap_model import load_clap_towers
    from consistencytta_torch.io import checkpoints
    from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
    from consistencytta_torch.tools.random_eval_checkpoints import write_eval_checkpoints
    from consistencytta_torch.training import step as tstep
    from consistencytta_torch.training.clap_loss import build_clap_loss
    from consistencytta_torch.training.data import to_device

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    clap = write_eval_checkpoints(stage3_dir, EVAL_SEED, which=("clap",))["clap"]
    valid = os.path.join(stage3_dir, "valid.jsonl")
    with open(ctx["valid"]) as f, open(valid, "w") as g:
        g.writelines(f.readlines()[:STAGE3_VAL_CLIPS])
    setup_s = time.perf_counter() - t0
    common = [a if a != ctx["valid"] else valid for a in ctx["common"]]
    runs = CliRuns(torch, "stage3", common, reset_counters, read_counters)
    out = {k: os.path.join(stage3_dir, k) for k in ("clap", "ftvae", "mel", "stft", "lora", "gen")}
    base = STAGE3 + ["--stage1_model", ctx["stage2_best"], "--clap_checkpoint", clap]
    once = ["--max_train_steps", "1", "--checkpointing_steps", "none", "--save_every", "1000"]
    expect = lambda steps, **kw: fit_expected(2, True, 2, steps, 1, fused_levels=fused_levels,
                                              **kw)

    # 1. --loss_type clap: 2 steps, writing nothing (FTVAE's step_2 measures a
    # stage-3 checkpoint); a batch-2 forward loss with given draws against
    # fp32 on the CPU; the time and peak memory of the parts of one micro-batch
    r = runs.run("clap", base + ["--loss_type", "clap", "--max_train_steps", "2",
                                 "--checkpointing_steps", "none", "--save_every", "1000",
                                 "--output_dir", out["clap"]], expect(2, loss="clap"))
    p = r.pipeline
    sched = train.schedule_from_args(r.args, config.scheduler)
    cfg = train.consistency_step_config_from_args(r.args)
    batch = next(iter(r.make_eval_loader()))
    micro = to_device({k: v[:2] for k, v in batch.items() if k != "captions"}, "cuda")
    cpu_gen = torch.Generator().manual_seed(8)
    draws = {"posterior_noise": torch.randn(p.latent_shape(2), generator=cpu_gen),
             "eps": torch.randn(p.latent_shape(2), generator=cpu_gen),
             "u": torch.tensor([3, 12]), "w": torch.tensor([0.3, 0.8])}

    def forward_loss(pipe, loss_fn, m):
        with torch.no_grad():
            pred, target, snr = tstep.consistency_forward(
                pipe, sched, cfg, pipe.unets["student"], pipe.unets["student_target"], m,
                draws=draws)
            inst = loss_fn(pred, target, m) * tstep.min_snr_weights_stage2(snr, cfg.snr_gamma)
        return inst.mean().item(), pred.float().cpu(), target.float().cpu()

    clap_loss = build_clap_loss(p, *load_clap_towers(clap, "cuda"))
    got = forward_loss(p, clap_loss, micro)

    # the parts of one micro-batch of the step, as the CLI's step runs it
    # (the student's forward recomputed in its backward), timed apart:
    # the forward (teacher interval, target, student), the loss's forward
    # (decode, HTSAT on the prediction and the ground truth, RoBERTa), the
    # backward of the decode chain and HTSAT alone (from a detached
    # prediction), the whole backward; peak memory after each
    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out_ = fn()
        torch.cuda.synchronize()
        return out_, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30

    r.state.optimizer.zero_grad(set_to_none=True)
    student = tstep.role_unet(r.state, r.state.student)
    target_net = tstep.role_unet(r.state, r.state.student_target)
    (pred, target, snr), fwd_s, fwd_gb = timed(lambda: tstep.consistency_forward(
        p, sched, cfg, student, target_net, micro, draws=draws))
    leaf = pred.detach().requires_grad_()
    inst, loss_fwd_s, loss_fwd_gb = timed(lambda: clap_loss(leaf, target, micro))
    _, chain_bwd_s, chain_bwd_gb = timed(lambda: inst.mean().backward())
    inst = clap_loss(pred, target, micro) * tstep.min_snr_weights_stage2(snr, cfg.snr_gamma)
    _, bwd_s, bwd_gb = timed(lambda: inst.mean().backward())
    r.state.optimizer.zero_grad(set_to_none=True)
    parts = {"forward_seconds": fwd_s, "forward_peak_gb": fwd_gb,
             "loss_forward_seconds": loss_fwd_s, "loss_forward_peak_gb": loss_fwd_gb,
             "decode_and_htsat_backward_seconds": chain_bwd_s,
             "decode_and_htsat_backward_peak_gb": chain_bwd_gb,
             "whole_backward_seconds": bwd_s, "whole_backward_peak_gb": bwd_gb}
    del pred, target, snr, leaf, inst, student, target_net

    cpu = lambda m: copy.deepcopy(m).to("cpu", torch.float32)
    ref = Pipeline(config, {k: cpu(p.unets[k]) for k in ("student", "student_target", "teacher")},
                   cpu(p.vae), cpu(p.vocoder), cpu(p.t5), torch.device("cpu"), torch.float32)
    t0 = time.perf_counter()
    want = forward_loss(ref, build_clap_loss(ref, *load_clap_towers(clap, "cpu")),
                        {k: v.cpu() for k, v in micro.items()})
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    reference = {"loss": got[0], "cpu_fp32_loss": want[0],
                 "loss_rel_err": abs(got[0] - want[0]) / abs(want[0]),
                 "tol_loss_rel_err": TOL_STAGE3_LOSS, "student_rel_l2": rel(got[1], want[1]),
                 "target_rel_l2": rel(got[2], want[2]), "tol_rel_l2": 0.1,
                 "cpu_fp32_seconds": time.perf_counter() - t0}
    runs.lines[-1].update(reference=reference, parts=parts)
    emit({"phase": "stage3", "run": "clap", "reference": reference, "parts": parts})
    if not reference["loss_rel_err"] <= TOL_STAGE3_LOSS \
            or not max(reference["student_rel_l2"], reference["target_rel_l2"]) <= 0.1:
        fail(f"stage3 clap: the forward on the card differs from fp32 on the CPU: {reference}")
    del r, p, ref, micro, batch, clap_loss
    torch.cuda.empty_cache()

    # 2. --finetune_vae: 2 steps, step_2 written; the decoder pair trained in
    # float32 with float32 gradients; its resume checked bit for bit
    ftvae_argv = base + ["--loss_type", "clap", "--finetune_vae"]
    r = runs.run("ftvae", ftvae_argv + ["--max_train_steps", "2", "--checkpointing_steps", "2",
                                        "--output_dir", out["ftvae"]],
                 expect(2, loss="clap", ftvae=True))
    dec = r.state.vae_dec
    if any(q.dtype != torch.float32 for q in dec.parameters()) \
            or any(q.data_ptr() == v.data_ptr() for q in dec.parameters()
                   for v in r.pipeline.vae.parameters()):
        fail("stage3 ftvae: the trainable decoder is not a float32 copy of its own")
    del r, dec
    torch.cuda.empty_cache()
    step2 = os.path.join(out["ftvae"], "step_2")

    def check_resume(r):
        t0 = time.perf_counter()
        load = lambda f: torch.load(os.path.join(step2, f), map_location="cpu", mmap=True,
                                    weights_only=True)
        model, opt = load(checkpoints.MODEL_FILE), load(checkpoints.OPTIMIZER_FILE)
        trained, ema = checkpoints.extract_ftvae_decoders(model)
        saved = {**{f"{role}.{k}": model[f"{role}_unet.{k}"] for role in STUDENT_ROLES
                    for k in getattr(r.state, role).state_dict()},
                 **{f"vae_dec.{k}": v for k, v in trained.items()},
                 **{f"vae_dec_ema.{k}": v for k, v in ema.items()}}
        held = {f"{role}.{k}": v for role in (*STUDENT_ROLES, "vae_dec", "vae_dec_ema")
                for k, v in getattr(r.state, role).state_dict().items()}
        unequal = [k for k, v in held.items() if k not in saved
                   or not torch.equal(v.cpu(), saved[k])]
        n = len(held)
        for i, st in r.state.optimizer.state_dict()["state"].items():
            for k, v in st.items():
                n += 1
                if not torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(opt["state"][i][k])):
                    unequal.append(f"optimizer.{i}.{k}")
        if unequal or r.state.step != 2 or len(held) != len(saved):
            fail(f"stage3 ftvae resume: restored state differs from step_2: {unequal[:5]}, "
                 f"step {r.state.step}, {len(held)} held, {len(saved)} saved")
        return {"restored_tensors_equal": n, "restored_step": r.state.step,
                "resume_check_seconds": time.perf_counter() - t0}

    r = runs.run("ftvae_resume", ftvae_argv + [
        "--max_train_steps", "3", "--checkpointing_steps", "none", "--save_every", "1000",
        "--resume_from_checkpoint", step2, "--output_dir", out["ftvae"]],
                 expect(1, loss="clap", ftvae=True), check_resume)
    if r.state.step != 3 or runs.lines[-1]["steps"] != 1:
        fail(f"stage3 ftvae resume: step {r.state.step} after {runs.lines[-1]['steps']} steps")
    del r
    torch.cuda.empty_cache()

    # 3. one step each of the mel and STFT losses, and of LoRA with clap
    for name, argv, kw in (("mel", ["--loss_type", "mel"], {"loss": "mel"}),
                           ("stft", ["--loss_type", "stft"], {"loss": "stft"}),
                           ("lora", ["--loss_type", "clap", "--use_lora"], {"loss": "clap"})):
        runs.run(name, base + argv + once + ["--output_dir", out[name]], expect(1, **kw))
        torch.cuda.empty_cache()

    # 4. the inference CLI on the FTVAE step_2 through its EMA decoder
    line, infer_counts = inference_run(torch, "stage3", step2,
                                       os.path.join(out["ftvae"], "summary.jsonl"), ctx["vae"],
                                       ctx["test"], out["gen"], fused_levels, reset_counters,
                                       read_counters)
    gen = Pipeline.create(config, dtype=torch.bfloat16, device="cuda", seed=5)
    loaded = checkpoints.load_frozen_and_roles(gen, model_path=step2, vae_checkpoint=ctx["vae"])
    if not {"vae decoder", "vae_ema"} <= set(loaded):
        fail(f"stage3 inference: the FTVAE checkpoint gave {sorted(loaded)}")
    del gen
    runs.lines.append(line)
    summary = {"phase": "stage3", "config": "PipelineConfig() light UNet + teacher, T5-large, "
               "bf16 frozen / fp32 trained; the fit phase's stage-2 best as --stage1_model; "
               "CLAP HTSAT-base + RoBERTa-base of seeded random weights (fp32)",
               "cuts": STAGE3_CUTS, "setup_seconds": setup_s,
               "phase_seconds": time.perf_counter() - t_phase,
               "launches_training_runs": runs.totals, "launches_inference": infer_counts}
    emit(summary)
    return runs.lines, runs.totals, infer_counts


DDP_WORLD = 2  # gloo ranks sharing cuda:0 (NCCL takes one rank a card)
DDP_MICRO = 2  # rows a rank takes of each global batch
DDP_STEPS = 3  # optimizer steps of the sound run; each planted fault takes one
DDP_STRIDE = 1009  # compared positions: every 1009th element of the flat student
DDP_SEED = 11  # the draws' generator, seeded alike in every process
# limits between the sound 2-rank reading and the planted faults' (the
# ddp phase's line prints every reading beside them)
TOL_DDP = {"loss_rel_err": 0.02, "exp_avg_rel_l2": 0.1, "exp_avg_sq_rel_l2": 0.1}
DDP_FAULTS = ("rank1_skips_all_reduce", "mean_drops_1_over_n", "rank1_shard_updated_twice")
DDP_ROLES = ("student", "student_target", "student_ema", "teacher")


def ddp_batch(torch, config, n, seed, dev):
    """A global batch of n seeded synthetic 10-s clips (a tone and noise) with
    hash-tokenized prompts, on `dev`: the same in every process."""
    from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond

    g = torch.Generator(device=dev).manual_seed(2000 + seed)
    t = torch.arange(config.segment_samples, device=dev) / config.sample_rate
    f0 = 110.0 * 2.0 ** (4.0 * torch.rand(n, 1, device=dev, generator=g))
    wav = 0.3 * torch.sin(2 * torch.pi * f0 * t) \
        + 0.05 * torch.randn(n, t.numel(), device=dev, generator=g)
    prompts = [PROMPTS[(seed + i) % len(PROMPTS)] for i in range(n)]
    ids, mask, uids, umask = tokenize_with_uncond(
        HashTokenizer(vocab_size=config.t5.vocab_size), prompts, TEXT_LEN)
    return {"wav": wav, "ids": ids, "mask": mask, "uncond_ids": uids, "uncond_mask": umask}


class DdpRun:
    """One process's stage-2 training set-up for the ddp phase: `config`
    (bf16 frozen modules, fp32 trained roles) from seed 0,
    an 18-step Heun schedule, a constant learning rate; `fresh` resets the
    roles to their initial weights and gives a new state."""

    def __init__(self, torch, config, dev):
        from consistencytta_torch.models.pipeline import Pipeline
        from consistencytta_torch.ops import schedulers
        from consistencytta_torch.training import step as tstep

        self.torch, self.config, self.dev, self.tstep = torch, config, dev, tstep
        self.pipe = Pipeline.create(self.config, dtype=torch.bfloat16, device=dev, seed=0,
                                    roles=DDP_ROLES, training=True)
        self.init = {k: v.clone() for k, v in self.pipe.unets["student"].state_dict().items()}
        heun = schedulers.make_heun_schedule(self.config.scheduler, HEUN_STEPS)
        self.step_fn = tstep.build_consistency_train_step(self.pipe, heun,
                                                          tstep.ConsistencyStepConfig())

    def fresh(self):
        from consistencytta_torch.training.optim import OptimizerConfig

        for role in ("student", "student_target", "student_ema"):
            m = self.pipe.unets[role]
            if any(p.is_meta for p in m.parameters()):  # a sharded shadow's skeleton
                m.to_empty(device=self.dev)
            m.load_state_dict(self.init)
        return self.tstep.TrainState.create(
            self.pipe, OptimizerConfig(learning_rate=TRAIN_LR, lr_scheduler_type="constant"))

    def batch(self, i):
        return ddp_batch(self.torch, self.config, DDP_WORLD * DDP_MICRO, i, self.dev)


def ddp_checksum(torch, module) -> int:
    """A bit-exact checksum of a module's parameters (their int32 words)."""
    return int(sum(p.detach().reshape(-1).view(torch.int32).long().sum().item()
                   for p in module.parameters()))


def ddp_samples(torch, state, lo=0, hi=None):
    """The compared values: the student at every DDP_STRIDE-th position of
    its flat parameters and, at those of the positions within [lo, hi), the
    AdamW moments and the EMA shadow (a ZeRO-1 rank holds exactly them)."""
    params = list(state.student.parameters())
    cat = lambda ts: torch.cat([t.detach().reshape(-1) for t in ts])
    hi = sum(p.numel() for p in params) if hi is None else hi
    start = -(-lo // DDP_STRIDE) * DDP_STRIDE  # the first compared position in range
    opt = state.optimizer
    if getattr(state, "zero1", None) is not None:  # the rank's range [lo, hi) only
        keys, shadow, offset = opt.param_groups[0]["params"], state.student_ema.pieces, lo
    else:
        keys, shadow, offset = params, list(state.student_ema.parameters()), 0
    pick = lambda flat: flat[start - offset:hi - offset:DDP_STRIDE].float().cpu()
    out = {k: pick(cat([opt.state[p][k] for p in keys])) for k in ("exp_avg", "exp_avg_sq")}
    out["ema"] = pick(cat(shadow))
    out["positions"] = torch.arange(start, hi, DDP_STRIDE)
    out["student"] = cat(params)[::DDP_STRIDE].float().cpu()
    return out


def ddp_before(torch, state):
    """The student and EMA samples of a state before its first update."""
    cat = lambda m: torch.cat([p.detach().reshape(-1) for p in m.parameters()])
    return {"student": cat(state.student)[::DDP_STRIDE].float().cpu(),
            "ema": cat(state.student_ema)[::DDP_STRIDE].float().cpu()}


def _ddp_plant(fault, mesh, state, pm):
    """Plant a fault into this rank's sharded step; returns its undo."""
    original = pm.all_reduce_mean
    if fault == "rank1_skips_all_reduce":
        def reduce(tensors, m):  # rank 1 takes part, and keeps its own values
            original([t.clone() for t in tensors] if m.rank == 1 else tensors, m)
        pm.all_reduce_mean = reduce
    elif fault == "mean_drops_1_over_n":
        def reduce(tensors, m):
            original(tensors, m)
            for t in tensors:
                t.mul_(m.world)
        pm.all_reduce_mean = reduce
    elif fault == "rank1_shard_updated_twice" and mesh.rank == 1:
        once = state.optimizer.step
        state.optimizer.step = lambda *a, **k: (once(), once())[1]

    def undo():
        pm.all_reduce_mean = original
    return undo


def ddp_rank(mesh, config, out_pattern):
    """One gloo rank of the ddp phase (spawned; cuda:0 shared): the sound
    run of DDP_STEPS sharded steps, then one step under each planted fault,
    each from the initial weights; writes its readings to
    out_pattern % rank."""
    import torch

    from consistencytta_torch.ops import attention as att, mrf, norm, stft, dilated_conv as dconv
    from consistencytta_torch.ops import geglu
    from consistencytta_torch.parallel import mesh as pm

    counters = {"flash_mha_packed": att.flash_mha_packed, "geglu": geglu.geglu,
                "flash_self_attention": att.flash_self_attention,
                "fused_mrf_level": mrf.fused_mrf_level, "wide_mrf_level": mrf.wide_mrf_level,
                "stft_magnitude": stft.stft_magnitude_cuda,
                "dilated_conv1d": dconv.dilated_conv1d,
                **{k: getattr(norm, k) for k in NORM_COUNTERS}}
    NORMS.install()
    t0 = time.perf_counter()
    run = DdpRun(torch, config, mesh.device)
    torch.cuda.synchronize()
    out = {"create_seconds": time.perf_counter() - t0,
           "initial_checksum": ddp_checksum(torch, run.pipe.unets["student"])}
    for fault in ("sound", *DDP_FAULTS):
        state = run.fresh()
        pm.shard_train_state(state, mesh)
        undo = _ddp_plant(fault, mesh, state, pm)
        step = pm.sharded_step(run.step_fn, mesh)
        gen = torch.Generator(device=mesh.device).manual_seed(DDP_SEED)
        for fn in counters.values():
            fn.launches = 0
        NORMS.reset()
        torch.cuda.reset_peak_memory_stats()
        losses, seconds = [], []
        for i in range(DDP_STEPS if fault == "sound" else 1):
            batch = run.batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch, generator=gen)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
        undo()
        out[fault] = {"losses": losses, "step_seconds": seconds,
                      "launches": {k: fn.launches for k, fn in counters.items()},
                      "norm_implied": NORMS.implied(),
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "held_bytes": pm.held_bytes(state),
                      "checksum": ddp_checksum(torch, state.student),
                      **ddp_samples(torch, state, *state.zero1.bounds[mesh.rank])}
        del state, step
    torch.save(out, out_pattern % mesh.rank)


def _rel(torch, got, want) -> float:
    return float((got - want).norm() / want.norm())


def ddp_readings(torch, got, ref, ref_before):
    """The compared readings of one run against the single-rank reference."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    readings = {"loss_rel_err": loss}
    for k in ("exp_avg", "exp_avg_sq"):
        readings[f"{k}_rel_l2"] = _rel(torch, got[k], ref[k])
    update = lambda s: s["student"] - ref_before["student"]
    readings["student_update_rel_l2"] = _rel(torch, update(got), update(ref))
    readings["ema_update_rel_l2"] = _rel(torch, got["ema"] - ref_before["ema"],
                                         ref["ema"] - ref_before["ema"])
    readings["over_limit"] = [k for k, tol in TOL_DDP.items() if not readings[k] <= tol]
    return readings


def ddp_phase(torch, config, dev, out_dir):
    """The ddp phase: the single-rank reference, one NCCL group of world
    size 1 through the sharded step, two gloo ranks on cuda:0 with the sound
    run and three planted faults, and where several cards are present the
    training CLI over NCCL on all of them. Returns the phase's line and the
    launches of the two ranks' sound run, per kernel."""
    import torch.distributed as dist

    from consistencytta_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    run = DdpRun(torch, config, dev)
    initial = ddp_checksum(torch, run.pipe.unets["student"])

    # the single-rank step on the whole global batch, the same draws
    state = run.fresh()
    gen = torch.Generator(device=dev).manual_seed(DDP_SEED)
    torch.cuda.reset_peak_memory_stats()
    before, ref, losses, seconds = None, {}, [], []
    for i in range(DDP_STEPS):
        batch = run.batch(i)
        if before is None:
            before = ddp_before(torch, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run.step_fn(state, batch, generator=gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        if i in (0, DDP_STEPS - 1):
            ref[i + 1] = {**ddp_samples(torch, state), "losses": list(losses)}
    single = {"step_seconds": seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
              "held_bytes": pm.held_bytes(state), "losses": losses}
    del state

    # one NCCL group of world size 1 through the sharded step
    mesh = pm.make_mesh(0, 1, f"tcp://localhost:{pm.free_port()}", [dev])
    try:
        state = pm.shard_train_state(run.fresh(), mesh)
        gen = torch.Generator(device=dev).manual_seed(DDP_SEED)
        metrics = pm.sharded_step(run.step_fn, mesh)(state, run.batch(0), generator=gen)
        got = {**ddp_samples(torch, state), "losses": [metrics["loss"].item()]}
        nccl = ddp_readings(torch, got, ref[1], before)
        nccl["exact"] = all(torch.equal(got[k], ref[1][k])
                            for k in ("student", "exp_avg", "exp_avg_sq", "ema"))
        del state
    finally:
        dist.destroy_process_group()
    del run
    torch.cuda.empty_cache()

    # two gloo ranks sharing the card
    pattern = os.path.join(out_dir, "ddp_rank%d.pt")
    t0 = time.perf_counter()
    pm.spawn(ddp_rank, DDP_WORLD, [dev] * DDP_WORLD, backend="gloo", args=(config, pattern))
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(pattern % r, weights_only=False) for r in range(DDP_WORLD)]
    if any(r["initial_checksum"] != initial for r in ranks):
        fail("ddp: the ranks' initial students differ from the reference's")
    merged = {}
    for fault in ("sound", *DDP_FAULTS):
        recs = [r[fault] for r in ranks]
        got = {k: torch.cat([r[k] for r in recs]) for k in ("exp_avg", "exp_avg_sq", "ema")}
        got.update(student=recs[0]["student"], losses=recs[0]["losses"])
        readings = ddp_readings(torch, got, ref[DDP_STEPS if fault == "sound" else 1], before)
        readings["replicas_equal"] = len({r["checksum"] for r in recs}) == 1
        every = torch.arange(0, recs[0]["student"].numel() * DDP_STRIDE, DDP_STRIDE)
        readings["positions_cover"] = bool(torch.equal(
            torch.cat([r["positions"] for r in recs]), every))
        merged[fault] = readings
    sound = merged["sound"]
    expected = {**unet_launches(4 * DDP_STEPS), "flash_self_attention": DDP_STEPS,
                **mrf_launches(0, 0), "stft_magnitude": DDP_STEPS, "dilated_conv1d": 0}
    per_rank = [{"launches": r["sound"]["launches"],
                 "expected_launches": {**expected, **r["sound"]["norm_implied"]},
                 "peak_memory_gb": r["sound"]["peak_memory_gb"],
                 "held_bytes": r["sound"]["held_bytes"],
                 "step_seconds": r["sound"]["step_seconds"],
                 "create_seconds": r["create_seconds"]} for r in ranks]

    cli = ddp_cli(torch, out_dir, torch.cuda.device_count())
    line = {
        "phase": "ddp", "config": "PipelineConfig() light UNet + teacher, T5-large; fp32 "
        "trained roles under bf16 autocast, bf16 frozen modules; stage 2 Heun, MSE, constant "
        f"lr {TRAIN_LR}; global batch {DDP_WORLD} x {DDP_MICRO}",
        "world": DDP_WORLD, "backend": "gloo, ranks sharing cuda:0", "steps": DDP_STEPS,
        "compared_every": DDP_STRIDE, "limits": TOL_DDP,
        "single_rank": single, "nccl_world_1": nccl, "sound": sound,
        "faults": {f: merged[f] for f in DDP_FAULTS}, "ranks": per_rank, "cli_nccl": cli,
        "spawn_seconds": spawn_s, "phase_seconds": time.perf_counter() - t_phase,
    }
    emit(line)
    if sound["over_limit"] or not sound["replicas_equal"] or not sound["positions_cover"]:
        fail(f"ddp: the two ranks differ from the single-rank run: {sound}")
    if nccl["over_limit"]:
        fail(f"ddp: the NCCL group of world size 1 differs from the single-rank run: {nccl}")
    missed = [f for f in DDP_FAULTS if not merged[f]["over_limit"]]
    if missed:
        fail(f"ddp: the limits pass the planted faults {missed}")
    for r, rec in enumerate(per_rank):
        if rec["launches"] != rec["expected_launches"]:
            fail(f"ddp rank {r}: launch counts {rec['launches']} != expected "
                 f"{rec['expected_launches']}")
    return line, {k: sum(r["launches"][k] for r in per_rank) for k in per_rank[0]["launches"]}


def ddp_cli(torch, out_dir, cards):
    """The training CLI with --num_devices <cards> over NCCL at full width
    (tools/ddp_scaling.py, two steps) where several cards are present; else
    the record that it was not run."""
    if cards < 2:
        return {"run": False, "reason": f"{cards} card present: N > 1 over NCCL not run"}
    from consistencytta_torch.tools.ddp_scaling import cli_run

    try:
        return {"run": True, **cli_run(os.path.join(out_dir, "cli"), cards)}
    except RuntimeError as e:
        fail(f"ddp: the CLI over NCCL on {cards} cards: {e}")


PROFILE_TOP = 15  # kernels by summed time in the profile phase's line
PROFILE_GAPS = 5  # longest idle gaps of the traced generate call


def profile_phase(torch, pipe, fused_levels, norm_per_call, reset_counters, read_counters,
                  trace_dir):
    """tools/profile_stages.py on the main phase's pipeline: the four stages'
    median CUDA-event ms from the stage spans of back-to-back 1-NFE generate
    calls, which replay the stages' CUDA graphs, then one traced 1-NFE
    generate call at batch 32 (after a warm-up call), both eager, read by
    utils.read_trace: the card's busy share, the top kernels, the longest
    idle gaps. K1-K3 and K7 must be in the trace with the launches one call makes,
    the counters must show the launches the phase's calls imply (a replay
    counts what it launched), and the graph counters that every timed call
    of a stage was a capture or a replay and every traced one eager;
    `norm_per_call`: the norm kernel's launches a generate call makes."""
    from consistencytta_torch.ops import norm
    from consistencytta_torch.tools import profile_stages as ps
    from consistencytta_torch.utils import GRAPH_EVENTS, graph_counts, reset_graph_counts

    reset_counters()
    t0 = time.perf_counter()
    s = ps.setup(pipe.device, pipeline=pipe)
    reset_graph_counts()
    stages = ps.stage_times(s)
    graphs = {"stage_times": graph_counts()}
    reset_graph_counts()
    profile = ps.profile_generate(s, trace_dir, top=None, gaps=PROFILE_GAPS)
    graphs["profile"] = graph_counts()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    norm_rows = [r for r in profile["top_kernels"] if norm.LAUNCH_NAME in r["name"]]
    norm_in_trace = {"ms": sum(r["ms"] for r in norm_rows),
                     "launches": sum(r["launches"] for r in norm_rows)}
    per_trace = ps.kernel_share(profile)
    trace_mb = os.path.getsize(profile.pop("trace")) / 2**20
    # generate calls: the stage timing's warm-up and timed ones, then the
    # profile's warm-up and traced one
    calls = 1 + ps.ITERS + 2
    expected = {**unet_launches(calls), "flash_self_attention": calls,
                **mrf_launches(calls, fused_levels), "stft_magnitude": 0,
                "dilated_conv1d": 0, **{k: n * calls for k, n in norm_per_call.items()}}
    in_trace = {"K1": 16, "K2": 1, "K3": fused_levels,
                "K7": mrf_launches(1, fused_levels)["wide_mrf_level"], "GEGLU": 16}
    line = {
        "phase": "profile", "batch": s.z.shape[0], "stages_ms": stages,
        "busy_share": profile["busy_share"], "window_ms": profile["window_ms"],
        "busy_ms": profile["busy_ms"], "call_seconds": profile["call_seconds"],
        "kernel_launches_in_trace": profile["kernels"],
        "top_kernels": profile["top_kernels"][:PROFILE_TOP], "gaps": profile["gaps"],
        "k1_k3_in_trace": per_trace, "launch_names": ps.LAUNCH_NAMES,
        "launches": launches, "expected_launches": expected, "trace_mb": trace_mb,
        "graphs": graphs, "seconds": seconds, "norm_in_trace": norm_in_trace,
    }
    if profile["kernels"] == 0:
        fail("profile: the trace holds no CUDA kernel")
    # (calls captured or replayed, eager calls) a stage: 1 + ITERS timed, 2 traced
    for part, want in (("stage_times", (1 + ps.ITERS, 0)), ("profile", (0, 2))):
        for stage in ("t5", "unet", "vae_decode", "vocoder"):
            c = graphs[part].get(stage, dict.fromkeys(GRAPH_EVENTS, 0))
            if (c["captures"] + c["replays"], c["eager"]) != want:
                fail(f"profile: {part} {stage} graph counts {c}, expected (graphed, eager) {want}")
    for k, n in in_trace.items():
        if per_trace[k]["launches"] != n:
            fail(f"profile: {k} ({ps.LAUNCH_NAMES[k]}) launched {per_trace[k]['launches']} "
                 f"times in the traced call, expected {n}")
    if launches != expected:
        fail(f"profile launch counts {launches} != expected {expected}")
    if norm_in_trace["launches"] != sum(norm_per_call.values()):
        fail(f"profile: the norm kernel ({norm.LAUNCH_NAME}) launched "
             f"{norm_in_trace['launches']} times in the traced call, expected "
             f"{sum(norm_per_call.values())}")
    return line, launches


def bench_phase(torch, fused_levels, reset_counters, read_counters, smi):
    """tools/bench.py's main in this process: its one JSON line (printed by
    it), re-emitted with the phase's launch counts, which must be those of
    11 student calls and 3 teacher calls of 35 queries at the CFG batch (the
    norm kernel's: those the module calls imply)."""
    from consistencytta_torch.tools import bench

    reset_counters()
    t0 = time.perf_counter()
    line = bench.main([])
    seconds = time.perf_counter() - t0
    launches = read_counters()
    student = 1 + bench.ITERS["cuda"]
    teacher = (1 + bench.TEACHER_ITERS["cuda"]) * (2 * bench.TEACHER_STEPS - 1)
    calls = student + 1 + bench.TEACHER_ITERS["cuda"]  # each call decodes once
    expected = with_norms({**unet_launches(student + teacher),
                           "flash_self_attention": calls,
                           **mrf_launches(calls, fused_levels), "stft_magnitude": 0,
                           "dilated_conv1d": 0})
    numbers = [line[k] for k in ("value", "vs_baseline", "device_ms_per_call",
                                 "teacher_clips_per_sec")]
    if not all(isinstance(x, float) and x > 0 and x == x and x != float("inf")
               for x in numbers):
        fail(f"bench: a non-positive or non-finite number in {line}")
    if f"{line['name']}, {line['power_limit']}" != smi:
        fail(f"bench: card {line['name']!r}, {line['power_limit']!r} is not nvidia-smi's {smi!r}")
    if launches != expected:
        fail(f"bench launch counts {launches} != expected {expected}")
    return {"phase": "bench", "line": line, "launches": launches, "expected_launches": expected,
            "seconds": seconds}, launches


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
        from consistencytta_torch.nn.layers import GroupNorm, LayerNorm
        from consistencytta_torch.nn.t5 import RMSNorm
        from consistencytta_torch.ops import _build
        from consistencytta_torch.ops import attention as att
        from consistencytta_torch.ops import dilated_conv as dconv
        from consistencytta_torch.ops import geglu, mrf, norm, schedulers, stft
        from consistencytta_torch.ops._packs import Pack
        from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
        from consistencytta_torch.tools import mrf_cases as mc
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
        # the MRF, STFT and dilated-conv kernels, what ptxas printed
        "attention_kernels": att.kernel_resources(),
        "attention_ptxas": _build.resources("flash_attention"),
        "mrf_ptxas": _build.resources("mrf"),
        "stft_ptxas": _build.resources("stft"),
        "dilated_conv_ptxas": _build.resources("dilated_conv"),
        "norm_ptxas": _build.resources("norm"),
        "conv_nlc_ptxas": _build.resources("conv_nlc"),
        "geglu_ptxas": _build.resources("geglu"),
    })

    # -- kernels against their plain versions ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    grad_errors = {}

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
        this shape `weight` times (default: its launches per main-path call), and
        its bound is the sum of the shapes' bounds, each computed alone."""
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
                                      "bound_bytes_ms": 0.0, "bound_operations_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if weight:
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                           (f"bound_{b_by}_ms", b_ms)):
                r[key] += weight * v
            if extra.get("device_ms") is not None:
                r["device_ms"] = r.get("device_ms", 0.0) + weight * extra["device_ms"]
            r["library_ms"] = None if lib_ms is None or r["library_ms"] is None \
                else r["library_ms"] + weight * lib_ms

    def gradient_check(name, shape, got, want, tol_max, mutants, check):
        """A kernel's gradient against autograd through its plain version,
        with the tolerance of its forward check; each planted fault must fail
        it. Its error goes into the kernel's max_abs_err."""
        err, scale, l2 = compare(got, want)
        caught = {f: not within(bad, want, tol_max) for f, bad in mutants.items()}
        ok = within(got, want, tol_max) and got.dtype == want.dtype
        emit({"phase": "kernel", "name": name, "check": check, "shape": shape,
              "max_abs_err": err, "max_abs_plain": scale, "tol_max_abs": tol_max * scale,
              "rel_l2": l2, "tol_rel_l2": TOL_L2, "dtype": str(got.dtype), "ok": ok,
              "mutants_caught": caught})
        if not ok:
            fail(f"{name} {check}: max abs err {err} (tol {tol_max * scale}), rel L2 {l2}, "
                 f"dtype {got.dtype} (plain {want.dtype})")
        if not all(caught.values()):
            fail(f"{name} {check}: the tolerance passes planted faults {caught}")
        grad_errors[name] = max(grad_errors.get(name, 0.0), err)

    def launch(kernel, call, n=1):
        """call() once, checking that it launched `kernel` exactly n times."""
        before = kernel.launches
        out = call()
        if kernel.launches != before + n:
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
    gradient_check("flash_mha_packed", f"B={b} S={s} H={h} d={HEAD_WIDTH} (64 padded)",
                   got, want, 2e-2, grad_mutants, "gradient under autocast")
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
    # K2's gradient as the stage-3 decoder's backward takes it: the VAE
    # mid-block under autocast, q, k and v slices of one projection that
    # requires grad, at the stage-3 micro-batch of 2; held against autograd
    # through the plain version outside autocast. The faults: the plain
    # gradient at 1.1 x the scale, and with dk and dv exchanged.
    b = STAGE3_BATCH
    qkv = torch.randn(b, 4096, 3 * 512, device=dev, generator=gen).bfloat16()
    g_out = torch.randn(b, 4096, 512, device=dev, generator=gen).bfloat16()

    def attn_grad(fn, scale, autocast):
        leaf = qkv.clone().requires_grad_()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = fn(*leaf.split(512, dim=-1), scale)
        return torch.autograd.grad(out, leaf, g_out)[0]

    got = launch(att.flash_self_attention,
                 lambda: attn_grad(att.flash_self_attention, 512 ** -0.5, True))
    want = attn_grad(att.attention_plain, 512 ** -0.5, False)
    dq, dk, dv = want.split(512, dim=-1)
    gradient_check("flash_self_attention", f"B={b} S=4096 D=512", got, want, 2e-2, {
        "scale_x1.1": attn_grad(att.attention_plain, 1.1 * 512 ** -0.5, False),
        "dk_dv_exchanged": torch.cat([dq, dv, dk], dim=-1)}, "gradient under autocast")
    del qkv, g_out, got, want, dq, dk, dv
    # K3: the vocoder's MRF levels; the fused levels (C <= FUSE_MAX_CHANNELS)
    # once per generate call, the wider ones (C = 256, 512) measured beside
    # the plain chain they run on. The plain chain has two formulations of its
    # dilated convs (direct, and split into phases); plain_ms is the faster of
    # the two at each shape. weight_l2_gb: the weight units the kernel
    # streams from L2 at the shape (every unit once per tile).
    ks, ds = mc.KS, mc.DS
    for c, length, b in ((128, 40968, BATCH), (64, 81936, BATCH), (32, 163872, BATCH),
                         (256, 20484, BATCH), (512, 5121, BATCH), (512, 2048, 2)):
        per_call = int(c <= FUSE_MAX_CHANNELS and b == BATCH)
        x, ws, bs = mc.inputs(gen, b, c, length)
        pack = Pack()  # the kernel's weight layout, made once as the vocoder keeps it
        kern = lambda: mrf.fused_mrf_level(x, ws, bs, ks, ds, 0.1, pack)
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
    # K3's gradient with respect to x, as the stage-3 losses' backward takes
    # it through the frozen vocoder (weights without gradient), at the C = 128
    # level of a stage-3 micro-batch; held against autograd through the plain
    # level. The faults: the plain gradient with the slope 0.2 in place of
    # 0.1, and with the first ResBlock's dilations reversed.
    b, c, length = STAGE3_BATCH, 128, 40968
    x, ws, bs = mc.inputs(gen, b, c, length)
    g_out = torch.randn(b, c, length, device=dev, generator=gen).bfloat16()

    def mrf_grad(fn, dil=ds, slope=0.1):
        leaf = x.clone().requires_grad_()
        return torch.autograd.grad(fn(leaf, ws, bs, ks, dil, slope), leaf, g_out)[0]

    got = launch(mrf.fused_mrf_level, lambda: mrf_grad(mrf.fused_mrf_level))
    want = mrf_grad(mrf.mrf_level_plain)
    gradient_check("fused_mrf_level", f"B={b} C={c} L={length}", got, want, 3e-2, {
        "slope_0.2": mrf_grad(mrf.mrf_level_plain, slope=0.2),
        "dilations_reversed": mrf_grad(mrf.mrf_level_plain, dil=((5, 3, 1),) + ds[1:])},
        "gradient wrt x")
    del x, ws, bs, g_out, got, want
    # K7: the MRF levels wider than FUSE_MAX_CHANNELS (C = 512, 256), once per
    # generate call at batch 32 (WIDE_LEVEL_LAUNCHES a level), beside the plain
    # chain (plain_ms: the faster of its direct and phase-split dilated convs);
    # every planted fault of tools/mrf_cases.py must fail the tolerance. At
    # batch 1 (tiles of 128 channels at C = 512) for the check alone.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c, length, b in ((512, 5121, BATCH), (256, 20484, BATCH), (512, 5121, 1)):
        x, ws, bs = mc.inputs(gen, b, c, length)
        pack = Pack()  # the kernel's weight layout, made once as the vocoder keeps it
        kern = lambda: mrf.wide_mrf_level(x, ws, bs, ks, ds, 0.1, pack)
        direct = lambda: mrf.mrf_level_plain(x, ws, bs, ks, ds, 0.1)
        split = lambda: mrf.mrf_level_plain(x, ws, bs, ks, ds, 0.1, phase_split=True)
        got, want = launch(mrf.wide_mrf_level, kern, WIDE_LEVEL_LAUNCHES), direct()
        mutants = {f: mc.fault(x, ws, bs, f) for f in mc.FAULTS}
        direct_ms, split_ms = cuda_ms(torch, direct, 2), cuda_ms(torch, split, 2)
        wbytes = sum(w.numel() * 2 for w in ws) + 18 * c * 2
        on_path = b == BATCH
        record("wide_mrf_level", f"B={b} C={c} L={length}", got, want, mc.TOL_MAX, mutants,
               cuda_ms(torch, kern, 2), min(direct_ms, split_ms), None,
               float(mrf.mrf_flops(b, c, length, ks, ds)), 2.0 * x.numel() * 2 + wbytes,
               WIDE_LEVEL_LAUNCHES if on_path else 0, weight=int(on_path),
               plain_direct_ms=direct_ms, plain_phase_split_ms=split_ms,
               tile_n=mrf.wide_tile_n(c, b, length, sms))
        del x, ws, bs, got, want, mutants
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
    # are those of the six convs run once each. device_ms: a replayed CUDA
    # graph's time, without the host's launch; plan: the tile plan's rings
    # and shared memory (ops/dilated_conv.py:tile_plan).
    b, c, length = BATCH, 64, 81936
    x = (torch.randn(b, c, length, device=dev, generator=gen) * 0.5).bfloat16()
    for kk, d in ((3, 3), (3, 5), (7, 3), (7, 5), (11, 3), (11, 5)):
        w = (torch.randn(c, c, kk, device=dev, generator=gen) / (c * kk) ** 0.5).bfloat16()
        p = d * (kk - 1) // 2
        pack = Pack()
        kern = lambda: dconv.dilated_conv1d(x, w, d, p, pack)
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
        plain_ms = cuda_ms(torch, plain, 20)
        device_ms, graph_error = graph_ms(kern)
        record("dilated_conv1d", f"B={b} C={c} L={length} k={kk} d={d}", got, want, 2e-2,
               mutants, cuda_ms(torch, kern, 20), plain_ms, plain_ms,
               float(dconv.dilated_conv_flops(b, c, length, kk)),
               2.0 * (2 * x.numel() + w.numel()), 0, weight=1, device_ms=device_ms,
               device_ms_error=graph_error, host_us=host_us(kern),
               plan=dconv.check_args(x, w, d, p)._asdict())
        del w, got, want, one_less, mutants
    del x
    torch.cuda.empty_cache()

    # The norm kernel (csrc/norm.cu): every distinct GroupNorm (+ SiLU),
    # LayerNorm and RMSNorm call of a 1-NFE generate call at batch 32,
    # weighted by how often the call repeats, then those of a call of the
    # full TANGO UNet's CFG teacher at batch 8 (tango-b8: GroupNorms of 10-80
    # channels a group, LayerNorms on rows of 320, 640 and 1280, which take
    # the rows kernel's two-warp instantiation), which are off the main path
    # and weigh nothing in the sums (tools/norm_cases.py enumerates the calls
    # on the meta device and makes inputs whose groups differ in scale and
    # offset). A LayerNorm or RMSNorm launch must count under the rows
    # instantiation that holds its width (norm.rows_launches). Tolerance:
    # record's 2^-7 of the largest output, and 1 bf16 ulp of each output
    # (`ulps`). The faults: eps outside the square root, the neighbour's
    # statistics, the SiLU left off, for the transformer's padded LayerNorm
    # rows (n true features of 256 / 512 / 1024) the statistics divided by
    # the width, and for rows wider than 1024 the statistics over the first
    # 1024 features, all that one warp holds. plain: the float32 copy,
    # torch's float32 norm and the cast back that the modules ran before the
    # kernel; library: torch's own norm on the bf16 input (float32 inside;
    # RMSNorm only where this torch has F.rms_norm), then F.silu where the
    # kernel fuses it; device_ms: a replayed CUDA graph's time, without the
    # host's launch; the bound: one bf16 read and one write of each element
    # and the float32 affine at 3.35 TB/s.
    from collections import Counter

    from consistencytta_torch.tools import norm_cases as nb

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main_calls = Counter(nb.generate_norms(*nb.CALLS["generate-b32"]))
    tango_calls = Counter(nb.generate_norms(*nb.CALLS["tango-b8"]))
    cases = ([("", c, k, k) for c, k in sorted(main_calls.items())]
             + [("tango-b8 ", c, k, 0) for c, k in sorted(tango_calls.items())
                if c not in main_calls])
    for cell, (kind, shape, groups, eps, silu, n), per_call, weight in cases:
        x, w, b = nb.inputs(kind, shape, groups, torch.bfloat16, gen, n)
        call = (kind, x, w, b, groups, eps, silu, n)
        kern = lambda: nb.kernel_call(*call)
        plain = lambda: nb.plain_call(*call)
        lib = (lambda: nb.library_call(*call)) if nb.has_library(kind) else None
        counter = {"group": norm.group_norm, "layer": norm.layer_norm, "rms": norm.rms_norm}[kind]
        held = None if kind == "group" else norm.rows_launches[norm.rows_instantiation(shape[-1])]
        before = None if held is None else held.launches
        got, want = launch(counter, kern), plain()
        if held is not None and held.launches != before + 1:
            fail(f"norm {cell}{kind} {tuple(shape)}: not counted under the rows instantiation "
                 f"{norm.rows_instantiation(shape[-1])}")
        faults = (["eps_outside_sqrt", "neighbour_statistics"] + (["silu_left_off"] if silu else [])
                  + ([nb.PAD_FAULT] if 0 < n < shape[-1] else [])
                  + ([nb.WIDE_FAULT] if kind != "group" and shape[-1] > 1024 else []))
        mutants = {f: (nb.group_norm_fault(x, groups, w, b, eps, silu, f) if kind == "group"
                       else nb.row_norm_fault(x, w, b, eps, kind == "rms", f, n or None))
                   for f in faults}
        ulps = nb.ulps(got, want)
        iters = max(3, int(2e8 // x.numel()))
        device_ms, graph_error = graph_ms(kern, max(2, min(20, int(2**30 // (2 * x.numel())))))
        label = f"{cell}{kind} {tuple(shape)} groups={groups} silu={silu} n={n}"
        record("norm", label, got, want, 2 ** -7, mutants, cuda_ms(torch, kern, iters),
               cuda_ms(torch, plain, 3), None if lib is None else cuda_ms(torch, lib, iters), 0.0,
               nb.bound_ms(x, kind) * 1e-3 * PEAK_BYTES, per_call, weight=weight, ulps=ulps,
               tol_ulps=nb.TOL_ULPS[torch.bfloat16], device_ms=device_ms,
               device_ms_error=graph_error,
               plan=norm.group_plan(shape[0] * groups, x[0].numel() // groups, 2, sms)
               if kind == "group" else norm.rows_plan(x.numel() // shape[-1], shape[-1], 2, sms))
        if ulps > nb.TOL_ULPS[torch.bfloat16]:
            fail(f"norm {cell}{kind} {tuple(shape)}: {ulps} bf16 ulps from the plain version")
        del x, w, b, got, want, mutants
        torch.cuda.empty_cache()

    # K8, the GEGLU kernel (csrc/geglu.cu): the `proj` output [M, 2N] of
    # every GEGLU of a 1-NFE generate call at batch 32 (M = 32 x the level's
    # positions, N the light UNet's half as it runs), weighted by its launches a
    # call, then batch 1 (gen-b1) and the full TANGO UNet's widths at the CFG
    # batch of 16 (tango-b8), which weigh nothing in the sums. Held bit for
    # bit to the plain version (the four PyTorch passes the module ran
    # before the kernel); the faults: the tanh gelu and the halves
    # exchanged, each also given in bf16 ulps of the plain output. No
    # library call computes it; the bound: one bf16 read of y and one write
    # of the product at 3.35 TB/s; device_ms: a replayed CUDA graph's time.
    geglu_cases = ([("", 32, level, None) for level in GEGLU_LEVELS]
                   + [("gen-b1 ", 1, level, 0) for level in GEGLU_LEVELS]
                   + [("tango-b8 ", 16, level, 0) for level in GEGLU_TANGO_LEVELS])
    for cell, b, (px, n, per_call), weight in geglu_cases:
        m = b * px
        y = (3.0 * torch.randn(m, 2 * n, device=dev, generator=gen)).bfloat16()
        kern = lambda: geglu.geglu(y)
        plain = lambda: geglu.geglu_plain(y)
        got, want = launch(geglu.geglu, kern), plain()
        h, gate = y.chunk(2, dim=-1)
        mutants = {"tanh_gelu": h * F.gelu(gate.float(), approximate="tanh").to(h.dtype),
                   "halves_exchanged": gate * F.gelu(h.float()).to(h.dtype)}
        device_ms, graph_error = graph_ms(kern, max(2, min(20, int(2**30 // y.numel()))))
        iters = max(3, int(2e8 // y.numel()))
        record("geglu", f"{cell}M={m} N={n}", got, want, 0.0, mutants,
               cuda_ms(torch, kern, iters), cuda_ms(torch, plain, 3), None, 0.0,
               3 * m * n * y.element_size(), per_call, weight=weight,
               mutant_ulps={f: nb.ulps(bad, want) for f, bad in mutants.items()},
               device_ms=device_ms, device_ms_error=graph_error)
        del y, h, gate, got, want, mutants
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

    counters = {"flash_mha_packed": att.flash_mha_packed, "geglu": geglu.geglu,
                "flash_self_attention": att.flash_self_attention,
                "fused_mrf_level": mrf.fused_mrf_level, "wide_mrf_level": mrf.wide_mrf_level,
                "stft_magnitude": stft.stft_magnitude_cuda,
                "dilated_conv1d": dconv.dilated_conv1d,
                **{k: getattr(norm, k) for k in NORM_COUNTERS}}
    # the norm kernel: one launch per norm module of the three stages that
    # hold them (T5, the student UNet, the VAE decoder), per generate call
    modules = [m for stage in (pipe.t5, pipe.unets["student_ema"], pipe.vae.decoder)
               for m in stage.modules()]
    norm_per_call = {k: sum(isinstance(m, cls) for m in modules)
                     for k, cls in zip(NORM_COUNTERS, (GroupNorm, LayerNorm, RMSNorm))}
    NORMS.install()

    def reset_counters():
        for fn in counters.values():
            fn.launches = 0
        NORMS.reset()

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
    if len(voc.upsample_rates) != MRF_LEVELS:
        fail(f"the vocoder has {len(voc.upsample_rates)} MRF levels, the tables {MRF_LEVELS}")
    fused_levels = sum(voc.upsample_initial_channel // 2 ** (i + 1) <= FUSE_MAX_CHANNELS
                       for i in range(len(voc.upsample_rates)))
    expected = {**unet_launches(calls), "flash_self_attention": calls,
                **mrf_launches(calls, fused_levels), "stft_magnitude": 0, "dilated_conv1d": 0,
                **{k: n * calls for k, n in norm_per_call.items()}}
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

    # -- profile: stage times and a traced generate call on main's pipeline -------
    trace_dir = os.path.join(root, "outputs", f"chip_smoke_profile_{os.getpid()}")
    try:
        profile, profile_launches = profile_phase(torch, pipe, fused_levels, norm_per_call,
                                                  reset_counters, read_counters, trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    emit(profile)
    del pipe, generate
    torch.cuda.empty_cache()

    # -- bench: tools/bench.py's line, in this process ------------------------------
    bench, bench_launches = bench_phase(torch, fused_levels, reset_counters, read_counters, smi)
    emit(bench)
    torch.cuda.empty_cache()

    # -- training path ------------------------------------------------------------
    del ref, student, z, emb, mel, wav, wav32, got, want
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
    train_expected = with_norms({**unet_launches(unet_queries),
                                 "flash_self_attention": calls_t, **mrf_launches(0, 0),
                                 "stft_magnitude": calls_t, "dilated_conv1d": 0})
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
    torch.cuda.empty_cache()

    # -- fit: the training CLI at full width ----------------------------------------
    fit_dir = os.path.join(root, "outputs", f"chip_smoke_fit_{os.getpid()}")
    os.makedirs(fit_dir)
    try:
        _, fit_train, fit_infer, fit_ctx = fit_phase(torch, config, fit_dir, reset_counters,
                                                     read_counters, fused_levels)
        torch.cuda.empty_cache()
        # -- stage3: the CLAP fine-tune from the fit phase's stage-2 best ----------
        stage3_dir = os.path.join(fit_dir, "stage3")
        os.makedirs(stage3_dir)
        _, s3_train, s3_infer = stage3_phase(torch, config, fit_ctx, stage3_dir, reset_counters,
                                             read_counters, fused_levels)
    finally:
        shutil.rmtree(fit_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- ddp: data-parallel training, two gloo ranks sharing the card ---------------
    ddp_dir = os.path.join(root, "outputs", f"chip_smoke_ddp_{os.getpid()}")
    os.makedirs(ddp_dir)
    try:
        _, ddp_launches = ddp_phase(torch, config, torch.device("cuda:0"), ddp_dir)
    finally:
        shutil.rmtree(ddp_dir, ignore_errors=True)

    # -- summary ----------------------------------------------------------------
    sources = {
        "flash_mha_packed": ("consistencytta_torch/csrc/flash_attention.cu",
                             "consistencytta_tpu/ops/pallas_attention.py:362"),
        "flash_self_attention": ("consistencytta_torch/csrc/flash_attention.cu",
                                 "consistencytta_tpu/ops/pallas_attention.py:420"),
        "fused_mrf_level": ("consistencytta_torch/csrc/mrf.cu",
                            "consistencytta_tpu/ops/pallas_mrf.py:508"),
        "wide_mrf_level": ("consistencytta_torch/csrc/conv_nlc.cu",
                           "none: consistencytta_tpu/nn/hifigan.py runs the wide levels as "
                           "plain ResBlocks"),
        "stft_magnitude": ("consistencytta_torch/csrc/stft.cu",
                           "consistencytta_tpu/ops/pallas_stft.py:89"),
        "stft_magnitude_n512": ("consistencytta_torch/csrc/stft.cu",
                                "consistencytta_tpu/ops/pallas_stft.py:89"),
        "dilated_conv1d": ("consistencytta_torch/csrc/dilated_conv.cu",
                           "consistencytta_tpu/ops/pallas_blockconv.py:204"),
        "norm": ("consistencytta_torch/csrc/norm.cu",
                 "none: XLA fuses consistencytta_tpu/nn/layers.py's norms"),
        "geglu": ("consistencytta_torch/csrc/geglu.cu",
                  "none: XLA fuses consistencytta_tpu/nn/attention.py's GEGLU"),
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
            "profile": "the profile run's stage calls and two generate calls",
            "bench": "the bench run's 11 student and 3 teacher calls",
            "train": f"the train run's {n_train_steps} steps and one validation",
            "serve": "the serve run's two CLI runs (the second evaluating)",
            "eval": "the eval run's evaluate_existing",
            "fit": "the fit run's five training CLI runs and its inference CLI run",
            "stage3": "the stage3 run's six training CLI runs and its inference CLI run",
            "ddp": f"the ddp run's {DDP_WORLD} ranks' {DDP_STEPS} sound steps"}
    kernels = []
    for name, (src, rep) in sources.items():
        r = results[name]
        b_ms = r["bound_ms"]
        b_by = max(("bytes", "operations"), key=lambda by: r[f"bound_{by}_ms"])
        counter = "stft_magnitude" if name.startswith("stft") else name
        keys = NORM_COUNTERS if name == "norm" else (counter,)
        n = lambda counts: sum(counts[k] for k in keys)
        paths = {"generate": n(launches), "profile": n(profile_launches),
                 "bench": n(bench_launches), "train": n(train_launches),
                 "serve": n(serve_launches), "eval": n(eval_launches),
                 "fit": n(fit_train) + n(fit_infer), "stage3": n(s3_train) + n(s3_infer),
                 "ddp": n(ddp_launches)}
        if counter == "stft_magnitude":
            # training runs take N = 1024, the inference CLI's eval mels N = 512
            n512 = name != counter
            paths = {k: v for k, v in paths.items()
                     if k in ("fit", "stage3") or (k in ("serve", "eval")) == n512}
            paths["fit"] = fit_infer[counter] if n512 else fit_train[counter]
            paths["stage3"] = s3_infer[counter] if n512 else s3_train[counter]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(paths.values()), **{f"launches_{k}": v for k, v in paths.items()},
            "max_abs_err": r["max_abs_err"],
            **({"gradient_max_abs_err": grad_errors[name]} if name in grad_errors else {}),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": r["library_ms"],
            **({"device_ms": r["device_ms"]} if "device_ms" in r else {}),
            "per": per.get(name, f"times per generate call at batch {BATCH}")
            + "; launches over " + ", ".join(runs[k] for k in paths),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
