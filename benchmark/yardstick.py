"""The benchmark's arithmetic, kept apart from the program it measures:
the card's data-sheet peaks, the operations and bytes of kernels K1 (the
UNet's self-attention) and K3 (a fused HiFi-GAN MRF level) at the shapes a
configuration gives them, the operations of each model of a call counted on
the meta device from the configuration's shapes, and the reading of a
profiler trace (busy share, kernel time by name, idle gaps)."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS = 989e12  # bf16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3

# the trace's event categories: what the device runs, and what the host runs
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: operations or bytes at peak."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


# -- K1: the UNet's self-attention ------------------------------------------

def k1_shapes(unet: dict, latent: dict) -> List[Tuple[int, int, int]]:
    """(tokens, heads, head width) of each self-attention of one UNet query,
    down blocks, mid block, then up blocks."""
    chs, heads, per = unet["block_out_channels"], unet["attention_head_dim"], unet["layers_per_block"]
    n = len(chs)
    tokens = lambda i: latent["t"] * latent["f"] // 4 ** i
    out = []
    for i, kind in enumerate(unet["down_block_types"]):
        if kind == "CrossAttnDownBlock2D":
            out += [(tokens(i), heads[i], chs[i] // heads[i])] * per
    out.append((tokens(n - 1), heads[-1], chs[-1] // heads[-1]))
    for i, kind in enumerate(unet["up_block_types"]):
        j = n - 1 - i
        if kind == "CrossAttnUpBlock2D":
            out += [(tokens(j), heads[j], chs[j] // heads[j])] * (per + 1)
    return out


def k1_bound_s(unet: dict, latent: dict, batch: int) -> float:
    """K1's bound for one UNet query at `batch`: per launch 4 b h S^2 d
    operations (q k^T and p v at the true head width, not the padded 64)
    and q, k, v read and the output written once in bf16."""
    return sum(bound_s(4.0 * batch * h * s * s * d, 4.0 * batch * s * h * d * 2)
               for s, h, d in k1_shapes(unet, latent))


# -- K3: a fused MRF level of the vocoder -----------------------------------

def vocoder_levels(vocoder: dict, frames: int) -> List[Tuple[int, int]]:
    """(channels, length) at each MRF level of one vocoder call."""
    c0, length, out = vocoder["upsample_initial_channel"], frames, []
    for i, (u, k) in enumerate(zip(vocoder["upsample_rates"], vocoder["upsample_kernel_sizes"])):
        length = (length - 1) * u - 2 * ((k - u) // 2) + k
        out.append((c0 // 2 ** (i + 1), length))
    return out


def k3_bound_s(vocoder: dict, frames: int, batch: int, fused_levels: int) -> float:
    """K3's bound for one vocoder call: the `fused_levels` narrowest levels,
    each 2 b L C^2 sum(2 len(d) k) operations (the 18 convs), x read and
    the output written once in bf16, and the 18 convs' weights and biases."""
    ks, ds = vocoder["resblock_kernel_sizes"], vocoder["resblock_dilation_sizes"]
    per_pos = sum(2 * len(d) * k for k, d in zip(ks, ds))
    total = 0.0
    for c, length in vocoder_levels(vocoder, frames)[len(vocoder["upsample_rates"]) - fused_levels:]:
        weights = sum(2 * len(d) * c * c * k for k, d in zip(ks, ds)) * 2 + 2 * sum(
            2 * len(d) for d in ds) * c * 2
        total += bound_s(2.0 * batch * length * c * c * per_pos,
                         2.0 * batch * c * length * 2 + weights)
    return total


# -- operations of a call, counted on the meta device -----------------------

def count_flops(fn, *args) -> int:
    """Operations (2 per multiply-add) that FlopCounterMode counts for
    fn(*args) on meta tensors."""
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return counter.get_total_flops()


def generate_flops(pipeline: dict, batch: int, text_len: int, unet_queries: int,
                   unet_batch: int, teacher: bool = False) -> int:
    """Operations of one generate call: T5 over the text at `unet_batch`,
    `unet_queries` UNet queries at `unet_batch`, the VAE decoder and the
    vocoder at `batch`."""
    from benchmark.weights import reference_models

    m = reference_models(pipeline, teacher)
    lat, meta = pipeline["latent"], torch.device("meta")
    ids = torch.zeros(unet_batch, text_len, dtype=torch.long, device=meta)
    z = torch.zeros(unet_batch, lat["t"], lat["f"], lat["c"], device=meta)
    text = torch.zeros(unet_batch, text_len, pipeline["t5"]["d_model"], device=meta)
    vec = torch.zeros(unet_batch, device=meta)
    t5 = count_flops(m.t5, ids, ids)
    unet = count_flops(m.unet, z, vec, text, ids, None if teacher else vec)
    zd = torch.zeros(batch, lat["t"], lat["f"], lat["c"], device=meta)
    vae = count_flops(m.vae.decode_mel, zd)
    frames = lat["t"] * 2 ** (len(pipeline["vae"]["ch_mult"]) - 1)
    mel = torch.zeros(batch, pipeline["vocoder"]["num_mels"], frames, device=meta)
    voc = count_flops(m.vocoder, mel)
    return t5 + unet_queries * unet + vae + voc


# -- the profiler trace ------------------------------------------------------

def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def read_trace(trace, gaps: int = 10) -> dict:
    """Read a Chrome trace as torch.profiler exports it (a path or the
    parsed JSON; times in microseconds). Returns, in seconds:

      window_s   the first event's start to the last one's end;
      busy_s     the union of the device's intervals (kernels, copies,
                 memsets), so that overlapping work counts once;
      kernels    launches in the trace;
      by_name    {kernel name: [seconds, launches]} over all kernels;
      gaps       the `gaps` longest stretches in which the device ran
                 nothing, each with the host operation that overlapped it
                 most (the shortest such one on a tie, so the innermost;
                 the profiler's own step ranges left out).
    """
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    if not spans:
        raise ValueError("the trace holds no complete events")
    start = min(float(e["ts"]) for e in spans)
    end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    by_name: Dict[str, List[float]] = {}
    for e in device:
        if e.get("cat") == "kernel":
            entry = by_name.setdefault(e["name"], [0.0, 0])
            entry[0] += float(e["dur"]) / 1e6
            entry[1] += 1
    idle, cursor = [], start
    for a, b in busy + [(end, end)]:
        if a > cursor:
            idle.append((cursor, a))
        cursor = max(cursor, b)
    idle = sorted(idle, key=lambda ab: -(ab[1] - ab[0]))[:gaps]
    host = [e for e in spans if e.get("cat") in HOST_CATEGORIES
            and not e["name"].startswith("ProfilerStep")]

    def host_op(a: float, b: float) -> Optional[str]:
        best, best_key = None, None
        for e in host:
            lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            overlap = min(hi, b) - max(lo, a)
            if overlap > 0 and (best_key is None or (overlap, -float(e["dur"])) > best_key):
                best, best_key = e["name"], (overlap, -float(e["dur"]))
        return best

    return {
        "window_s": (end - start) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": sum(n for _, n in by_name.values()),
        "by_name": by_name,
        "gaps": [[host_op(a, b) or "none", (b - a) / 1e6] for a, b in idle],
    }


def kernel_seconds(trace: dict, launch_name: str) -> Tuple[float, int]:
    """(seconds, launches) of the kernels whose name holds `launch_name`."""
    hits = [v for k, v in trace["by_name"].items() if launch_name in k]
    return sum(s for s, _ in hits), sum(n for _, n in hits)
