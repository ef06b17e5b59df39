"""Device times of the MRF levels (K3, and K7 at the wide levels) and the STFT
magnitude (K4) beside their plain versions and library calls, on the card.

    python3 -m consistencytta_torch.tools.mrf_stft_bench [--flags="-D..."] [--check]
    python3 -m consistencytta_torch.tools.mrf_stft_bench --l2-bytes   (no card needed)

K3 at the vocoder's five levels at batch 32 (C = 128, 64, 32 on the generate
path; C = 256 and 512, which the path gives to K7), beside the plain chain
with direct and with phase-split dilated convs (the wide levels' path until
K7); K7 (`wide_mrf_level`) at C = 512 and 256 beside the same two, with the
level's bound (its operations at 989 TFLOP/s); K4 at batch 1, 8 and 32 on
10-s clips beside `torch.stft` + `abs`. Times are CUDA events around calls
queued behind a spin kernel (`attention_bench.device_ms`), so the card never
waits for the host; the host time of one K4 launch is printed too. With
`--check` each kernel is first held against its plain version at small
shapes (max error over the largest magnitude, relative L2). `--flags` adds
nvcc flags to the build, to time a variant of the source; the last line gives
the registers, spills and shared memory of the builds that were timed.
`--l2-bytes` prints, per level at batch 32, the weight bytes K3 streams from
L2 (`ops/mrf.py:weight_l2_bytes`) beside those of PR 3's design, which
restarted a conv's whole weight stream for every round of 8 warps x MR x 16
rows (MR = 4, 2, 1 at C = 32, 64, >= 128) of T = 512, 512, 224 outputs.
"""

from __future__ import annotations

import argparse
import json

import torch

from consistencytta_torch.configs import STFTConfig
from consistencytta_torch.ops import _build, mrf, stft
from consistencytta_torch.ops._packs import Pack
from consistencytta_torch.tools import mrf_cases
from consistencytta_torch.tools.attention_bench import device_ms, host_us

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
LEVELS = ((128, 40968), (64, 81936), (32, 163872), (256, 20484), (512, 5121))


def pr3_weight_l2_bytes(b: int, c: int, length: int) -> int:
    """Weight bytes from L2 of K3 as PR 3 built it (see the module note)."""
    t = {32: 512, 64: 512, 128: 224}[c]
    per_round = 8 * {32: 4, 64: 2, 128: 1}[c] * 16
    per_tile = 0
    for k, ds in zip(KS, DS):
        lo, hi = 0, t + 2 * sum((d + 1) * (k - 1) // 2 for d in ds)
        for d in ds:
            for p in (d * (k - 1) // 2, (k - 1) // 2):
                lo, hi = lo + p, hi - p
                per_tile += -(-(hi - lo) // per_round) * k * c * c * 2
    return b * -(-length // t) * per_tile


def errors(got, want):
    got, want = got.float(), want.float()
    return {"max_err_share": ((got - want).abs().max() / want.abs().max()).item(),
            "rel_l2": ((got - want).norm() / want.norm()).item()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--flags", default="", help="extra nvcc flags for the build")
    parser.add_argument("--check", action="store_true", help="check at small shapes first")
    parser.add_argument("--l2-bytes", action="store_true",
                        help="print K3's weight traffic from L2, this design and PR 3's")
    args = parser.parse_args()
    if args.l2_bytes:
        for c, length in LEVELS[:3]:
            print(json.dumps({"C": c, "L": length, "B": 32,
                              "weight_l2_gb": mrf.weight_l2_bytes(32, c, length, KS, DS) / 1e9,
                              "pr3_weight_l2_gb": pr3_weight_l2_bytes(32, c, length) / 1e9}))
        return
    if not torch.cuda.is_available():
        raise SystemExit("mrf_stft_bench: needs a CUDA card")
    _build.FLAGS = _build.FLAGS + tuple(args.flags.split())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    fe = stft.MelFrontend(STFTConfig(), device="cuda")
    if args.check:
        for b, c, length in ((1, 32, 97), (2, 32, 1500), (1, 64, 1500), (2, 128, 1500),
                             (1, 128, 2003), (2, 256, 700), (2, 512, 300)):
            x, ws, bs = mrf_cases.inputs(gen, b, c, length)
            got = mrf.fused_mrf_level(x, ws, bs, KS, DS, 0.1)
            print(json.dumps({"check": "fused_mrf_level", "B": b, "C": c, "L": length,
                              **errors(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1))}),
                  flush=True)
        for b, c, length in ((1, 256, 97), (2, 256, 1500), (1, 512, 5121), (2, 192, 333)):
            x, ws, bs = mrf_cases.inputs(gen, b, c, length)
            got = mrf.wide_mrf_level(x, ws, bs, KS, DS, 0.1)
            print(json.dumps({"check": "wide_mrf_level", "B": b, "C": c, "L": length,
                              **errors(got, mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1))}),
                  flush=True)
        for b, t in ((1, 513), (2, 32007)):
            wav = torch.randn(b, t, device="cuda", generator=gen) * 0.3
            want = stft.stft_magnitude(wav, fe.cos_basis, fe.sin_basis, 160, 512)
            print(json.dumps({"check": "stft_magnitude", "B": b, "T": t,
                              **errors(fe.magnitude(wav), want)}), flush=True)
    for c, length in LEVELS:
        x, ws, bs = mrf_cases.inputs(gen, 32, c, length)
        pack = Pack()  # the kernel's weight layout, made once as the vocoder keeps it
        kern = lambda: mrf.fused_mrf_level(x, ws, bs, KS, DS, 0.1, pack)
        print(json.dumps({
            "kernel": "fused_mrf_level", "B": 32, "C": c, "L": length,
            "ms": [device_ms(kern, 2), device_ms(kern, 2)],
            "plain_direct_ms": device_ms(lambda: mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 1),
            "plain_phase_split_ms": device_ms(
                lambda: mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1, phase_split=True), 1),
            "tile": mrf.tile_plan(c, length, KS, DS)[0],
            "weight_l2_gb": mrf.weight_l2_bytes(32, c, length, KS, DS) / 1e9}), flush=True)
        del x, ws, bs
    for c, length in LEVELS[4:2:-1]:
        x, ws, bs = mrf_cases.inputs(gen, 32, c, length)
        pack = Pack()
        kern = lambda: mrf.wide_mrf_level(x, ws, bs, KS, DS, 0.1, pack)
        bound_ms = mrf.mrf_flops(32, c, length, KS, DS) / 989e9
        ms = [device_ms(kern, 2), device_ms(kern, 2)]
        print(json.dumps({
            "kernel": "wide_mrf_level", "B": 32, "C": c, "L": length, "ms": ms,
            "plain_direct_ms": device_ms(lambda: mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1), 1),
            "plain_phase_split_ms": device_ms(
                lambda: mrf.mrf_level_plain(x, ws, bs, KS, DS, 0.1, phase_split=True), 1),
            "bound_ms": bound_ms, "bound_share": bound_ms / min(ms),
            "tile_n": mrf.wide_tile_n(c, 32, length, torch.cuda.get_device_properties(
                "cuda").multi_processor_count)}), flush=True)
        del x, ws, bs
    hann = torch.hann_window(1024, periodic=True, device="cuda")
    for b in (1, 8, 32):
        wav = torch.randn(b, 160000, device="cuda", generator=gen) * 0.3
        kern = lambda: fe.magnitude(wav)
        lib = lambda: torch.stft(wav, 1024, 160, 1024, hann, center=True, pad_mode="reflect",
                                 return_complex=True).abs()
        print(json.dumps({
            "kernel": "stft_magnitude", "B": b, "T": 160000,
            "ms": [device_ms(kern, 50), device_ms(kern, 50)], "torch_stft_ms": device_ms(lib, 50),
            "plain_ms": device_ms(
                lambda: stft.stft_magnitude(wav, fe.cos_basis, fe.sin_basis, 160, 512), 10),
            "host_us": host_us(kern)}), flush=True)
    print(json.dumps({"ptxas": {n: _build.resources(n) for n in ("mrf", "stft", "conv_nlc")}}),
          flush=True)


if __name__ == "__main__":
    main()
