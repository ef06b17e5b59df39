"""Device times of the attention kernels K1 and K2 beside SDPA, on the card.

    python3 -m consistencytta_torch.tools.attention_bench [--flags="-DFA_BOUNDED_WAIT ..."]

Times `flash_mha_packed` at the UNet's four shapes and `flash_self_attention`
at the VAE's, at batch 32 and batch 1, with CUDA events around calls queued
behind a spin kernel, so that the card never waits for the host: the numbers
are the kernels' own, where `chip_smoke.py` (calls timed back to back) reads
the host's time per launch at the short shapes. Each kernel is timed twice
with SDPA between, and the host time of one launch is printed too. `--flags`
adds nvcc flags to the build, to time a variant of the source; the last lines
give the registers, spills and shared memory of the build that was timed.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from consistencytta_torch.ops import _build
from consistencytta_torch.ops import attention as att

HEAD_WIDTH = 51  # the UNet's heads, padded to the kernel's 64


def device_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3e7))  # the queue fills while the card spins
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 300) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--flags", default="", help="extra nvcc flags for the build")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_bench: needs a CUDA card")
    _build.FLAGS = _build.FLAGS + tuple(args.flags.split())
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b in (32, 1):
        for s, h in ((4096, 5), (1024, 10), (256, 20), (64, 20)):
            qkv = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen).bfloat16()
            q, k, v = qkv.split(h * 64, dim=-1)
            heads = lambda t: t.unflatten(-1, (h, 64)).transpose(1, 2)
            scale = HEAD_WIDTH ** -0.5
            kern = lambda: att.flash_mha_packed(q, k, v, h, scale)
            lib = lambda: sdpa(heads(q), heads(k), heads(v), scale=scale)
            iters = max(5, min(100, 40000 // s))
            print(json.dumps({
                "kernel": "flash_mha_packed", "B": b, "S": s, "H": h,
                "ms": [device_ms(kern, iters), device_ms(kern, iters)],
                "sdpa_ms": device_ms(lib, iters),
                "host_us": host_us(kern), "sdpa_host_us": host_us(lib)}), flush=True)
        qkv = torch.randn(b, 4096, 3 * 512, device="cuda", generator=gen).bfloat16()
        q, k, v = qkv.split(512, dim=-1)
        kern = lambda: att.flash_self_attention(q, k, v, 512 ** -0.5)
        lib = lambda: sdpa(q[:, None], k[:, None], v[:, None], scale=512 ** -0.5)
        print(json.dumps({
            "kernel": "flash_self_attention", "B": b, "S": 4096, "D": 512,
            "ms": [device_ms(kern, 5), device_ms(kern, 5)], "sdpa_ms": device_ms(lib, 5),
            "host_us": host_us(kern, 50), "sdpa_host_us": host_us(lib, 50)}), flush=True)
    print(json.dumps({"resources": att.kernel_resources(),
                      "ptxas": _build.resources("flash_attention")}), flush=True)


if __name__ == "__main__":
    main()
