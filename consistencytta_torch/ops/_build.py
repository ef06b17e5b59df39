"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` for Hopper (sm_90a) into `build/lib<name>-<hash>.so` at the root of
the checkout, where <hash> is a digest of the source, the shared headers
(`csrc/*.cuh`) and the flags: an edited source gets a new library, and a
library that exists is reused. nvcc's output, with the registers, spills
and shared memory of every kernel (`-Xptxas -v`), is kept beside the library
as `<library>.log`; `resources` reads it. The
libraries are loaded with ctypes; pointers and the stream are passed as
`c_void_p`, integers as `c_int`, scalars as `c_float`. Every entry point
launches on the caller's stream and returns `cudaGetLastError()`, which
`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module on a
machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("flash_attention", "mrf", "stft", "dilated_conv", "norm", "conv_nlc", "geglu")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> str:
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no up-to-date library, one nvcc
    process per source, all started together. Returns seconds per build."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    errors, build_seconds = [], {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        with open(f"{out}.log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return build_seconds


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of a `-Xptxas -v` log: registers, bytes of
    spill stores and loads, stack frame and static shared memory."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                         spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def resources(name: str) -> Dict[str, object]:
    """What ptxas reported at the build of csrc/<name>.cu: `kernels` as
    `parse_ptxas` gives them and `performance_warnings`, its lines on
    potential performance loss (serialised wgmma for want of registers)."""
    load(name)
    with open(f"{_lib_path(name)}.log") as f:
        log = f.read()
    warnings = [line.strip()[:200] for line in log.splitlines() if "Performance Loss" in line]
    return {"kernels": parse_ptxas(log), "performance_warnings": warnings}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
