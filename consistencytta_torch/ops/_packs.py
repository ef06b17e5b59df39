"""Kernel-layout copies of weights, made once per weight version.

A kernel that reads its weights in a layout of its own (`ops/mrf.py`,
`ops/dilated_conv.py`), and the UNet transformer's zero-padded weights
(`nn/attention.py`), keep the copy here rather than making it at every
call. The key holds each tensor's storage address, shape, dtype and device;
the entry holds weak references to the tensors, their in-place version
counters and the pack, and is taken only while they all live at those
versions, so a storage freed and reused by other tensors can never hit it.
An in-place update (an optimizer or EMA step) gives a new pack in the same
entry, in constant time, so a training run's shadows, updated every step,
keep one pack each; new tensors give a new entry, and the entries of
tensors that died are dropped then. An in-place update must move the
version counter: on CUDA `torch._foreach_lerp_` and the fused AdamW do not
(torch 2.11), so `training/ema.py:ema_update` moves it itself.

While `graphs.run` captures a CUDA graph, a pack found here is handed to
that graph, which holds it and makes it anew in place when its weights
change in place; a pack made during the capture is made inside the graph,
so each replay makes it from the weights it reads, and it is not kept here.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Hashable, Sequence

import torch

from consistencytta_torch import graphs


def cached_pack(cache: "OrderedDict[tuple, tuple]", size: int,
                tensors: Sequence[torch.Tensor], extra: Hashable, make: Callable[[], object]):
    """`make()`, or the pack it gave for these tensors at their current
    versions; `cache` keeps at most `size` packs, the least recent dropped."""
    key = tuple((t.data_ptr(), tuple(t.shape), t.dtype, t.device) for t in tensors) + (extra,)
    versions = tuple(t._version for t in tensors)
    hit = cache.get(key)
    live = hit is not None and all(r() is t for r, t in zip(hit[0], tensors))
    capture = graphs.recording()
    if live and hit[2] == versions:
        cache.move_to_end(key)
        if capture is not None:
            capture.keep(tensors, hit[1], make)
        return hit[1]
    if not live:
        for k in [k for k, (refs, _, _) in cache.items() if any(r() is None for r in refs)]:
            del cache[k]
    pack = make()
    if capture is not None:
        return pack
    cache[key] = (tuple(weakref.ref(t) for t in tensors), pack, versions)
    cache.move_to_end(key)
    while len(cache) > size:
        cache.popitem(last=False)
    return pack
