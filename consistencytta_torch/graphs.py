"""CUDA-graph replay of the four stage modules' frozen inference calls.

`T5Encoder`, `UNet2DConditionGuided`, the VAE `Decoder` and
`HiFiGANGenerator` run their forward through `run`, so a module call still
runs its forward pre- and post-hooks around it. A frozen inference call
replays a CUDA graph captured for its key; every other call runs the forward
eagerly, as does every call inside `eager()`. A call is a frozen inference
call when `refusals` finds nothing against it: its tensors are on CUDA, grad
mode is off, no autocast is active, no parameter of the module requires
grad, every argument is a tensor or None (a Python number would be baked
into the graph), no capture is under way already, and the module's weights
have not changed in place since its last call (below).

The key (`key`) is the data pointers of the module's parameters and buffers,
each argument's shape, strides, dtype and device, and whether inference mode
is on. The first call with a new key copies its arguments into static
inputs, captures the forward on a side stream into the module's memory pool,
and replays the graph. A module's first capture, and its first after its
weights are replaced, follows one eager warm-up call on that stream, for
the lazy set-up of cuBLAS, cuDNN and the kernels' libraries and of the
module's own weight copies. Later calls copy their arguments into the
static inputs and replay. The outputs are cloned before they are returned,
so a later replay never overwrites a caller's tensor; that, and one graph
replayed at a time on the caller's stream, is what lets a module's graphs
share one pool.

Weights: parameters replaced by new tensors change the key, and the
module's graphs are dropped and captured anew. An in-place update (a
load_state_dict into the same tensors, an EMA step) keeps the key and moves
the weights' version counters: the module's next call runs eagerly
("updated" in `refusals`) and records the new versions, and later calls
replay the graphs, which read the new values.

Counting: `utils.graph_counts` has the captures, replays and eager calls per
stage. The kernels' Python launch counters (`flash_mha_packed.launches` and
the others) count a call once, however it ran: the warm-up and the capture
leave them as they were, and each replay adds what the capture launched.
"""

from __future__ import annotations

import contextlib
import operator
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from consistencytta_torch.utils import count_graph

_eager_depth = 0  # open eager() contexts
_VERSION, _GRAD = operator.attrgetter("_version"), operator.attrgetter("requires_grad")
_counters: Optional[tuple] = None  # the kernels' launch-counting functions
_side_streams: Dict[torch.device, torch.cuda.Stream] = {}

# bumped whenever a module anywhere registers a submodule: a module's list of
# weight dicts is walked anew after that, and read from the list otherwise
_structure = 0


def _bump(module, name, submodule):
    global _structure
    _structure += 1


nn.modules.module.register_module_module_registration_hook(_bump)


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Calls inside run eagerly, as if no graph had been captured: for the
    tests' comparisons and the diagnostic tools' module spans."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, inputs):
        self.graph = torch.cuda.CUDAGraph()
        self.inputs = inputs
        self.outputs = None
        self.launches: List[int] = []


class _State:
    """A module's graphs, for the weight pointers they were captured with,
    in one memory pool."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.weights: Optional[tuple] = None
        self.versions: Optional[tuple] = None
        self.pool = None
        self.warm = False
        self.dicts: list = []  # the _parameters and _buffers dicts of its modules
        self.structure = -1


_STATES: "weakref.WeakKeyDictionary[nn.Module, _State]" = weakref.WeakKeyDictionary()


def _state(module: nn.Module) -> _State:
    state = _STATES.get(module)
    if state is None:
        state = _STATES[module] = _State()
    return state


def _weights(module: nn.Module, state: _State) -> Tuple[tuple, tuple, bool]:
    """(data pointers of the module's parameters and buffers, their version
    counters, whether a parameter requires grad)."""
    if state.structure != _structure:
        state.dicts = [d for m in module.modules() for d in (m._parameters, m._buffers) if d]
        state.structure = _structure
    ts = [t for d in state.dicts for t in d.values() if t is not None]
    return tuple(map(torch.Tensor.data_ptr, ts)), tuple(map(_VERSION, ts)), any(map(_GRAD, ts))


def _autocast() -> bool:
    return torch.is_autocast_enabled("cuda") or torch.is_autocast_enabled("cpu")


def _call_refusals(args) -> Iterator[str]:
    """What stands against a graph in the call itself, cheapest first."""
    if _eager_depth:
        yield "eager"
    tensors = [a for a in args if a is not None]
    if not all(isinstance(a, torch.Tensor) for a in tensors):
        yield "scalar"
    if not tensors or not all(isinstance(a, torch.Tensor) and a.is_cuda for a in tensors):
        yield "cpu"
    elif torch.cuda.is_current_stream_capturing():
        yield "capturing"
    if torch.is_grad_enabled():
        yield "grad"
    if _autocast():
        yield "autocast"


def refusals(module: nn.Module, *args) -> Tuple[str, ...]:
    """Why a call of `module` on `args` runs eagerly: the names of every
    condition it fails ("eager", "scalar", "cpu", "capturing", "grad",
    "autocast", "trainable", "updated": weights changed in place since the
    module's last call); () for a call that replays a graph."""
    out = list(_call_refusals(args))
    state = _state(module)
    weights, versions, trainable = _weights(module, state)
    if trainable:
        out.append("trainable")
    elif weights == state.weights and versions != state.versions:
        out.append("updated")
    return tuple(out)


def _call_key(args) -> tuple:
    """The arguments' shapes, strides, dtypes and devices, and inference
    mode: which of a module's graphs a call replays."""
    specs = tuple(None if a is None else (tuple(a.shape), a.stride(), a.dtype, a.device)
                  for a in args)
    return specs, torch.is_inference_mode_enabled()


def key(module: nn.Module, *args) -> tuple:
    """The key of a call's graph: the module's weight pointers and
    `_call_key`."""
    return _weights(module, _state(module))[0], *_call_key(args)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(t.clone() for t in out)


def _launch_counters() -> tuple:
    global _counters
    if _counters is None:
        from consistencytta_torch.ops import attention, dilated_conv, geglu, mrf, norm, stft

        _counters = (attention.flash_mha_packed, attention.flash_self_attention,
                     mrf.fused_mrf_level, mrf.wide_mrf_level, stft.stft_magnitude_cuda,
                     dilated_conv.dilated_conv1d, norm.group_norm, norm.layer_norm, norm.rms_norm,
                     *norm.rows_launches.values(), geglu.geglu)
    return _counters


def _side_stream(dev: torch.device) -> torch.cuda.Stream:
    s = _side_streams.get(dev)
    if s is None:
        s = _side_streams[dev] = torch.cuda.Stream(dev)
    return s


def _capture(state: _State, fn: Callable, args) -> _Graph:
    """Capture fn on static copies of `args` (after the module's one
    warm-up, if it has had none) and leave the launch counters as they
    were."""
    dev = next(a.device for a in args if a is not None)
    counters = _launch_counters()
    start = [f.launches for f in counters]
    rec = _Graph([None if a is None else torch.empty_like(a).copy_(a) for a in args])
    if state.pool is None:
        state.pool = torch.cuda.graph_pool_handle()
    current, side = torch.cuda.current_stream(dev), _side_stream(dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        if not state.warm:
            fn(*rec.inputs)
            state.warm = True
        before = [f.launches for f in counters]
        rec.graph.capture_begin(pool=state.pool, capture_error_mode="thread_local")
        try:
            rec.outputs = fn(*rec.inputs)
        finally:
            rec.graph.capture_end()
    current.wait_stream(side)
    rec.launches = [f.launches - n for f, n in zip(counters, before)]
    for f, n in zip(counters, start):
        f.launches = n
    return rec


def run(module: nn.Module, stage: str, fn: Callable, *args):
    """fn(*args), the eager forward of `module`: as a graph's replay where
    the call is a frozen inference call, else eagerly. `stage` names the
    module's stage in `utils.graph_counts`."""
    state = _state(module)
    weights, versions, trainable = _weights(module, state)
    updated = False
    if not trainable:  # a frozen forward, eager or replayed, reads these versions
        if weights != state.weights:
            state.graphs, state.weights, state.pool, state.warm = {}, weights, None, False
        else:
            updated = versions != state.versions
        state.versions = versions
    if trainable or updated or next(_call_refusals(args), None) is not None:
        count_graph(stage, "eager")
        return fn(*args)
    k = _call_key(args)
    rec = state.graphs.get(k)
    if rec is None:
        rec = state.graphs[k] = _capture(state, fn, args)
        count_graph(stage, "captures")
    else:
        for dst, a in zip(rec.inputs, args):
            if dst is not None:
                dst.copy_(a)
        count_graph(stage, "replays")
    rec.graph.replay()
    for f, n in zip(_launch_counters(), rec.launches):
        f.launches += n
    return _clone(rec.outputs)
