"""Data-parallel training over processes: the port's counterpart of the JAX
package's parallel/mesh.py.

The reference trains with DDP through Accelerate (an NCCL all-reduce of the
gradients at `accelerator.backward`); the JAX package shards the batch over
a `data` mesh axis, lets XLA insert that all-reduce, and adds ZeRO-1: the
AdamW moments and the EMA shadows are split over the axis, so that each
device keeps and updates about 1/N of them. Here that is one process per
rank, `torch.distributed` between them:

  * `make_mesh` joins the process group: NCCL with rank r on `cuda:r`, or
    gloo on the host (the CPU analogue of the JAX tests' 8-device host
    mesh), or gloo ranks that share one card (NCCL refuses two ranks on one
    device). `spawn` starts the ranks on a free localhost port. The JAX
    package's `model` axis, reserved and of size 1 everywhere (the UNet fits
    one device), is not ported.
  * `shard_batch`: rank r takes, from each of the step's `accum`
    micro-batches of the global batch, its r-th contiguous block, which is
    the JAX step's layout: its micro-batch i is rows [i B/a, (i+1) B/a) of
    the global batch, split over `data`. With one micro-batch that is the
    r-th contiguous block of the batch.
  * `RankGenerator`: every rank seeds the same generator and makes each
    draw at the global micro-batch's size, keeping its own rows, as
    `jax.random` draws at the global shape whatever the sharding: a row's
    noise does not depend on the rank count, and no two ranks draw alike.
  * ZeRO-1 (`shard_train_state`, `Zero1`): the trainable parameters (and
    each EMA shadow) are seen as one flat vector, cut into `world` equal
    ranges; rank r owns range r. Its AdamW runs over `nn.Parameter`s that
    alias its ranges of the parameters, so it holds the moments of those
    elements only, and its EMA shadows keep only their own ranges
    (`ShadowShard`). AdamW and the EMA are elementwise, so any partition
    gives the replicated result. One step: gradients accumulated locally;
    the mean gradient and the mean loss all-reduced in buckets; the
    non-finite guard and `max_grad_norm` applied to those global values
    (so every rank takes or skips the update alike); AdamW on the owned
    range; every owner broadcasts its range of the updated parameters, so
    each rank holds the whole student again; the EMAs update their ranges.
    gloo has no reduce-scatter, so the step uses only `all_reduce` and
    `broadcast`, which both backends have, and the same code runs on the
    CPU tests and on the card.
    The target network stays replicated: every rank's forward reads it
    whole in every micro-batch, so a sharded target would have to be
    all-gathered into a full copy each step (4 bytes a parameter more of
    traffic) and would lower no peak; it costs 4 bytes a parameter on
    every rank, the EMA shard 4 / N and the moments 8 / N.
  * `sharded_step` runs a `build_*_train_step` step on the rank's rows of
    a global batch; `sharded_eval` runs a function on the rank's rows and
    gathers the outputs in row order.
"""

from __future__ import annotations

import copy
import socket
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

BUCKET = 1 << 24  # elements of one collective (64 MB of float32)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group."""

    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes logs and checkpoints."""
        return self.rank == 0


def make_mesh(rank: int, world: int, init_method: str, devices: Sequence,
              backend: Optional[str] = None) -> Mesh:
    """Join the process group as `rank` of `world` and return the rank's
    Mesh. `devices` holds one device per rank (the JAX `make_mesh(devices=
    ...)`); `backend` defaults to NCCL for cards, gloo for the host. NCCL
    takes one rank a card; gloo ranks may share one."""
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a world of {world}")
    device = devices[rank]
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("name each rank's card: cuda:<index>")
        if device.index >= torch.cuda.device_count():
            raise ValueError(f"{device} requested, {torch.cuda.device_count()} cards present")
        torch.cuda.set_device(device)
    if backend == "nccl" and len(set(devices)) < world:
        raise ValueError("NCCL takes one rank a card; ranks that share a card need gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return Mesh(rank, world, device)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, init_method, devices, backend, args):
    mesh = make_mesh(rank, world, init_method, devices, backend)
    if mesh.device.type == "cpu":  # the host's cores, shared among its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, devices: Sequence, backend: Optional[str] = None,
          args: tuple = ()) -> None:
    """Run fn(mesh, *args) in `world` fresh processes, one a rank, joined
    on a free localhost port; returns when all have ended, and raises if
    one failed (the others are then stopped). `fn` and `args` are pickled:
    `fn` must be importable by name."""
    init_method = f"tcp://localhost:{free_port()}"
    torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, world, init_method, list(map(str, devices)), backend, args),
        nprocs=world, join=True, start_method="spawn")


# -- the batch ----------------------------------------------------------------


def shard_rows(n: int, mesh: Mesh, accum: int = 1) -> np.ndarray:
    """The rows of a global batch of n that the rank takes: from each of the
    `accum` micro-batches, its block of n / (accum * world) rows."""
    if n % (accum * mesh.world):
        raise ValueError(f"a batch of {n} does not split into {accum} micro-batches "
                         f"over {mesh.world} ranks")
    micro, m = n // accum, n // (accum * mesh.world)
    return np.concatenate([np.arange(i * micro + mesh.rank * m, i * micro + (mesh.rank + 1) * m)
                           for i in range(accum)])


def shard_batch(batch, mesh: Mesh, accum: int = 1):
    """The rank's rows (`shard_rows`) of every entry of a batch dict (numpy
    arrays, tensors or lists of per-row values, such as the captions)."""
    n = len(next(iter(batch.values())))
    rows = shard_rows(n, mesh, accum)
    take = lambda v: [v[i] for i in rows] if isinstance(v, list) else v[rows]
    return {k: take(v) for k, v in batch.items()}


@dataclass
class RankGenerator:
    """A generator seeded alike on every rank, whose draws a step makes at
    the global micro-batch (`world` times the rank's rows), keeping the
    rank's block (training/step.py's sampler reads it)."""

    generator: torch.Generator
    rank: int
    world: int

    def rows(self, draw: Callable[[int], torch.Tensor], b: int) -> torch.Tensor:
        """draw(n) for the global n, the rank's b rows of it."""
        return draw(b * self.world)[self.rank * b:(self.rank + 1) * b]


# -- collectives --------------------------------------------------------------


def flat_views(tensors: Sequence[torch.Tensor], lo: int, hi: int) -> List[torch.Tensor]:
    """The 1-D views that cover [lo, hi) of the tensors' concatenated flat
    elements, in order."""
    views, start = [], 0
    for t in tensors:
        end = start + t.numel()
        if end > lo and start < hi:
            views.append(t.view(-1)[max(lo - start, 0):min(hi, end) - start])
        if end >= hi:
            break
        start = end
    return views


def _scatter(buf: torch.Tensor, views: Sequence[torch.Tensor]) -> None:
    """Copy a flat buffer into consecutive views."""
    offset = 0
    for v in views:
        v.copy_(buf[offset:offset + v.numel()])
        offset += v.numel()


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replace every tensor by its mean over the ranks, in place; one
    all-reduce a bucket of their concatenated elements (one dtype)."""
    total = sum(t.numel() for t in tensors)
    for lo in range(0, total, BUCKET):
        views = flat_views(tensors, lo, min(lo + BUCKET, total))
        buf = torch.cat(views)
        dist.all_reduce(buf)
        _scatter(buf.div_(mesh.world), views)


@torch.no_grad()
def broadcast_owned(mesh: Mesh, bounds: Sequence[tuple], owned: Sequence[torch.Tensor],
                    dest: Optional[Sequence[torch.Tensor]], dtype=torch.float32) -> None:
    """Every owner's range of a flat vector to every rank: rank o holds
    [lo_o, hi_o) = bounds[o] as the pieces `owned`, and `dest` (full-size
    tensors whose concatenation is the vector, or None to receive nothing)
    takes every other owner's values. One broadcast a bucket."""
    mine = bounds[mesh.rank][0]
    for o, (lo, hi) in enumerate(bounds):
        for start in range(lo, hi, BUCKET):
            stop = min(start + BUCKET, hi)
            if o == mesh.rank:
                buf = torch.cat(flat_views(owned, start - mine, stop - mine))
            else:
                buf = torch.empty(stop - start, dtype=dtype, device=mesh.device)
            dist.broadcast(buf, src=o)
            if o != mesh.rank and dest is not None:
                _scatter(buf, flat_views(dest, start, stop))


def agree(flag: bool, mesh: Mesh) -> bool:
    """Rank 0's value of a decision, on every rank."""
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    dist.broadcast(t, src=0)
    return bool(t.item())


# -- ZeRO-1 ---------------------------------------------------------------------


def partition(numels: Sequence[int], world: int) -> List[tuple]:
    """Each rank's range [lo, hi) of a flat vector of sum(numels) elements:
    `world` consecutive ranges of ceil(total / world) (the last shorter),
    so that every element has one owner."""
    total = sum(numels)
    chunk = -(-total // world)
    return [(min(r * chunk, total), min((r + 1) * chunk, total)) for r in range(world)]


class ShadowShard:
    """A rank's ZeRO-1 part of an EMA shadow module: float32 copies of its
    owned range of the shadow's flat parameters (`pieces`); the module
    itself is kept on the meta device, shapes only. `training/ema.py`
    updates the pieces from the same range of the followed module."""

    def __init__(self, module: nn.Module, mesh: Mesh):
        if any(True for _ in module.buffers()):
            raise ValueError("a sharded EMA shadow holds parameters only")
        params = list(module.parameters())
        self.mesh = mesh
        self.bounds = partition([p.numel() for p in params], mesh.world)
        lo, hi = self.bounds[mesh.rank]
        self.pieces = [v.detach().clone() for v in flat_views(params, lo, hi)]
        self.module = module.to("meta")

    def views_of(self, module: nn.Module) -> List[torch.Tensor]:
        """The owned range of another module of the same architecture."""
        return flat_views(list(module.parameters()), *self.bounds[self.mesh.rank])

    @torch.no_grad()
    def gather(self) -> Optional[nn.Module]:
        """The whole shadow on the main rank (None elsewhere); every rank
        must call it."""
        full = None
        if self.mesh.is_main:
            full = copy.deepcopy(self.module).to_empty(device=self.mesh.device)
        dest = list(full.parameters()) if full is not None else None
        if dest is not None:
            _scatter(torch.cat(self.pieces) if self.pieces else dest[0].new_empty(0),
                     self.views_of(full))
        broadcast_owned(self.mesh, self.bounds, self.pieces, dest)
        return full

    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.pieces)


class ShardAdamW(torch.optim.AdamW):
    """AdamW over one rank's pieces of the trainable parameters
    (`nn.Parameter`s that alias the owned ranges). `zero_grad` clears the
    whole parameters' gradients too, as the replicated optimizer would."""

    def __init__(self, pieces, full_params, **hyper):
        super().__init__(pieces, **hyper)
        self.full_params = full_params

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        for p in self.full_params:
            p.grad = None


class Zero1:
    """The rank's part of the optimizer update of a sharded TrainState
    (`shard_train_state`); `training/step.py:guarded_update` hands it the
    step."""

    def __init__(self, mesh: Mesh, params: List[nn.Parameter], optimizer: ShardAdamW,
                 ranges: List[tuple]):
        self.mesh, self.params, self.optimizer, self.ranges = mesh, params, optimizer, ranges
        self.bounds = partition([p.numel() for p in params], mesh.world)

    @torch.no_grad()
    def update(self, state, loss: torch.Tensor) -> bool:
        """The replicated `guarded_update` on the global gradient: all-reduce
        the mean loss (written into `loss`) and gradients, skip on a
        non-finite value on any rank, clip, AdamW on the owned range, then
        every owner broadcasts its range of the parameters."""
        for p in self.params:
            if p.grad is None and not p.requires_grad:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params if p.grad is not None]
        mean_loss = loss.detach().float().reshape(1).clone()
        all_reduce_mean([mean_loss, *grads], self.mesh)
        loss.copy_(mean_loss[0])
        checks = torch.stack([mean_loss[0], *torch._foreach_norm(grads)])
        finite = bool(torch.isfinite(checks).all())
        if finite:
            if state.max_grad_norm is not None:
                torch.nn.utils.clip_grad_norm_(self.params, state.max_grad_norm)
            for piece, (i, a, b) in zip(self.optimizer.param_groups[0]["params"], self.ranges):
                g = self.params[i].grad
                piece.grad = None if g is None else g.view(-1)[a:b]
            self.optimizer.step()
            state.lr_scheduler.step()
            broadcast_owned(self.mesh, self.bounds, self._owned(), self.params)
        self.optimizer.zero_grad(set_to_none=True)
        return finite

    def _owned(self) -> List[torch.Tensor]:
        return [piece.detach() for piece in self.optimizer.param_groups[0]["params"]]

    def moment_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for s in self.optimizer.state.values()
                   for k, t in s.items() if k != "step")

    @torch.no_grad()
    def full_optimizer_state(self) -> Optional[dict]:
        """The replicated AdamW's state_dict, gathered onto the main rank
        (None elsewhere): every rank must call it."""
        pieces = self.optimizer.param_groups[0]["params"]
        steps = torch.zeros(len(self.params), dtype=torch.float64, device=self.mesh.device)
        for piece, (i, _, _) in zip(pieces, self.ranges):
            if piece in self.optimizer.state:
                steps[i] = float(self.optimizer.state[piece]["step"])
        dist.all_reduce(steps, op=dist.ReduceOp.MAX)
        main = self.mesh.is_main
        out = {}
        for key in ("exp_avg", "exp_avg_sq"):
            owned = [self.optimizer.state[p][key] if p in self.optimizer.state
                     else torch.zeros_like(p) for p in pieces]
            # on the host: the checkpoint writer's copy, off the card
            full = [torch.empty(p.shape, dtype=p.dtype) for p in self.params] if main else None
            if main:
                _scatter(torch.cat(owned) if owned else self.params[0].new_empty(0),
                         flat_views(full, *self.bounds[self.mesh.rank]))
            broadcast_owned(self.mesh, self.bounds, owned, full)
            out[key] = full
        if not main:
            return None
        group = {k: v for k, v in self.optimizer.param_groups[0].items() if k != "params"}
        state = {i: {"step": torch.tensor(float(steps[i])), "exp_avg": out["exp_avg"][i],
                     "exp_avg_sq": out["exp_avg_sq"][i]}
                 for i in range(len(self.params)) if steps[i] > 0}
        params = list(range(len(self.params)))
        return {"state": state, "param_groups": [{**group, "params": params}]}


SHADOWS = ("student_ema", "vae_dec_ema")  # sharded; the target stays replicated


def shard_train_state(state, mesh: Mesh):
    """ZeRO-1 placement of a replicated TrainState (or FTVAE or LoRA
    state), in place: its optimizer, with any moments it holds (a resumed
    state), becomes the rank's `ShardAdamW` over its range, its schedule
    follows, and the EMA shadows in `SHADOWS` become `ShadowShard`s. Every
    rank must hold the same state. Returns the state."""
    old = state.optimizer
    if len(old.param_groups) != 1:
        raise ValueError("ZeRO-1 takes an optimizer of one parameter group")
    params = list(old.param_groups[0]["params"])
    lo, hi = partition([p.numel() for p in params], mesh.world)[mesh.rank]
    ranges, start = [], 0
    for i, p in enumerate(params):
        a, b = max(lo - start, 0), min(hi, start + p.numel()) - start
        if a < b:
            ranges.append((i, a, b))
        start += p.numel()
    pieces = [nn.Parameter(params[i].detach().view(-1)[a:b]) for i, a, b in ranges]
    group = {k: v for k, v in old.param_groups[0].items() if k != "params"}
    optimizer = ShardAdamW(pieces, params)
    for piece, (i, a, b) in zip(pieces, ranges):
        full = old.state.get(params[i])
        if full:
            optimizer.state[piece] = {
                k: v.clone() if k == "step" else v.view(-1)[a:b].clone() for k, v in full.items()}
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, state.lr_scheduler.lr_lambdas[0])
    scheduler.load_state_dict(state.lr_scheduler.state_dict())
    optimizer.param_groups[0].update(group)  # the hyperparameters and the current rate
    state.optimizer, state.lr_scheduler = optimizer, scheduler
    state.zero1 = Zero1(mesh, params, optimizer, ranges)
    for name in SHADOWS:
        module = getattr(state, name, None)
        if module is not None:
            setattr(state, name, ShadowShard(module, mesh))
    return state


class _Gathered:
    """What save_checkpoint reads of a gathered optimizer."""

    def __init__(self, state_dict):
        self._state_dict = state_dict

    def state_dict(self):
        return self._state_dict


def gathered_state(state):
    """A replicated view of a sharded state on the main rank, for the
    checkpoint writer: the EMA shadows and the optimizer's moments gathered
    whole; None on the other ranks. Every rank must call it."""
    z = state.zero1
    shadows = {name: getattr(state, name).gather() for name in SHADOWS
               if isinstance(getattr(state, name, None), ShadowShard)}
    optimizer = z.full_optimizer_state()
    if not z.mesh.is_main:
        return None
    return replace(state, optimizer=_Gathered(optimizer), zero1=None, **shadows)


def held_bytes(state) -> dict:
    """The bytes of AdamW moments and EMA shadows this rank holds."""
    if getattr(state, "zero1", None) is not None:
        moments = state.zero1.moment_bytes()
    else:
        moments = sum(t.numel() * t.element_size() for s in state.optimizer.state.values()
                      for k, t in s.items() if k != "step")
    ema = 0
    for name in SHADOWS:
        m = getattr(state, name, None)
        if isinstance(m, ShadowShard):
            ema += m.nbytes()
        elif m is not None:
            ema += sum(p.numel() * p.element_size() for p in m.parameters())
    return {"moments": moments, "ema": ema}


# -- steps and evaluation ----------------------------------------------------------


def sharded_step(step_fn: Callable, mesh: Mesh, accum: int = 1) -> Callable:
    """step(state, batch, generator=None, draws=None) -> metrics for a
    state from `shard_train_state`: `step_fn` (a step made by
    training/step.py, lora.py or ftvae.py) on the rank's rows of the global
    `batch` (`shard_batch`), with the rank's rows of the per-row `draws`
    (a dict, or one a micro-batch) and a generator seeded alike on every
    rank (`RankGenerator`). The metrics' loss is the global mean."""

    def step(state, batch, generator=None, draws=None):
        if state.zero1 is None:
            raise ValueError("shard the state first: shard_train_state")
        if isinstance(draws, (list, tuple)):
            draws = [shard_batch(d, mesh) for d in draws]
        elif draws is not None:
            draws = shard_batch(draws, mesh, accum)
        if isinstance(generator, torch.Generator):
            generator = RankGenerator(generator, mesh.rank, mesh.world)
        return step_fn(state, shard_batch(batch, mesh, accum), generator, draws)

    return step


def sharded_eval(fn: Callable, mesh: Mesh, n_batch_args: int) -> Callable:
    """fn(params, *batch_args, *tail_args) on the rank's rows of each of
    the `n_batch_args` batch arguments (tensors, leading axis split), the
    params and the trailing arguments as given (the JAX version's
    replicated tail); the outputs (one tensor of rows) all-gathered in row
    order on every rank."""

    def run(params, *args):
        batch, tail = args[:n_batch_args], args[n_batch_args:]
        rows = torch.as_tensor(shard_rows(batch[0].shape[0], mesh))
        out = fn(params, *(a[rows.to(a.device)] for a in batch), *tail).contiguous()
        parts = [torch.empty_like(out) for _ in range(mesh.world)]
        dist.all_gather(parts, out)
        return torch.cat(parts)

    return run
