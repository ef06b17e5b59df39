"""ZeRO-1 data parallelism of the port (consistencytta_torch/parallel/mesh.py)
on the CPU: the partition, the batch split and the ranks' draws in this
process; then two gloo ranks on the host (one spawn for the module) run each
step variant the training CLI ships (tests/test_zero1_variants.py's list:
stage 2 with Heun and accumulation, DDIM, stage 1 without a target, LoRA,
FTVAE) on their rows of a global batch with given draws, and each is held
to the port's single-rank step on the whole batch (itself held to the JAX
steps by test_torch_train_step, _stage1, _lora, _ftvae and _train_ddim):
loss, student, target, EMA shadows and AdamW moments, gathered by the
checkpoint writer, within tests/torch_zero1_common.py's tolerances; every
rank holds the same student and about 1/N of the moments and EMA bytes. A
NaN in one rank's rows skips the update on both ranks; `sharded_eval`
gathers its outputs in row order.
"""


import numpy as np
import pytest
import torch
from torch import nn

from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.parallel import mesh as pm
from consistencytta_torch.training import step
from consistencytta_torch.training.optim import OptimizerConfig, make_optimizer
from tests import torch_zero1_common as zc

JOBS = {
    "heun": zc.job("heun", rows=4, accum=2, steps=2),
    "ddim": zc.job("ddim"),
    "stage1": zc.job("stage1"),
    "lora": zc.job("lora"),
    "ftvae": zc.job("ftvae"),
    "nan": zc.job("heun", nan_rank=1),
}
EVAL = {"x": np.random.default_rng(5).standard_normal((6, 3)).astype(np.float32),
        "params": np.random.default_rng(6).standard_normal((3, 2)).astype(np.float32)}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _meshes(world):
    return [pm.Mesh(r, world, torch.device("cpu")) for r in range(world)]


class _Odd(nn.Module):
    """Parameters whose sizes no rank count divides."""

    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.randn(7, 5))
        self.b = nn.Parameter(torch.randn(1))
        self.c = nn.Parameter(torch.randn(300))
        self.d = nn.Parameter(torch.randn(3, 3))


def _odd_state():
    torch.manual_seed(0)
    student, ema = _Odd(), _Odd()
    ema.load_state_dict(student.state_dict())
    optimizer, sched = make_optimizer(list(student.parameters()), OptimizerConfig())
    return step.TrainState(0, student, None, ema, optimizer, sched)


@pytest.mark.parametrize("world", [2, 3])
def test_partition_gives_every_element_one_owner(world):
    total = sum(p.numel() for p in _Odd().parameters())
    bounds = pm.partition([p.numel() for p in _Odd().parameters()], world)
    owned = np.zeros(total, int)
    per_rank = []
    for mesh in _meshes(world):
        state = _odd_state()
        params = list(state.student.parameters())
        pm.shard_train_state(state, mesh)
        lo, hi = bounds[mesh.rank]
        pieces = state.optimizer.param_groups[0]["params"]
        assert sum(p.numel() for p in pieces) == hi - lo
        # the pieces alias the student's storage: AdamW updates it in place
        flat = torch.cat([p.detach().view(-1) for p in params])
        assert torch.equal(torch.cat([p.detach() for p in pieces]), flat[lo:hi])
        assert all(any(p.data_ptr() <= q.data_ptr() < p.data_ptr() + 4 * p.numel()
                       for p in params) for q in pieces)
        owned[lo:hi] += 1
        for q in pieces:  # one update creates the moments
            q.grad = torch.ones_like(q)
        state.optimizer.step()
        held = pm.held_bytes(state)
        per_rank.append(held)
        assert held["moments"] <= 2 * 4 * -(-total // world)
        assert held["ema"] <= 4 * -(-total // world)
        assert state.student_ema.module.c.is_meta
    assert (owned == 1).all()
    assert sum(h["moments"] for h in per_rank) == 2 * 4 * total
    assert sum(h["ema"] for h in per_rank) == 4 * total


@pytest.mark.parametrize("accum", [1, 2, 3])
def test_shard_rows_take_each_micro_batch_block(accum):
    world, n = 2, 12
    rows = [pm.shard_rows(n, m, accum) for m in _meshes(world)]
    assert sorted(np.concatenate(rows)) == list(range(n))
    micro = n // accum
    for r, got in enumerate(rows):
        m = micro // world
        want = [i * micro + r * m + j for i in range(accum) for j in range(m)]
        assert list(got) == want
    batch = {"wav": np.arange(n * 2).reshape(n, 2), "captions": [f"c{i}" for i in range(n)],
             "ids": torch.arange(n)}
    part = pm.shard_batch(batch, _meshes(world)[1], accum)
    assert part["captions"] == [f"c{i}" for i in rows[1]]
    assert torch.equal(part["ids"], torch.as_tensor(rows[1]))
    with pytest.raises(ValueError, match="does not split"):
        pm.shard_rows(10, _meshes(3)[0], accum)


def test_rank_generators_draw_the_single_rank_rows():
    """Each rank's draws are its rows of the one-rank draws at the global
    size, and the ranks' rows differ."""
    b, world = 3, 2
    want = step._Sampler("cpu", torch.Generator().manual_seed(4), None)
    want = [want.normal("eps", (b * world, 2, 2)), want.randint("u", b * world, 17),
            want.uniform("w", b * world), want.bernoulli("drop", b * world, 0.5)]
    for r in range(world):
        s = step._Sampler("cpu", pm.RankGenerator(torch.Generator().manual_seed(4), r, world),
                          None)
        got = [s.normal("eps", (b, 2, 2)), s.randint("u", b, 17), s.uniform("w", b),
               s.bernoulli("drop", b, 0.5)]
        for g, w in zip(got, want):
            assert torch.equal(g, w[r * b:(r + 1) * b])
    assert not torch.equal(want[0][:b], want[0][b:])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The jobs on two gloo ranks, and the pipeline file they started from."""
    d = tmp_path_factory.mktemp("zero1")
    pipeline_file = str(d / "pipeline.pt")
    zc.save_pipeline(Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                                     seed=7, roles=zc.STAGE2_ROLES, training=True),
                     pipeline_file)
    results = zc.spawn_jobs(pipeline_file, {**JOBS, "eval": {"kind": "eval", **EVAL}}, str(d))
    return {"dir": str(d), "pipeline": pipeline_file, "results": results}


@pytest.mark.parametrize("name", ["heun", "ddim", "stage1", "lora", "ftvae"])
def test_two_ranks_match_one(ranks, name):
    spec = JOBS[name]
    state, metrics = zc.run_single(spec, ranks["pipeline"])
    recs = ranks["results"][name]
    zc.assert_matches_single(ranks["dir"], name, recs, state, metrics, len(spec["batches"]))
    assert recs[0]["before"] != recs[0]["student"]  # the update moved the student
    # each rank holds about half of the moments and of the EMA shadows
    n, n_ema = recs[0]["n_params"], recs[0]["n_ema"]
    for rec in recs:
        assert rec["held"]["moments"] <= 2 * 4 * -(-n // 2)
        # the student's shadow over its own range; an FTVAE decoder's too
        assert rec["held"]["ema"] <= 4 * (-(-n_ema // 2) - (-(n - n_ema) // 2))
    assert sum(r["held"]["moments"] for r in recs) == 2 * 4 * n


def test_a_nan_on_one_rank_skips_the_update_on_both(ranks):
    recs = ranks["results"]["nan"]
    for rec in recs:
        assert rec["finite"] == [False] and np.isnan(rec["losses"][0])
        assert rec["student"] == rec["before"]  # untouched
        assert rec["step"] == 1 and rec["held"]["moments"] == 0
    state, metrics = zc.run_single(JOBS["nan"], ranks["pipeline"])
    assert not metrics[0]["loss_finite"]


def test_sharded_eval_gathers_rows_in_order(ranks):
    x, w = torch.from_numpy(EVAL["x"]), torch.from_numpy(EVAL["params"])
    for r, rec in enumerate(ranks["results"]["eval"]):
        torch.testing.assert_close(rec["out"], x @ w)
        assert len(rec["seen"]) == 1 and torch.equal(rec["seen"][0], x[3 * r:3 * (r + 1)])
