"""A 2-rank ZeRO-1 stage-2 step of the port (two gloo processes on the host,
consistencytta_torch/parallel/mesh.py) against the JAX package's
`sharded_step(..., state_example=state)` on a 2-device mesh, the same
weights, the same global batch of 4 and the same per-row draws, made from
the JAX step's own key splits (tests/torch_training_common.py): the loss,
the student, target and EMA (the port's gathered by its checkpoint writer)
within that file's tolerances, and the AdamW moments within 1e-3 of their
largest magnitude (gradients in another summation order). The one JAX
step of this file is jit-compiled once.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.parallel import mesh as jmesh
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.io import checkpoints as ck
from consistencytta_torch.io import from_jax
from tests import torch_training_common as common
from tests import torch_zero1_common as zc

ROWS = 4


class _Loaded:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero1_jax")
    jp, params, frozen = common.make_jax_side()
    pipeline_file = str(d / "pipeline.pt")
    zc.save_pipeline(common.make_port(params), pipeline_file)
    batch = common.make_batch(ROWS, seed=0)
    rng = jax.random.PRNGKey(10)
    draws = common.stage2_draws(rng, ROWS, zc.HEUN_STEPS)

    jcfg, _ = common.optimizer_configs()
    tx = joptim.make_optimizer(jcfg)
    mesh = jmesh.make_mesh(devices=jax.devices()[:2])
    state = jstep.TrainState.create(params, tx)
    fn = jstep.build_consistency_train_step(
        jp, jsched.make_heun_schedule(jsched.SchedulerConfig(), zc.HEUN_STEPS), tx,
        jstep.ConsistencyStepConfig())
    run = jmesh.sharded_step(fn, mesh, donate_state=False, state_example=state)
    jstate, jm = run(jmesh.shard_train_state(state, mesh),
                     jmesh.device_put_replicated(frozen, mesh),
                     jmesh.device_put_batch(batch, mesh), rng)
    jstate = jax.device_get(jstate)

    spec = {"kind": "heun", "accum": 1, "batches": [batch], "draws": [draws]}
    recs = zc.spawn_jobs(pipeline_file, {"heun": spec}, str(d))["heun"]
    model = torch.load(str(d / "heun" / ck.MODEL_FILE), weights_only=True)
    opt = torch.load(str(d / "heun" / ck.OPTIMIZER_FILE), weights_only=True)
    names = [n for n, _ in zc.load_pipeline(pipeline_file).unets["student"].named_parameters()]
    return recs, model, opt, names, jstate, float(jm["loss"])


def test_loss_is_the_global_mean(runs):
    recs, _, _, _, _, jloss = runs
    for rec in recs:
        assert rec["finite"] == [True]
        common.close(torch.tensor(rec["losses"][0]), np.float32(jloss))


@pytest.mark.parametrize("role", ["student", "student_target", "student_ema"])
def test_roles_match_jax(runs, role):
    recs, model, _, _, jstate, _ = runs
    sd = ck.strip_prefix(model, f"{role}_unet.")
    common._assert_unet(_Loaded(sd), getattr(jstate, role), 2e-3 * common.LR)
    assert len({r["student"] for r in recs}) == 1


@pytest.mark.parametrize("moment", [("exp_avg", "mu"), ("exp_avg_sq", "nu")])
def test_moments_match_jax(runs, moment):
    _, _, opt, names, jstate, _ = runs
    ours, theirs = moment
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    want = from_jax.unet_state_dict(getattr(adam[0], theirs), PipelineConfig.tiny().unet)
    assert sorted(want) == sorted(names) and len(opt["state"]) == len(names)
    scale = max(float(v.abs().max()) for v in want.values())
    assert scale > 0
    for i, name in enumerate(names):
        np.testing.assert_allclose(opt["state"][i][ours].numpy(), want[name].numpy(),
                                   atol=1e-3 * scale, rtol=0, err_msg=name)
        assert float(opt["state"][i]["step"]) == 1.0
