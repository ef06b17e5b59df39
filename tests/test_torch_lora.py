"""The port's LoRA (consistencytta_torch/training/lora.py) against the JAX
package's (consistencytta_tpu/training/lora.py), the cases of
tests/test_lora.py: every attention projection adapted, the adapted UNet
equal to its base at init, the merge against JAX's for the same factors,
two LoRA steps (loss, then the student's, target's and EMA's factors)
against the JAX LoRA step with the same factors, batches and draws, and
accumulation equal to the mean of the micro-batches' updates.

Tolerances as in tests/torch_training_common.py: forward quantities within
1e-4 of scale; factors after n Adam steps within 2e-3 of one learning rate
per step (the tests' Adam epsilon of 1e-3 keeps an update smooth in its
gradient); the merge within two float32 roundings of the weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.models.pipeline import PipelineParams
from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.training import lora as jlora
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
from consistencytta_torch.io import from_jax
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.training import lora, step
from tests import torch_training_common as common

HEUN_STEPS = 18


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_side():
    return common.make_jax_side()


def _lora_state(params, config=None):
    port = common.make_port(params)
    return port, lora.init_lora_state(port, config or common.optimizer_configs()[1])


def test_init_covers_all_attention_projections(jax_side):
    _, params, _ = jax_side
    _, state = _lora_state(params)
    factors = state.student
    jfactors = jlora.init_lora_params(params.student, rank=4)
    # 16 transformers at the tiny geometry, attn1 and attn2, 4 projections
    assert len(factors.names) == 16 * 2 * 4
    assert len(list(factors.parameters())) == len(jax.tree_util.tree_leaves(jfactors))
    assert lora.lora_param_count(factors) == jlora.lora_param_count(jfactors)
    sd = from_jax.lora_state_dict(jfactors, factors.names)
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in factors.state_dict().items()}
    assert all(not p.requires_grad for p in state.lora_base.parameters())
    assert all(p.requires_grad and p.dtype == torch.float32 for p in factors.parameters())
    assert [p for g in state.optimizer.param_groups for p in g["params"]] == \
        list(factors.parameters())
    # the factors of one seed are the same numbers on any device
    assert torch.equal(lora.init_lora_params(state.lora_base, seed=0).a[3], factors.a[3])


def test_merge_identity_at_init(jax_side):
    _, params, _ = jax_side
    port, state = _lora_state(params)
    base = state.lora_base.state_dict()
    merged = lora.merged_state_dict(state.lora_base, state.student)
    assert sorted(merged) == sorted(base)
    assert all(torch.equal(merged[k], base[k]) for k in base)
    batch = common.make_batch(2)
    text = port.encode_text(batch["ids"], batch["mask"])
    z = torch.randn(2, *common.LATENT, generator=torch.Generator().manual_seed(0))
    args = (z, torch.tensor([500.0, 20.0]), text, torch.as_tensor(batch["mask"]),
            torch.tensor([1.0, 4.0]))
    with torch.no_grad():
        assert torch.equal(lora.LoRAUNet(state.lora_base, state.student)(*args),
                           state.lora_base(*args))


def test_merge_matches_jax_after_an_update(jax_side):
    _, params, _ = jax_side
    _, state = _lora_state(params)
    bumped = jax.tree_util.tree_map(lambda x: x + 0.01,
                                    jlora.init_lora_params(params.student, rank=4))
    state.student.load_state_dict(from_jax.lora_state_dict(bumped, state.student.names))
    want = from_jax.unet_state_dict(jlora.merge_lora(params.student, bumped),
                                    PipelineConfig.tiny().unet)
    got = lora.merged_state_dict(state.lora_base, state.student)
    moved = 0
    for k, v in want.items():
        ulps = 2 * np.finfo(np.float32).eps * float(v.abs().max())
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=ulps, rtol=0, err_msg=k)
        moved += not torch.equal(got[k], state.lora_base.state_dict()[k])
    assert moved == len(state.student.names)


def test_is_lora_tree(jax_side):
    _, params, _ = jax_side
    _, state = _lora_state(params)
    assert lora.is_lora_tree(state.student)
    assert lora.is_lora_tree(state.student.state_dict())
    assert not lora.is_lora_tree(state.lora_base)
    assert not lora.is_lora_tree(state.lora_base.state_dict())
    assert not lora.is_lora_tree({})
    assert not lora.is_lora_tree({"a.0": torch.zeros(1)})


@pytest.fixture(scope="module")
def steps(jax_side):
    """Two LoRA steps on both sides from the same factors (JAX's init,
    bumped so that B is not zero), batches and draws."""
    jp, params, frozen = jax_side
    frozen = PipelineParams(teacher=frozen.teacher, vae=frozen.vae, vocoder=frozen.vocoder,
                            t5=frozen.t5, student=params.student)
    jcfg, tcfg = common.optimizer_configs()
    tx = joptim.make_optimizer(jcfg)
    js = jsched.make_heun_schedule(jsched.SchedulerConfig(), HEUN_STEPS)
    factors0 = jax.tree_util.tree_map(
        lambda x: x + 0.01, jlora.init_lora_params(params.student, rank=4,
                                                   rng=jax.random.PRNGKey(2)))
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), student=copy(factors0),
                              student_target=copy(factors0), student_ema=copy(factors0),
                              opt_state=tx.init(factors0))
    jrun = jax.jit(jlora.build_lora_consistency_train_step(
        jp, js, tx, jstep.ConsistencyStepConfig()))

    port, state = _lora_state(params, tcfg)
    sd = from_jax.lora_state_dict(factors0, state.student.names)
    for role in (state.student, state.student_target, state.student_ema):
        role.load_state_dict(sd)
    run = lora.build_lora_consistency_train_step(
        port, sched.make_heun_schedule(SchedulerConfig(), HEUN_STEPS),
        step.ConsistencyStepConfig())
    metrics = []
    for i in range(2):
        batch = common.make_batch(2, seed=i)
        rng = jax.random.PRNGKey(20 + i)
        jstate, jm = jrun(jstate, frozen, batch, rng)
        metrics.append((run(state, batch, draws=common.stage2_draws(rng, 2, HEUN_STEPS)), jm))
    return metrics, state, jstate, sd


@pytest.mark.parametrize("i", [0, 1], ids=["first_step", "second_step"])
def test_lora_step_loss_matches(steps, i):
    got, want = steps[0][i]
    assert got["loss_finite"] and bool(want["loss_finite"])
    common.close(got["loss"], want["loss"])


def test_lora_factors_target_and_ema_match_after_two_steps(steps):
    _, state, jstate, start = steps
    assert state.step == int(jstate.step) == 2
    tol = 2e-3 * common.LR * 2
    names = state.student.names
    for role in ("student", "student_target", "student_ema"):
        want = from_jax.lora_state_dict(getattr(jstate, role), names)
        got = getattr(state, role).state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol, rtol=0,
                                       err_msg=f"{role}.{k}")
    # the factors moved; the frozen base did not
    got = state.student.state_dict()
    moves = [(got[k] - v).abs().max() for k, v in start.items()]
    assert min(moves) > 0 and max(moves) > 0.1 * common.LR
    base = from_jax.unet_state_dict(common.make_jax_side()[1].student,
                                    PipelineConfig.tiny().unet)
    assert all(torch.equal(v, base[k]) for k, v in state.lora_base.state_dict().items())


def test_accumulation_matches_the_mean_of_micro_batch_updates(jax_side):
    """accum_steps=2 against two single micro-batch steps under SGD, where
    the update is linear in the gradient: the accumulated update is the mean
    of the two, given the draws each micro-batch takes."""
    _, params, _ = jax_side
    heun = sched.make_heun_schedule(SchedulerConfig(), HEUN_STEPS)
    batch = common.make_batch(4, seed=9)
    keys = jax.random.split(jax.random.PRNGKey(42), 2)
    draws = [common.stage2_draws(k, 2, HEUN_STEPS) for k in keys]
    micro = [{k: v[2 * i:2 * i + 2] for k, v in batch.items()} for i in range(2)]

    def update(accum, b, d):
        port, state = _lora_state(params)
        start = torch.optim.SGD(state.student.parameters(), lr=0.1)
        state.optimizer = start
        state.lr_scheduler = torch.optim.lr_scheduler.LambdaLR(start, lambda s: 1.0)
        before = [p.detach().clone() for p in state.student.parameters()]
        run = lora.build_lora_consistency_train_step(
            port, heun, step.ConsistencyStepConfig(accum_steps=accum, snr_gamma=None))
        loss = run(state, b, draws=d)["loss"]
        return loss, [p.detach() - p0 for p, p0 in zip(state.student.parameters(), before)]

    loss_acc, d_acc = update(2, batch, draws)
    (l0, d0), (l1, d1) = update(1, micro[0], draws[0]), update(1, micro[1], draws[1])
    torch.testing.assert_close(loss_acc, (l0 + l1) / 2, rtol=1e-5, atol=0)
    assert any(x.abs().max() > 0 for x in d_acc)
    for da, x0, x1 in zip(d_acc, d0, d1):
        torch.testing.assert_close(da, (x0 + x1) / 2, rtol=1e-4, atol=1e-6)
