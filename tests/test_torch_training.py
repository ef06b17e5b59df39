"""The port's stage-2 forward (consistencytta_torch/training/step.py) against
the JAX package's, the non-finite guard of the train step, the optimizer and
learning-rate schedule against optax, and the pipeline's training roles.
The optimizer steps themselves are held against the JAX package in
tests/test_torch_train_step.py (stage 2), test_torch_stage1.py and
test_torch_validation.py. See tests/torch_training_common.py for the set-up
and the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_tpu.training import optim as joptim
from consistencytta_tpu.training import step as jstep
from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.training import optim, step
from consistencytta_torch.training.ema import ema_update
from tests import torch_training_common as common
from tests.torch_training_common import FOURIER, ROLES, make_batch, stage2_draws


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_side():
    return common.make_jax_side()


@pytest.fixture(scope="module")
def port(jax_side):
    """A port pipeline that the tests using it do not modify."""
    return common.make_port(jax_side[1])


# -- the forward -------------------------------------------------------------


@pytest.fixture(scope="module")
def forward(jax_side, port):
    """A 3-step schedule, so that both special cases occur in one batch:
    u == 0 (the resample to pure noise) and t_next == 0 (the target is the
    ground truth)."""
    jp, params, frozen = jax_side
    b, n = 4, 3
    js = jsched.make_heun_schedule(jsched.SchedulerConfig(), n)
    ts = sched.make_heun_schedule(SchedulerConfig(), n)
    batch = make_batch(b)
    rng = jax.random.PRNGKey(0)
    draws = stage2_draws(rng, b, n)
    assert set(draws["u"].tolist()) == {0, 1}
    jfn = jax.jit(lambda student, target, fr, micro, key: jstep.consistency_forward(
        jp, js, jstep.ConsistencyStepConfig(), student, target, fr, micro, key))
    want = jfn(params.student, params.student_target, frozen, batch, rng)
    with torch.no_grad():
        got = step.consistency_forward(
            port, ts, step.ConsistencyStepConfig(), port.unets["student"],
            port.unets["student_target"], batch, draws=draws)
    return got, want, batch, draws, ts


@pytest.mark.parametrize("i,name", [(0, "student_prediction"), (1, "target"), (2, "snr")])
def test_consistency_forward_matches(forward, i, name):
    got, want = forward[0], forward[1]
    common.close(got[i], want[i])


def test_target_is_the_ground_truth_where_t_next_is_zero(forward, port):
    got, _, batch, draws, ts = forward
    z0 = port.encode_audio(batch["wav"], noise=draws["posterior_noise"])
    at_zero = torch.from_numpy(draws["u"] == ts.num_steps - 2)
    assert at_zero.any() and not at_zero.all()
    assert torch.equal(got[1][at_zero], z0[at_zero])
    assert not torch.equal(got[1][~at_zero], z0[~at_zero])


def test_uncondition_swaps_the_dropped_rows_to_the_empty_prompt(forward, port):
    """`uncondition` with a given drop mask is the plain forward on a batch
    whose dropped rows carry the unconditional tokens."""
    _, _, batch, draws, ts = forward
    drop = np.array([False, True, False, True])
    swapped = dict(batch, ids=np.where(drop[:, None], batch["uncond_ids"], batch["ids"]),
                   mask=np.where(drop[:, None], batch["uncond_mask"], batch["mask"]))
    unets = port.unets
    with torch.no_grad():
        got = step.consistency_forward(
            port, ts, step.ConsistencyStepConfig(uncondition=True), unets["student"],
            unets["student_target"], batch, draws=dict(draws, drop=drop))
        want = step.consistency_forward(
            port, ts, step.ConsistencyStepConfig(), unets["student"],
            unets["student_target"], swapped, draws=draws)
        plain = step.consistency_forward(
            port, ts, step.ConsistencyStepConfig(), unets["student"],
            unets["student_target"], batch, draws=draws)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0][~drop], plain[0][~drop])
    assert not torch.equal(got[0][drop], plain[0][drop])


def test_remat_student_gives_the_same_gradient(port):
    ts = sched.make_heun_schedule(SchedulerConfig(), 18)
    batch = make_batch(2)
    draws = stage2_draws(jax.random.PRNGKey(1), 2, 18)
    student = port.unets["student"]
    grads = []
    for remat in (True, False):
        pred, target, _ = step.consistency_forward(
            port, ts, step.ConsistencyStepConfig(remat_student=remat), student,
            port.unets["student_target"], batch, draws=draws)
        assert pred.requires_grad and not target.requires_grad
        step.mse_instance(pred, target).mean().backward()
        grads.append(student.conv_in.weight.grad.clone())
        student.zero_grad(set_to_none=True)
    torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=1e-5)
    assert grads[0].abs().max() > 0


def test_forward_draws_from_generator_when_none_are_passed(port):
    ts = sched.make_heun_schedule(SchedulerConfig(), 18)
    batch = make_batch(2)
    cfg = step.ConsistencyStepConfig()
    unets = port.unets

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return step.consistency_forward(port, ts, cfg, unets["student"],
                                            unets["student_target"], batch, generator=g)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert all(torch.isfinite(t).all() for t in a)


# -- the non-finite guard ------------------------------------------------


def _snapshot(state):
    opt = [{k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in s.items()}
           for s in state.optimizer.state.values()]
    return {k: v.clone() for k, v in state.student.state_dict().items()}, opt


def _assert_untouched(state, snap):
    weights, opt = snap
    for k, v in state.student.state_dict().items():
        assert torch.equal(v, weights[k]), k
    now = list(state.optimizer.state.values())
    assert len(now) == len(opt)
    for a, b in zip(now, opt):
        for k, v in b.items():
            assert torch.equal(a[k], v) if isinstance(v, torch.Tensor) else a[k] == v


@pytest.fixture
def warm_state(jax_side):
    """(state, good step, batch, draws, schedule, port) after one good step,
    which fills the optimizer state."""
    n = 18
    ts = sched.make_heun_schedule(SchedulerConfig(), n)
    port = common.make_port(jax_side[1])
    state = step.TrainState.create(port, common.optimizer_configs()[1])
    good = step.build_consistency_train_step(port, ts)
    batch = make_batch(2)
    draws = stage2_draws(jax.random.PRNGKey(3), 2, n)
    assert good(state, batch, draws=draws)["loss_finite"]
    return state, good, batch, draws, ts, port


def test_nan_in_the_waveform_is_sanitised_by_the_frontend(warm_state):
    """As in the JAX package: the frontend's nan_to_num makes the step an
    ordinary one."""
    state, good, batch, draws, _, _ = warm_state
    before = state.student.conv_in.weight.detach().clone()
    bad = dict(batch, wav=batch["wav"].copy())
    bad["wav"][0, 7] = np.nan
    metrics = good(state, bad, draws=draws)
    assert metrics["loss_finite"] and torch.isfinite(metrics["loss"])
    assert not torch.equal(state.student.conv_in.weight, before)


@pytest.mark.parametrize("fault", ["nan_loss", "finite_loss_nan_grad"])
def test_non_finite_step_leaves_student_and_optimizer_untouched(warm_state, fault):
    state, good, batch, draws, ts, port = warm_state
    snap = _snapshot(state)
    shadows = [m.conv_in.weight.detach().clone()
               for m in (state.student_target, state.student_ema)]
    if fault == "nan_loss":
        poisoned = dict(draws, eps=draws["eps"].copy())
        poisoned["eps"][0, 0, 0, 0] = np.nan
        metrics = good(state, batch, draws=poisoned)
        assert not torch.isfinite(metrics["loss"])
    else:
        # sqrt has an infinite slope at 0: the loss is finite, its gradient not
        def loss_fn(pred, target, micro):
            return step.mse_instance(pred, target) + 0.0 * torch.sqrt(pred - pred).sum()

        bad_step = step.build_consistency_train_step(port, ts, loss_fn_override=loss_fn)
        metrics = bad_step(state, batch, draws=draws)
        assert torch.isfinite(metrics["loss"])
    assert not metrics["loss_finite"]
    assert state.step == 2  # the count advances
    _assert_untouched(state, snap)
    assert state.lr_scheduler.last_epoch == 1  # and the schedule counts updates taken
    # the EMAs still update, towards the unchanged student
    student = state.student.conv_in.weight.detach()
    for shadow, was, decay in zip((state.student_target, state.student_ema), shadows,
                                  (0.95, 0.999)):
        now = shadow.conv_in.weight.detach()
        torch.testing.assert_close(now, was + (1 - decay) * (student - was),
                                   atol=1e-7, rtol=1e-5)
        assert not torch.equal(now, was)


# -- optimizer and schedule ----------------------------------------------


@pytest.mark.parametrize("kind", optim.SUPPORTED_LR_SCHEDULES)
def test_lr_schedule_matches(kind):
    kw = dict(learning_rate=3e-4, num_warmup_steps=5, max_train_steps=40,
              lr_scheduler_type=kind)
    want_fn = joptim.lr_schedule_with_warmup(joptim.OptimizerConfig(**kw))
    got_fn = optim.lr_schedule_with_warmup(optim.OptimizerConfig(**kw))
    steps = [0, 1, 2, 4, 5, 6, 10, 22, 39, 40, 41, 100]
    for s in steps:
        np.testing.assert_allclose(got_fn(s), float(want_fn(s)), rtol=1e-6, atol=1e-12)
    # and as the optimizer sees it: the rate of update k is schedule(k)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, lr_sched = optim.make_optimizer([p], optim.OptimizerConfig(**kw))
    for k in range(12):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(want_fn(k)),
                                   rtol=1e-6, atol=1e-12)
        p.grad = torch.ones(2)
        opt.step()
        lr_sched.step()


def test_unknown_lr_schedule_raises():
    with pytest.raises(ValueError, match="polynomial"):
        optim.lr_schedule_with_warmup(optim.OptimizerConfig(lr_scheduler_type="polynomial"))


@pytest.mark.parametrize("clip", [None, 0.5], ids=["no_clip", "global_norm_clip"])
def test_adamw_is_the_optax_update(clip):
    """torch.optim.AdamW against optax.adamw on the same gradients: decoupled
    decay scaled by the rate, eps outside the root. Equal within float32
    rounding (1e-6 relative) over 6 steps of a warm-up schedule."""
    kw = dict(learning_rate=1e-2, weight_decay=0.1, num_warmup_steps=3,
              max_train_steps=20, adam_epsilon=1e-3, max_grad_norm=clip)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = rng.standard_normal((6, 5, 7)).astype(np.float32) * 0.01
    tx = joptim.make_optimizer(joptim.OptimizerConfig(**kw))
    jp_, jopt = jnp.asarray(p0), None
    jopt = tx.init(jp_)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, lr_sched = optim.make_optimizer([p], optim.OptimizerConfig(**kw))
    for g in grads:
        updates, jopt = tx.update(jnp.asarray(g), jopt, jp_)
        jp_ = optax.apply_updates(jp_, updates)
        p.grad = torch.from_numpy(g.copy())
        if clip is not None:
            torch.nn.utils.clip_grad_norm_([p], clip)
        opt.step()
        lr_sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp_), rtol=1e-6, atol=1e-7)
    assert np.abs(p.detach().numpy() - p0).max() > 1e-3


# -- the training roles --------------------------------------------------


def test_training_roles_are_distinct_equal_and_float32():
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.bfloat16, device="cpu",
                        roles=ROLES, training=True)
    mods = [p.unets[r] for r in STUDENT_ROLES]
    assert len({id(m) for m in mods}) == 3
    ref = mods[0].state_dict()
    for m in mods:
        for k, v in m.state_dict().items():
            assert v.dtype == torch.float32, k
            assert torch.equal(v, ref[k]), k
    trainable = {k for k, v in mods[0].named_parameters() if v.requires_grad}
    assert trainable == set(ref) - {FOURIER}
    assert not any(v.requires_grad for m in mods[1:] for v in m.parameters())
    # the frozen modules hold the compute dtype
    assert p.unets["teacher"].conv_in.weight.dtype == torch.bfloat16
    assert p.vae.encoder.conv_in.weight.dtype == torch.bfloat16
    # an EMA update writes into the shadow and not into the student
    with torch.no_grad():
        mods[2].conv_in.weight.add_(1.0)
    was = mods[2].conv_in.weight.clone()
    ema_update(mods[2], mods[0], 0.9)
    assert torch.equal(mods[0].conv_in.weight, ref["conv_in.weight"])
    torch.testing.assert_close(mods[2].conv_in.weight,
                               was + 0.1 * (mods[0].conv_in.weight - was))


def test_generation_roles_still_share_one_frozen_module():
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.bfloat16, device="cpu")
    mods = [p.unets[r] for r in STUDENT_ROLES]
    assert len({id(m) for m in mods}) == 1
    assert mods[0].conv_in.weight.dtype == torch.bfloat16
    assert not any(v.requires_grad for v in mods[0].parameters())
    with pytest.raises(ValueError, match="training=True"):
        step.TrainState.create(p)


def test_unported_options_raise():
    """An unknown loss type is refused (clap comes through the loss
    override); stage 3's mel and STFT losses build and take a step that
    moves the student; a solver that does not match `use_edm` is an error;
    the DDIM branch builds."""
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                        roles=ROLES, training=True)
    heun = sched.make_heun_schedule(SchedulerConfig(), 18)
    ddim = sched.make_ddim_schedule(SchedulerConfig(), 18)
    with pytest.raises(ValueError, match="loss type"):
        step.build_consistency_train_step(p, heun, step.ConsistencyStepConfig(loss_type="clap"))
    for loss_type in ("mel", "stft"):
        run = step.build_consistency_train_step(p, heun, step.ConsistencyStepConfig(
            loss_type=loss_type))
        state = step.TrainState.create(p, common.optimizer_configs()[1])
        before = state.student.conv_in.weight.clone()
        metrics = run(state, make_batch(2), draws=stage2_draws(jax.random.PRNGKey(3), 2, 18))
        assert metrics["loss_finite"] and torch.isfinite(metrics["loss"])
        assert not torch.equal(state.student.conv_in.weight, before), loss_type
    for schedule, cfg in ((heun, step.ConsistencyStepConfig(use_edm=False)),
                          (ddim, step.ConsistencyStepConfig(use_edm=True))):
        with pytest.raises(ValueError, match="use_edm"):
            step.build_consistency_train_step(p, schedule, cfg)
    ddim_cfg = step.ConsistencyStepConfig(use_edm=False)
    assert callable(step.build_consistency_train_step(p, ddim, ddim_cfg))
    assert callable(step.build_validation_step(p, ddim, ddim_cfg))
    with pytest.raises(ValueError, match="DDPMSchedule"):
        step.build_validation_step(p, sched.make_ddpm_schedule(SchedulerConfig()))
