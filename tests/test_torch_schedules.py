"""The port's solver and loss-weight functions (consistencytta_torch/ops/
schedulers.py) against the JAX package's: the Heun schedule's pred_x0, snr,
euler_step, heun_pair and sample_loop, the DDPM schedule's add_noise and
snr, and both min-SNR weights. Inputs from a numpy seed; the model is a
cheap closed-form function given to both sides.

Tolerance: 1e-5 of the output's scale (a handful of float32 operations per
element; the sigma tables are bit-equal, tests/test_torch_modules.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.ops import schedulers as jsched
from consistencytta_torch.configs import SchedulerConfig
from consistencytta_torch.ops import schedulers as sched

SHAPE = (3, 4, 4, 2)


def _close(got, want, rel=1e-5):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=rel)


def _arrays(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]


def _pair(prediction_type="v_prediction", steps=18):
    kw = dict(prediction_type=prediction_type)
    return (sched.make_heun_schedule(SchedulerConfig(**kw), steps),
            jsched.make_heun_schedule(jsched.SchedulerConfig(**kw), steps))


def _model(z, t, sigma, xp):
    """A stand-in model output: any smooth function of its three inputs."""
    shape = (-1,) + (1,) * (z.ndim - 1)
    return xp.tanh(z) * 0.5 + (t.reshape(shape) / 1000.0) * z - 0.01 * sigma.reshape(shape)


T = torch.from_numpy


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_pred_x0_and_euler_step(prediction_type):
    ts, js = _pair(prediction_type)
    x, out = _arrays(0)
    sigma, nxt = ts.sigmas[[0, 7, 16]], ts.sigmas[[1, 8, 17]]
    _close(ts.pred_x0(T(x), T(out), T(sigma)), js.pred_x0(x, out, sigma))
    _close(ts.euler_step(T(x), T(out), T(sigma), T(nxt)), js.euler_step(x, out, sigma, nxt))


def test_unknown_prediction_type_raises():
    ts, _ = _pair("sample")
    with pytest.raises(ValueError, match="prediction type"):
        ts.pred_x0(torch.zeros(SHAPE), torch.zeros(SHAPE), torch.ones(3))
    with pytest.raises(ValueError, match="prediction type"):
        sched.min_snr_weights_stage1(torch.ones(3), 5.0, "sample")


def test_heun_snr():
    ts, js = _pair()
    u = np.array([0, 5, 16])
    _close(ts.snr(T(u)), js.snr(u), 1e-6)


def test_heun_pair_with_the_sigma_zero_guard():
    """Rows 0 and 1 are ordinary intervals; row 2 steps to sigma_next == 0,
    where the second slope falls back to the first."""
    ts, js = _pair()
    (x,) = _arrays(1, 1)
    idx = np.array([0, 9, 17])
    sigma, nxt = ts.sigmas[idx], ts.sigmas[idx + 1]
    assert nxt[2] == 0.0
    t = ts.timesteps[idx]
    t_next = np.append(ts.timesteps, np.float32(0.0))[idx + 1]
    want = js.heun_pair(x, sigma, nxt, lambda z, tt, s: _model(z, tt, s, jnp), t, t_next)
    got = ts.heun_pair(T(x), T(sigma), T(nxt), lambda z, tt, s: _model(z, tt, s, torch),
                       T(t), T(t_next))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w)


@pytest.mark.parametrize("steps", [18, 2])
def test_sample_loop(steps):
    ts, js = _pair(steps=steps)
    (x,) = _arrays(2, 1)
    x = x * ts.init_noise_sigma
    calls = []

    def model(z, t, s):
        calls.append(1)
        return _model(z, t, s, torch)

    got = ts.sample_loop(T(x), model)
    assert len(calls) == 2 * (steps - 1) + 1
    _close(got, js.sample_loop(x, lambda z, t, s: _model(z, t, s, jnp)), 1e-4)
    # from index 1 on: the rollout the validation step runs after its first interval
    t0, t1, s0, s1 = ts.interval(0, x.shape[0], "cpu")
    first, _ = ts.heun_pair(T(x), s0, s1, lambda z, t, s: _model(z, t, s, torch), t0, t1)
    _close(ts.sample_loop(first, lambda z, t, s: _model(z, t, s, torch), start=1), got.numpy(), 1e-6)


def test_ddpm_schedule():
    want = jsched.make_ddpm_schedule(jsched.SchedulerConfig())
    got = sched.make_ddpm_schedule(SchedulerConfig())
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))
    assert got.init_noise_sigma == want.init_noise_sigma == 1.0
    assert got.num_train_timesteps == want.num_train_timesteps
    assert got.prediction_type == want.prediction_type
    x, e = _arrays(3)
    t = np.array([999, 0, 412])
    _close(got.add_noise(T(x), T(e), T(t)), want.add_noise(x, e, t), 1e-6)
    _close(got.snr(T(t)), want.snr(t), 1e-6)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_min_snr_weights(prediction_type):
    snr = np.array([1e-3, 0.7, 5.0, 40.0, 2.5e4], np.float32)
    _close(sched.min_snr_weights_stage1(T(snr), 5.0, prediction_type),
           jsched.min_snr_weights_stage1(snr, 5.0, prediction_type), 1e-6)
    _close(sched.min_snr_weights_stage2(T(snr), 5.0),
           jsched.min_snr_weights_stage2(snr, 5.0), 1e-6)
