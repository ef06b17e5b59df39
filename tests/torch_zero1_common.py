"""Shared by the data-parallel tests of the port (tests/test_torch_zero1*.py):
gloo ranks on the host through `parallel.mesh.spawn`, each running jobs of
the tiny pipeline's step variants on its rows of a global batch with given
per-row draws, and the same jobs on one rank in the test's own process.

The rank processes import this module by name, so it imports neither JAX
nor the JAX package. A rank loads the pipeline from a file that the test
wrote (`save_pipeline`), so that every rank and the test's own single-rank
run start from the same weights; rank 0 writes the gathered state with the
checkpoint writer, and every rank writes what it holds (`<job>.rank<r>.pt`).

Optimizer settings are those of tests/torch_training_common.py (a constant
learning rate of 1e-3, weight decay 1e-2, Adam epsilon 1e-3), and so are
the tolerances: the weights and shadows within 2e-3 of one learning rate
per step (and two float32 roundings of the largest value), forward
quantities within 1e-4 of their scale, and each AdamW moment, as one
vector over every parameter, within 1e-4 of its largest magnitude.
"""

import hashlib
import os

import numpy as np
import torch

from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
from consistencytta_torch.io import checkpoints as ck
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.ops import schedulers as sched
from consistencytta_torch.parallel import mesh as pm
from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
from consistencytta_torch.training import ftvae, lora, optim, step
from consistencytta_torch.training.losses import mel_loss_instance

TEXT_LEN = 8
LR, WEIGHT_DECAY, ADAM_EPS = 1e-3, 1e-2, 1e-3
LATENT = (16, 16, 8)
HEUN_STEPS = 18
STAGE2_ROLES = ("student", "student_target", "student_ema", "teacher")
ROLES = {"stage1": ("student", "student_ema", "teacher"), "lora": ("student", "teacher")}


def save_pipeline(pipeline, path):
    torch.save({"unets": {r: m.state_dict() for r, m in pipeline.unets.items()},
                "vae": pipeline.vae.state_dict(), "vocoder": pipeline.vocoder.state_dict(),
                "t5": pipeline.t5.state_dict()}, path)


def load_pipeline(path, roles=STAGE2_ROLES):
    """A training pipeline of the tiny config holding `path`'s weights."""
    sd = torch.load(path, weights_only=True)
    p = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu", roles=roles,
                        training=True)
    for role in roles:
        p.unets[role].load_state_dict(sd["unets"][role])
    for name in ("vae", "vocoder", "t5"):
        getattr(p, name).load_state_dict(sd[name])
    return p


def make_batch(b, seed=0):
    tok = HashTokenizer(vocab_size=256)
    ids, mask, uids, umask = tokenize_with_uncond(
        tok, [f"sound number {i}" for i in range(b)], TEXT_LEN)
    wav = np.random.default_rng(seed).standard_normal((b, 64 * 160)) * 0.1
    return {"wav": wav.astype(np.float32), "ids": ids, "mask": mask,
            "uncond_ids": uids, "uncond_mask": umask}


def make_draws(kind, b, seed):
    """Per-row draws of a step's forward, from numpy."""
    rng = np.random.default_rng(seed)
    normal = lambda: rng.standard_normal((b, *LATENT)).astype(np.float32)
    draws = {"posterior_noise": normal(), "eps": normal(),
             "w": rng.uniform(size=b).astype(np.float32)}
    if kind == "stage1":
        draws["t"] = rng.integers(0, 1000, b)
    else:
        draws["u"] = rng.integers(0, HEUN_STEPS - 1, b)
    return draws


def job(kind, rows=4, accum=1, steps=1, nan_rank=None):
    """A job: `steps` optimizer steps of `kind` (heun, ddim, stage1, lora,
    ftvae) on global batches of `rows` rows in `accum` micro-batches, with
    given draws; `nan_rank` puts a NaN into that rank's rows of 2."""
    batches, draws = [], []
    for i in range(steps):
        batches.append(make_batch(rows, seed=i))
        micro = [make_draws(kind, rows // accum, 100 * i + j) for j in range(accum)]
        if nan_rank is not None:  # the noise of the rank's first row
            micro[0]["eps"][nan_rank * rows // (2 * accum)] = np.nan
        draws.append(micro if accum > 1 else micro[0])
    return {"kind": kind, "accum": accum, "batches": batches, "draws": draws}


def build(kind, pipeline, accum):
    """(state, step function) of a job's kind on `pipeline`."""
    config = optim.OptimizerConfig(learning_rate=LR, weight_decay=WEIGHT_DECAY,
                                   adam_epsilon=ADAM_EPS, lr_scheduler_type="constant")
    if kind == "stage1":
        cfg = step.GuidedStepConfig(accum_steps=accum)
        return (step.TrainState.create(pipeline, config, with_target=False),
                step.build_guided_train_step(pipeline, sched.make_ddpm_schedule(SchedulerConfig()),
                                             cfg))
    use_edm = kind != "ddim"
    schedule = (sched.make_heun_schedule if use_edm else sched.make_ddim_schedule)(
        SchedulerConfig(), HEUN_STEPS)
    cfg = step.ConsistencyStepConfig(accum_steps=accum, use_edm=use_edm)
    if kind == "lora":
        return (lora.init_lora_state(pipeline, config, seed=1),
                lora.build_lora_consistency_train_step(pipeline, schedule, cfg))
    if kind == "ftvae":
        # a stand-in for the CLAP loss with the same reach: the mel loss
        # decoded through the trainable decoder pair
        def decoded_loss(pred, target, micro, decoder):
            return mel_loss_instance(pred, target, lambda z: pipeline.decode_mel(decoder, z))

        return (ftvae.FTVAETrainState.create(pipeline, config),
                ftvae.build_ftvae_train_step(pipeline, schedule, cfg, decoded_loss))
    return step.TrainState.create(pipeline, config), \
        step.build_consistency_train_step(pipeline, schedule, cfg)


def run_single(spec, pipeline_file):
    """The job on one rank, in this process: (state, [metrics])."""
    pipeline = load_pipeline(pipeline_file, ROLES.get(spec["kind"], STAGE2_ROLES))
    state, fn = build(spec["kind"], pipeline, spec["accum"])
    metrics = [fn(state, b, draws=d) for b, d in zip(spec["batches"], spec["draws"])]
    return state, metrics


def digest(module) -> str:
    h = hashlib.sha1()
    for p in module.parameters():
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


def rank_jobs(mesh, pipeline_file, jobs, out_dir):
    """On each rank: every job of `jobs` ({name: spec}) on the rank's rows,
    the state ZeRO-1 sharded; then rank 0 writes the gathered state
    (`<out_dir>/<name>`, the checkpoint writer's layout) and every rank what
    it held (`<name>.rank<r>.pt`)."""
    torch.set_num_threads(1)  # the test workers share the host's cores
    torch.manual_seed(0)
    for name, spec in jobs.items():
        if spec["kind"] == "eval":
            params = torch.from_numpy(spec["params"])
            seen = []

            def fn(w, x):
                seen.append(x.clone())
                return x @ w

            out = pm.sharded_eval(fn, mesh, 1)(params, torch.from_numpy(spec["x"]))
            torch.save({"out": out, "seen": seen},
                       os.path.join(out_dir, f"{name}.rank{mesh.rank}.pt"))
            continue
        pipeline = load_pipeline(pipeline_file, ROLES.get(spec["kind"], STAGE2_ROLES))
        state, fn = build(spec["kind"], pipeline, spec["accum"])
        before = digest(state.student)
        pm.shard_train_state(state, mesh)
        run = pm.sharded_step(fn, mesh, spec["accum"])
        metrics = [run(state, b, draws=d) for b, d in zip(spec["batches"], spec["draws"])]
        held = pm.held_bytes(state)
        ck.save_checkpoint(os.path.join(out_dir, name), state)
        torch.save({"losses": [float(m["loss"]) for m in metrics],
                    "finite": [bool(m["loss_finite"]) for m in metrics],
                    "held": held, "step": state.step, "before": before,
                    "student": digest(state.student),
                    "target": digest(state.student_target) if state.student_target else None,
                    "n_params": sum(p.numel() for p in state.zero1.params),
                    "n_ema": sum(p.numel() for p in state.student_ema.module.parameters())},
                   os.path.join(out_dir, f"{name}.rank{mesh.rank}.pt"))


def spawn_jobs(pipeline_file, jobs, out_dir, world=2):
    pm.spawn(rank_jobs, world, ["cpu"] * world, args=(pipeline_file, jobs, out_dir))
    return {name: [torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt"), weights_only=False)
                   for r in range(world)] for name in jobs}


def assert_close_state_dicts(got, want, atol_of, what):
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        v = torch.as_tensor(v).float()
        g = torch.as_tensor(got[k]).float()
        atol = atol_of(v) + 2 * np.finfo(np.float32).eps * float(v.abs().max())
        np.testing.assert_allclose(g.numpy(), v.numpy(), atol=atol, rtol=0,
                                   err_msg=f"{what} {k}")


def assert_matches_single(out_dir, name, ranks, state, metrics, steps):
    """The 2-rank job (rank 0's files and both ranks' records) against the
    single-rank state and metrics."""
    weight_tol = lambda v: 2e-3 * LR * steps
    for rec in ranks:
        np.testing.assert_allclose(rec["losses"], [float(m["loss"]) for m in metrics],
                                   rtol=1e-4)
        assert rec["finite"] == [bool(m["loss_finite"]) for m in metrics]
        assert rec["step"] == state.step == steps
    # every rank holds the same student (and target) after the all-gather
    assert len({r["student"] for r in ranks}) == 1
    assert len({r["target"] for r in ranks}) == 1
    d = os.path.join(out_dir, name)
    model = torch.load(os.path.join(d, ck.MODEL_FILE), weights_only=True)
    assert_close_state_dicts(model, ck.model_state_dict(state), weight_tol, "model")
    opt = torch.load(os.path.join(d, ck.OPTIMIZER_FILE), weights_only=True)
    want = state.optimizer.state_dict()
    got_factors = opt.pop("lora_factors", None)
    if state.lora_base is not None:
        for role in ck.STUDENT_ROLES:
            assert_close_state_dicts(got_factors[role], getattr(state, role).state_dict(),
                                     weight_tol, f"factors {role}")
    assert opt["param_groups"] == want["param_groups"]
    assert sorted(opt["state"]) == sorted(want["state"])
    # each moment as one vector over every parameter, at its largest magnitude
    # (a parameter whose gradient is rounding noise has moments of noise)
    scale = {k: max(float(s[k].abs().max()) for s in want["state"].values())
             for k in ("exp_avg", "exp_avg_sq")}
    for i, s in want["state"].items():
        assert torch.equal(opt["state"][i]["step"], s["step"])
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(opt["state"][i][k].numpy(), s[k].numpy(),
                                       atol=1e-4 * scale[k], rtol=0, err_msg=f"{i} {k}")
    sched_sd = torch.load(os.path.join(d, ck.SCHEDULER_FILE), weights_only=True)
    assert sched_sd["step"] == state.step
    assert sched_sd["lr_scheduler"] == state.lr_scheduler.state_dict()
