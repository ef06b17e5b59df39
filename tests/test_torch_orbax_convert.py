"""tools/orbax_to_torch.py: the JAX package's orbax checkpoint directories
converted into the port's layout, held to the JAX package's own loader.

Four states are written with the JAX `save_checkpoint` at the tiny config,
as the JAX training CLI writes them (`state` plus the `frozen` teacher,
VAE, vocoder and T5): stage 1 (no target), stage 2, LoRA (the base student
in `frozen`) and FTVAE, their AdamW behind a clip transform in the optax
chain. Each has
taken two AdamW updates with random gradients, so that its moments are not
zero, and its roles are scaled apart, so that a role loaded into another's
place shows.

Loading: the port's `load_frozen_and_roles(model_path=OUT_DIR)` against the
JAX `cli/common.py:load_frozen_and_roles(model_path=ORBAX_DIR)`: every
module equal bit for bit after layout, and a 1-NFE clip with the same noise
within 1e-5 of its scale (fp32). `--stage1_model`: a converted stage-2
directory beside a TANGO file against the JAX loader given the orbax
directory. Resume: the port's `load_checkpoint` restores moments equal to
optax's `mu` / `nu` and the step, and one AdamW update with the same
gradients (optax `tx.update` against `optimizer.step`) agrees within 1e-6 of
the parameters' scale, and the update within 1e-4 relative L2.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import numpy as np
import optax
import pytest
import torch

from cli.common import load_frozen_and_roles as jax_load
from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.inference.generate import (
    GenerateConfig as JaxGenerateConfig, build_generate_fn as jax_build_generate_fn,
)
from consistencytta_tpu.io.checkpoints import save_checkpoint as jax_save_checkpoint
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline, PipelineParams
from consistencytta_tpu.training import lora as jlora
from consistencytta_tpu.training.ftvae import FTVAETrainState as JaxFTVAETrainState
from consistencytta_tpu.training.optim import (
    OptimizerConfig as JaxOptimizerConfig, make_optimizer as jax_make_optimizer,
)
from consistencytta_tpu.training.step import TrainState as JaxTrainState
from consistencytta_torch.configs import PipelineConfig, UNetConfig
from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn
from consistencytta_torch.io import checkpoints as ck
from consistencytta_torch.io import from_jax as fj
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
from consistencytta_torch.training import lora
from consistencytta_torch.training.ftvae import FTVAETrainState
from consistencytta_torch.training.optim import OptimizerConfig
from consistencytta_torch.training.step import TrainState
from tests.tiny import cached_init_params
from tools import orbax_to_torch

TEXT_LEN = 16
ROLES = ("student", "student_target", "student_ema")
KINDS = ("stage1", "stage2", "lora", "ftvae")
# the optimizer of every state, in both packages; the chain puts a clip
# before adamw, as the JAX CLI's does with --max_grad_norm, at a norm the
# gradients stay under (the port clips in its train step, not in
# optimizer.step, which is what is compared)
OPT = dict(learning_rate=1e-3, num_warmup_steps=0, max_train_steps=100, weight_decay=1e-2)
FLAGS = ["--learning_rate", "1e-3", "--num_warmup_steps", "0", "--max_train_steps", "100",
         "--adam_weight_decay", "1e-2"]
UPDATES = 2
STEP = 3  # the state's step: one step more than updates, as after a skipped update


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(fn, *trees):
    return jax.tree_util.tree_map(fn, *trees)


def _random_like(tree, rng, scale=1e-2):
    return _tree(lambda x: jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32)
                                       * scale), tree)


def _update(tx, grads, opt_state, params):
    """`tx.update` on the trees raveled into one vector each, its moments
    unraveled back into trees: the same elementwise AdamW (the clip is not
    reached), at the cost of one small compile instead of one per tree."""
    flat, unravel = ravel_pytree(params)
    is_tree = lambda x: isinstance(x, dict)  # noqa: E731
    flat_opt = jax.tree_util.tree_map(lambda x: ravel_pytree(x)[0] if is_tree(x) else x,
                                      opt_state, is_leaf=is_tree)
    updates, new = jax.jit(tx.update)(ravel_pytree(grads)[0], flat_opt, flat)
    new = jax.tree_util.tree_map(lambda x: unravel(x) if np.ndim(x) == 1 else x, new)
    return unravel(updates), new


def _train(tx, trainable, rng):
    """UPDATES optax updates with random gradients: (trainable, opt_state)."""
    opt = tx.init(trainable)
    for _ in range(UPDATES):
        updates, opt = _update(tx, _random_like(trainable, rng), opt, trainable)
        trainable = optax.apply_updates(trainable, updates)
    return trainable, opt


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The four orbax directories, each converted once; the JAX side's
    pipeline, parameters and optimizers."""
    root = tmp_path_factory.mktemp("orbax")
    jp = JaxPipeline.create(JaxPipelineConfig.tiny())
    params = cached_init_params(jp, text_len=TEXT_LEN)
    rng = np.random.default_rng(0)
    scaled = {r: _tree(lambda x, f=1.0 + 0.05 * i: x * f, getattr(params, r))
              for i, r in enumerate(ROLES)}
    frozen = PipelineParams(teacher=params.teacher, vae=params.vae, vocoder=params.vocoder,
                            t5=params.t5)
    tx = jax_make_optimizer(JaxOptimizerConfig(**OPT, max_grad_norm=1e6))
    step = jnp.asarray(STEP, jnp.int32)
    states = {}

    student, opt = _train(tx, scaled["student"], rng)
    states["stage2"] = (JaxTrainState(step, student, scaled["student_target"],
                                      scaled["student_ema"], opt), frozen)
    states["stage1"] = (JaxTrainState(step, student, None, scaled["student_ema"], opt), frozen)
    factors = {r: _tree(lambda x, i=i: x + 0.01 * (i + 1),
                        jlora.init_lora_params(params.student, rank=4,
                                               rng=jax.random.PRNGKey(i)))
               for i, r in enumerate(ROLES)}
    student, opt = _train(tx, factors["student"], rng)
    states["lora"] = (JaxTrainState(step, student, factors["student_target"],
                                    factors["student_ema"], opt),
                      dataclasses.replace(frozen, student=params.student))
    ft = JaxFTVAETrainState.create(dataclasses.replace(params, **scaled), tx)
    dec = _tree(lambda x: x * 0.9, ft.vae_dec)
    trained, opt = _train(tx, {"unet": ft.student, "vae_dec": dec}, rng)
    states["ftvae"] = (dataclasses.replace(
        ft, step=step, student=trained["unet"], vae_dec=trained["vae_dec"],
        vae_dec_ema=_tree(lambda x: x * 1.1, ft.vae_dec_ema), opt_state=opt), frozen)

    dirs = {}
    for kind, (state, fz) in states.items():
        orbax_dir, out = str(root / kind), str(root / f"{kind}_torch")
        # the frozen tree that three states share is written once, by the
        # stage-2 save, and copied
        shared = fz is frozen and kind != "stage2"
        jax_save_checkpoint(orbax_dir, state, None if shared else fz, jp.config)
        if shared:
            shutil.copytree(str(root / "stage2" / "frozen"), os.path.join(orbax_dir, "frozen"))
        written_files = orbax_to_torch.main([orbax_dir, out, *FLAGS])
        assert os.path.dirname(written_files[ck.MODEL_FILE]) == out
        dirs[kind] = (orbax_dir, out)
    generate = jax_build_generate_fn(jp, JaxGenerateConfig(truncate_seconds=None), jit=True)
    return jp, params, states, dirs, generate, tx


def _port(roles, training=False):
    return Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                           roles=roles, training=training)


def _assert_equal(module, sd, what):
    got = module.state_dict()
    assert set(got) == set(sd), what
    for k, v in sd.items():
        assert torch.equal(got[k], v), f"{what}: {k}"


def _roles_of(kind):
    return ("student", "student_ema") if kind == "stage1" else ROLES


@pytest.mark.parametrize("kind", KINDS)
def test_loading_matches_the_jax_loader(written, kind):
    jp, params, states, dirs, generate, _ = written
    orbax_dir, out = dirs[kind]
    port = _port((*_roles_of(kind), "teacher"))
    loaded = ck.load_frozen_and_roles(port, model_path=out)
    assert {"vae", "vocoder", "t5", "teacher", *_roles_of(kind)} <= set(loaded)
    assert loaded["vae"] == loaded["vocoder"] == os.path.join(out, ck.FIRST_STAGE_FILE)
    jparams = jax_load(jp, model_path=orbax_dir)
    cfg = port.config
    teacher_cfg = UNetConfig.from_dict({**cfg.unet.to_dict(), "guided": False})
    for role in (*_roles_of(kind), "teacher"):
        _assert_equal(port.unets[role], fj.unet_state_dict(
            getattr(jparams, role), teacher_cfg if role == "teacher" else cfg.unet), role)
    _assert_equal(port.vae, fj.vae_state_dict(jparams.vae, cfg.vae), "vae")
    _assert_equal(port.vocoder, fj.hifigan_state_dict(jparams.vocoder, cfg.vocoder), "vocoder")
    _assert_equal(port.t5, fj.t5_state_dict(jparams.t5, cfg.t5.num_layers), "t5")
    if kind == "ftvae":
        _assert_equal(port.vae_ema, fj.vae_decoder_state_dict(jparams.vae_ema, cfg.vae),
                      "vae_ema")
    if kind == "lora":  # the merged roles differ from the base
        base = fj.unet_state_dict(params.student, cfg.unet)
        name = lora.adapted_weights(port.unets["student"])[0]
        assert not torch.equal(port.unets["student"].state_dict()[name], base[name])

    text = tokenize_with_uncond(HashTokenizer(vocab_size=256), ["a dog barks"], TEXT_LEN)
    rng = jax.random.PRNGKey(2)
    # one compiled graph for every kind: where the state has no EMA decoder
    # pair, the VAE's own pair stands in for it, which decodes alike
    vae_ema = jparams.vae_ema if jparams.vae_ema is not None else {
        k: jparams.vae[k] for k in ("decoder", "post_quant_conv")}
    used = PipelineParams(student_ema=jparams.student_ema, vae=jparams.vae,
                          vocoder=jparams.vocoder, t5=jparams.t5, vae_ema=vae_ema)
    want = np.asarray(generate(used, *text, rng, 4.0))
    _, noise_rng = jax.random.split(rng)
    noise = np.array(jax.random.normal(noise_rng, jp.latent_shape(1), np.float32))
    got = build_generate_fn(port, GenerateConfig(truncate_seconds=None))(
        *text, 4.0, noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_stage1_model_beside_a_tango_file(written, tmp_path):
    jp, params, states, dirs, _, tx = written
    orbax_dir, out = dirs["stage2"]
    cfg = PipelineConfig.tiny()
    teacher_cfg = UNetConfig.from_dict({**cfg.unet.to_dict(), "guided": False})
    tango = str(tmp_path / "tango.bin")
    torch.save({"unet." + k: v * 1.2 for k, v in
                fj.unet_state_dict(params.teacher, teacher_cfg).items()}, tango)
    port = _port((*ROLES, "teacher"))
    ck.load_frozen_and_roles(port, tango_model=tango, stage1_model=out, random_init_seed=0)
    jparams = jax_load(jp, tango_model=tango, stage1_model=orbax_dir)
    for role in (*ROLES, "teacher"):
        _assert_equal(port.unets[role], fj.unet_state_dict(
            getattr(jparams, role), teacher_cfg if role == "teacher" else cfg.unet), role)
    # the students seed from the stage-2 state's EMA, not its student
    _assert_equal(port.unets["student"], fj.unet_state_dict(
        states["stage2"][0].student_ema, cfg.unet), "student from student_ema")


def _port_state(kind, params):
    """The port's training state of this kind on the CPU at the tiny config,
    with the optimizer the JAX states took."""
    config = OptimizerConfig(**OPT)
    pipe = _port((*ROLES, "teacher"), training=True)
    if kind == "lora":
        pipe.unets["student"].load_state_dict(fj.unet_state_dict(params.student,
                                                                 pipe.config.unet))
        return pipe, lora.init_lora_state(pipe, config)
    if kind == "ftvae":
        return pipe, FTVAETrainState.create(pipe, config)
    return pipe, TrainState.create(pipe, config)


def _jax_trainable(kind, state):
    if kind == "ftvae":
        return {"unet": state.student, "vae_dec": state.vae_dec}
    return state.student


def _as_port(kind, tree, cfg, names):
    """A JAX tree of the trainable parameters as the port's optimizer lists
    them (the converter's own map)."""
    return orbax_to_torch._moments(tree, "full" if kind == "stage2" else kind, cfg, names)


@pytest.mark.parametrize("kind", ["stage2", "lora", "ftvae"])
def test_resume_restores_the_moments_and_one_update_agrees(written, kind):
    jp, params, states, dirs, _, tx = written
    jstate, _ = states[kind]
    _, out = dirs[kind]
    pipe, state = _port_state(kind, params)
    ck.load_checkpoint(out, state)
    cfg = pipe.config
    names = orbax_to_torch._parameter_names("full" if kind == "stage2" else kind, cfg,
                                            {"student": jstate.student})
    adam = orbax_to_torch.find_adam_state(jstate.opt_state)
    group = state.optimizer.param_groups[0]
    assert len(group["params"]) == len(names)
    assert state.step == STEP and state.lr_scheduler.last_epoch == UPDATES
    for i, (p, m, v) in enumerate(zip(group["params"], _as_port(kind, adam["mu"], cfg, names),
                                      _as_port(kind, adam["nu"], cfg, names))):
        s = state.optimizer.state[p]
        assert torch.equal(s["exp_avg"], m) and torch.equal(s["exp_avg_sq"], v), names[i]
        assert s["step"].item() == UPDATES and s["step"].dtype == torch.float32
    params_now = _as_port(kind, _jax_trainable(kind, jstate), cfg, names)
    for p, want in zip(group["params"], params_now):
        assert torch.equal(p.detach(), want)

    grads = _random_like(_jax_trainable(kind, jstate), np.random.default_rng(5))
    updates, _ = _update(tx, grads, jstate.opt_state, _jax_trainable(kind, jstate))
    want = _as_port(kind, optax.apply_updates(_jax_trainable(kind, jstate), updates), cfg, names)
    before = [p.detach().clone() for p in group["params"]]
    for p, g in zip(group["params"], _as_port(kind, grads, cfg, names)):
        p.grad = g.clone()
    state.optimizer.step()
    scale = max(w.abs().max().item() for w in want)
    for name, p, w in zip(names, group["params"], want):
        np.testing.assert_allclose(p.detach().numpy(), w.numpy(), atol=1e-6 * scale, rtol=0,
                                   err_msg=name)
    # the update itself, not only the parameters it moved: a wrong learning
    # rate, bias correction or decay shows here
    step_port = torch.cat([(p.detach() - b).flatten() for p, b in zip(group["params"], before)])
    step_jax = torch.cat([(w - b).flatten() for w, b in zip(want, before)])
    # (1e-4: each step is read as a difference of float32 parameters, whose
    # rounding is ~6e-8 of |p| against steps ~1e-3 of it)
    assert ((step_port - step_jax).norm() / step_jax.norm()).item() < 1e-4


def test_what_the_converter_and_the_port_refuse(written, tmp_path):
    jp, params, states, dirs, _, tx = written
    orbax_dir, _ = dirs["stage2"]
    port = _port((*ROLES, "teacher"))
    with pytest.raises(NotImplementedError, match="tools/orbax_to_torch.py"):
        ck.load_frozen_and_roles(port, model_path=orbax_dir)
    # the LoRA state beside the frozen tree of a full state (no base student)
    no_base = str(tmp_path / "lora_no_base")
    shutil.copytree(os.path.join(dirs["lora"][0], "state"), os.path.join(no_base, "state"))
    shutil.copytree(os.path.join(orbax_dir, "frozen"), os.path.join(no_base, "frozen"))
    shutil.copyfile(os.path.join(orbax_dir, "config.json"), os.path.join(no_base, "config.json"))
    with pytest.raises(ValueError, match="LoRA factors but no base student") as jax_err:
        jax_load(jp, model_path=no_base)
    with pytest.raises(ValueError, match="LoRA factors but no base student") as err:
        orbax_to_torch.convert(no_base, str(tmp_path / "out"))
    assert str(err.value).split(" holds ")[1] == str(jax_err.value).split(" holds ")[1]
    os.remove(os.path.join(no_base, "config.json"))
    with pytest.raises(ValueError, match="config.json"):
        orbax_to_torch.convert(no_base, str(tmp_path / "out"))
    with pytest.raises(ValueError, match="not an orbax checkpoint"):
        orbax_to_torch.convert(str(tmp_path), str(tmp_path / "out"))


def test_find_adam_state_anywhere_in_the_chain():
    tree = {"w": jnp.ones(3)}
    for tx in (optax.adamw(1e-3), optax.chain(optax.clip_by_global_norm(1.0),
                                              optax.adamw(1e-3))):
        found = orbax_to_torch.find_adam_state(tx.init(tree))
        assert set(found) >= {"count", "mu", "nu"} and int(found["count"]) == 0
    restored = [None, [{"count": 4, "mu": {}, "nu": {}}, None, {"count": 4}]]
    assert orbax_to_torch.find_adam_state(restored)["count"] == 4
    assert orbax_to_torch.find_adam_state([None, {"count": 1}]) is None
