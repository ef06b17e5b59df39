"""The port's checkpoint loader (consistencytta_torch/io/checkpoints.py)
against the JAX package's (cli/common.py:load_frozen_and_roles) on
reference-format torch files built from one tiny JAX parameter tree: the
full model with its legacy role names, the AudioLDM-style VAE checkpoint
with its vocoder, TANGO alone and with a stage-1 file, and the FTVAE decoder
pair with its EMA copy. The roles are scaled apart, so that a role loaded
into another's place shows.

Every loaded tensor must equal the JAX loader's, converted to torch layout,
bit for bit (both hold the same float32 numbers); the loaded port's
waveform must equal the JAX package's from its own loaded trees within 1e-4
of the waveform's scale (fp32 through the whole pipeline, as in
tests/test_torch_generate.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from cli.common import load_frozen_and_roles as jax_load
from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.inference.generate import (
    GenerateConfig as JaxGenerateConfig, build_generate_fn as jax_build_generate_fn,
)
from consistencytta_tpu.io import torch_import as ti
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_torch.configs import PipelineConfig, UNetConfig
from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn
from consistencytta_torch.io import checkpoints as ck
from consistencytta_torch.io import from_jax as fj
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.text.tokenizer import HashTokenizer, tokenize_with_uncond
from tests.tiny import cached_init_params

TEXT_LEN = 16
ROLES = STUDENT_ROLES + ("teacher",)
LEGACY = {"student": "consistency_unet.", "student_target": "consistency_ema_unet.",
          "student_ema": "consistency_slow_ema_unet.", "teacher": "diffusion_unet."}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _scaled(sd, factor):
    return {k: v * factor for k, v in sd.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Reference-format files from one tiny JAX tree, the roles scaled apart."""
    d = tmp_path_factory.mktemp("ckpt")
    jp = JaxPipeline.create(JaxPipelineConfig.tiny())
    params = cached_init_params(jp, text_len=TEXT_LEN)
    cfg = PipelineConfig.tiny()
    teacher_cfg = UNetConfig.from_dict({**cfg.unet.to_dict(), "guided": False})
    unets = {r: _scaled(fj.unet_state_dict(getattr(params, r),
                                           teacher_cfg if r == "teacher" else cfg.unet),
                        1.0 + 0.05 * i)
             for i, r in enumerate(ROLES)}
    vae = fj.vae_state_dict(params.vae, cfg.vae)
    voc = fj.hifigan_state_dict(params.vocoder, cfg.vocoder)
    paths = {name: str(d / name) for name in
             ("full.bin", "vae.ckpt", "tango.bin", "stage1.bin", "ftvae.bin")}
    full = {LEGACY[r] + k: v for r, sd in unets.items() for k, v in sd.items()}
    torch.save(full, paths["full.bin"])
    torch.save({"state_dict": {**{"first_stage_model." + k: v for k, v in vae.items()},
                               **{"first_stage_model.vocoder." + k: v for k, v in voc.items()}},
                "global_step": 7}, paths["vae.ckpt"])
    torch.save({"unet." + k: v for k, v in unets["teacher"].items()}, paths["tango.bin"])
    torch.save({"student_ema_unet." + k: v for k, v in unets["student_ema"].items()},
               paths["stage1.bin"])
    dec = fj.vae_decoder_state_dict(params.vae, cfg.vae)
    ft = {**full,
          **{"vae." + k: v * 0.9 for k, v in dec.items()},
          **{("ema_vae_decoder." + k[8:] if k.startswith("decoder.")
              else "ema_vae_pqconv." + k[16:]): v * 1.1 for k, v in dec.items()}}
    torch.save(ft, paths["ftvae.bin"])
    return jp, params, paths


def _port(params):
    """A tiny fp32 CPU pipeline holding every role, its T5 from the JAX tree
    (no checkpoint holds the text encoder)."""
    port = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                           roles=ROLES)
    port.t5.load_state_dict(fj.t5_state_dict(params.t5, port.config.t5.num_layers))
    return port


def _assert_equal(module, sd, what):
    got = module.state_dict()
    assert set(got) == set(sd), what
    for k, v in sd.items():
        assert torch.equal(got[k], v), f"{what}: {k}"


def _check_against_jax(port, jparams, cfg):
    """Every module the JAX loader filled equals the port's, bit for bit."""
    teacher_cfg = UNetConfig.from_dict({**cfg.unet.to_dict(), "guided": False})
    for role in ROLES:
        tree = getattr(jparams, role)
        _assert_equal(port.unets[role], fj.unet_state_dict(
            tree, teacher_cfg if role == "teacher" else cfg.unet), role)
    _assert_equal(port.vae, fj.vae_state_dict(jparams.vae, cfg.vae), "vae")
    _assert_equal(port.vocoder, fj.hifigan_state_dict(jparams.vocoder, cfg.vocoder), "vocoder")


def _waveforms(jp, jparams, port, params, use_ema_decoder=None):
    jparams.t5 = params.t5  # the JAX loader leaves the text encoder to random init
    text = tokenize_with_uncond(HashTokenizer(vocab_size=256), ["a dog barks"], TEXT_LEN)
    rng = jax.random.PRNGKey(2)
    kw = dict(truncate_seconds=None, use_ema_decoder=use_ema_decoder)
    want = np.asarray(jax_build_generate_fn(jp, JaxGenerateConfig(**kw), jit=False)(
        jparams, *text, rng, 4.0))
    _, noise_rng = jax.random.split(rng)
    noise = np.array(jax.random.normal(noise_rng, jp.latent_shape(1), np.float32))
    got = build_generate_fn(port, GenerateConfig(**kw))(
        *text, 4.0, noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_full_model_with_legacy_names_and_vae_checkpoint(files):
    jp, params, paths = files
    port = _port(params)
    assert port.unets["student"] is port.unets["student_ema"]  # shared until loaded
    loaded = ck.load_frozen_and_roles(port, model_path=paths["full.bin"],
                                      vae_checkpoint=paths["vae.ckpt"])
    assert set(loaded) == {"vae", "vocoder", *ROLES}
    jparams = jax_load(jp, model_path=paths["full.bin"], vae_checkpoint=paths["vae.ckpt"])
    _check_against_jax(port, jparams, port.config)
    assert not torch.equal(port.unets["student"].conv_in.weight,
                           port.unets["student_ema"].conv_in.weight)
    _waveforms(jp, jparams, port, params)


@pytest.mark.parametrize("stage1", [False, True], ids=["tango", "tango_and_stage1"])
def test_tango_fan_out(files, stage1):
    """TANGO alone: the teacher's weights seed every student role, with the
    JAX package's fresh guidance init; with a stage-1 file, its student EMA
    (guidance weights included) seeds them."""
    jp, params, paths = files
    port = _port(params)
    kw = dict(tango_model=paths["tango.bin"], vae_checkpoint=paths["vae.ckpt"],
              stage1_model=paths["stage1.bin"] if stage1 else None)
    ck.load_frozen_and_roles(port, **kw)
    jparams = jax_load(jp, **kw)
    _check_against_jax(port, jparams, port.config)


def test_guidance_init_is_the_jax_packages():
    cfg = PipelineConfig.tiny().unet
    got = ck.init_guidance_params(cfg, seed=3)
    want = ti.init_guidance_params(cfg, seed=3)
    np.testing.assert_array_equal(got["guidance_proj.weight"].numpy(),
                                  want["guidance_proj"]["weight"])
    for n in ("linear_1", "linear_2"):
        np.testing.assert_array_equal(got[f"guidance_embedding.{n}.weight"].numpy(),
                                      want["guidance_embedding"][n]["kernel"].T)
        np.testing.assert_array_equal(got[f"guidance_embedding.{n}.bias"].numpy(),
                                      want["guidance_embedding"][n]["bias"])


def test_ftvae_decoder_pair_and_ema_copy(files):
    jp, params, paths = files
    port = _port(params)
    loaded = ck.load_frozen_and_roles(port, model_path=paths["ftvae.bin"],
                                      vae_checkpoint=paths["vae.ckpt"])
    assert {"vae decoder", "vae_ema"} <= set(loaded)
    jparams = jax_load(jp, model_path=paths["ftvae.bin"], vae_checkpoint=paths["vae.ckpt"])
    cfg = port.config
    _check_against_jax(port, jparams, cfg)
    _assert_equal(port.vae_ema, fj.vae_decoder_state_dict(jparams.vae_ema, cfg.vae), "vae_ema")
    _waveforms(jp, jparams, port, params, use_ema_decoder=True)


def test_what_the_loader_refuses(files, tmp_path):
    _, params, paths = files
    port = _port(params)
    orbax = tmp_path / "run"
    os.makedirs(orbax / "state")
    with pytest.raises(NotImplementedError, match="orbax.*tools/orbax_to_torch.py"):
        ck.load_frozen_and_roles(port, model_path=str(orbax))
    with pytest.raises(ValueError, match="tango_model"):
        ck.load_frozen_and_roles(port, stage1_model=paths["stage1.bin"])
    with pytest.raises(ValueError, match="no checkpoint holds"):  # no VAE, no vocoder
        ck.load_frozen_and_roles(port, model_path=paths["full.bin"])
    ck.load_frozen_and_roles(port, model_path=paths["full.bin"], random_init_seed=0)
    with pytest.raises(KeyError, match="missing"):  # a checkpoint without the VAE's keys
        ck.load_frozen_and_roles(port, vae_checkpoint=paths["stage1.bin"], random_init_seed=0)
    voc_only = str(tmp_path / "vocoder_only.ckpt")
    torch.save({k: v for k, v in ck.load_torch_state_dict(paths["vae.ckpt"]).items()
                if k.startswith("first_stage_model.vocoder.")}, voc_only)
    with pytest.raises(KeyError, match="missing"):  # the vocoder alone, no VAE
        ck.load_frozen_and_roles(port, vae_checkpoint=voc_only, random_init_seed=0)


def test_state_dict_wrappers_and_prefixes(files):
    _, _, paths = files
    sd = ck.load_torch_state_dict(paths["vae.ckpt"])
    assert "global_step" not in sd and all(k.startswith("first_stage_model.") for k in sd)
    assert set(ck.strip_prefix(sd, "first_stage_model.vocoder.")) == \
        set(fj.hifigan_state_dict(files[1].vocoder, PipelineConfig.tiny().vocoder))
    roles = ck.split_consistencytta_checkpoint(
        {"consistency_ema_unet.w": torch.ones(1), "consistency_unet.w": torch.zeros(1)})
    assert torch.equal(roles["student_ema"]["w"], torch.ones(1))  # no slow EMA: the target's
    assert roles["teacher"] == {}
