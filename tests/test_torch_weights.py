"""The port's weight bridge (consistencytta_torch/io/from_jax.py).

Two checks per module (T5, UNet, the whole VAE, its decoder pair alone,
HiFi-GAN) at the tiny geometry:
  * round trip: port state_dict -> the JAX package's torch importer
    (convert_*) -> JAX tree -> from_jax -> the identical state_dict;
  * the JAX package's own random-init trees load into the port modules
    strictly (no missing, unexpected or mis-shaped key).
"""

import jax  # noqa: F401  (import both frameworks up front)
import numpy as np
import pytest
import torch

from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.io import torch_import as ti
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.io import from_jax
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.nn.vae import AutoencoderKLDecoder
from tests.tiny import cached_init_params

MODULES = ("t5", "unet", "vae", "vae_decoder_pair", "vocoder")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port():
    return Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32,
                           device="cpu", seed=3)


@pytest.fixture(scope="module")
def jax_params():
    return cached_init_params(JaxPipeline.create(JaxPipelineConfig.tiny()), text_len=16)


def _module(port, name):
    if name == "unet":
        return port.unets["student"]
    if name == "vae_decoder_pair":
        # the pair an EMA decoder checkpoint holds: the same keys as the
        # whole autoencoder's, without encoder.* and quant_conv.*
        pair = AutoencoderKLDecoder(port.config.vae)
        pair.load_state_dict({k: v for k, v in port.vae.state_dict().items()
                              if k.startswith(("decoder.", "post_quant_conv."))})
        return pair
    return getattr(port, name)


def _to_jax(name, sd_np, jcfg):
    if name == "t5":
        return ti.convert_t5(sd_np, jcfg.t5.num_layers)
    if name == "unet":
        return ti.convert_unet(sd_np, jcfg.unet)
    if name == "vae":
        return ti.convert_vae(sd_np, jcfg.vae)
    if name == "vae_decoder_pair":
        return ti.convert_vae_decoder_pair(sd_np, jcfg.vae)
    return ti.convert_hifigan(sd_np, jcfg.vocoder)


def _from_jax(name, tree, cfg):
    if name == "t5":
        return from_jax.t5_state_dict(tree, cfg.t5.num_layers)
    if name == "unet":
        return from_jax.unet_state_dict(tree, cfg.unet)
    if name == "vae":
        return from_jax.vae_state_dict(tree, cfg.vae)
    if name == "vae_decoder_pair":
        return from_jax.vae_decoder_state_dict(tree, cfg.vae)
    return from_jax.hifigan_state_dict(tree, cfg.vocoder)


@pytest.mark.parametrize("name", MODULES)
def test_round_trip_through_jax_importer(port, name):
    cfg, jcfg = PipelineConfig.tiny(), JaxPipelineConfig.tiny()
    sd = _module(port, name).state_dict()
    tree = _to_jax(name, {k: v.numpy() for k, v in sd.items()}, jcfg)
    back = _from_jax(name, tree, cfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", MODULES)
def test_jax_init_params_load_strictly(port, jax_params, name):
    cfg = PipelineConfig.tiny()
    tree = {"t5": jax_params.t5, "unet": jax_params.student_ema,
            "vae": jax_params.vae, "vae_decoder_pair": jax_params.vae,
            "vocoder": jax_params.vocoder}[name]
    sd = _from_jax(name, tree, cfg)
    module = _module(port, name)
    ref = module.state_dict()
    assert sorted(sd) == sorted(ref)
    for k, v in sd.items():
        assert v.shape == ref[k].shape, k
    fresh = _module(
        Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu"), name
    )
    if name == "vae":
        assert any(k.startswith("encoder.down.0.downsample.conv") for k in sd)
        assert "quant_conv.weight" in sd
    result = fresh.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    loaded = fresh.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v.numpy(), err_msg=k)
