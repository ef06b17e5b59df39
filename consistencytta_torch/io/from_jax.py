"""JAX-package parameter trees -> the port's state dicts.

The trees are nested dicts of arrays as the JAX package's modules hold
them (channels-last kernels: Dense [in, out], Conv2d [kh, kw, in, out],
Conv1d [k, in, out], ConvTranspose1d [k, out, in], norms {scale, bias}, the
T5 layers stacked on a leading axis). The state dicts use torch layouts and
the reference's key names, so `module.load_state_dict(sd)` loads them. This
is the inverse of the JAX package's torch importer, written independently.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from consistencytta_torch.configs import HiFiGANConfig, UNetConfig, VAEConfig

Tree = Mapping[str, Any]
StateDict = Dict[str, torch.Tensor]


def _t(a, perm=None) -> torch.Tensor:
    a = np.array(a, dtype=np.float32)  # a writable copy
    if perm is not None:
        a = np.transpose(a, perm)
    return torch.from_numpy(np.ascontiguousarray(a))


def _linear(sd: StateDict, key: str, p: Tree) -> None:
    sd[f"{key}.weight"] = _t(p["kernel"], (1, 0))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv2d(sd: StateDict, key: str, p: Tree) -> None:
    sd[f"{key}.weight"] = _t(p["kernel"], (3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, key: str, p: Tree) -> None:
    sd[f"{key}.weight"] = _t(p["kernel"], (2, 1, 0))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, key: str, p: Tree) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


# -- T5 ----------------------------------------------------------------------


def t5_state_dict(p: Tree, num_layers: int) -> StateDict:
    sd: StateDict = {
        "shared.weight": _t(p["token_embedding"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            _t(p["relative_attention_bias"]),
        "encoder.final_layer_norm.weight": _t(p["final_norm"]["scale"]),
    }
    layers = p["blocks"]["layer"]
    for i in range(num_layers):
        b = f"encoder.block.{i}.layer"
        sd[f"{b}.0.layer_norm.weight"] = _t(layers["attn_norm"]["scale"][i])
        for name in ("q", "k", "v", "o"):
            sd[f"{b}.0.SelfAttention.{name}.weight"] = _t(
                layers["attn"][name]["kernel"][i], (1, 0)
            )
        sd[f"{b}.1.layer_norm.weight"] = _t(layers["ff_norm"]["scale"][i])
        for name in ("wi_0", "wi_1", "wo"):
            sd[f"{b}.1.DenseReluDense.{name}.weight"] = _t(
                layers[name]["kernel"][i], (1, 0)
            )
    return sd


# -- UNet --------------------------------------------------------------------


def _unet_resnet(sd: StateDict, key: str, p: Tree) -> None:
    _norm(sd, f"{key}.norm1", p["norm1"])
    _conv2d(sd, f"{key}.conv1", p["conv1"])
    _linear(sd, f"{key}.time_emb_proj", p["time_emb_proj"])
    _norm(sd, f"{key}.norm2", p["norm2"])
    _conv2d(sd, f"{key}.conv2", p["conv2"])
    if "conv_shortcut" in p:
        _conv2d(sd, f"{key}.conv_shortcut", p["conv_shortcut"])


def _unet_transformer(sd: StateDict, key: str, p: Tree) -> None:
    _norm(sd, f"{key}.norm", p["norm"])
    _linear(sd, f"{key}.proj_in", p["proj_in"])
    _linear(sd, f"{key}.proj_out", p["proj_out"])
    i = 0
    while f"block_{i}" in p:
        blk, tb = p[f"block_{i}"], f"{key}.transformer_blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{tb}.{n}", blk[n])
        for a in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear(sd, f"{tb}.{a}.{proj}", blk[a][proj])
            _linear(sd, f"{tb}.{a}.to_out.0", blk[a]["to_out"])
        _linear(sd, f"{tb}.ff.net.0.proj", blk["ff"]["act"]["proj"])
        _linear(sd, f"{tb}.ff.net.2", blk["ff"]["proj_out"])
        i += 1


def unet_state_dict(p: Tree, config: UNetConfig) -> StateDict:
    sd: StateDict = {}
    _conv2d(sd, "conv_in", p["conv_in"])
    for n in ("linear_1", "linear_2"):
        _linear(sd, f"time_embedding.{n}", p["time_embedding"][n])
    if config.guided:
        sd["guidance_proj.weight"] = _t(p["guidance_proj"]["weight"])
        for n in ("linear_1", "linear_2"):
            _linear(sd, f"guidance_embedding.{n}", p["guidance_embedding"][n])
    n_levels = config.num_levels
    for i, kind in enumerate(config.down_block_types):
        for j in range(config.layers_per_block):
            _unet_resnet(sd, f"down_blocks.{i}.resnets.{j}", p[f"down_{i}_resnet_{j}"])
            if kind == "CrossAttnDownBlock2D":
                _unet_transformer(sd, f"down_blocks.{i}.attentions.{j}",
                                  p[f"down_{i}_attn_{j}"])
        if i != n_levels - 1:
            _conv2d(sd, f"down_blocks.{i}.downsamplers.0.conv",
                    p[f"down_{i}_downsample"]["conv"])
    _unet_resnet(sd, "mid_block.resnets.0", p["mid_resnet_0"])
    _unet_transformer(sd, "mid_block.attentions.0", p["mid_attn_0"])
    _unet_resnet(sd, "mid_block.resnets.1", p["mid_resnet_1"])
    for i, kind in enumerate(config.up_block_types):
        for j in range(config.layers_per_block + 1):
            _unet_resnet(sd, f"up_blocks.{i}.resnets.{j}", p[f"up_{i}_resnet_{j}"])
            if kind == "CrossAttnUpBlock2D":
                _unet_transformer(sd, f"up_blocks.{i}.attentions.{j}",
                                  p[f"up_{i}_attn_{j}"])
        if i != n_levels - 1:
            _conv2d(sd, f"up_blocks.{i}.upsamplers.0.conv",
                    p[f"up_{i}_upsample"]["conv"])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv2d(sd, "conv_out", p["conv_out"])
    return sd


_LORA_NAME = re.compile(
    r"(?:(down|up)_blocks\.(\d+)|mid_block)\.attentions\.(\d+)\.transformer_blocks\.(\d+)"
    r"\.(attn[12])\.(to_q|to_k|to_v|to_out)(?:\.0)?\.weight")


def lora_state_dict(tree: Tree, names: Sequence[str]) -> StateDict:
    """A JAX LoRA factor tree ({..., attn: {proj: {a [in, r], b [r, out]}}},
    training/lora.py) as the state dict of the port's `LoRAFactors` whose
    adapted weights are `names` (`a.<i>`, `b.<i>` in the names' order)."""
    sd: StateDict = {}
    for i, name in enumerate(names):
        kind, level, attn_idx, block, attn, proj = _LORA_NAME.fullmatch(name).groups()
        top = f"{kind}_{level}_attn_{attn_idx}" if kind else f"mid_attn_{attn_idx}"
        node = tree[top][f"block_{block}"][attn][proj]
        sd[f"a.{i}"], sd[f"b.{i}"] = _t(node["a"]), _t(node["b"])
    return sd


# -- VAE ---------------------------------------------------------------------


def _vae_resnet(sd: StateDict, key: str, p: Tree) -> None:
    _norm(sd, f"{key}.norm1", p["norm1"])
    _conv2d(sd, f"{key}.conv1", p["conv1"])
    _norm(sd, f"{key}.norm2", p["norm2"])
    _conv2d(sd, f"{key}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv2d(sd, f"{key}.nin_shortcut", p["nin_shortcut"])


def _vae_mid(sd: StateDict, key: str, p: Tree) -> None:
    _vae_resnet(sd, f"{key}.block_1", p["mid_block_1"])
    attn = p["mid_attn_1"]
    _norm(sd, f"{key}.attn_1.norm", attn["norm"])
    for n in ("q", "k", "v", "proj_out"):
        _conv2d(sd, f"{key}.attn_1.{n}", attn[n])
    _vae_resnet(sd, f"{key}.block_2", p["mid_block_2"])


def vae_decoder_state_dict(p: Tree, config: VAEConfig) -> StateDict:
    """The decoder pair (decoder + post_quant_conv) of a JAX AutoencoderKL
    tree, for `AutoencoderKLDecoder`."""
    dec = p["decoder"]
    sd: StateDict = {}
    _conv2d(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder.mid", dec)
    for i in range(len(config.ch_mult)):
        for j in range(config.num_res_blocks + 1):
            _vae_resnet(sd, f"decoder.up.{i}.block.{j}", dec[f"up_{i}_block_{j}"])
        if i != 0:
            _conv2d(sd, f"decoder.up.{i}.upsample.conv", dec[f"up_{i}_upsample"])
    _norm(sd, "decoder.norm_out", dec["norm_out"])
    _conv2d(sd, "decoder.conv_out", dec["conv_out"])
    _conv2d(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def vae_state_dict(p: Tree, config: VAEConfig) -> StateDict:
    """A whole JAX AutoencoderKL tree (encoder, quant_conv and the decoder
    pair), for `AutoencoderKL`."""
    enc = p["encoder"]
    sd = vae_decoder_state_dict(p, config)
    _conv2d(sd, "encoder.conv_in", enc["conv_in"])
    for i in range(len(config.ch_mult)):
        for j in range(config.num_res_blocks):
            _vae_resnet(sd, f"encoder.down.{i}.block.{j}", enc[f"down_{i}_block_{j}"])
        if i != len(config.ch_mult) - 1:
            _conv2d(sd, f"encoder.down.{i}.downsample.conv", enc[f"down_{i}_downsample"])
    _vae_mid(sd, "encoder.mid", enc)
    _norm(sd, "encoder.norm_out", enc["norm_out"])
    _conv2d(sd, "encoder.conv_out", enc["conv_out"])
    _conv2d(sd, "quant_conv", p["quant_conv"])
    return sd


# -- HiFi-GAN ----------------------------------------------------------------


def hifigan_state_dict(p: Tree, config: HiFiGANConfig) -> StateDict:
    sd: StateDict = {}
    _conv1d(sd, "conv_pre", p["conv_pre"])
    nk = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        sd[f"ups.{i}.weight"] = _t(p[f"ups_{i}_kernel"], (2, 1, 0))
        sd[f"ups.{i}.bias"] = _t(p[f"ups_{i}_bias"])
        for j in range(nk):
            blk = p[f"resblock_{i}_{j}"]
            for m in range(len(config.resblock_dilation_sizes[j])):
                for c in ("convs1", "convs2"):
                    _conv1d(sd, f"resblocks.{i * nk + j}.{c}.{m}", blk[f"{c}_{m}"])
    _conv1d(sd, "conv_post", p["conv_post"])
    return sd


def load_pipeline_params(pipeline, params) -> None:
    """Load a JAX `PipelineParams`-like object (attributes t5, vae, vocoder
    and the UNet roles, each a tree or None) into a port `Pipeline`,
    strictly: a missing or unexpected key raises."""
    cfg = pipeline.config
    # load_state_dict copies into the existing parameters, casting to their
    # dtype and device
    pipeline.t5.load_state_dict(t5_state_dict(params.t5, cfg.t5.num_layers))
    pipeline.vae.load_state_dict(vae_state_dict(params.vae, cfg.vae))
    pipeline.vocoder.load_state_dict(hifigan_state_dict(params.vocoder, cfg.vocoder))
    for role, unet in pipeline.unets.items():
        tree = getattr(params, role, None)
        if tree is not None:
            unet.load_state_dict(unet_state_dict(tree, unet.config))
