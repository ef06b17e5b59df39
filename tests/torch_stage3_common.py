"""Shared by the stage-3 tests of the port (tests/test_torch_stage3_*.py,
test_torch_ftvae.py): the tiny CLAP towers of tests/test_clap_loss.py in
both packages from one seeded state dict, an audible tiny pipeline, and a
batch with CLAP captions.

The tiny pipeline's random vocoder (tests/tiny.py's init) gives waveforms of
about 1e-7, whose 48-kHz log-mels all sit at the frontend's -100 dB floor:
the CLAP terms of the loss then have no gradient at all, in either package,
and a comparison of gradients would hold nothing. `audible` scales the
vocoder's output convolution by 1e6 in the JAX parameters before both
packages take them, which brings the waveforms to a few tenths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from consistencytta_tpu.evaluation import clap_model as jc
from consistencytta_torch.evaluation import clap_model as cm
from consistencytta_torch.text.tokenizer import HashClapTokenizer
from consistencytta_torch.tools import random_eval_checkpoints as R
from tests.torch_training_common import make_batch, make_jax_side, make_port

TINY_AUDIO = dict(spec_size=128, patch_size=4, patch_stride=4, embed_dim=16,
                  depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2), window_size=4, mel_bins=32)
TINY_TEXT = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                 intermediate_size=64, max_position_embeddings=80)
CLIP_SECONDS = 64 * 160 / 16000  # the tiny pipeline's segment
CLAP_TEXT_LEN = 20
VOCODER_GAIN = 1e6


def jax_configs():
    return jc.HTSATConfig(**TINY_AUDIO), jc.RobertaConfig(**TINY_TEXT)


def clap_towers(seed: int = 3):
    """(port audio tower, port text tower, JAX audio params, JAX text
    params) from one seeded laion_clap-format state dict. The JAX text
    parameters are JAX arrays (its tower indexes the embedding table with
    traced ids, which numpy refuses)."""
    acfg, tcfg = cm.HTSATConfig(**TINY_AUDIO), cm.RobertaConfig(**TINY_TEXT)
    sd = R.clap_state_dict(seed, acfg, tcfg)
    audio_sd, text_sd = cm.tower_state_dicts(sd)
    audio, text = cm.CLAPAudioTower(acfg), cm.CLAPTextTower(tcfg)
    audio.load_state_dict(audio_sd)
    text.load_state_dict(text_sd)
    npsd = {k: v.numpy() for k, v in sd.items()}
    ja, jt = jax_configs()
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    return (audio.eval(), text.eval(), as_jax(jc.convert_clap_audio(npsd, ja)),
            as_jax(jc.convert_clap_text(npsd, jt)))


def audible(params, frozen):
    """(params, frozen) with the vocoder's conv_post kernel times
    VOCODER_GAIN (see the module docstring)."""
    voc = dict(params.vocoder)
    voc["conv_post"] = {**voc["conv_post"], "kernel": voc["conv_post"]["kernel"] * VOCODER_GAIN}
    return (dataclasses.replace(params, vocoder=voc), dataclasses.replace(frozen, vocoder=voc))


def make_stage3_sides():
    """(JAX pipeline, audible params, frozen with the CLAP towers, port
    pipeline with the same weights, port audio tower, port text tower)."""
    jp, params, frozen = make_jax_side()
    params, frozen = audible(params, frozen)
    audio, text, ja, jt = clap_towers()
    frozen = dataclasses.replace(frozen, clap_audio=ja, clap_text=jt)
    return jp, params, frozen, make_port(params), audio, text


def clap_batch(b: int, seed: int = 0) -> dict:
    """`make_batch` plus the CLAP captions' ids and mask."""
    batch = make_batch(b, seed)
    enc = HashClapTokenizer(TINY_TEXT["vocab_size"])(
        [f"a tone number {i} rising" for i in range(b)], max_length=CLAP_TEXT_LEN)
    batch["clap_text_ids"], batch["clap_text_mask"] = enc["input_ids"], enc["attention_mask"]
    return batch


def to_torch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
