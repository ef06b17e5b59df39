"""Shared inputs of the evaluation-harness parity tests: clips written from a
numpy seed, a small CLAP geometry, and a tiny RoBERTa tokenizer on disk.

The tokenizer is a byte-level BPE with no merges over the lowercase letters,
written with `transformers` into a directory named `roberta-base`. With
that directory in the working directory, the JAX package's
`AutoTokenizer.from_pretrained("roberta-base")` and the port's
local-files-only loader both read it, so that the CLAP scores are computed
by both harnesses instead of being NaN.
"""

import json
import os

import jax
import numpy as np
import pytest

from consistencytta_torch.evaluation.clap_model import HTSATConfig, RobertaConfig
from consistencytta_torch.io.audio import write_wav

# the structural dims infer_clap_configs reads back from a state dict; the
# frontend fields (48 kHz, 64 mel, spec 256) stay the published ones. The
# last stage's 8 x 8 resolution equals the window, so its blocks take the
# unshifted, clamped path; hidden 32 gives 8 text heads in both packages.
SMALL_HTSAT = HTSATConfig(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4),
                          joint_embed=32)
SMALL_ROBERTA = RobertaConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=8,
                              intermediate_size=64, max_position_embeddings=80, joint_embed=32)


def clip(seed: int, n: int, sr: int = 16000) -> np.ndarray:
    """A tone, its octave and noise, peak under 0.5."""
    rng = np.random.default_rng(seed)
    f0 = 110.0 * 2 ** (4 * rng.random())
    t = np.arange(n) / sr
    wav = 0.25 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(4 * np.pi * f0 * t) \
        + 0.05 * rng.standard_normal(n)
    return wav.astype(np.float32)


def write_pairs(root, lengths, seed: int = 0):
    """gen/ and ref/ under root with one pair of same-named clips per
    length (the generated one a noisier copy); returns the two directories
    and the file names."""
    gen_dir, ref_dir = os.path.join(root, "gen"), os.path.join(root, "ref")
    os.makedirs(gen_dir), os.makedirs(ref_dir)
    rng = np.random.default_rng(seed + 1000)
    names = []
    for i, n in enumerate(lengths):
        name = f"clip_{i:02d}.wav"
        ref = clip(seed + i, n)
        write_wav(os.path.join(ref_dir, name), ref)
        write_wav(os.path.join(gen_dir, name), ref + 0.03 * rng.standard_normal(n))
        names.append(name)
    return gen_dir, ref_dir, names


def write_tiny_roberta_tokenizer(directory: str) -> str:
    from transformers import RobertaTokenizer

    path = os.path.join(directory, "roberta-base")
    os.makedirs(path, exist_ok=True)
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in map(chr, range(ord("a"), ord("z") + 1)):
        vocab[c] = len(vocab)
        vocab["Ġ" + c] = len(vocab)  # the byte-level BPE's word-initial form
    vocab["<mask>"] = len(vocab)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    RobertaTokenizer(os.path.join(path, "vocab.json"),
                     os.path.join(path, "merges.txt")).save_pretrained(path)
    return path


def jax_text_params_as_arrays(monkeypatch):
    """Make the JAX package's CLAP text parameters JAX arrays. Its
    convert_clap_text returns the checkpoint's numpy arrays, and its jitted
    RobertaEncoder indexes the word-embedding table with the traced token
    ids (clap_model.py:414), which numpy refuses (TracerArrayConversionError):
    CLAPWrapper.text_embeddings fails on any checkpoint loaded from a file.
    The port does not share the fault (ROADMAP.md section 3)."""
    import jax
    import jax.numpy as jnp

    from consistencytta_tpu.evaluation import clap_model as jc

    convert = jc.convert_clap_text
    monkeypatch.setattr(jc, "convert_clap_text",
                        lambda sd, cfg: jax.tree_util.tree_map(jnp.asarray, convert(sd, cfg)))


@pytest.fixture(scope="module", autouse=True)
def no_persistent_jax_cache():
    """Keep this module's JAX programs out of the persistent compile cache
    (tests/conftest.py): the JAX harness jits its backbones with their
    weights as constants, ~300 MB an entry."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)
