"""The port's training data (consistencytta_torch/training/data.py) against
the JAX package's (consistencytta_tpu/training/data.py): the A-weighting,
gain, mixing and augmentation functions on the same inputs, and the
loaders' batches on one 16-kHz manifest and seed, in order, with and without
`augment`: waveforms, token ids, masks and captions equal. Both packages
run the same float64 numpy arithmetic, so every comparison is exact.
"""

import json
import random

import numpy as np
import pytest
import torch

from consistencytta_tpu.text.tokenizer import HashTokenizer as JaxHashTokenizer
from consistencytta_tpu.training import data as jdata
from consistencytta_torch.io.audio import write_wav
from consistencytta_torch.text.tokenizer import HashTokenizer
from consistencytta_torch.training import data

SEG = 16000


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    t = np.arange(SEG) / 16000
    rows = []
    for i in range(11):
        path = str(d / f"c{i}.wav")
        wav = 0.4 * np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.05 * rng.standard_normal(SEG)
        write_wav(path, wav * (0.2 + 0.08 * i))
        rows.append({"captions": f"Tone number {i}", "location": path})
    path = str(d / "manifest.json")
    with open(path, "w") as f:
        json.dump({"data": rows}, f)
    return path


def _datasets(manifest):
    return (data.T2ADataset.from_json(manifest, segment_length=SEG),
            jdata.T2ADataset.from_json(manifest, segment_length=SEG))


def test_weighting_gain_and_mix_equal_jax():
    rng = np.random.default_rng(1)
    for fs, n_fft in ((16000, 2048), (44100, 4096)):
        np.testing.assert_array_equal(data.a_weight(fs, n_fft), jdata.a_weight(fs, n_fft))
    a, b = rng.standard_normal(SEG) * 0.5, rng.standard_normal(SEG) * 0.005
    np.testing.assert_array_equal(data.compute_gain_db(a, 16000),
                                  jdata.compute_gain_db(a, 16000))
    for r in (0.5, 0.3):
        np.testing.assert_array_equal(data.mix_sounds(a, b, r, 16000),
                                      jdata.mix_sounds(a, b, r, 16000))
    with pytest.raises(ValueError, match="fs"):
        data.compute_gain_db(a, 22050)


@pytest.mark.parametrize("num_items", [None, 1])
def test_augment_batch_equals_jax(num_items):
    rng = np.random.default_rng(2)
    wavs = (rng.standard_normal((5, SEG)) * 0.3).astype(np.float32)
    caps = ["A dog", "Rain falls", "", "Birds", "wind"]
    got = data.augment_batch(wavs, caps, num_items, rng=random.Random(3))
    want = jdata.augment_batch(wavs, caps, num_items, rng=random.Random(3))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32 and got[1] == want[1]
    assert any(" and " in c for c in got[1])
    empty = data.augment_batch(wavs[:1], caps[:1])
    assert empty[0].shape == (0, SEG) and empty[1] == []


@pytest.mark.parametrize("augment,batch_size,seed,shuffle", [
    (False, 3, 0, True), (False, 4, 5, False), (True, 3, 0, True), (True, 6, 7, True)])
def test_loader_batches_equal_jax(manifest, augment, batch_size, seed, shuffle):
    ds, jds = _datasets(manifest)
    kw = dict(batch_size=batch_size, text_len=12, augment=augment, shuffle=shuffle, seed=seed)
    got = list(data.DataLoader(ds, HashTokenizer(), **kw))
    want = list(jdata.DataLoader(jds, JaxHashTokenizer(), **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["captions"] == w["captions"] and len(g["captions"]) == batch_size
        for k in ("ids", "mask", "uncond_ids", "uncond_mask"):
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g["wav"], w["wav"])
        assert g["wav"].shape == (batch_size, SEG) and g["wav"].dtype == np.float32
    if augment:
        assert any(" and " in c for b in got for c in b["captions"])


def test_loader_clap_columns_and_shard(manifest):
    ds, jds = _datasets(manifest)

    def clap_tok(caps, padding, truncation, max_length, return_tensors):
        ids = np.array([[len(c) % 7 + 1] * max_length for c in caps])
        return {"input_ids": ids, "attention_mask": np.ones_like(ids)}

    kw = dict(batch_size=2, text_len=8, clap_tokenizer=clap_tok, clap_text_len=5)
    got = next(iter(data.DataLoader(ds, HashTokenizer(), **kw)))
    want = next(iter(jdata.DataLoader(jds, JaxHashTokenizer(), **kw)))
    for k in ("clap_text_ids", "clap_text_mask"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.int32 and got[k].shape == (2, 5)
    for k, n in ((0, 3), (2, 3)):
        part, jpart = ds.shard(k, n), jds.shard(k, n)
        assert part.captions == jpart.captions and part.paths == jpart.paths
        assert part.segment_length == SEG and len(part) == len(ds.captions[k::n])
    cap, wav = ds.load_item(4)
    jcap, jwav = jds.load_item(4)
    assert cap == jcap
    np.testing.assert_array_equal(wav, jwav)


def test_to_device_drops_captions_and_keeps_dtypes(manifest, monkeypatch):
    ds, _ = _datasets(manifest)
    batch = next(iter(data.DataLoader(ds, HashTokenizer(), batch_size=2, text_len=8)))
    out = data.to_device(batch, "cpu")
    assert set(out) == set(batch) - {"captions"}
    assert out["wav"].dtype == torch.float32 and out["ids"].dtype == torch.int32
    np.testing.assert_array_equal(out["wav"].numpy(), batch["wav"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        data.to_device(batch, "cuda")
