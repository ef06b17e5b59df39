"""Training data on the host: json manifests -> fixed-shape numpy batches.

The port's copy of the JAX package's training/data.py (the reference's
tools/t2a_dataset.py, tools/mix.py and tools/torch_tools.py:92-123): the
same manifests (columns `captions` / `location` by default), the same
waveform preprocessing (`io/audio.read_wav_file`), the same loudness-matched
mix augmentation, and the same draws: the order from
`np.random.default_rng(seed)`, the mixes from `random.Random(seed)`. So a
manifest and a seed give the batches the JAX loader gives, captions and
token ids included. Batches are numpy; `to_device` puts one on the card.
"""

from __future__ import annotations

import itertools
import json
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from consistencytta_torch.io.audio import read_wav_file
from consistencytta_torch.text.tokenizer import tokenize_with_uncond
from consistencytta_torch.utils import resolve_device


def a_weight(fs: int, n_fft: int, min_db: float = -80.0) -> np.ndarray:
    """IEC A-weighting curve in dB over the rfft bins."""
    freq = np.linspace(0, fs // 2, n_fft // 2 + 1)
    freq_sq = np.power(freq, 2)
    freq_sq[0] = 1.0
    weight = 2.0 + 20.0 * (
        2 * np.log10(12194)
        + 2 * np.log10(freq_sq)
        - np.log10(freq_sq + 12194**2)
        - np.log10(freq_sq + 20.6**2)
        - 0.5 * np.log10(freq_sq + 107.7**2)
        - 0.5 * np.log10(freq_sq + 737.9**2)
    )
    return np.maximum(weight, min_db)


def compute_gain_db(sound: np.ndarray, fs: int, min_db: float = -80.0) -> np.ndarray:
    """A-weighted energy in dB of each half-overlapping Hann frame."""
    if fs == 16000:
        n_fft = 2048
    elif fs == 44100:
        n_fft = 4096
    else:
        raise ValueError(f"invalid fs {fs}")
    stride = n_fft // 2
    aw = np.power(10, a_weight(fs, n_fft) / 10)
    window = np.hanning(n_fft + 1)[:-1]
    gains = []
    for i in range(0, len(sound) - n_fft + 1, stride):
        spec = np.fft.rfft(window * sound[i : i + n_fft])
        gains.append(np.sum(np.abs(spec) ** 2 * aw))
    g = np.maximum(np.array(gains), np.power(10, min_db / 10))
    return 10 * np.log10(g)


def mix_sounds(s1: np.ndarray, s2: np.ndarray, r: float, fs: int) -> np.ndarray:
    """Mix two sounds at ratio r after matching their loudness."""
    g1 = np.max(compute_gain_db(s1, fs))
    g2 = np.max(compute_gain_db(s2, fs))
    t = 1.0 / (1 + np.power(10, (g1 - g2) / 20.0) * (1 - r) / r)
    return (s1 * t + s2 * (1 - t)) / np.sqrt(t**2 + (1 - t) ** 2)


def _uncapitalize(s: str) -> str:
    return s[:1].lower() + s[1:] if s else ""


def augment_batch(waveforms: np.ndarray, texts: Sequence[str],
                  num_items: Optional[int] = None, sr: int = 16000,
                  rng: Optional[random.Random] = None):
    """Pairwise mix augmentation: up to len(texts) // 2 random pairs, mixed
    at 0.5, captioned "A and b", the set renormalised to a peak of 0.5.
    Returns (mixes [n, samples] float32, captions)."""
    rng = rng or random
    if num_items is None:
        num_items = len(texts) // 2
    combos = list(itertools.combinations(range(len(texts)), 2))
    rng.shuffle(combos)
    combos = combos[:num_items]
    mixed_wavs, mixed_caps = [], []
    for i, j in combos:
        mixed_wavs.append(mix_sounds(waveforms[i], waveforms[j], 0.5, sr))
        mixed_caps.append(f"{texts[i]} and {_uncapitalize(texts[j])}")
    if not mixed_wavs:
        return np.zeros((0, waveforms.shape[1]), np.float32), []
    mixed = np.stack(mixed_wavs)
    mixed = mixed / np.abs(mixed).max() / 2.0
    return mixed.astype(np.float32), mixed_caps


@dataclass
class T2ADataset:
    """Text-audio pairs from a json manifest: {"data": [{...}, ...]}, a JSON
    list of rows, or jsonl, each row carrying the caption and wav-path
    columns (the reference's data/*.json)."""

    captions: List[str]
    paths: List[str]
    segment_length: int = 1024 * 160
    target_sr: int = 16000

    @classmethod
    def from_json(cls, path: str, text_column: str = "captions",
                  audio_column: str = "location", num_examples: int = -1,
                  prefix: Optional[str] = None, **kwargs) -> "T2ADataset":
        """`prefix` is prepended to every caption (the reference's --prefix)."""
        rows: List[dict] = []
        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "{":
                try:
                    obj = json.load(f)
                    if isinstance(obj, dict):
                        # a {"data": [...]} manifest, or a single jsonl row
                        rows = obj["data"] if "data" in obj else [obj]
                    else:
                        rows = obj
                except json.JSONDecodeError:
                    f.seek(0)
                    rows = [json.loads(line) for line in f if line.strip()]
            elif first == "[":
                rows = json.load(f)
            else:
                rows = [json.loads(line) for line in f if line.strip()]
        if num_examples > 0:
            rows = rows[:num_examples]
        return cls(captions=[(prefix or "") + r[text_column] for r in rows],
                   paths=[r[audio_column] for r in rows], **kwargs)

    def __len__(self) -> int:
        return len(self.captions)

    def shard(self, process_index: int, process_count: int) -> "T2ADataset":
        """The rows of one of `process_count` processes: k, k + P, k + 2P, ..."""
        return T2ADataset(captions=self.captions[process_index::process_count],
                          paths=self.paths[process_index::process_count],
                          segment_length=self.segment_length, target_sr=self.target_sr)

    def load_item(self, idx: int):
        """(caption, float32 waveform [segment_length])."""
        wav = read_wav_file(self.paths[idx], self.segment_length, self.target_sr)
        return self.captions[idx], wav


@dataclass
class DataLoader:
    """Batches of an exact size, with optional mix augmentation and
    tokenization. The last short batch of an epoch is dropped. With
    `augment`, each batch holds (2 * batch_size + 2) // 3 originals and
    their mixes, cut to batch_size. Each batch: wav [B, samples] float32,
    ids / mask / uncond_ids / uncond_mask [B, text_len] int32, captions;
    with `clap_tokenizer`, also clap_text_ids / clap_text_mask."""

    dataset: T2ADataset
    tokenizer: object
    batch_size: int
    text_len: int = 64
    augment: bool = False
    shuffle: bool = True
    seed: int = 0
    clap_tokenizer: object = None
    clap_text_len: int = 77

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        rng = random.Random(self.seed)
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        # with augmentation, fewer originals keep the emitted size fixed
        n_orig = self.batch_size
        if self.augment:
            n_orig = (self.batch_size * 2 + 2) // 3
        for start in range(0, len(order) - n_orig + 1, n_orig):
            caps, wavs = [], []
            for i in order[start : start + n_orig]:
                c, w = self.dataset.load_item(int(i))
                caps.append(c)
                wavs.append(w)
            wav = np.stack(wavs)
            if self.augment:
                mixed, mixed_caps = augment_batch(wav, caps, rng=rng)
                wav = np.concatenate([wav, mixed], axis=0)[: self.batch_size]
                caps = (caps + mixed_caps)[: self.batch_size]
                if wav.shape[0] < self.batch_size:
                    continue
            ids, mask, uids, umask = tokenize_with_uncond(self.tokenizer, caps, self.text_len)
            batch = {"wav": wav.astype(np.float32), "ids": ids, "mask": mask,
                     "uncond_ids": uids, "uncond_mask": umask, "captions": caps}
            if self.clap_tokenizer is not None:
                enc = self.clap_tokenizer(caps, padding="max_length", truncation=True,
                                          max_length=self.clap_text_len, return_tensors="np")
                batch["clap_text_ids"] = enc["input_ids"].astype(np.int32)
                batch["clap_text_mask"] = enc["attention_mask"].astype(np.int32)
            yield batch


def to_device(batch: Dict[str, np.ndarray], device="cuda") -> Dict[str, torch.Tensor]:
    """A loader batch as tensors on `device`, captions dropped: through
    pinned host memory and a non-blocking copy for the card. Asking for the
    card where there is none raises."""
    dev = resolve_device(device)
    out = {}
    for key, value in batch.items():
        if key == "captions":
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
    return out
