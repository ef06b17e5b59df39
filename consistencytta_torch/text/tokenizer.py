"""Prompt tokenization for the frozen text encoder.

`HashTokenizer` is a deterministic, dependency-free stand-in that hashes
whitespace tokens into the T5 vocab range; it is not lexically compatible
with sentencepiece and exists so runs without tokenizer files work. It
pads to a fixed length, like the HF tokenizer with padding="max_length".
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np

T5_EOS_ID = 1
T5_PAD_ID = 0


class HashTokenizer:
    """Deterministic stand-in tokenizer (see module docstring)."""

    def __init__(self, vocab_size: int = 32128, max_length: int = 512):
        self.vocab_size = vocab_size
        self.model_max_length = max_length

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
        return 2 + (h % (self.vocab_size - 2))  # avoid pad/eos ids

    def __call__(
        self, prompts: Sequence[str], max_length: int, padding: str = "max_length"
    ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(prompts), max_length), T5_PAD_ID, np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, prompt in enumerate(prompts):
            toks = [self._word_id(w) for w in prompt.lower().split()][: max_length - 1]
            toks.append(T5_EOS_ID)
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask


def tokenize_with_uncond(
    tokenizer, prompts: Sequence[str], max_length: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize prompts plus the empty-string unconditional batch used for
    classifier-free guidance (uncond tokens are "" padded to the same
    length)."""
    ids, mask = tokenizer(prompts, max_length)
    uncond_ids, uncond_mask = tokenizer([""] * len(prompts), max_length)
    return ids, mask, uncond_ids, uncond_mask
