"""Prompt tokenization for the frozen text encoder.

`HFTokenizer` wraps a Hugging Face sentencepiece tokenizer whose files are
on disk (a local path, or a name already in the local cache: the port never
downloads). `HashTokenizer` is a deterministic, dependency-free stand-in
that hashes whitespace tokens into the T5 vocab range; it is not lexically
compatible with sentencepiece and exists so runs without tokenizer files
work. `load_tokenizer` takes the first when it resolves, else the second.
Both pad to a fixed length (padding="max_length").

The stage-3 CLAP loss tokenizes captions for the CLAP text tower with
RoBERTa's tokenizer: `load_clap_tokenizer` takes it where its files are
local, else `HashClapTokenizer`, the same kind of stand-in with RoBERTa's
special ids.
"""

from __future__ import annotations

import hashlib
import os
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


class HFTokenizer:
    """A Hugging Face tokenizer from local files, with fixed-length padding
    and truncation; ids and mask as int32 numpy arrays."""

    def __init__(self, name_or_path: str = "google/flan-t5-large"):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=True)
        self.model_max_length = self.tok.model_max_length

    def __call__(
        self, prompts: Sequence[str], max_length: int, padding: str = "max_length"
    ) -> Tuple[np.ndarray, np.ndarray]:
        batch = self.tok(list(prompts), max_length=max_length, padding="max_length",
                         truncation=True, return_tensors="np")
        return batch["input_ids"].astype(np.int32), batch["attention_mask"].astype(np.int32)


def _tokenizer_files_present(name_or_path: str) -> bool:
    """A local directory, or a hub name whose tokenizer config is in the
    local cache. Looked up before `transformers` is imported: importing it
    only to find no files costs seconds (8 to 28 s on an H100 host)."""
    if os.path.isdir(name_or_path):
        return True
    try:
        from huggingface_hub import try_to_load_from_cache
    except ImportError:
        return False
    try:
        return isinstance(try_to_load_from_cache(name_or_path, "tokenizer_config.json"), str)
    except ValueError:  # not a valid hub name
        return False


def load_tokenizer(name_or_path: str = "google/flan-t5-large", vocab_size: int = 32128):
    """`HFTokenizer` when the tokenizer's files are local and `transformers`
    is installed, else `HashTokenizer(vocab_size)` (its ids stay inside the
    model's embedding table)."""
    if _tokenizer_files_present(name_or_path):
        try:
            return HFTokenizer(name_or_path)
        except (ImportError, OSError, ValueError):
            pass
    return HashTokenizer(vocab_size=vocab_size)


def tokenize_with_uncond(
    tokenizer, prompts: Sequence[str], max_length: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Tokenize prompts plus the empty-string unconditional batch used for
    classifier-free guidance (uncond tokens are "" padded to the same
    length)."""
    ids, mask = tokenizer(prompts, max_length)
    uncond_ids, uncond_mask = tokenizer([""] * len(prompts), max_length)
    return ids, mask, uncond_ids, uncond_mask


ROBERTA_BOS_ID = 0
ROBERTA_PAD_ID = 1
ROBERTA_EOS_ID = 2


class HashClapTokenizer:
    """Stand-in for the RoBERTa tokenizer of the CLAP text tower, with the
    Hugging Face tokenizer's dict-returning call (what `training/data.py`'s
    loader calls): whitespace words hashed into the vocabulary's range, with
    RoBERTa's special ids (bos 0, pad 1, eos 2). Not lexically compatible
    with RoBERTa's BPE: real CLAP checkpoints need the real tokenizer."""

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
        return 3 + (h % (self.vocab_size - 3))

    def __call__(self, prompts: Sequence[str], padding: str = "max_length",
                 truncation: bool = True, max_length: int = 77,
                 return_tensors: str = "np") -> dict:
        ids = np.full((len(prompts), max_length), ROBERTA_PAD_ID, np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, prompt in enumerate(prompts):
            toks = [ROBERTA_BOS_ID]
            toks += [self._word_id(w) for w in prompt.lower().split()][: max_length - 2]
            toks.append(ROBERTA_EOS_ID)
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_clap_tokenizer(vocab_size: int = 50265):
    """RoBERTa's tokenizer for the CLAP text tower where its files are local
    (never downloaded) and its vocabulary fits the tower's embedding table
    (`vocab_size`), else `HashClapTokenizer(vocab_size)`. Never None."""
    if _tokenizer_files_present("roberta-base"):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained("roberta-base", local_files_only=True)
        except (ImportError, OSError, ValueError):
            tok = None
        if tok is not None and getattr(tok, "vocab_size", 0) <= vocab_size:
            return tok
    return HashClapTokenizer(vocab_size=vocab_size)
