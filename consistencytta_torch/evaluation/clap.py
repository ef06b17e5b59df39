"""CLAP embedding extraction for the evaluation harness.

The port's counterpart of consistencytta_tpu/evaluation/clap.py: the towers
of evaluation/clap_model.py wired to the harness protocol
(audioldm_eval/eval.py:30-56): 48 kHz audio features with the seeded
truncation, RoBERTa-tokenized captions, L2-normalised joint embeddings.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def clap_embeddings(
    gen_paths: List[str],
    ref_paths: List[str],
    captions: List[str],
    checkpoint: Optional[str],
    device="cuda",
) -> Optional[Dict[str, np.ndarray]]:
    """{"gen": [N, 512], "gt": [N, 512], "text": [N, 512]}, or None where
    the checkpoint or the tokenizer's files are absent."""
    if not checkpoint or not os.path.exists(checkpoint):
        return None

    from consistencytta_torch.evaluation.clap_model import CLAPWrapper

    wrapper = CLAPWrapper.from_checkpoint(checkpoint, device=device)
    if wrapper is None:
        return None
    gen = wrapper.audio_embeddings(gen_paths)
    gt = wrapper.audio_embeddings(ref_paths)
    text = wrapper.text_embeddings(captions)
    return {"gen": gen, "gt": gt, "text": text}
