"""The stage-3 CLAP-score loss: the predicted latent decoded with gradients
and embedded by the frozen CLAP audio tower.

The port's counterpart of the JAX package's training/clap_loss.py
(`build_clap_loss`, after the reference's tools/losses.py:259-316 CLAPLoss).
Per instance:

    mse_weight * latent MSE + clap_weight * (2 - cos(gen, text) - cos(gen, gt))

`gen` is the embedding of the predicted latent decoded through the VAE
decoder and HiFi-GAN (`Pipeline.decode_latents`: kernels K2 and K3 on the
card, whose backwards differentiate their plain versions), cut to
`clip_seconds`, resampled 16 -> 48 kHz (`ops/resample.py:resample`), padded
or cut to the clip length at 48 kHz, through `CLAPMelFrontend` and
`CLAPAudioTower`. That audio path is recomputed in the backward
(`torch.utils.checkpoint`, as the JAX package wraps it in `jax.checkpoint`)
to bound the memory of the Swin's activations. `gt` embeds the micro-batch's
waveform and `text` its RoBERTa-tokenized captions (`clap_text_ids` /
`clap_text_mask`, `training/data.py`), both without gradient. The towers
are frozen: they allocate no `.grad`. The embeddings are L2-normalised, so
a cosine is a dot product.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from consistencytta_torch.evaluation.clap_model import (
    CLAPAudioTower,
    CLAPMelFrontend,
    CLAPTextTower,
)
from consistencytta_torch.ops.resample import resample
from consistencytta_torch.training.losses import mse_instance

CLAP_SAMPLE_RATE = 48000


def build_clap_loss(
    pipeline,
    audio_tower: CLAPAudioTower,
    text_tower: CLAPTextTower,
    mse_weight: float = 1.0,
    clap_weight: float = 0.1,
    clip_seconds: float = 10.0,
) -> Callable:
    """Returns instance_loss(pred_latent, target_latent, micro, decoder=None)
    -> [B], the `loss_fn_override` of `training/step.py`'s consistency step.
    `decoder` (a decoder pair) decodes in place of the pipeline's VAE: the
    FTVAE step's trainable copy. `micro` carries `wav` and the CLAP captions'
    `clap_text_ids` / `clap_text_mask`. Freezes both towers."""
    for tower in (audio_tower, text_tower):
        tower.eval().requires_grad_(False)
    dev, sr = pipeline.device, pipeline.config.sample_rate
    frontend = CLAPMelFrontend(audio_tower.config, device=dev)
    target = int(CLAP_SAMPLE_RATE * clip_seconds)

    def embed(wav_16k):
        wav_48k = resample(wav_16k[:, : int(sr * clip_seconds)], sr, CLAP_SAMPLE_RATE)
        n = wav_48k.shape[1]
        wav_48k = F.pad(wav_48k, (0, target - n)) if n < target else wav_48k[:, :target]
        return audio_tower(frontend(wav_48k))

    def embed_audio(wav_16k):
        # recomputed in the backward when the waveform carries gradients
        if torch.is_grad_enabled() and wav_16k.requires_grad:
            return checkpoint(embed, wav_16k, use_reentrant=False)
        return embed(wav_16k)

    def loss_fn(pred_latent, target_latent, micro, decoder: Optional[nn.Module] = None):
        mse = mse_instance(pred_latent, target_latent)
        wav_gen = pipeline.decode_latents(pred_latent, decoder=decoder)
        gen_emb = embed_audio(wav_gen)
        with torch.no_grad():
            gt_emb = embed_audio(torch.as_tensor(micro["wav"], device=dev).float())
            text_emb = text_tower(torch.as_tensor(micro["clap_text_ids"], device=dev).long(),
                                  torch.as_tensor(micro["clap_text_mask"], device=dev).long())
        gen_text = (gen_emb * text_emb).sum(dim=-1)
        gen_gt = (gen_emb * gt_emb).sum(dim=-1)
        return mse_weight * mse + clap_weight * (2.0 - gen_text - gen_gt)

    return loss_fn
