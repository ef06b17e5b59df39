"""The stage-3 FTVAE variant: the CLAP fine-tune with a trainable VAE decoder.

The port's counterpart of the JAX package's training/ftvae.py, after the
reference's models/audio_consistency_model_ftvae.py (`--finetune_vae`): the
VAE decoder and its post_quant_conv join the student UNet as trainable
parameters under one AdamW, carry an EMA shadow at `ema_decay`, and the
CLAP loss decodes the predicted latent through the trainable decoder. It
requires the CLAP loss (the reference asserts `loss_type == 'clap'`, :32).

The trainable pair is a float32 copy of the pipeline's VAE decoder
(`vae_decoder_subset`): the frozen VAE, which the encoder side and the other
losses use, shares no tensor with it, as the JAX package's `create` copies
for the same reason. On the card the copy runs under bf16 autocast
(`Pipeline.decode_mel`), so its mid-block attention is kernel K2, whose
backward differentiates the plain version; its weights take float32
gradients. Where the JAX package merges the pair into the VAE's parameter
tree (`merge_vae_decoder`), the port hands the module to
`Pipeline.decode_latents(decoder=...)`.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from consistencytta_torch.nn.vae import AutoencoderKLDecoder, DiagonalGaussian
from consistencytta_torch.ops.schedulers import min_snr_weights_stage2
from consistencytta_torch.training.ema import ema_update
from consistencytta_torch.training.losses import mse_instance
from consistencytta_torch.training.optim import OptimizerConfig, make_optimizer
from consistencytta_torch.training.step import (
    Batch,
    ConsistencyStepConfig,
    TrainState,
    _check_solver,
    accumulate_gradients,
    build_validation_step,
    consistency_forward,
    guarded_update,
)
from consistencytta_torch.utils import resolve_device

DECODER_PREFIXES = ("decoder.", "post_quant_conv.")


def vae_decoder_subset(vae: nn.Module) -> AutoencoderKLDecoder:
    """A float32 copy of the VAE's decoder pair (decoder + post_quant_conv)
    on its device, trainable, sharing no storage with it."""
    dev = vae.post_quant_conv.weight.device
    with torch.device("meta"):
        dec = AutoencoderKLDecoder(vae.config)
    dec = dec.to_empty(device=dev).float()
    dec.load_state_dict({k: v for k, v in vae.state_dict().items()
                         if k.startswith(DECODER_PREFIXES)})
    return dec.eval().requires_grad_(True)


@dataclass
class FTVAETrainState(TrainState):
    """A stage-2 `TrainState` whose optimizer also holds the trainable
    decoder pair `vae_dec`; `vae_dec_ema` is its EMA shadow."""

    vae_dec: Optional[nn.Module] = None
    vae_dec_ema: Optional[nn.Module] = None

    @classmethod
    def create(cls, pipeline, config: OptimizerConfig = OptimizerConfig()) -> "FTVAETrainState":
        """From a pipeline made with `training=True`: its student roles, a
        trainable float32 copy of its VAE decoder pair and that copy's EMA,
        and one AdamW over the student and the pair."""
        base = TrainState.create(pipeline, config)
        dec = vae_decoder_subset(pipeline.vae)
        ema = copy.deepcopy(dec).requires_grad_(False)
        optimizer, lr_scheduler = make_optimizer(
            [*base.student.parameters(), *dec.parameters()], config)
        return cls(0, base.student, base.student_target, base.student_ema, optimizer,
                   lr_scheduler, config.max_grad_norm, vae_dec=dec, vae_dec_ema=ema)


def build_ftvae_train_step(pipeline, schedule, cfg: ConsistencyStepConfig,
                           clap_loss: Callable) -> Callable:
    """Returns step(state, batch, generator=None, draws=None) -> metrics for
    an `FTVAETrainState`: the stage-2 forward, `clap_loss`
    (`training/clap_loss.py:build_clap_loss`) decoding through the trainable
    pair, min-SNR weights, gradient accumulation, one guarded AdamW update of
    student and pair (a non-finite loss or gradient in either leaves both
    as they were), then the target, the student's EMA and the pair's EMA.
    The batch carries `clap_text_ids` / `clap_text_mask` besides the stage-2
    keys. The state is updated in place."""
    _check_solver(schedule, cfg)
    resolve_device(pipeline.device)

    def step(state: FTVAETrainState, batch: Batch, generator=None, draws=None):
        if state.vae_dec is None:
            raise ValueError("not an FTVAE state: make it with FTVAETrainState.create")

        def micro_loss(micro, generator, draws):
            pred, target, snr = consistency_forward(
                pipeline, schedule, cfg, state.student, state.student_target, micro,
                generator, draws)
            inst = clap_loss(pred, target, micro, decoder=state.vae_dec)
            if cfg.snr_gamma is not None:
                inst = inst * min_snr_weights_stage2(snr, cfg.snr_gamma)
            return inst.mean()

        loss = accumulate_gradients(state, micro_loss, batch, cfg.accum_steps, generator, draws)
        finite = guarded_update(state, loss)
        ema_update(state.student_target, state.student, cfg.target_ema_decay)
        ema_update(state.student_ema, state.student, cfg.ema_decay)
        ema_update(state.vae_dec_ema, state.vae_dec, cfg.ema_decay)
        state.step += 1
        return {"loss": loss, "loss_finite": finite}

    return step


def build_ftvae_validation_step(pipeline, schedule,
                                cfg: ConsistencyStepConfig = ConsistencyStepConfig()) -> Callable:
    """The 4-loss stage-2 validation (`training/step.py:build_validation_step`)
    plus `loss_decoder_mel`: the trainable decoder's mel reconstruction MSE
    on the posterior mode of the ground-truth latent, which makes a diverging
    decoder visible to the best-checkpoint tracking. The mode needs no
    random draw, so the health metric does not vary between runs."""
    base_validate = build_validation_step(pipeline, schedule, cfg)

    @torch.no_grad()
    def validate(state: FTVAETrainState, batch: Batch, generator=None, draws=None):
        losses = base_validate(state, batch, generator, draws)
        wav = torch.as_tensor(batch["wav"], device=pipeline.device, dtype=torch.float32)
        mel_gt = pipeline.frontend.wav_to_mel_image(wav, pipeline.config.target_mel_frames)
        z0 = pipeline.config.vae.scale_factor \
            * DiagonalGaussian(pipeline.vae.encode_moments(mel_gt)).mode()
        mel_rec = pipeline.decode_mel(state.vae_dec, z0)
        losses["loss_decoder_mel"] = mse_instance(mel_rec, mel_gt).mean()
        return losses

    return validate
