"""One-class API: load once, then prompts -> waveforms (the port's
counterpart of consistencytta_tpu/easy.py, after the reference's
easy_inference/consistencytta.py):

    from consistencytta_torch.easy import ConsistencyTTA
    model = ConsistencyTTA(unet_checkpoint="unet_state_dict.pt",
                           vae_checkpoint="vae_state_dict.pt")
    wav = model("A dog barks while a car passes by.", cfg_scale_input=4.0)

Runs on the card unless `device="cpu"` is passed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from consistencytta_torch.configs import PipelineConfig, UNetConfig
from consistencytta_torch.inference.generate import GenerateConfig, build_generate_fn
from consistencytta_torch.io import checkpoints as ck
from consistencytta_torch.models.pipeline import Pipeline
from consistencytta_torch.text.tokenizer import load_tokenizer, tokenize_with_uncond


class ConsistencyTTA:
    def __init__(
        self,
        unet_checkpoint: Optional[str] = None,
        vae_checkpoint: Optional[str] = None,
        full_checkpoint: Optional[str] = None,
        unet_config_json: Optional[str] = None,
        text_encoder: str = "google/flan-t5-large",
        use_bf16: bool = True,
        random_init_seed: Optional[int] = None,
        text_len: int = 64,
        pipeline_config: Optional[PipelineConfig] = None,
        device="cuda",
    ):
        """`unet_checkpoint`: a bare guided-UNet state dict (the
        easy_inference format), loaded as the student; `full_checkpoint`: a
        full ConsistencyTTA model instead; `vae_checkpoint`: the VAE (and
        its vocoder, where it holds one). With `random_init_seed`, what no
        checkpoint holds keeps the pipeline's seeded init."""
        config = pipeline_config or PipelineConfig()
        if unet_config_json:
            config = PipelineConfig.from_dict(
                {**config.to_dict(),
                 "unet": UNetConfig.from_diffusers_json(unet_config_json).to_dict()})
        self.config = config
        self.text_len = text_len
        self.pipeline = Pipeline.create(
            config, dtype=torch.bfloat16 if use_bf16 else torch.float32, device=device,
            seed=0 if random_init_seed is None else random_init_seed, roles=("student_ema",))
        self.tokenizer = load_tokenizer(text_encoder, vocab_size=config.t5.vocab_size)
        loaded = ck.load_frozen_and_roles(
            self.pipeline, model_path=None if unet_checkpoint else full_checkpoint,
            vae_checkpoint=vae_checkpoint, random_init_seed=random_init_seed or 0)
        if unet_checkpoint:
            ck.load_into(self.pipeline.unets["student_ema"],
                     ck.load_torch_state_dict(unet_checkpoint), "student_ema")
            loaded["student_ema"] = unet_checkpoint
        missing = [m for m in ("vae", "vocoder", "student_ema") if m not in loaded]
        if random_init_seed is None and missing:
            raise ValueError(f"no checkpoint holds {missing}; pass their files or "
                             "random_init_seed")
        self._generate: Dict[tuple, object] = {}
        self._generator = torch.Generator(device=self.pipeline.device).manual_seed(0)

    def __call__(self, prompt: Union[str, Sequence[str]], cfg_scale_input: float = 3.0,
                 cfg_scale_post: float = 1.0, num_steps: int = 1, num_samples: int = 1,
                 seed: Optional[int] = None) -> np.ndarray:
        """Prompt(s) -> waveform [B * num_samples, samples] float32, 9.5 s
        long as in easy_inference; each prompt repeated num_samples times."""
        prompts: List[str] = [prompt] if isinstance(prompt, str) else list(prompt)
        if num_samples > 1:
            prompts = [p for p in prompts for _ in range(num_samples)]
        text = tokenize_with_uncond(self.tokenizer, prompts, self.text_len)
        key = (num_steps, cfg_scale_post)
        if key not in self._generate:
            self._generate[key] = build_generate_fn(self.pipeline, GenerateConfig(
                num_steps=num_steps, guidance_post=cfg_scale_post, truncate_seconds=9.5))
        generator = self._generator if seed is None else \
            torch.Generator(device=self.pipeline.device).manual_seed(seed)
        wav = self._generate[key](*text, np.float32(cfg_scale_input), generator=generator)
        return wav.cpu().numpy()
