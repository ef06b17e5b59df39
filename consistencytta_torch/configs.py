"""Configuration dataclasses for every component of the pipeline.

The port's own copy of the JAX package's config classes, field for field,
so that a JSON config written by either package loads in the other. A few
fields only steer TPU layouts there (`use_flash_attention`,
`rechannel_small_convs`, `strict_upcast`); they are kept so such configs
load, and select nothing here: on a CUDA tensor the port always runs its
kernels, on a CPU tensor their plain versions.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


class JsonConfig:
    """Mixin: json round-trip for config dataclasses."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclass(frozen=True)
class STFTConfig(JsonConfig):
    """Training-time mel frontend (filter 1024 / hop 160 / 64 mel / 16 kHz)."""

    filter_length: int = 1024
    hop_length: int = 160
    win_length: int = 1024
    n_mel_channels: int = 64
    sampling_rate: int = 16000
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    compression_clip: float = 1e-5


@dataclass(frozen=True)
class VAEConfig(JsonConfig):
    """AudioLDM AutoencoderKL config."""

    in_channels: int = 1
    out_channels: int = 1
    base_channels: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 8
    embed_dim: int = 8
    double_z: bool = True
    scale_factor: float = 1.0
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    use_flash_attention: bool = True  # inert in the port


@dataclass(frozen=True)
class HiFiGANConfig(JsonConfig):
    """HiFi-GAN generator config (16 kHz / 64-mel variant)."""

    num_mels: int = 64
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    sampling_rate: int = 16000
    lrelu_slope: float = 0.1
    rechannel_small_convs: bool = True  # inert in the port


@dataclass(frozen=True)
class UNetConfig(JsonConfig):
    """CFG-guidance-conditioned 2-D cross-attention UNet.

    `attention_head_dim` is the number of attention *heads* per level (the
    diffusers misnomer); the head width is channels // heads, which gives
    transformer inner dims 255/510/1020 for the light config (head width
    51). The parameters keep those widths; on the way through, the
    transformer carries its tokens zero-padded to 256/512/1024 and its
    heads to 64, and its GEGLU's hidden 1020 to 1024 (`nn/attention.py`).
    """

    in_channels: int = 8
    out_channels: int = 8
    block_out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    act_fn: str = "silu"
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_linear_projection: bool = True
    upcast_attention: bool = True
    strict_upcast: bool = False  # inert in the port
    use_flash_attention: bool = True  # inert in the port
    downsample_padding: int = 1
    mid_block_scale_factor: float = 1.0
    time_embedding_type: str = "positional"
    guidance_embedding_type: str = "fourier"
    guided: bool = True

    @classmethod
    def from_diffusers_json(cls, path_or_dict) -> "UNetConfig":
        """From a reference-format diffusers UNet config (a json path or its
        dict), as the reference's --unet_model_config gives it."""
        if isinstance(path_or_dict, dict):
            d = path_or_dict
        else:
            with open(path_or_dict) as f:
                d = json.load(f)
        heads = d["attention_head_dim"]
        return cls(
            in_channels=d["in_channels"],
            out_channels=d["out_channels"],
            block_out_channels=tuple(d["block_out_channels"]),
            down_block_types=tuple(d["down_block_types"]),
            up_block_types=tuple(d["up_block_types"]),
            layers_per_block=d.get("layers_per_block", 2),
            attention_head_dim=tuple(heads) if isinstance(heads, (list, tuple))
            else (heads,) * len(d["block_out_channels"]),
            cross_attention_dim=d.get("cross_attention_dim", 1024),
            norm_num_groups=d.get("norm_num_groups", 32),
            norm_eps=d.get("norm_eps", 1e-5),
            act_fn=d.get("act_fn", "silu"),
            flip_sin_to_cos=d.get("flip_sin_to_cos", True),
            freq_shift=d.get("freq_shift", 0),
            use_linear_projection=d.get("use_linear_projection", False),
            upcast_attention=d.get("upcast_attention", False),
            downsample_padding=d.get("downsample_padding", 1),
            mid_block_scale_factor=d.get("mid_block_scale_factor", 1.0),
        )

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)


# The two shipped UNet configs (reference configs/tango_diffusion_light.json
# and configs/tango_diffusion.json). TANGO's full UNet runs every width at a
# head width of 64, so its transformers pad nothing; with `guided=False` it
# is the TANGO teacher.
TANGO_LIGHT_UNET = UNetConfig()
TANGO_FULL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280, 1280),
)


@dataclass(frozen=True)
class T5Config(JsonConfig):
    """T5 encoder config; defaults match google/flan-t5-large."""

    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    max_length: int = 512


@dataclass(frozen=True)
class SchedulerConfig(JsonConfig):
    """Noise schedule config (SD-2.1: scaled_linear 0.00085 -> 0.012,
    1000 steps, v_prediction)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"


@dataclass(frozen=True)
class LatentShape(JsonConfig):
    """Latent geometry [T, F, C] (NHWC): 256 x 16 x 8 for 10.24-s clips."""

    t: int = 256
    f: int = 16
    c: int = 8


@dataclass(frozen=True)
class PipelineConfig(JsonConfig):
    """Bundle for the end-to-end generation pipeline."""

    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    vocoder: HiFiGANConfig = field(default_factory=HiFiGANConfig)
    stft: STFTConfig = field(default_factory=STFTConfig)
    t5: T5Config = field(default_factory=T5Config)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    latent: LatentShape = field(default_factory=LatentShape)
    sample_rate: int = 16000
    segment_samples: int = 1024 * 160
    target_mel_frames: int = 1024

    @classmethod
    def tiny(cls) -> "PipelineConfig":
        """Shrunken pipeline with production topology (4-level UNet, 4x VAE,
        160x vocoder, T5): 0.64-s clips, latent 16x16x8."""
        return cls(
            unet=UNetConfig(
                block_out_channels=(16, 16, 32, 32),
                attention_head_dim=(2, 2, 4, 4),
                cross_attention_dim=32,
                norm_num_groups=8,
            ),
            vae=VAEConfig(base_channels=16, norm_num_groups=8, scale_factor=0.9),
            vocoder=HiFiGANConfig(upsample_initial_channel=64),
            t5=T5Config(
                vocab_size=256, d_model=32, d_kv=16, d_ff=64,
                num_layers=2, num_heads=2,
            ),
            latent=LatentShape(t=16, f=16, c=8),
            segment_samples=64 * 160,
            target_mel_frames=64,
        )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        def sub(klass, key):
            v = d.get(key)
            if v is None:
                return klass()
            return klass.from_dict(v) if isinstance(v, dict) else v

        return cls(
            unet=sub(UNetConfig, "unet"),
            vae=sub(VAEConfig, "vae"),
            vocoder=sub(HiFiGANConfig, "vocoder"),
            stft=sub(STFTConfig, "stft"),
            t5=sub(T5Config, "t5"),
            scheduler=sub(SchedulerConfig, "scheduler"),
            latent=sub(LatentShape, "latent"),
            sample_rate=d.get("sample_rate", 16000),
            segment_samples=d.get("segment_samples", 1024 * 160),
            target_mel_frames=d.get("target_mel_frames", 1024),
        )
