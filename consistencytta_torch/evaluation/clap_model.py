"""LAION-CLAP (HTSAT-base + RoBERTa) for the CLAP scores.

The port's counterpart of consistencytta_tpu/evaluation/clap_model.py,
after the reference tree's
  * laion_clap/clap_module/htsat.py: the HTSAT Swin audio encoder ("base":
    spec_size 256, patch 4 / stride 4, embed 128, depths (2, 2, 12, 2),
    heads (4, 8, 16, 32), window 8) with the mel -> image reshape
    (:858-884) and the 1024-d "embedding" head (:796-825),
  * laion_clap/clap_module/model.py: the dual tower, audio and text
    projection MLPs to the 512-d joint space, the RoBERTa pooler text
    branch (:627-634), L2-normalised embeddings (:696-740),
  * laion_clap/training/data.py get_mel (:363-399): the 48 kHz
    torchlibrosa log-mel (n_fft 1024, hop 480, 64 mel, 50-14000 Hz).

The towers keep laion_clap's state-dict keys (audio_branch.*,
audio_projection.*, text_branch.*, text_projection.*), so a checkpoint's
tensors load with `load_state_dict(strict=True)` once the keys that no
tower computes from are set aside (`tower_state_dicts`). Swin and RoBERTa
attention are einsum and softmax, as the JAX package computes them in XLA
(no Pallas kernel there); the frontend's STFT is the plain `stft_power`.
Images are NCHW, the reference's layout. The audio path is differentiable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consistencytta_torch.evaluation.mels import load_wav_16k
from consistencytta_torch.evaluation.panns import BatchNormInference
from consistencytta_torch.io.checkpoints import load_torch_state_dict
from consistencytta_torch.ops.mel import mel_filterbank, real_dft_basis
from consistencytta_torch.ops.resample import resample_numpy
from consistencytta_torch.ops.stft import _matmul_fp32, stft_power
from consistencytta_torch.utils import resolve_device


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    embed_dim: int = 128  # "base"
    depths: Tuple[int, ...] = (2, 2, 12, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    mel_bins: int = 64
    sample_rate: int = 48000
    window_size_stft: int = 1024
    hop_size: int = 480
    fmin: float = 50.0
    fmax: float = 14000.0
    clip_samples: int = 480000
    joint_embed: int = 512

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    joint_embed: int = 512


TEXT_LENGTH = 77  # the reference tokenizer's max_length


# ---------------------------------------------------------------------------
# Mel frontend + image reshape
# ---------------------------------------------------------------------------


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1,
        (a + 2) * at**3 - (a + 3) * at**2 + 1,
        np.where(at < 2, a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a, 0.0),
    )


def bicubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] interpolation matrix for torch bicubic with
    align_corners=True (a = -0.75), applied as out = M @ in along one axis."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = (n_in - 1) / (n_out - 1)
    m = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        x = i * scale
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            idx = np.clip(x0 + k, 0, n_in - 1)
            m[i, idx] += _cubic_kernel(np.array(x - (x0 + k)))
    return m.astype(np.float32)


class CLAPMelFrontend:
    """48 kHz waveform [B, 480000] -> raw log-mel [B, 1001, 64]
    (torchlibrosa power log-mel, get_mel, data.py:363-399; bn0 is in the
    tower). The bases are float32 tensors on `device`, the card unless the
    caller passes "cpu"."""

    def __init__(self, config: HTSATConfig = HTSATConfig(), device="cuda"):
        device = resolve_device(device)
        self.config = config
        cos_b, sin_b = real_dft_basis(config.window_size_stft, config.window_size_stft, "hann")
        self.cos = torch.from_numpy(cos_b).to(device)
        self.sin = torch.from_numpy(sin_b).to(device)
        mel = mel_filterbank(config.sample_rate, config.window_size_stft, config.mel_bins,
                             config.fmin, config.fmax)
        self.mel_t = torch.from_numpy(mel.T.copy()).to(device)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        power = stft_power(wav.float(), self.cos, self.sin, self.config.hop_size,
                           self.config.window_size_stft // 2)
        mel = _matmul_fp32(power, self.mel_t)
        return 10.0 * torch.log10(mel.clamp_min(1e-10))


def reshape_mel_to_image(mel: torch.Tensor, config: HTSATConfig) -> torch.Tensor:
    """[B, T, F] log-mel -> [B, 1, 256, 256] Swin input, reproducing
    reshape_wav2img (htsat.py:858-884): bicubic time interpolation
    (align_corners) to 1024 frames, then 4-way time chunking stacked along
    frequency: img[chunk * F + f, tau] = mel[chunk * 256 + tau, f]."""
    b, t, f = mel.shape
    ratio = config.freq_ratio
    target_t = config.spec_size * ratio
    if t != target_t:
        m = torch.from_numpy(bicubic_resize_matrix(t, target_t)).to(mel.device)
        mel = _matmul_fp32(m, mel)
    # [B, 4, 256, F] -> [B, 4, F, 256] -> [B, 4 F, 256]
    chunks = mel.reshape(b, ratio, config.spec_size, f)
    return chunks.transpose(2, 3).reshape(b, 1, ratio * f, config.spec_size)


# ---------------------------------------------------------------------------
# Swin transformer pieces
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nH * nW, w * w, C]."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_unpartition(windows: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // w) * (wd // w))
    x = windows.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def relative_position_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)  # [w*w, w*w]


def swin_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """[nW, w*w, w*w] additive mask (0 / -100) for shifted windows."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // window, window, w // window, window)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.randn((2 * window - 1) ** 2, heads) * 0.02)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b_, n, c = x.shape
        head_dim = c // self.heads
        q, k, v = self.qkv(x).reshape(b_, n, 3, self.heads, head_dim).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q * head_dim**-0.5, k).float()
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        logits = logits + bias.reshape(n, n, self.heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = logits.reshape(b_ // nw, nw, self.heads, n, n) + mask[None, :, None]
            logits = logits.reshape(b_, self.heads, n, n)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b_, n, c)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """A Swin block; where the resolution is no larger than the window, the
    window shrinks to it and the shift is 0 (as htsat.py's __init__ does).
    Shifted blocks hold their mask as the buffer `attn_mask`."""

    def __init__(self, dim: int, resolution: Tuple[int, int], heads: int, window: int,
                 shift: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.resolution = resolution
        if min(resolution) <= window:
            window, shift = min(resolution), 0
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        mask = torch.from_numpy(swin_attn_mask(*resolution, window, shift)) if shift else None
        self.register_buffer("attn_mask", mask)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, l, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if self.shift:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
        wins = self.attn(window_partition(x, self.window), self.attn_mask)
        x = window_unpartition(wins, self.window, h, w)
        if self.shift:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + x.reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: Tuple[int, int]):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1).reshape(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    def __init__(self, config: HTSATConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, config.embed_dim, config.patch_size, stride=config.patch_stride)
        self.norm = nn.LayerNorm(config.embed_dim)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(img).flatten(2).transpose(1, 2))


class HTSATEncoder(nn.Module):
    """bn0 (applied by the tower, before the image reshape) and the Swin
    stack: image [B, 1, 256, 256] (already bn0-normalised) -> the 1024-d
    clip embedding, the mean over all tokens (htsat.py:823-825)."""

    def __init__(self, config: HTSATConfig = HTSATConfig()):
        super().__init__()
        self.bn0 = BatchNormInference(config.mel_bins)
        self.patch_embed = _PatchEmbed(config)
        grid = (config.spec_size - config.patch_size) // config.patch_stride + 1
        res, dim = (grid, grid), config.embed_dim
        self.layers = nn.ModuleList()
        for i_layer, depth in enumerate(config.depths):
            layer = nn.Module()
            layer.blocks = nn.ModuleList(
                SwinBlock(dim, res, config.num_heads[i_layer], config.window_size,
                          0 if j % 2 == 0 else config.window_size // 2, config.mlp_ratio)
                for j in range(depth))
            if i_layer < len(config.depths) - 1:
                layer.downsample = PatchMerging(dim, res)
                res, dim = (res[0] // 2, res[1] // 2), dim * 2
            self.layers.append(layer)
        self.norm = nn.LayerNorm(config.num_features)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(img)
        for layer in self.layers:
            for block in layer.blocks:
                x = block(x)
            if hasattr(layer, "downsample"):
                x = layer.downsample(x)
        return self.norm(x).mean(dim=1)


def _projection(dim: int, joint: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(dim, joint), nn.ReLU(), nn.Linear(joint, joint))


class CLAPAudioTower(nn.Module):
    """log-mel [B, T, F] -> L2-normalised joint-space audio embedding."""

    def __init__(self, config: HTSATConfig = HTSATConfig()):
        super().__init__()
        self.config = config
        self.audio_branch = HTSATEncoder(config)
        self.audio_projection = _projection(config.num_features, config.joint_embed)

    def forward(self, logmel: torch.Tensor) -> torch.Tensor:
        x = self.audio_branch.bn0(logmel.transpose(1, 2)).transpose(1, 2)
        emb = self.audio_branch(reshape_mel_to_image(x, self.config))
        h = self.audio_projection(emb)
        return h / h.norm(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# RoBERTa text tower
# ---------------------------------------------------------------------------


def _dense_norm(d_in: int, d_out: int, eps: float) -> nn.ModuleDict:
    return nn.ModuleDict({"dense": nn.Linear(d_in, d_out), "LayerNorm": nn.LayerNorm(d_out, eps)})


class RobertaLayer(nn.Module):
    def __init__(self, config: RobertaConfig):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.heads = config.num_heads
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: nn.Linear(d, d) for n in ("query", "key", "value")}),
            "output": _dense_norm(d, d, eps),
        })
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(d, config.intermediate_size)})
        self.output = _dense_norm(config.intermediate_size, d, eps)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        head_dim = d // self.heads
        proj = self.attention["self"]
        q, k, v = (proj[n](x).reshape(b, l, self.heads, head_dim) for n in ("query", "key", "value"))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * head_dim**-0.5 + mask_bias
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, d)
        out = self.attention["output"]
        x = out["LayerNorm"](x + out["dense"](attn))
        h = self.output["dense"](F.gelu(self.intermediate["dense"](x)))
        return self.output["LayerNorm"](x + h)


class RobertaEncoder(nn.Module):
    """input_ids / attention_mask [B, L] -> pooler output [B, hidden]."""

    def __init__(self, config: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.config = config
        d = config.hidden_size
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(config.vocab_size, d),
            "position_embeddings": nn.Embedding(config.max_position_embeddings, d),
            "token_type_embeddings": nn.Embedding(config.type_vocab_size, d),
            "LayerNorm": nn.LayerNorm(d, config.layer_norm_eps),
        })
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(RobertaLayer(config) for _ in range(config.num_layers))
        self.pooler = nn.ModuleDict({"dense": nn.Linear(d, d)})

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        emb = self.embeddings
        mask = attention_mask.long()
        # RoBERTa's position ids from the mask (HF
        # create_position_ids_from_input_ids): cumsum(mask) * mask + pad_id
        position_ids = torch.cumsum(mask, dim=1) * mask + self.config.pad_token_id
        x = emb["word_embeddings"](input_ids.long()) + emb["position_embeddings"](position_ids) \
            + emb["token_type_embeddings"].weight[0]
        x = emb["LayerNorm"](x)
        mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, mask_bias)
        return torch.tanh(self.pooler["dense"](x[:, 0]))


class CLAPTextTower(nn.Module):
    """token ids and mask [B, L] -> L2-normalised joint-space text embedding."""

    def __init__(self, config: RobertaConfig = RobertaConfig()):
        super().__init__()
        self.text_branch = RobertaEncoder(config)
        self.text_projection = _projection(config.hidden_size, config.joint_embed)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        h = self.text_projection(self.text_branch(input_ids, attention_mask))
        return h / h.norm(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _getter(sd):
    def g(key):
        for k in (key, "module." + key):
            if k in sd:
                return sd[k]
        raise KeyError(key)

    def has(key):
        return key in sd or ("module." + key) in sd

    return g, has


def infer_clap_configs(
    sd,
    base_audio: HTSATConfig = HTSATConfig(),
    base_text: RobertaConfig = RobertaConfig(),
) -> Tuple[HTSATConfig, RobertaConfig]:
    """The structural CLAP dimensions (Swin depths / widths / heads, RoBERTa
    width / depth) from a checkpoint's tensor shapes, keeping the signal
    frontend's fields (mel bins, spec size, sample rate) from the base
    configs, so that any laion_clap-format checkpoint loads, small test ones
    included."""
    g, has = _getter(sd)
    ab = "audio_branch."
    embed_dim = g(ab + "patch_embed.proj.weight").shape[0]
    depths, heads = [], []
    i = 0
    while has(f"{ab}layers.{i}.blocks.0.norm1.weight"):
        j = 0
        while has(f"{ab}layers.{i}.blocks.{j}.norm1.weight"):
            j += 1
        depths.append(j)
        table = g(f"{ab}layers.{i}.blocks.0.attn.relative_position_bias_table")
        heads.append(int(table.shape[1]))
        i += 1
    table0 = g(f"{ab}layers.0.blocks.0.attn.relative_position_bias_table")
    window = (int(round(np.sqrt(table0.shape[0]))) + 1) // 2
    mlp_ratio = g(f"{ab}layers.0.blocks.0.mlp.fc1.weight").shape[0] / embed_dim

    joint = int(g("audio_projection.2.weight").shape[0])
    audio = dataclasses.replace(
        base_audio, embed_dim=int(embed_dim), depths=tuple(depths), num_heads=tuple(heads),
        window_size=int(window), mlp_ratio=float(mlp_ratio), joint_embed=joint)

    tb = "text_branch."
    word = g(tb + "embeddings.word_embeddings.weight")
    vocab, hidden = int(word.shape[0]), int(word.shape[1])
    n_layers = 0
    while has(f"{tb}encoder.layer.{n_layers}.attention.self.query.weight"):
        n_layers += 1
    inter = int(g(f"{tb}encoder.layer.0.intermediate.dense.weight").shape[0])
    max_pos = int(g(tb + "embeddings.position_embeddings.weight").shape[0])
    # The head count is not in the shapes. The BERT / RoBERTa family fixes
    # the head width at 64, so hidden // 64 recovers it for any production
    # text branch; a small test checkpoint (hidden not a multiple of 64)
    # keeps the base count, shrunk only as needed to divide hidden.
    if hidden % 64 == 0:
        n_heads = hidden // 64
    else:
        n_heads = base_text.num_heads
        if hidden % n_heads != 0:
            n_heads = max(d for d in range(1, n_heads + 1) if hidden % d == 0)

    text = dataclasses.replace(
        base_text, vocab_size=vocab, hidden_size=hidden, num_layers=n_layers, num_heads=n_heads,
        intermediate_size=inter, max_position_embeddings=max_pos,
        joint_embed=int(g("text_projection.2.weight").shape[0]))
    return audio, text


# laion_clap checkpoint entries that no tower computes from: the HTSAT
# frontend's bases (CLAPMelFrontend builds the same ones), its classifier
# head and token-semantic conv, RoBERTa's position-id buffer, the logit
# scales and the unused transform MLPs
_UNUSED = ("audio_branch.spectrogram_extractor.", "audio_branch.logmel_extractor.",
           "audio_branch.head.", "audio_branch.tscam_conv.", "text_branch.embeddings.position_ids",
           "text_branch.embeddings.token_type_ids", "logit_scale", "audio_transform.",
           "text_transform.")


def tower_state_dicts(sd) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A laion_clap state dict (keys maybe prefixed `module.`) -> the audio
    tower's and the text tower's entries. Entries that neither tower has nor
    `_UNUSED` names are kept, so that strict loading reports them."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith(_UNUSED)}
    text = {k: v for k, v in sd.items() if k.startswith(("text_branch.", "text_projection."))}
    return {k: v for k, v in sd.items() if k not in text}, text


def load_clap_towers(path_or_sd, device="cuda") -> Tuple[CLAPAudioTower, CLAPTextTower]:
    """Both towers, sized from the checkpoint's shapes, loaded strictly and
    in eval mode on `device`. A missing, unexpected or wrongly shaped key
    raises, naming it."""
    device = resolve_device(device)
    sd = load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    audio_sd, text_sd = tower_state_dicts(sd)
    acfg, tcfg = infer_clap_configs({**audio_sd, **text_sd})
    audio, text = CLAPAudioTower(acfg), CLAPTextTower(tcfg)
    audio.load_state_dict(audio_sd, strict=True)
    text.load_state_dict(text_sd, strict=True)
    return audio.to(device).eval(), text.to(device).eval()


# ---------------------------------------------------------------------------
# Host-facing wrapper
# ---------------------------------------------------------------------------


Tokenizer = Callable[[List[str], int], Tuple[np.ndarray, np.ndarray]]


class CLAPWrapper:
    """Batched embedding extraction with the evaluation protocol (the
    CLAP_Module equivalent, laion_clap/hook.py:20-219). `tokenizer` maps
    (captions, max_length) to int ids and mask, padded to max_length."""

    def __init__(self, audio_tower: CLAPAudioTower, text_tower: CLAPTextTower,
                 tokenizer: Tokenizer):
        self.audio_tower = audio_tower
        self.text_tower = text_tower
        self.tokenizer = tokenizer
        self.device = next(audio_tower.parameters()).device
        self.frontend = CLAPMelFrontend(audio_tower.config, self.device)

    @classmethod
    def from_checkpoint(cls, path: str, tokenizer_path: str = "roberta-base",
                        device="cuda") -> Optional["CLAPWrapper"]:
        """The towers from a laion_clap checkpoint and the RoBERTa tokenizer
        from local files only (a directory, or the hub cache). None where
        those files are absent, as in the JAX package."""
        from consistencytta_torch.text.tokenizer import HFTokenizer, _tokenizer_files_present

        device = resolve_device(device)
        if not _tokenizer_files_present(tokenizer_path):
            return None
        try:
            tokenizer = HFTokenizer(tokenizer_path)
        except (ImportError, OSError, ValueError):
            return None  # the RoBERTa tokenizer's files are unreadable here
        return cls(*load_clap_towers(path, device), tokenizer)

    def audio_embeddings_from_waves(self, waves_48k: np.ndarray) -> np.ndarray:
        """[B, 480000] 48 kHz waveforms -> [B, joint] embeddings."""
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(waves_48k, np.float32)).to(self.device)
            return self.audio_tower(self.frontend(x)).cpu().numpy()

    def audio_embeddings(self, paths: List[str], batch: int = 16) -> np.ndarray:
        """Batch-16 embedding with the reference CLAP protocol
        (audioldm_eval/eval.py:217-219 DataLoader(batch_size=16) and
        eval.py:38-46 seed_all(0) before every get_audio_embedding_from_data
        call): each batch draws its rand_trunc crops from a fresh
        RandomState(0), one randint per clip longer than 10 s, in batch
        order (laion_clap/training/data.py:465-467)."""
        outs = []
        for start in range(0, len(paths), batch):
            rand_state = np.random.RandomState(0)
            wavs = []
            for p in paths[start : start + batch]:
                w = resample_to_48k(load_wav_16k(p, 1000))
                # the eval loader peak-normalises twice (tools/torch_tools.py:
                # 54-75 read_wav_file: /max/2 -> pad or crop -> /max/2 again)
                w = w / (np.abs(w).max() + 1e-8) / 2.0
                w = fit_length(w, self.audio_tower.config.clip_samples, rand_state)
                w = w / (np.abs(w).max() + 1e-8) / 2.0
                wavs.append(w)
            outs.append(self.audio_embeddings_from_waves(np.stack(wavs)))
        return np.concatenate(outs, axis=0)

    def text_embeddings(self, captions: List[str], batch: int = 32) -> np.ndarray:
        outs = []
        with torch.no_grad():
            for start in range(0, len(captions), batch):
                ids, mask = self.tokenizer(captions[start : start + batch], TEXT_LENGTH)
                ids = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
                mask = torch.as_tensor(np.asarray(mask, np.int64), device=self.device)
                outs.append(self.text_tower(ids, mask).cpu().numpy())
        return np.concatenate(outs, axis=0)


def resample_to_48k(wav_16k: np.ndarray) -> np.ndarray:
    return resample_numpy(wav_16k.astype(np.float32), 16000, 48000)


def fit_length(wav: np.ndarray, n: int,
               rand_state: "np.random.RandomState | None" = None) -> np.ndarray:
    """Fit to n samples with the reference get_audio_features semantics
    (laion_clap/training/data.py:402-495, data_truncating='rand_trunc',
    data_filling='repeatpad'):

      * longer than n  -> random crop, start = rand_state.randint(0,
        overflow + 1), the np.random draw the reference makes after
        seed_all(0) (:465-467); rand_state=None keeps the head crop;
      * shorter than n -> repeat floor(n / len) times, then zero-pad to n
        (:472-483 'repeatpad': not a cyclic tile);
      * exactly n      -> unchanged.
    """
    if len(wav) > n:
        start = int(rand_state.randint(0, len(wav) - n + 1)) if rand_state is not None else 0
        return wav[start : start + n]
    if len(wav) == n:
        return wav
    reps = n // len(wav)
    out = np.zeros((n,), wav.dtype)
    out[: reps * len(wav)] = np.tile(wav, reps)
    return out
