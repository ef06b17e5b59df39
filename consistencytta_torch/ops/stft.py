"""STFT-as-matmul mel frontend: kernel K4 with its plain version.

The training mel spectrogram is a framed real DFT (window 1024, hop 160,
reflect padding of half a window) against a precomputed windowed basis, then
a mel filterbank product and a log compression with a 1e-5 floor
(TacotronSTFT). `stft_magnitude` is the plain version: unfold, one float32
matrix product, magnitude. `stft_magnitude_cuda` (K4) launches
`csrc/stft.cu`, which never materialises the frames and takes the product as
three TF32 passes on the tensor cores over a basis packed by `pack_basis`
into the kernel's tile order; it has no gradient, as
the JAX package's kernel has none, so differentiable callers use the plain
functions (`frame_signal` is `Tensor.unfold`, whose autograd backward is the
overlap-add). `MelFrontend.magnitude` launches the kernel for a CUDA tensor
and runs the plain version for a CPU tensor, with no other switch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from consistencytta_torch.configs import STFTConfig
from consistencytta_torch.ops import _build
from consistencytta_torch.ops.mel import mel_filterbank, real_dft_basis
from consistencytta_torch.utils import resolve_device

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
TILE_FRAMES = 64  # frames per block (TF in csrc/stft.cu)
TILE_BINS = 64  # bins per block (TB)
BASIS_STAGE_BYTES = 2 * 32 * 2 * TILE_BINS * 4  # two staged basis tiles
SPAN_SKEW = 8  # words the kernel skips in its staged span every hop samples
GROUP_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)  # sample order within a group of 8


def frame_signal(wav: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Overlapping frames: [B, T] -> [B, n_frames, frame_length] (a view)."""
    return wav.unfold(-1, frame_length, hop)


def reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    """[B, T] -> [B, T + 2 pad], mirrored without repeating the edge sample."""
    if pad and wav.shape[-1] <= pad:
        raise ValueError(
            f"reflect padding of {pad} needs more than {pad} samples, got {wav.shape[-1]}"
        )
    if not pad:
        return wav
    return torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 at full precision: on the card the product must not
    drop to TF32, whatever the caller has set."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _spectrum(wav, cos_basis, sin_basis, hop_length, center_pad):
    """(re, im), each [B, n_frames, n_bins], float32."""
    wav = reflect_pad(wav.float(), center_pad)
    frames = frame_signal(wav, cos_basis.shape[0], hop_length)
    basis = torch.cat([cos_basis, sin_basis], dim=1)  # [L, 2*n_bins]
    return _matmul_fp32(frames, basis).split(cos_basis.shape[1], dim=-1)


def stft_magnitude(wav, cos_basis, sin_basis, hop_length: int, center_pad: int):
    """Magnitude STFT of [B, T] -> [B, n_frames, n_bins]: K4's plain version."""
    re, im = _spectrum(wav, cos_basis, sin_basis, hop_length, center_pad)
    return torch.sqrt(re * re + im * im)


def stft_power(wav, cos_basis, sin_basis, hop_length: int, center_pad: int):
    """Power spectrogram re^2 + im^2 (differentiable everywhere)."""
    re, im = _spectrum(wav, cos_basis, sin_basis, hop_length, center_pad)
    return re * re + im * im


def pack_basis(cos_basis: torch.Tensor, sin_basis: torch.Tensor) -> torch.Tensor:
    """The [L, n_bins] cos and sin bases in the order K4 stages them:
    [bin tile][L / 8][128 columns: 64 cos, then the 64 sin of the same bins]
    [8 samples as k0 k4 k1 k5 k2 k6 k3 k7], zero columns past n_bins. A tile
    of 32 window samples is then one contiguous 16 KB copy, and the two
    values a thread needs of a column (samples t and t + 4) are adjacent."""
    length, n_bins = cos_basis.shape
    tiles = -(-n_bins // TILE_BINS)
    pad = (0, tiles * TILE_BINS - n_bins)
    both = torch.stack([torch.nn.functional.pad(b, pad).reshape(length, tiles, TILE_BINS)
                        for b in (cos_basis, sin_basis)], dim=2)  # [L, tiles, 2, 64]
    groups = both.reshape(length // 8, 8, tiles, 2 * TILE_BINS)[:, list(GROUP_ORDER)]
    return groups.permute(2, 0, 3, 1).contiguous()


def stft_magnitude_cuda(wav, cos_basis, sin_basis, hop_length: int, center_pad: int,
                        packed=None):
    """K4: the same function in one launch on the raw [B, T] float32
    waveform; reflect padding, framing, the DFT product (three TF32 passes
    with float32-grade accuracy) and the magnitude all happen inside the
    kernel. `packed` is `pack_basis(cos_basis, sin_basis)`, for a caller
    that keeps it; it is made here when not given."""
    if wav.requires_grad:
        raise RuntimeError(
            "stft_magnitude_cuda has no gradient; use stft_magnitude or stft_power"
        )
    length, n_bins = cos_basis.shape
    for name, t in (("wav", wav), ("cos_basis", cos_basis), ("sin_basis", sin_basis)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != wav.device:
            raise TypeError(f"stft_magnitude_cuda: {name} must be contiguous float32 on wav's device")
    if wav.ndim != 2 or tuple(sin_basis.shape) != (length, n_bins):
        raise ValueError("stft_magnitude_cuda: wav [B, T], bases [L, n_bins] expected")
    b, t = wav.shape
    if center_pad and t <= center_pad:
        raise ValueError(
            f"reflect padding of {center_pad} needs more than {center_pad} samples, got {t}"
        )
    if hop_length % 8 or length % 32 or t + 2 * center_pad < length:
        raise ValueError(
            "stft_magnitude_cuda: the kernel takes hop % 8 == 0, window % 32 == 0 "
            "and at least one frame"
        )
    span = (TILE_FRAMES - 1) * hop_length + length
    smem = (span + SPAN_SKEW * (span // hop_length + 1)) * 4 + BASIS_STAGE_BYTES
    if smem > SMEM_LIMIT:
        raise ValueError(f"stft_magnitude_cuda: a tile of frames needs {smem} bytes of shared memory")
    if packed is None:
        packed = pack_basis(cos_basis, sin_basis)
    tiles = -(-n_bins // TILE_BINS)
    if (tuple(packed.shape) != (tiles, length // 8, 2 * TILE_BINS, 8) or packed.device != wav.device
            or packed.dtype != torch.float32 or not packed.is_contiguous()):
        raise ValueError("stft_magnitude_cuda: packed is not pack_basis(cos_basis, sin_basis)")
    n_frames = (t + 2 * center_pad - length) // hop_length + 1
    out = torch.empty((b, n_frames, n_bins), dtype=torch.float32, device=wav.device)
    fn = _build.load("stft").stft_magnitude_fwd
    fn.restype = ctypes.c_int
    code = fn(
        ctypes.c_void_p(wav.data_ptr()), ctypes.c_void_p(packed.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(length), ctypes.c_int(hop_length),
        ctypes.c_int(center_pad), ctypes.c_int(n_frames), ctypes.c_int(n_bins),
        _build.stream_ptr(wav.device),
    )
    _build.check(code, "stft_magnitude_cuda")
    stft_magnitude_cuda.launches += 1
    return out


stft_magnitude_cuda.launches = 0


def stft_flops(b: int, n_frames: int, length: int, n_bins: int) -> int:
    """Operations of the DFT product: 2 per multiply-add."""
    return 2 * b * n_frames * length * 2 * n_bins


class MelFrontend:
    """Waveform -> log-mel spectrogram, the TacotronSTFT equivalent.

        frontend = MelFrontend(STFTConfig())
        mel, mag = frontend(wav)       # [B, T] -> [B, n_frames, 64], [.., 513]
        mel = frontend.to_fixed(mel)   # pad/crop frames to 1024

    The bases and the filterbank are float32 tensors on `device`: the card
    unless the caller passes "cpu" (without a card, "cuda" raises). The
    waveforms it is given must lie there too."""

    def __init__(self, config: STFTConfig = STFTConfig(), device="cuda"):
        device = resolve_device(device)
        self.config = config
        cos_b, sin_b = real_dft_basis(config.filter_length, config.win_length, window="hann")
        mel_fb = mel_filterbank(
            sr=config.sampling_rate, n_fft=config.filter_length,
            n_mels=config.n_mel_channels, fmin=config.mel_fmin, fmax=config.mel_fmax,
        )
        self.cos_basis = torch.from_numpy(cos_b).to(device)
        self.sin_basis = torch.from_numpy(sin_b).to(device)
        self.mel_fb_t = torch.from_numpy(mel_fb.T.copy()).to(device)  # [n_bins, n_mels]
        self._packed = None  # pack_basis of the two bases, made at K4's first launch

    @property
    def n_bins(self) -> int:
        return self.config.filter_length // 2 + 1

    def magnitude(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, n_frames, n_bins] magnitude spectrogram."""
        hop, pad = self.config.hop_length, self.config.filter_length // 2
        if not wav.is_cuda:
            return stft_magnitude(wav, self.cos_basis, self.sin_basis, hop, pad)
        if self._packed is None:
            self._packed = pack_basis(self.cos_basis, self.sin_basis)
        return stft_magnitude_cuda(wav, self.cos_basis, self.sin_basis, hop, pad, self._packed)

    def __call__(self, wav: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, T] waveform in [-1, 1] -> (log-mel [B, n_frames, n_mels],
        log-magnitude [B, n_frames, n_bins]): clamp and sanitise the input,
        magnitude STFT, mel product in float32, log with the floor on both."""
        wav = torch.nan_to_num(wav.float().clamp(-1.0, 1.0))
        mag = self.magnitude(wav)
        mel = _matmul_fp32(mag, self.mel_fb_t)
        clip = self.config.compression_clip
        return torch.log(mel.clamp_min(clip)), torch.log(mag.clamp_min(clip))

    def to_fixed(self, mel: torch.Tensor, target_frames: int = 1024) -> torch.Tensor:
        """Pad (zeros) or crop the frame axis to `target_frames`, and drop the
        last mel channel if the channel count is odd."""
        n = mel.shape[1]
        if n < target_frames:
            mel = torch.nn.functional.pad(mel, (0, 0, 0, target_frames - n))
        elif n > target_frames:
            mel = mel[:, :target_frames]
        if mel.shape[-1] % 2:
            mel = mel[..., :-1]
        return mel

    def wav_to_mel_image(self, wav: torch.Tensor, target_frames: int = 1024) -> torch.Tensor:
        """[B, T] -> [B, target_frames, n_mels, 1] NHWC mel image for the VAE
        encoder."""
        mel, _ = self(wav)
        return self.to_fixed(mel, target_frames)[..., None]
