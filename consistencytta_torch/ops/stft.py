"""STFT-as-matmul mel frontend: kernel K4 with its plain version.

The training mel spectrogram is a framed real DFT (window 1024, hop 160,
reflect padding of half a window; the evaluation frontend's window is 512)
against a precomputed windowed basis, then
a mel filterbank product and a log compression with a 1e-5 floor
(TacotronSTFT). `stft_magnitude` is the plain version: unfold, one float32
matrix product, magnitude. `stft_magnitude_cuda` (K4) launches
`csrc/stft.cu`, which never materialises the frames and computes the same
function as a float32 FFT in shared memory, for a filter of 512 or 1024
samples: the windowed basis is exactly the window times the DFT, so the
kernel takes the window and a float32 table of twiddles built once in
float64 for its length (`fft_twiddles`). It has no gradient, as
the JAX package's kernel has none, so differentiable callers use the plain
functions (`frame_signal` is `Tensor.unfold`, whose autograd backward is the
overlap-add). `MelFrontend.magnitude` launches the kernel for a CUDA tensor
and runs the plain version for a CPU tensor, with no other switch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from consistencytta_torch.configs import STFTConfig
from consistencytta_torch.ops import _build
from consistencytta_torch.ops.mel import hann_window, mel_filterbank, pad_center, real_dft_basis
from consistencytta_torch.utils import resolve_device

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
FFT_LENGTHS = (512, 1024)  # the kernel's filter lengths: 32 x 16 and 32 x 32 four-step FFTs
FFT_RADIX = 32
TILE_FRAMES = {512: 64, 1024: 32}  # frames per block (Plan<N>::FPB in csrc/stft.cu)
EXCHANGE_BYTES = (8 * 32 * 33 + 16) * 8  # per-warp transpose buffers and W_32


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
    """a @ b in float32 at full precision, whatever the caller has set: on
    the card the product must not drop to TF32, and on a CPU with bf16
    matrix units a oneDNN float32 precision of "bf16" (what
    torch.set_float32_matmul_precision("medium") sets) makes it bf16 passes,
    which lose three decimal digits."""
    if a.is_cuda:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    onednn = getattr(torch.backends.mkldnn, "matmul", None)
    prev = getattr(onednn, "fp32_precision", "ieee")
    if prev == "ieee":
        return torch.matmul(a, b)
    onednn.fp32_precision = "ieee"
    try:
        return torch.matmul(a, b)
    finally:
        onednn.fp32_precision = prev


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


def fft_twiddles(length: int = 1024) -> np.ndarray:
    """The kernel's twiddle table for an N = `length` point FFT (32 x Q,
    Q = N / 32), [Q * R + R / 2, 2] float32 (re, im) with R = 32: W_N^(n1 k2)
    at row k2 * R + n1 (k2 < Q, n1 < R), then W_R^e for e < R / 2, where
    W_M = exp(-2 pi i / M). Built in float64 and rounded once to float32."""
    r, q = FFT_RADIX, length // FFT_RADIX
    k2, n1 = np.meshgrid(np.arange(q), np.arange(r), indexing="ij")
    ang = np.concatenate([(n1 * k2).reshape(-1) / length, np.arange(r // 2) / r])
    w = np.exp(-2j * np.pi * ang)
    return np.stack([w.real, w.imag], axis=1).astype(np.float32)


_TWIDDLES: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _twiddles_on(device: torch.device, length: int) -> torch.Tensor:
    key = (device, length)
    if key not in _TWIDDLES:
        _TWIDDLES[key] = torch.from_numpy(fft_twiddles(length)).to(device)
    return _TWIDDLES[key]


def fft_smem_bytes(hop_length: int, length: int = 1024) -> int:
    """Shared memory of one K4 block (mirrors smem_bytes in csrc/stft.cu):
    the transpose buffers, the window and the span of the block's frames."""
    return EXCHANGE_BYTES + (2 * length + (TILE_FRAMES[length] - 1) * hop_length) * 4


def stft_magnitude_cuda(wav, cos_basis, sin_basis, hop_length: int, center_pad: int,
                        window=None):
    """K4: the same function in one launch on the raw [B, T] float32
    waveform; reflect padding, framing, windowing, the FFT and the magnitude
    all happen inside the kernel, in float32. The bases must be
    `real_dft_basis` of the window (window times the DFT, as MelFrontend's
    are): the kernel takes `window` ([L] float32, the padded window), by
    default the cos basis's bin-0 column, which is the window exactly."""
    if wav.requires_grad:
        raise RuntimeError(
            "stft_magnitude_cuda has no gradient; use stft_magnitude or stft_power"
        )
    length, n_bins = cos_basis.shape
    if window is None:
        window = cos_basis[:, 0].contiguous()
    for name, t in (("wav", wav), ("cos_basis", cos_basis), ("sin_basis", sin_basis),
                    ("window", window)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != wav.device:
            raise TypeError(f"stft_magnitude_cuda: {name} must be contiguous float32 on wav's device")
    if wav.ndim != 2 or tuple(sin_basis.shape) != (length, n_bins):
        raise ValueError("stft_magnitude_cuda: wav [B, T], bases [L, n_bins] expected")
    if length not in FFT_LENGTHS or n_bins != length // 2 + 1:
        raise ValueError(
            "stft_magnitude_cuda: the FFT kernel takes a filter of 512 or 1024 samples "
            f"and its N / 2 + 1 bins, got {length} and {n_bins}"
        )
    if window.ndim != 1 or window.shape[0] != length:
        raise ValueError(
            f"stft_magnitude_cuda: the window must be padded to the filter length {length}, "
            f"got {tuple(window.shape)}"
        )
    b, t = wav.shape
    if center_pad and t <= center_pad:
        raise ValueError(
            f"reflect padding of {center_pad} needs more than {center_pad} samples, got {t}"
        )
    if t + 2 * center_pad < length:
        raise ValueError("stft_magnitude_cuda: the padded signal holds no frame")
    if hop_length < 1 or fft_smem_bytes(hop_length, length) > SMEM_LIMIT:
        raise ValueError(
            f"stft_magnitude_cuda: a block's {TILE_FRAMES[length]} frames at hop "
            f"{hop_length} need {fft_smem_bytes(max(hop_length, 0), length)} bytes of "
            "shared memory"
        )
    n_frames = (t + 2 * center_pad - length) // hop_length + 1
    out = torch.empty((b, n_frames, n_bins), dtype=torch.float32, device=wav.device)
    fn = _build.load("stft").stft_magnitude_fwd
    fn.restype = ctypes.c_int
    code = fn(
        ctypes.c_void_p(wav.data_ptr()), ctypes.c_void_p(window.data_ptr()),
        ctypes.c_void_p(_twiddles_on(wav.device, length).data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int(b), ctypes.c_int(t), ctypes.c_int(length), ctypes.c_int(hop_length),
        ctypes.c_int(center_pad), ctypes.c_int(n_frames),
        _build.stream_ptr(wav.device),
    )
    _build.check(code, "stft_magnitude_cuda")
    stft_magnitude_cuda.launches += 1
    return out


stft_magnitude_cuda.launches = 0


def stft_flops(b: int, n_frames: int, length: int, n_bins: int) -> int:
    """Operations of the DFT as a product with the basis: 2 per multiply-add
    (what the plain version and K4's first designs did)."""
    return 2 * b * n_frames * length * 2 * n_bins


def stft_fft_flops(b: int, n_frames: int, length: int) -> int:
    """Operations of K4's FFT: 5 N log2 N per complex FFT of two frames."""
    return b * -(-n_frames // 2) * 5 * length * int(np.log2(length))


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
        window = pad_center(hann_window(config.win_length, dtype=np.float64), config.filter_length)
        self.window = torch.from_numpy(window.astype(np.float32)).to(device)  # K4's input

    @property
    def n_bins(self) -> int:
        return self.config.filter_length // 2 + 1

    def magnitude(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, n_frames, n_bins] magnitude spectrogram."""
        hop, pad = self.config.hop_length, self.config.filter_length // 2
        if not wav.is_cuda:
            return stft_magnitude(wav, self.cos_basis, self.sin_basis, hop, pad)
        return stft_magnitude_cuda(wav, self.cos_basis, self.sin_basis, hop, pad, self.window)

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
