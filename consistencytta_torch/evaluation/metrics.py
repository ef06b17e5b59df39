"""Evaluation metric math: FD / FAD, KL, ISc, KID, PSNR, SSIM, LSD, CLAP score.

The port's copy of consistencytta_tpu/evaluation/metrics.py, the math
unchanged: numpy and SciPy ports of the reference audioldm_eval formulas
(audioldm_eval/metrics/{fid,kl,isc,kid}.py, eval.py:226-307), independent of
the feature extractors. Every function takes precomputed feature or logit
arrays on the host, so the same math serves the Cnn14, VGGish and CLAP
backbones.

Protocol constants follow eval.py: ISc with 10 splits and rng_seed 2020;
KID polynomial kernel degree 3, coef0 1, gamma 1/dim, 100 subsets, rng_seed
2020; KL on paired logits; CLAP cosine similarities clamped at 0 and scaled
by 100. `frechet_distance` keeps scipy.linalg.sqrtm: on 2048-wide Cnn14
features it is the harness's largest host cost. The one change from the
JAX copy: sqrtm is called without its `disp` keyword, which SciPy 1.18
removed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


# -- Frechet distance (FD on Cnn14 "2048"; FAD on VGGish) --------------------


def frechet_distance(
    features_gen: np.ndarray, features_ref: np.ndarray, eps: float = 1e-6
) -> float:
    """Frechet distance between Gaussian fits of two feature sets
    (metrics/fid.py:7-67; identical math in metrics/fad.py:88-144)."""
    import scipy.linalg

    mu1, mu2 = features_gen.mean(axis=0), features_ref.mean(axis=0)
    sigma1 = np.cov(features_gen, rowvar=False)
    sigma2 = np.cov(features_ref, rowvar=False)

    diff = mu1 - mu2
    # sqrtm without `disp`: SciPy 1.18 removed it (disp=False only added
    # the error estimate to the return value; the root is the same)
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real

    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


# -- KL divergence on paired logits -----------------------------------------


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def kl_divergence_paired(
    logits_gen: np.ndarray, logits_ref: np.ndarray, eps: float = 1e-6
) -> Dict[str, float]:
    """KL(ref || gen) on filename-paired classifier logits
    (metrics/kl.py:35-103). Returns the softmax (AudioGen) and sigmoid
    variants; rows must already be aligned by filename."""
    n = len(logits_gen)

    p_gen = _softmax(logits_gen, axis=1)
    p_ref = _softmax(logits_ref, axis=1)
    # torch kl_div(input=log q, target=p) = sum p * (log p - log q)
    log_q = np.log(p_gen + eps)
    kl_softmax = float(
        np.sum(p_ref * (np.log(np.clip(p_ref, 1e-38, None)) - log_q)) / n
    )

    s_gen = _sigmoid(logits_gen)
    s_ref = _sigmoid(logits_ref)
    kl_sigmoid = float(
        np.sum(s_ref * (np.log(np.clip(s_ref, 1e-38, None)) - np.log(s_gen + eps)))
        / n
    )
    return {
        "kullback_leibler_divergence_softmax": kl_softmax,
        "kullback_leibler_divergence_sigmoid": kl_sigmoid,
    }


# -- Inception score ---------------------------------------------------------


def inception_score(
    logits: np.ndarray,
    splits: int = 10,
    rng_seed: int = 2020,
    samples_shuffle: bool = True,
) -> Dict[str, float]:
    """ISc on classifier logits (metrics/isc.py), float64 math."""
    n = len(logits)
    feats = logits.astype(np.float64)
    if samples_shuffle:
        rng = np.random.RandomState(rng_seed)
        feats = feats[rng.permutation(n), :]

    p = _softmax(feats, axis=1)
    log_p = feats - feats.max(axis=1, keepdims=True)
    log_p = log_p - np.log(np.exp(log_p).sum(axis=1, keepdims=True))

    scores = []
    for i in range(splits):
        pc = p[(i * n // splits) : ((i + 1) * n // splits)]
        lpc = log_p[(i * n // splits) : ((i + 1) * n // splits)]
        q = pc.mean(axis=0, keepdims=True)
        kl = (pc * (lpc - np.log(q))).sum(axis=1).mean()
        scores.append(np.exp(kl))
    return {
        "inception_score_mean": float(np.mean(scores)),
        "inception_score_std": float(np.std(scores)),
    }


# -- Kernel inception distance ----------------------------------------------


def _polynomial_kernel(x, y, degree=3, gamma=None, coef0=1):
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef0) ** degree


def _polynomial_mmd(f1, f2, degree, gamma, coef0):
    k_xx = _polynomial_kernel(f1, f1, degree, gamma, coef0)
    k_yy = _polynomial_kernel(f2, f2, degree, gamma, coef0)
    k_xy = _polynomial_kernel(f1, f2, degree, gamma, coef0)
    m = k_xx.shape[0]
    kt_xx = k_xx.sum() - np.trace(k_xx)
    kt_yy = k_yy.sum() - np.trace(k_yy)
    return (kt_xx + kt_yy) / (m * (m - 1)) - 2 * k_xy.sum() / (m * m)


def kernel_inception_distance(
    features_gen: np.ndarray,
    features_ref: np.ndarray,
    subsets: int = 100,
    subset_size: Optional[int] = None,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef0: float = 1.0,
    rng_seed: int = 2020,
) -> Dict[str, float]:
    """Polynomial-kernel MMD over random subsets (metrics/kid.py)."""
    if subset_size is None:
        subset_size = min(len(features_gen), len(features_ref))
    subset_size = min(subset_size, len(features_gen), len(features_ref))

    rng = np.random.RandomState(rng_seed)
    mmds = np.zeros(subsets)
    for i in range(subsets):
        f1 = features_gen[rng.choice(len(features_gen), subset_size, replace=False)]
        f2 = features_ref[rng.choice(len(features_ref), subset_size, replace=False)]
        mmds[i] = _polynomial_mmd(f1, f2, degree, gamma, coef0)
    return {
        "kernel_inception_distance_mean": float(np.mean(mmds)),
        "kernel_inception_distance_std": float(np.std(mmds)),
    }


# -- PSNR / SSIM on normalized log-mel --------------------------------------


def psnr(img1: np.ndarray, img2: np.ndarray, data_range: float = 2.0) -> float:
    """Peak SNR (skimage-compatible; the reference passes float mel images
    normalized to [0, 1] — skimage infers data_range 2 for floats)."""
    mse = np.mean((img1.astype(np.float64) - img2.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range**2) / mse))


def ssim(
    img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0, win_size: int = 7
) -> float:
    """Structural similarity, skimage default settings (uniform 7x7 window,
    K1=0.01, K2=0.03, sample covariance normalization)."""
    from scipy.ndimage import uniform_filter

    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    filt = lambda x: uniform_filter(x, size=win_size)
    np_ = win_size**2
    cov_norm = np_ / (np_ - 1)

    ux, uy = filt(img1), filt(img2)
    uxx, uyy, uxy = filt(img1 * img1), filt(img2 * img2), filt(img1 * img2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux**2 + uy**2 + c1) * (vx + vy + c2)
    s = num / den

    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


# -- Log-spectral distance ---------------------------------------------------


def log_spectral_distance(
    wav_gen: np.ndarray,
    wav_ref: np.ndarray,
    sr: int = 16000,
    time_offset: int = 160 * 7,
) -> Dict[str, float]:
    """LSD + STFT-SSIM between a generated and reference waveform.

    Follows the ssr_eval AudioMetrics protocol used by the reference
    (eval.py:137-165): generated audio shifted by the HiFi-GAN 7-frame
    offset, both signals mean-centered and peak-normalized, spectrogram with
    n_fft = 2048 * sr / 44100 and hop = sr / 100, LSD on log10 power
    spectra."""
    a1 = wav_gen[time_offset:]
    a1 = (a1 - a1.mean()) / (np.abs(a1).max() + 1e-12)
    a2 = (wav_ref - wav_ref.mean()) / (np.abs(wav_ref).max() + 1e-12)
    n = min(len(a1), len(a2))
    a1, a2 = a1[:n], a2[:n]

    n_fft = int(2048 / (44100 / sr))
    hop = int(sr / 100)
    window = np.hanning(n_fft)

    def spec(x):
        frames = []
        for i in range(0, len(x) - n_fft + 1, hop):
            frames.append(np.abs(np.fft.rfft(window * x[i : i + n_fft])))
        return np.stack(frames) if frames else np.zeros((1, n_fft // 2 + 1))

    s1 = np.log10(spec(a1) ** 2 + 1e-8)
    s2 = np.log10(spec(a2) ** 2 + 1e-8)
    lsd = float(np.mean(np.sqrt(np.mean((s1 - s2) ** 2, axis=1))))
    ssim_val = ssim(s1, s2, data_range=max(s1.max() - s1.min(), 1e-6))
    return {"lsd": lsd, "ssim_stft": ssim_val}


# -- CLAP score --------------------------------------------------------------


def clap_scores(
    gt_audio_emb: np.ndarray,
    gen_audio_emb: np.ndarray,
    text_emb: np.ndarray,
) -> Dict[str, float]:
    """Cosine similarities x100, clamped at 0 (eval.py:243-257)."""

    def cos(a, b):
        a = a / np.linalg.norm(a, axis=1, keepdims=True)
        b = b / np.linalg.norm(b, axis=1, keepdims=True)
        return np.clip((a * b).sum(axis=1), 0, None)

    return {
        "gt_text_clap_score": float(cos(gt_audio_emb, text_emb).mean() * 100),
        "gen_text_clap_score": float(cos(gen_audio_emb, text_emb).mean() * 100),
        "gen_gt_clap_score": float(cos(gen_audio_emb, gt_audio_emb).mean() * 100),
    }
