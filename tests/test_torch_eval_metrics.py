"""The port's metric math (consistencytta_torch/evaluation/metrics.py)
against the JAX package's on the same numpy inputs from a seed, mirroring
tests/test_metrics.py. Both are the same numpy and SciPy expressions, so
every result agrees to 1e-10 relative (bit for bit in practice); the
Frechet distances stay narrow (32 wide) to keep scipy's sqrtm cheap.
"""

import numpy as np
import pytest

from consistencytta_tpu.evaluation import metrics as jm
from consistencytta_torch.evaluation import metrics as tm

RTOL = 1e-10


def _agree(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _agree(got[k], want[k])
        return
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("shift,n", [(0.3, 64), (0.0, 16), (2.0, 40)])
def test_frechet_distance(shift, n):
    rng = np.random.default_rng(0)
    f1 = rng.standard_normal((n, 32))
    f2 = rng.standard_normal((n, 32)) * 1.3 + shift
    _agree(tm.frechet_distance(f1, f2), jm.frechet_distance(f1, f2))
    assert tm.frechet_distance(f1, f1) == pytest.approx(0.0, abs=1e-6)


def test_frechet_distance_rank_deficient_takes_the_offset_path():
    """Fewer samples than dimensions: singular covariances, as with 32 clips
    of 2048-wide Cnn14 features."""
    rng = np.random.default_rng(1)
    f1, f2 = rng.standard_normal((6, 24)), rng.standard_normal((6, 24)) + 0.5
    _agree(tm.frechet_distance(f1, f2), jm.frechet_distance(f1, f2))


def test_kl_divergence_paired():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((20, 50)).astype(np.float32), rng.standard_normal((20, 50))
    _agree(tm.kl_divergence_paired(a, b), jm.kl_divergence_paired(a, b))


@pytest.mark.parametrize("n,splits,shuffle", [(100, 10, True), (37, 10, True), (12, 3, False)])
def test_inception_score(n, splits, shuffle):
    logits = np.random.default_rng(3).standard_normal((n, 30)).astype(np.float32)
    _agree(tm.inception_score(logits, splits, samples_shuffle=shuffle),
           jm.inception_score(logits, splits, samples_shuffle=shuffle))


@pytest.mark.parametrize("subset_size", [None, 7])
def test_kernel_inception_distance(subset_size):
    rng = np.random.default_rng(4)
    f1, f2 = rng.standard_normal((20, 16)), rng.standard_normal((24, 16)) + 0.2
    _agree(tm.kernel_inception_distance(f1, f2, subsets=20, subset_size=subset_size),
           jm.kernel_inception_distance(f1, f2, subsets=20, subset_size=subset_size))


def test_psnr_and_ssim():
    rng = np.random.default_rng(5)
    a = rng.random((201, 64))
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1)
    _agree(tm.psnr(a, b), jm.psnr(a, b))
    assert tm.psnr(a, a) == jm.psnr(a, a) == float("inf")
    _agree(tm.ssim(a, b), jm.ssim(a, b))
    _agree(tm.ssim(a, b, data_range=2.0, win_size=5), jm.ssim(a, b, data_range=2.0, win_size=5))


@pytest.mark.parametrize("n_gen,n_ref", [(32000, 32000), (40000, 24000), (1500, 1500)])
def test_log_spectral_distance(n_gen, n_ref):
    """Equal, unequal, and shorter than one 742-point frame."""
    rng = np.random.default_rng(6)
    g, r = rng.standard_normal(n_gen) * 0.1, rng.standard_normal(n_ref) * 0.1
    _agree(tm.log_spectral_distance(g, r), jm.log_spectral_distance(g, r))


def test_clap_scores_clamp_and_scale():
    rng = np.random.default_rng(7)
    gt, gen, text = (rng.standard_normal((5, 12)) for _ in range(3))
    text[0] = -gt[0]  # a negative cosine clamps to 0
    _agree(tm.clap_scores(gt, gen, text), jm.clap_scores(gt, gen, text))
