"""Stage 3's losses in the port against the JAX package on the CPU in
float32, on the same numpy-seeded inputs and weights (tiny pipeline, the
tiny CLAP towers of tests/test_clap_loss.py): the differentiable resampler;
the mel loss and the multi-resolution STFT loss per instance, and the STFT
loss's gradient with respect to the predicted latent; the CLAP loss per
instance and its gradient (whole, and its CLAP terms alone); which modules
the CLAP loss leaves without gradient. Each JAX function is jitted on its
own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistencytta_tpu.ops import resample as jresample
from consistencytta_tpu.training import losses as jlosses
from consistencytta_tpu.training.clap_loss import build_clap_loss as jax_build_clap_loss
from consistencytta_torch.ops.resample import resample
from consistencytta_torch.training import ftvae, losses
from consistencytta_torch.training.clap_loss import build_clap_loss
from tests.torch_stage3_common import (
    CLIP_SECONDS, clap_batch, jax_configs, make_stage3_sides, rel_l2, to_torch,
)
from tests.torch_training_common import LATENT

B = 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def sides():
    return make_stage3_sides()


@pytest.fixture(scope="module")
def latents():
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((B, *LATENT)).astype(np.float32)
    target = (pred + 0.5 * rng.standard_normal((B, *LATENT))).astype(np.float32)
    return pred, target


def _instances_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


@pytest.mark.parametrize("orig,new,length", [(16000, 48000, 10240), (48000, 16000, 4800),
                                             (16000, 22050, 3000)])
def test_resample_matches_jax(orig, new, length):
    wav = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32) * 0.3
    x = torch.tensor(wav, requires_grad=True)
    got = resample(x, orig, new)
    want = np.asarray(jresample.resample(jnp.asarray(wav), orig, new))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the gradient of a weighted sum, against jax.grad
    w = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    jgrad = jax.grad(lambda a: (jresample.resample(a, orig, new) * w).sum())(jnp.asarray(wav))
    assert rel_l2(x.grad.numpy(), jgrad) < 1e-5


def test_mel_loss_matches_jax(sides, latents):
    jp, params, frozen, port, _, _ = sides
    pred, target = latents
    decode = lambda z: jp.vae.apply({"params": frozen.vae}, z,
                                    method=jp.vae.decode_first_stage)
    want = jax.jit(lambda p, t: jlosses.mel_loss_instance(p, t, decode))(pred, target)
    got = losses.mel_loss_instance(torch.from_numpy(pred), torch.from_numpy(target),
                                   lambda z: port.decode_mel(port.vae, z))
    _instances_close(got.detach().numpy(), want, 1e-5)


@pytest.mark.parametrize("factor_mag,grad_tol", [(0.0, 1e-4), (0.1, 1e-3)],
                         ids=["mse_and_convergence", "whole"])
def test_stft_loss_and_its_gradient_match_jax(sides, latents, factor_mag, grad_tol):
    """Per instance within 1e-5 relative; the gradient with respect to the
    predicted latent within 1e-4 relative L2 without the log-magnitude term.
    That term weights each STFT bin by 1 / |X|, and the float32 rounding of
    the small bins (a relative 1e-4 at |X| ~ 1e-2 beside peaks of 50-90)
    makes the two packages' float32 gradients on the same waveforms differ
    by ~2e-4 relative L2, ~7e-4 once through the decoder's backward: the
    whole gradient is held to 1e-3."""
    jp, params, frozen, port, _, _ = sides
    pred, target = latents
    jloss = jlosses.MultiResolutionSTFTLoss(sr=16000, factor_mag=factor_mag)
    decode = lambda z: jp.decode_latents(frozen.vae, frozen.vocoder, z)
    inst = jax.jit(lambda p, t: jloss(p, t, decode))
    grad = jax.jit(jax.grad(lambda p, t: jloss(p, t, decode).sum()))
    p = torch.tensor(pred, requires_grad=True)
    got = losses.MultiResolutionSTFTLoss(sr=16000, factor_mag=factor_mag)(
        p, torch.from_numpy(target), port.decode_latents)
    _instances_close(got.detach().numpy(), inst(pred, target), 1e-5)
    got.sum().backward()
    want = np.asarray(grad(pred, target))
    assert np.linalg.norm(want) > 0
    assert rel_l2(p.grad.numpy(), want) < grad_tol


def test_stft_basis_is_torch_stft():
    """The windowed DFT basis: torch.stft's magnitude, Hann window centred
    inside n_fft."""
    wav = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4000)).astype(np.float32))
    for n_fft, hop, win in zip((1024, 2048, 512), (120, 240, 50), (600, 1200, 240)):
        basis = torch.from_numpy(losses.stft_basis(n_fft, win))
        got = losses._stft_mag(wav, basis, n_fft, hop)
        want = torch.stft(wav, n_fft, hop, win, torch.hann_window(win), center=True,
                          pad_mode="reflect", return_complex=True).abs().transpose(1, 2)
        torch.testing.assert_close(got, want.clamp_min(1e-4), rtol=1e-4,
                                   atol=1e-4 * float(want.max()))


def _jax_clap(jp, mse_weight=1.0):
    ja, jt = jax_configs()
    return jax_build_clap_loss(jp, mse_weight=mse_weight, htsat_config=ja, roberta_config=jt,
                               clip_seconds=CLIP_SECONDS)


@pytest.mark.parametrize("mse_weight", [1.0, 0.0], ids=["whole", "clap_terms"])
def test_clap_loss_and_its_gradient_match_jax(sides, latents, mse_weight):
    """Per instance within 1e-4 relative; the gradient with respect to the
    predicted latent within 1e-3 relative L2, the CLAP terms' alone too
    (mse_weight 0), which must not vanish."""
    jp, params, frozen, port, audio, text = sides
    pred, target = latents
    batch = clap_batch(B)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = _jax_clap(jp, mse_weight)
    inst = jax.jit(lambda p, t: jloss(p, t, frozen, jbatch))
    grad = jax.jit(jax.grad(lambda p, t: jloss(p, t, frozen, jbatch).sum()))
    loss = build_clap_loss(port, audio, text, mse_weight=mse_weight, clip_seconds=CLIP_SECONDS)
    p = torch.tensor(pred, requires_grad=True)
    got = loss(p, torch.from_numpy(target), to_torch(batch))
    _instances_close(got.detach().numpy(), inst(pred, target), 1e-4)
    got.sum().backward()
    want = np.asarray(grad(pred, target))
    assert np.linalg.norm(want) > 1e-5
    assert rel_l2(p.grad.numpy(), want) < 1e-3


def test_clap_loss_trains_only_what_it_should(sides, latents):
    """Gradients reach the predicted latent and, under FTVAE, the decoder
    copy; the towers, the frozen VAE and the vocoder allocate none."""
    _, _, _, port, audio, text = sides
    pred, target = latents
    loss = build_clap_loss(port, audio, text, clip_seconds=CLIP_SECONDS)
    dec = ftvae.vae_decoder_subset(port.vae)
    p = torch.tensor(pred, requires_grad=True)
    loss(p, torch.from_numpy(target), to_torch(clap_batch(B)), decoder=dec).sum().backward()
    assert p.grad is not None and float(p.grad.norm()) > 0
    assert all(q.grad is not None and q.grad.dtype == torch.float32 for q in dec.parameters())
    assert float(dec.decoder.mid.attn_1.q.weight.grad.norm()) > 0
    for frozen_module in (audio, text, port.vae, port.vocoder):
        assert all(q.grad is None and not q.requires_grad for q in frozen_module.parameters())
    # the copy shares no storage with the frozen VAE
    vae_ptrs = {q.data_ptr() for q in port.vae.parameters()}
    assert not vae_ptrs & {q.data_ptr() for q in dec.parameters()}
