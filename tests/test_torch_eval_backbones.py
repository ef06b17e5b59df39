"""The port's evaluation backbones against the JAX package's, on the CPU in
float32, with the same seeded random weights under the reference
checkpoints' keys (the port loads them with load_state_dict(strict=True),
the JAX package through convert_cnn14 / convert_vggish / convert_clap_*)
and the same numpy inputs from a seed. Mirrors tests/test_eval_backbones.py
(TestCnn14, TestVGGish) and tests/test_clap.py (TestBicubic,
TestRandTruncProtocol); the CLAP towers run at a small infer_clap_configs
size (tests/torch_eval_common.py).

Tolerances: Cnn14 embeddings and logits, VGGish embeddings, the CLAP
log-mels, images and tower embeddings within 1e-4 of the output's largest
magnitude (float32 sums in another order); the CLAP embeddings also after
removing the across-set mean, on sets whose embeddings lie apart; the numpy frontends (VGGish
examples, HTK and bicubic matrices, masks, fit_length) bit for bit; the
sinc resampler within 1e-6 of the signal's scale (tests/test_torch_eval_mels.py).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from consistencytta_tpu.evaluation import clap_model as jc
from consistencytta_tpu.evaluation import panns as jp
from consistencytta_tpu.evaluation import vggish as jv
from consistencytta_torch.evaluation import clap_model as cm
from consistencytta_torch.evaluation import panns, vggish
from consistencytta_torch.io.audio import write_wav
from consistencytta_torch.tools import random_eval_checkpoints as R
from tests.torch_eval_common import (
    SMALL_HTSAT, SMALL_ROBERTA, clip, jax_text_params_as_arrays, no_persistent_jax_cache,  # noqa: F401
    write_tiny_roberta_tokenizer,
)

TOL = 1e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _spread(emb):
    """How far a set's embeddings lie apart: the norm after removing the
    across-set mean over the norm."""
    emb = np.asarray(emb, np.float64)
    return np.linalg.norm(emb - emb.mean(0)) / np.linalg.norm(emb)


def _close_apart(got, want, min_spread=0.05, tol=TOL):
    """_close, and again after removing the across-set mean, on a set whose
    embeddings lie apart: the input-dependent part is held to the same
    tolerance as the whole, not hidden under a part common to every row."""
    _close(got, want, tol)
    assert _spread(want) > min_spread, _spread(want)
    got, want = np.asarray(got), np.asarray(want)
    _close(got - got.mean(0), want - want.mean(0), tol)


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def cnn14_sd():
    return R.cnn14_state_dict(0)


@pytest.fixture(scope="module")
def clap_sd():
    return R.clap_state_dict(3, SMALL_HTSAT, SMALL_ROBERTA)


class TestCnn14:
    def test_embeddings_and_logits_match_jax(self, cnn14_sd):
        wav = np.stack([clip(0, 32000), clip(1, 32000) * 0.3])
        model = panns.Cnn14()
        model.load_state_dict(cnn14_sd, strict=True)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(wav))
        want = jp.Cnn14().apply({"params": jp.convert_cnn14(_numpy(cnn14_sd))}, wav)
        for key in ("2048", "logits"):
            _close(got[key].numpy(), want[key])
        # the random weights keep the full-depth stack alive
        assert 0.1 < (got["2048"] > 0).float().mean() < 0.9
        assert got["2048"].shape == (2, 2048) and got["logits"].shape == (2, 527)

    @pytest.mark.parametrize("layout", ["wrapped", "prefixed"])
    def test_loads_the_official_layout(self, cnn14_sd, tmp_path, layout):
        """Weights under "model" beside non-tensor entries, keys maybe
        prefixed `model.`: every key, the frontend's bases and
        num_batches_tracked included, is taken strictly."""
        path = str(tmp_path / "cnn14.pth")
        sd = cnn14_sd if layout == "wrapped" else {"model." + k: v for k, v in cnn14_sd.items()}
        torch.save({"model": sd, "iteration": 0}, path)
        model = panns.load_cnn14(path, device="cpu")
        assert "spectrogram_extractor.stft.conv_real.weight" in cnn14_sd
        assert "logmel_extractor.melW" in cnn14_sd and "bn0.num_batches_tracked" in cnn14_sd
        for k, v in model.state_dict().items():
            assert torch.equal(v, cnn14_sd[k]), k

    def test_wrong_shape_names_its_key(self, cnn14_sd, tmp_path):
        path = str(tmp_path / "bad.pth")
        bad = dict(cnn14_sd)
        bad["fc1.weight"] = bad["fc1.weight"].t().contiguous()[:100]
        torch.save({"model": bad}, path)
        with pytest.raises(RuntimeError, match="fc1.weight"):
            panns.load_cnn14(path, device="cpu")


class TestVGGish:
    def test_htk_mel_matrix(self):
        np.testing.assert_array_equal(vggish.htk_mel_matrix(), jv.htk_mel_matrix())

    @pytest.mark.parametrize("n", [160000, 15999, 300])
    def test_frontend_examples(self, n):
        wav = clip(2, n).astype(np.float64)
        got = vggish.waveform_to_examples(wav)
        np.testing.assert_array_equal(got, jv.waveform_to_examples(wav))
        assert got.shape == ({160000: 10, 15999: 1, 300: 0}[n], 96, 64)

    def test_network_parity(self):
        sd = R.vggish_state_dict(1)
        model = vggish.VGGish()
        model.load_state_dict(sd, strict=True)
        ex = (np.random.default_rng(3).standard_normal((3, 96, 64)) * 2 - 1).astype(np.float32)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(ex)).numpy()
        want = jv.VGGish().apply({"params": jv.convert_vggish(_numpy(sd))}, ex)
        _close(got, want)

    @pytest.mark.parametrize("sr", [16000, 32000, 22050])
    def test_load_audio_fad(self, tmp_path, sr):
        """Decimation at an integer ratio, the sinc resampler otherwise, a
        head crop, no centring and no pad."""
        path = str(tmp_path / "a.wav")
        write_wav(path, clip(4, int(sr * 1.5), sr) + 0.01, sr)
        got, want = vggish.load_audio_fad(path, 100), jv.load_audio_fad(path, 100)
        assert got.shape == want.shape == (16000,) and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    def test_embeddings_of_files_match_jax(self, tmp_path):
        """Examples of all files concatenated, then batches (3 here); None
        without a checkpoint file."""
        paths = []
        for i, n in enumerate((33000, 40000, 33000)):  # 2 examples each
            paths.append(str(tmp_path / f"{i}.wav"))
            write_wav(paths[-1], clip(10 + i, n))
        ckpt = R.write_eval_checkpoints(str(tmp_path / "ckpt"), 5, which=("vggish",))["vggish"]
        got = vggish.vggish_embeddings(paths, ckpt, batch=3, device="cpu")
        want = jv.vggish_embeddings(paths, ckpt, batch=3)
        assert got.shape == (6, 128)
        _close(got, want)
        assert vggish.vggish_embeddings(paths, str(tmp_path / "none.pth"), device="cpu") is None


class TestBicubic:
    def test_matches_jax_and_torch_align_corners(self):
        got = cm.bicubic_resize_matrix(101, 128)
        np.testing.assert_array_equal(got, jc.bicubic_resize_matrix(101, 128))
        x = np.random.default_rng(0).standard_normal((2, 1, 101, 64)).astype(np.float32)
        want = F.interpolate(torch.from_numpy(x), (128, 64), mode="bicubic",
                             align_corners=True).numpy()
        np.testing.assert_allclose(np.einsum("ot,bctf->bcof", got, x), want, atol=6e-5, rtol=1e-4)

    def test_reshape_mel_to_image(self):
        mel = (np.random.default_rng(1).standard_normal((2, 1001, 64)) * 2).astype(np.float32)
        got = cm.reshape_mel_to_image(torch.from_numpy(mel), cm.HTSATConfig()).numpy()
        want = np.asarray(jc.reshape_mel_to_image(mel, jc.HTSATConfig()))
        assert got.shape == (2, 1, 256, 256)
        _close(got[:, 0], want[..., 0])


class TestSwinPieces:
    def test_window_partition_round_trip(self):
        x = np.random.default_rng(2).standard_normal((2, 16, 24, 3)).astype(np.float32)
        wins = cm.window_partition(torch.from_numpy(x), 8)
        np.testing.assert_array_equal(wins.numpy(), np.asarray(jc.window_partition(x, 8)))
        np.testing.assert_array_equal(cm.window_unpartition(wins, 8, 16, 24).numpy(), x)

    @pytest.mark.parametrize("res,window,shift", [(16, 8, 4), (64, 8, 4), (8, 4, 2)])
    def test_masks_and_index(self, res, window, shift):
        np.testing.assert_array_equal(cm.relative_position_index(window),
                                      jc.relative_position_index(window))
        np.testing.assert_array_equal(cm.swin_attn_mask(res, res, window, shift),
                                      jc.swin_attn_mask(res, res, window, shift))


class TestCLAP:
    def test_frontend_matches_jax(self):
        wav = np.stack([clip(5, 96000, 48000), clip(6, 96000, 48000) * 0.1])
        got = cm.CLAPMelFrontend(device="cpu")(torch.from_numpy(wav)).numpy()
        want = np.asarray(jc.CLAPMelFrontend()(wav))
        assert got.shape == (2, 201, 64)
        _close(got, want)

    def test_configs_inferred_as_in_jax(self, clap_sd):
        acfg, tcfg = cm.infer_clap_configs(clap_sd)
        jacfg, jtcfg = jc.infer_clap_configs(_numpy(clap_sd))
        assert acfg == cm.HTSATConfig(**vars(jacfg)) == SMALL_HTSAT
        assert tcfg == cm.RobertaConfig(**vars(jtcfg)) == SMALL_ROBERTA

    def test_audio_tower_matches_jax(self, clap_sd):
        audio, _ = cm.load_clap_towers(clap_sd, device="cpu")
        logmel = (np.random.default_rng(7).standard_normal((2, 1001, 64)) * 10 - 40)
        logmel = logmel.astype(np.float32)
        with torch.no_grad():
            got = audio(torch.from_numpy(logmel)).numpy()
        acfg, _ = jc.infer_clap_configs(_numpy(clap_sd))
        want = jc.CLAPAudioTower(acfg).apply(
            {"params": jc.convert_clap_audio(_numpy(clap_sd), acfg)}, logmel)
        assert got.shape == (2, 32)
        _close_apart(got, want)

    def test_text_tower_matches_jax(self, clap_sd):
        _, text = cm.load_clap_towers(clap_sd, device="cpu")
        rng = np.random.default_rng(8)
        ids = rng.integers(2, 64, size=(3, 77)).astype(np.int32)
        mask = np.ones((3, 77), np.int32)
        for row, n in ((0, 9), (1, 40)):  # padded rows: position ids from the mask
            ids[row, n:], mask[row, n:] = 1, 0
        with torch.no_grad():
            got = text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        _, tcfg = jc.infer_clap_configs(_numpy(clap_sd))
        want = jc.CLAPTextTower(tcfg).apply(
            {"params": jc.convert_clap_text(_numpy(clap_sd), tcfg)}, ids, mask)
        _close_apart(got, want)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)

    def test_checkpoint_keys(self, clap_sd):
        """`module.` prefixes and the laion_clap entries no tower computes
        from are set aside; an unknown or wrongly shaped key is named."""
        sd = {"module." + k: v for k, v in clap_sd.items()}
        sd.update({"module.logit_scale_a": torch.zeros(()), "module.audio_branch.head.weight":
                   torch.zeros(3, 4), "module.text_branch.embeddings.position_ids":
                   torch.arange(80)[None]})
        audio, text = cm.load_clap_towers(sd, device="cpu")
        assert torch.equal(audio.state_dict()["audio_projection.2.weight"],
                           clap_sd["audio_projection.2.weight"])
        with pytest.raises(RuntimeError, match="audio_branch.extra"):
            cm.load_clap_towers({**clap_sd, "audio_branch.extra": torch.zeros(1)}, device="cpu")
        key = "text_branch.encoder.layer.1.output.dense.weight"
        with pytest.raises(RuntimeError, match=key):
            cm.load_clap_towers({**clap_sd, key: clap_sd[key][:, :5]}, device="cpu")

    def test_resample_to_48k(self):
        wav = clip(9, 16000)
        got, want = cm.resample_to_48k(wav), jc.resample_to_48k(wav)
        assert got.shape == want.shape == (48000,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    def test_wrapper_matches_jax(self, clap_sd, tmp_path, monkeypatch):
        """The protocol end to end (16 kHz load, 48 kHz, the two peak
        normalisations, repeatpad) in batches of 2, and the captions, with
        the tiny RoBERTa tokenizer that both packages read from the working
        directory."""
        monkeypatch.chdir(tmp_path)
        write_tiny_roberta_tokenizer(str(tmp_path))
        jax_text_params_as_arrays(monkeypatch)
        ckpt = R.write_eval_checkpoints(str(tmp_path / "ckpt"), 3, SMALL_HTSAT, SMALL_ROBERTA,
                                        which=("clap",))["clap"]
        paths = []
        for i, n in enumerate((160000, 8000, 40000)):
            paths.append(str(tmp_path / f"{i}.wav"))
            write_wav(paths[-1], clip(20 + i, n))
        caps = ["a dog barks", "rain on a tin roof", ""]
        port = cm.CLAPWrapper.from_checkpoint(ckpt, device="cpu")
        jax_wrapper = jc.CLAPWrapper.from_checkpoint(ckpt)
        _close_apart(port.audio_embeddings(paths, batch=2),
                     jax_wrapper.audio_embeddings(paths, batch=2))
        _close_apart(port.text_embeddings(caps), jax_wrapper.text_embeddings(caps))
        # without the tokenizer's files: None; the towers take any tokenizer
        assert cm.CLAPWrapper.from_checkpoint(ckpt, "missing-tokenizer", device="cpu") is None
        standin = lambda c, n: (np.full((len(c), n), 5), np.ones((len(c), n), np.int64))
        wrapper = cm.CLAPWrapper(*cm.load_clap_towers(ckpt, "cpu"), standin)
        assert wrapper.text_embeddings(caps).shape == (3, 32)


class TestRandTruncProtocol:
    """fit_length against the reference chain (seed_all(0), then one
    np.random.randint per long clip) and the JAX package's copy."""

    def test_crop_start_pins_to_reference_chain(self):
        n, overflow = 480_000, 37_013
        wav = np.arange(n + overflow, dtype=np.float32)
        np.random.seed(0)
        expect = int(np.random.randint(0, overflow + 1))
        got = cm.fit_length(wav, n, np.random.RandomState(0))
        np.testing.assert_array_equal(got, wav[expect : expect + n])
        np.testing.assert_array_equal(got, jc.fit_length(wav, n, np.random.RandomState(0)))

    def test_sequential_draws_and_short_clips_draw_nothing(self):
        n, overflow = 1000, 177
        wav = np.arange(n + overflow, dtype=np.float32)
        np.random.seed(0)
        first, second = (int(np.random.randint(0, overflow + 1)) for _ in range(2))
        rs = np.random.RandomState(0)
        assert (int(cm.fit_length(wav, n, rs)[0]), int(cm.fit_length(wav, n, rs)[0])) == \
            (first, second)
        rs = np.random.RandomState(0)
        cm.fit_length(np.ones(10, np.float32), n, rs)
        assert int(cm.fit_length(wav, n, rs)[0]) == first

    def test_repeatpad_zero_tail_exact_and_head_crop(self):
        wav = np.array([1.0, 2.0, 3.0], np.float32)
        np.testing.assert_array_equal(cm.fit_length(wav, 10),
                                      np.array([1, 2, 3, 1, 2, 3, 1, 2, 3, 0], np.float32))
        wav = np.arange(8, dtype=np.float32)
        np.testing.assert_array_equal(cm.fit_length(wav, 8), wav)
        np.testing.assert_array_equal(cm.fit_length(wav, 4), wav[:4])


def test_random_weights_are_seeded(tmp_path):
    """The stand-in checkpoints are a function of the seed alone."""
    a = R.clap_state_dict(1, SMALL_HTSAT, SMALL_ROBERTA)
    b = R.clap_state_dict(1, SMALL_HTSAT, SMALL_ROBERTA)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["audio_projection.0.weight"],
                           R.clap_state_dict(2, SMALL_HTSAT, SMALL_ROBERTA)["audio_projection.0.weight"])
    assert os.path.basename(R.write_eval_checkpoints(str(tmp_path), which=("vggish",))["vggish"]) \
        == "vggish.pth"
