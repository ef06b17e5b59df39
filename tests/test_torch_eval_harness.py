"""The port's evaluation harness (consistencytta_torch/evaluation/harness.py),
its evaluate_existing CLI and the test-set CLI's --test_references path,
against the JAX package's EvaluationHelper on the same directories of wavs
written from a numpy seed, with the same seeded random checkpoints, on the
CPU. Mirrors tests/test_eval_backbones.py's TestHarnessSmoke.

Tolerances: a metric dict agrees key by key within 1e-4 of max(1, |value|)
plus 1e-4, the step of the 4-place rounding both harnesses apply (the
backbones agree within 1e-4 of their outputs' scale,
tests/test_torch_eval_backbones.py), and is NaN exactly where the JAX
harness's is. The batched eval mels (one frontend call for the files of one
length) equal the per-file ones within 1e-6 absolute on the CPU (the plain
STFT's float32 product at another batch size) and the JAX package's within
2e-4 absolute (tests/test_torch_eval_mels.py).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import cli.evaluate_existing as jeval_cli
from consistencytta_tpu.evaluation import harness as jh
from consistencytta_torch.cli import evaluate_existing as eval_cli
from consistencytta_torch.cli import inference as cli
from consistencytta_torch.evaluation import harness as th
from consistencytta_torch.evaluation import mels
from consistencytta_torch.io.audio import write_wav
from consistencytta_torch.tools import random_eval_checkpoints as R
from tests.torch_eval_common import (
    SMALL_HTSAT, SMALL_ROBERTA, clip, jax_text_params_as_arrays, no_persistent_jax_cache,  # noqa: F401
    write_pairs, write_tiny_roberta_tokenizer,
)

NO_BACKBONES = dict(cnn14_checkpoint=None, vggish_checkpoint=None, clap_checkpoint=None)
BACKBONE_KEYS = {
    "cnn14": ["frechet_distance", "kullback_leibler_divergence_sigmoid",
              "kullback_leibler_divergence_softmax", "inception_score_mean",
              "inception_score_std", "kernel_inception_distance_mean",
              "kernel_inception_distance_std"],
    "vggish": ["frechet_audio_distance"],
    "clap": ["gt_text_clap_score", "gen_text_clap_score", "gen_gt_clap_score"],
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def assert_same_metrics(got, want):
    assert list(got) == list(want) == th.RESULT_KEYS == jh.RESULT_KEYS
    for k, w in want.items():
        if math.isnan(w):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)) + 1e-4, (k, got[k], w)


def _identical(*results):
    """Equal dicts, NaN equal to NaN (as the results file writes it)."""
    return len({json.dumps(r) for r in results}) == 1


def _nan_keys(result):
    return {k for k, v in result.items() if math.isnan(v)}


def test_batched_mels_equal_per_file():
    """Files of one length share a frontend call (two rows a call here); each
    row is that file's own mel, in input order."""
    wavs = [clip(i, n) for i, n in enumerate((32000, 24000, 32000, 32000, 24000, 40000))]
    frontend = mels.eval_mel_frontend("cpu")
    got = th.batched_logmels(wavs, frontend, batch=2)
    jf = jh.eval_mel_frontend()
    for w, g in zip(wavs, got):
        per_file = mels.normalized_logmel(w, frontend)
        assert g.shape == per_file.shape == (len(w) // 160 + 1, 64)
        np.testing.assert_allclose(g, per_file, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g, jh.normalized_logmel(w, jf), rtol=0, atol=2e-4)


def test_mel_artifact_fast_path_is_exact(tmp_path):
    """The all_mels.npz fast path reproduces PSNR / SSIM of the recompute,
    and a stale artifact (another crop length) is rejected."""
    gen_dir, ref_dir, names = write_pairs(str(tmp_path), (32000, 32000))
    frontend = mels.eval_mel_frontend("cpu")
    stored = mels.normalized_logmel(
        np.stack([mels.load_wav_16k(os.path.join(gen_dir, n), 1000) for n in names]), frontend)
    mel_npz = str(tmp_path / "all_mels.npz")
    np.savez(mel_npz, names=np.array(names), mels=stored, target_centisec=1000)
    helper = th.EvaluationHelper(**NO_BACKBONES, device="cpu")
    recomputed = helper.main(gen_dir, ref_dir)
    fast = helper.main(gen_dir, ref_dir, mel_path=mel_npz)
    assert (fast["psnr"], fast["ssim"]) == (recomputed["psnr"], recomputed["ssim"])
    np.savez(mel_npz, names=np.array(names), mels=stored * 0.5, target_centisec=500)
    assert helper.load_mel_artifact(mel_npz) == {}
    assert helper.main(gen_dir, ref_dir, mel_path=mel_npz)["psnr"] == recomputed["psnr"]
    with open(gen_dir + "_evaluation_results.json") as f:
        assert _identical(json.load(f), recomputed)


def test_paired_metrics_match_jax_without_backbones(tmp_path):
    """Full, uncropped files of three lengths (one over 10 s): LSD, SSIM-STFT,
    PSNR and SSIM as the JAX harness gives them, every backbone key NaN."""
    gen_dir, ref_dir, _ = write_pairs(str(tmp_path), (32000, 20000, 176000))
    got = th.EvaluationHelper(**NO_BACKBONES, device="cpu").main(gen_dir, ref_dir)
    want = jh.EvaluationHelper(**NO_BACKBONES).main(gen_dir, ref_dir)
    assert_same_metrics(got, want)
    assert _nan_keys(got) == set().union(*BACKBONE_KEYS.values())
    assert 10 < got["psnr"] and 0 < got["ssim"] <= 1


@pytest.mark.parametrize("backbone", sorted(BACKBONE_KEYS))
def test_missing_backbone_gives_nan(tmp_path, capsys, backbone):
    """A checkpoint path that names no file: NaN for that backbone's metrics
    and its warning, as in the JAX harness."""
    gen_dir, ref_dir, names = write_pairs(str(tmp_path), (20000, 20000))
    kwargs = {**NO_BACKBONES, f"{backbone}_checkpoint": str(tmp_path / "absent.pt")}
    captions = {n: "a tone" for n in names}
    got = th.EvaluationHelper(**kwargs, device="cpu").main(gen_dir, ref_dir, captions=captions)
    port_log = capsys.readouterr().out
    want = jh.EvaluationHelper(**kwargs).main(gen_dir, ref_dir, captions=captions)
    jax_log = capsys.readouterr().out
    assert_same_metrics(got, want)
    assert set(BACKBONE_KEYS[backbone]) <= _nan_keys(got)
    warning = {"cnn14": "Cnn14 checkpoint unavailable", "vggish": "VGGish checkpoint unavailable",
               "clap": "CLAP checkpoint unavailable"}[backbone]
    assert warning in port_log and warning in jax_log


def test_unpaired_sets(tmp_path):
    """No shared names: the paired metrics are -1 in both harnesses."""
    gen_dir, ref_dir, _ = write_pairs(str(tmp_path), (20000,))
    os.rename(os.path.join(gen_dir, "clip_00.wav"), os.path.join(gen_dir, "other.wav"))
    got = th.EvaluationHelper(**NO_BACKBONES, device="cpu").main(gen_dir, ref_dir)
    assert_same_metrics(got, jh.EvaluationHelper(**NO_BACKBONES).main(gen_dir, ref_dir))
    assert [got[k] for k in ("lsd", "ssim_stft", "psnr", "ssim")] == [-1, -1, -1, -1]


def test_harness_matches_jax_with_cnn14_and_vggish(tmp_path):
    """The one test with the 2048-wide Cnn14 Frechet distance (scipy's sqrtm,
    ~10 s a harness on an 8-core CPU): ten pairs of three lengths (Cnn14 batches
    of one length, VGGish examples across files) with Cnn14 and VGGish at
    their published widths. CLAP is held to the JAX harness in the CLI test
    below and in tests/test_torch_eval_backbones.py."""
    ckpt = R.write_eval_checkpoints(str(tmp_path / "ckpt"), 1, which=("cnn14", "vggish"))
    lengths = (32000, 24000, 40000, 32000, 24000, 32000, 40000, 32000, 24000, 32000)
    gen_dir, ref_dir, _ = write_pairs(str(tmp_path), lengths, seed=3)
    paths = {**NO_BACKBONES, **{f"{k}_checkpoint": v for k, v in ckpt.items()}}
    helper = th.EvaluationHelper(**paths, device="cpu")
    got = helper.main(gen_dir, ref_dir)
    want = jh.EvaluationHelper(**paths).main(gen_dir, ref_dir)
    assert_same_metrics(got, want)
    assert _nan_keys(got) == set(BACKBONE_KEYS["clap"])
    assert {"wav_load", "lsd", "mels", "psnr_ssim", "cnn14", "frechet_distance", "kl_isc_kid",
            "vggish", "frechet_audio_distance"} == set(helper.seconds)


def test_cli_test_references_matches_jax(tmp_path, monkeypatch):
    """The test-set CLI with --test_references at the tiny pipeline: its
    results file and summary line equal the JAX EvaluationHelper's on the
    same two directories, with the CLI's captions, its all_mels.npz as
    mel_path and the same checkpoints under ckpt/ in the working directory.
    The tiny clips (0.64 s) are shorter than one VGGish example, so VGGish
    is left out (both harnesses would fail on them) and Cnn14 too (its
    Frechet distance is covered above); CLAP scores and the paired metrics
    are computed, the rest is NaN in both."""
    monkeypatch.chdir(tmp_path)
    write_tiny_roberta_tokenizer(str(tmp_path))
    jax_text_params_as_arrays(monkeypatch)
    R.write_eval_checkpoints(str(tmp_path / "ckpt"), 2, SMALL_HTSAT, SMALL_ROBERTA,
                             which=("clap",))
    rows = [{"captions": "a dog barks", "location": "clips/a.wav"},
            {"captions": "rain on a roof", "location": "b.wav"},
            {"captions": "birds chirp", "location": "c.flac"}]
    manifest = tmp_path / "test.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    refs = tmp_path / "refs"
    refs.mkdir()
    for i, name in enumerate(("a.wav", "b.wav", "output_2.wav")):
        write_wav(str(refs / name), clip(30 + i, (16000, 24000, 32000)[i]))
    out = str(tmp_path / "out")
    result = cli.main(["--device", "cpu", "--pipeline_config", "tiny", "--random_init",
                       "--text_len", "16", "--test_file", str(manifest), "--batch_size", "2",
                       "--test_references", str(refs), "--output_dir", out])
    with open(out + "_evaluation_results.json") as f:
        got = json.load(f)
    with open(os.path.join(out, "summary.jsonl")) as f:
        line = json.loads(f.read())
    assert _identical({k: line[k] for k in th.RESULT_KEYS}, {k: result[k] for k in th.RESULT_KEYS},
                      got)
    assert line["eval_seconds"] > 0
    captions = dict(zip(("a.wav", "b.wav", "output_2.wav"), (r["captions"] for r in rows)))
    want = jh.EvaluationHelper().main(out, str(refs), captions=captions,
                                      mel_path=os.path.join(out, "all_mels.npz"))
    assert_same_metrics(got, want)
    assert _nan_keys(got) == set(BACKBONE_KEYS["cnn14"] + BACKBONE_KEYS["vggish"])


def test_evaluate_existing_cli_matches_jax(tmp_path, capsys):
    """The same flags as the JAX CLI plus --device, and the same printed
    result."""
    got_args = vars(eval_cli.parse_args(["--gen_dir", "g", "--ref_dir", "r"]))
    want_args = vars(jeval_cli.parse_args(["--gen_dir", "g", "--ref_dir", "r"]))
    assert {k: v for k, v in got_args.items() if k != "device"} == want_args
    assert got_args["device"] == "cuda"
    gen_dir, ref_dir, names = write_pairs(str(tmp_path), (24000, 24000))
    caps = tmp_path / "captions.json"
    caps.write_text(json.dumps({n: "a tone" for n in names}))
    argv = ["--gen_dir", gen_dir, "--ref_dir", ref_dir, "--captions_json", str(caps),
            "--cnn14_checkpoint", "none", "--vggish_checkpoint", "none",
            "--clap_checkpoint", "none", "--limit_num", "1"]
    got = eval_cli.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    jeval_cli.main(argv)
    printed = capsys.readouterr().out
    want = json.loads(printed[printed.index("{"):])
    assert_same_metrics(got, want)
