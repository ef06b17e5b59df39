"""The port's test-set CLI (consistencytta_torch/cli/inference.py), its
demo and its one-class API on the CPU at the tiny geometry with random
weights: file names (`_s<k>` with --num_samples, `output_<i>.wav` for a
non-wav manifest path), the last batch padded with empty prompts, the
teacher's files beside the student's, `all_mels.npz`, the `summary.jsonl`
line, config replay and the stage-mismatch assertion, each against the JAX
CLI's functions where it has them; and its parser against the JAX CLI's.

Tolerance: the stored mels within 2e-4 of the JAX package's eval mels of
the same files (tests/test_torch_eval_mels.py says why).
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import cli.inference as jcli
from consistencytta_tpu.evaluation import harness as jharness
from consistencytta_torch.cli import demo
from consistencytta_torch.cli import inference as cli
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.easy import ConsistencyTTA
from consistencytta_torch.inference import generate as gen
from consistencytta_torch.text.tokenizer import HashTokenizer

TINY_SAMPLES = 10272  # the tiny vocoder's output for the tiny latent's 64 mel frames
BASE = ["--device", "cpu", "--pipeline_config", "tiny", "--random_init", "--text_len", "16"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def manifest(tmp_path):
    path = tmp_path / "test.jsonl"
    rows = [{"captions": "a dog barks", "location": "clips/a.wav"},
            {"captions": "rain on a roof", "location": "b.wav"},
            {"captions": "birds chirp", "location": "c.flac"}]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def test_parser_has_every_flag_of_the_jax_cli():
    want = {a.dest: a.default for a in jcli._build_parser()._actions if a.dest != "help"}
    got = {a.dest: a.default for a in cli._build_parser()._actions if a.dest != "help"}
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"


def test_pipeline_config_and_replay_files(tmp_path):
    """--pipeline_config as "tiny" or a json, --unet_model_config from a
    diffusers json, and a namespace written to summary.jsonl read back."""
    from consistencytta_torch.cli import common

    cfg_path, unet_path = tmp_path / "config.json", tmp_path / "unet.json"
    cfg_path.write_text(PipelineConfig.tiny().to_json())
    unet = {"in_channels": 8, "out_channels": 8, "block_out_channels": [32, 64],
            "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
            "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"], "attention_head_dim": 4,
            "use_linear_projection": True}
    unet_path.write_text(json.dumps(unet))
    args = cli.parse_args(["--pipeline_config", str(cfg_path), "--unet_model_config",
                           str(unet_path)])
    got = common.build_pipeline_config(args)
    assert json.loads(got.vae.to_json()) == json.loads(PipelineConfig.tiny().vae.to_json())
    assert got.unet.block_out_channels == (32, 64) and got.unet.attention_head_dim == (4, 4)
    assert common.build_pipeline_config(cli.parse_args(["--pipeline_config", "tiny"])) == \
        PipelineConfig.tiny()
    common.append_config_replay(str(tmp_path / "run"), args)
    replay = common.read_config_replay(str(tmp_path / "run" / "summary.jsonl"))
    assert replay["unet_model_config"] == str(unet_path) and replay["seed"] == 0


def test_tokenizer_loader_looks_for_files_first(tmp_path, monkeypatch):
    """`transformers` is tried only where the tokenizer's files are local
    (a directory, or a hub name in the local cache); else the hash
    tokenizer, without importing it."""
    from consistencytta_torch.text import tokenizer as tk

    calls = []
    monkeypatch.setattr(tk, "HFTokenizer", lambda name: calls.append(name) or "hf")
    for name in ("google/flan-t5-large", str(tmp_path / "missing"), "not a hub name!"):
        got = tk.load_tokenizer(name, vocab_size=256)
        assert isinstance(got, HashTokenizer) and got.vocab_size == 256
    assert calls == []
    assert tk.load_tokenizer(str(tmp_path)) == "hf" and calls == [str(tmp_path)]

    def refuse(name):
        raise OSError("no tokenizer files")

    monkeypatch.setattr(tk, "HFTokenizer", refuse)
    assert isinstance(tk.load_tokenizer(str(tmp_path)), HashTokenizer)


def test_generate_config_from_args_matches_jax():
    argv = ["--num_steps", "3", "--guidance_scale_post", "2.0", "--use_ema", "--use_edm"]
    got = cli.generate_config_from_args(cli.parse_args(argv))
    want = jcli.generate_config_from_args(jcli.parse_args(argv))
    assert got == gen.GenerateConfig(**{f: getattr(want, f) for f in got.__dataclass_fields__})


def test_config_replay_matches_jax(tmp_path):
    replay = {"stage": 2, "num_steps": 2, "use_edm": True, "seed": 99, "prefix": "sound: ",
              "guidance_scale_input": 2.0, "output_dir": "elsewhere", "random_init": True,
              "text_column": "wrong", "model": "other.bin", "batch_size": 4, "unknown": 1}
    argv = ["--num_steps", "5", "--output_dir", "here"]
    got = cli.apply_config_replay(cli.parse_args(argv), replay)
    want = jcli.apply_config_replay(jcli.parse_args(argv), replay)
    assert {k: v for k, v in vars(got).items() if k not in ("device", "_explicit")} == \
        {k: v for k, v in vars(want).items() if k != "_explicit"}
    assert (got.num_steps, got.use_edm, got.seed, got.batch_size) == (5, True, 0, 4)


def _run(argv, monkeypatch):
    """main() with the texts each sampler was given recorded."""
    calls = []

    def recording(make, kind):
        def build(*a, **kw):
            fn = make(*a, **kw)

            def wrapped(ids, *rest, **kwr):
                calls.append((kind, np.array(ids)))
                return fn(ids, *rest, **kwr)
            return wrapped
        return build

    for name in ("build_generate_fn", "build_teacher_generate_fn",
                 "build_guided_student_generate_fn"):
        monkeypatch.setattr(gen, name, recording(getattr(gen, name), name))
    return cli.main(argv), calls


def test_cli_writes_the_test_set(tmp_path, manifest, monkeypatch):
    out = str(tmp_path / "out")
    argv = BASE + ["--test_file", manifest, "--batch_size", "2", "--num_samples", "2",
                   "--query_teacher", "--num_teacher_steps", "2", "--skip_eval",
                   "--output_dir", out]
    result, calls = _run(argv, monkeypatch)
    names = ["a_s0.wav", "a_s1.wav", "b_s0.wav", "b_s1.wav", "output_2_s0.wav",
             "output_2_s1.wav"]
    assert sorted(os.listdir(out)) == sorted(names + ["all_mels.npz", "summary.jsonl"])
    assert sorted(os.listdir(out + "_teacher")) == sorted(names)
    for d in (out, out + "_teacher"):
        for n in names:
            sr, data = wavfile.read(os.path.join(d, n))
            assert sr == 16000 and data.dtype == np.int16 and data.shape == (TINY_SAMPLES,)
            assert np.abs(data).max() > 0
    # every batch is batch_size x num_samples rows; the last one padded with ""
    assert [k for k, _ in calls] == ["build_generate_fn", "build_teacher_generate_fn"] * 2
    assert all(ids.shape == (4, 16) for _, ids in calls)
    empty, _ = HashTokenizer(vocab_size=256)([""], 16)
    last = calls[2][1]
    assert (last[2:] == empty).all() and not (last[:2] == empty).all(axis=1).any()
    # the eval mels of the files as written
    mels = np.load(os.path.join(out, "all_mels.npz"))
    assert list(mels["names"]) == names and int(mels["target_centisec"]) == 1000
    assert mels["mels"].shape == (6, 201, 64)
    assert mels["mels"].min() >= 0 and mels["mels"].max() <= 1
    jf = jharness.eval_mel_frontend()
    for n, m in zip(names, mels["mels"]):
        want = jharness.normalized_logmel(jharness.load_wav_16k(os.path.join(out, n), 1000), jf)
        np.testing.assert_allclose(m, want, rtol=0, atol=2e-4)
    # one summary line a run, with the flags and the result
    cli.main(argv + ["--no_save_mels", "--num_samples", "1"])
    lines = open(os.path.join(out, "summary.jsonl")).read().splitlines()
    assert len(lines) == 2
    first = json.loads(lines[0])
    assert first["num_clips"] == result["num_clips"] == 6
    assert first["batch_size"] == 2 and first["device"] == "cpu"
    assert {"gen_seconds", "teacher_seconds", "load_seconds", "mel_seconds"} <= set(first)


def test_cli_stage1_guided_student(tmp_path, manifest, monkeypatch):
    """--stage 1 samples the guided student (the student role without
    --use_ema), DDIM without --use_edm, no teacher."""
    out = str(tmp_path / "s1")
    result, calls = _run(BASE + ["--test_file", manifest, "--stage", "1", "--num_steps", "2",
                                 "--batch_size", "3", "--skip_eval", "--output_dir", out],
                         monkeypatch)
    assert [k for k, _ in calls] == ["build_guided_student_generate_fn"]
    assert result["num_clips"] == 3
    assert sorted(n for n in os.listdir(out) if n.endswith(".wav")) == \
        ["a.wav", "b.wav", "output_2.wav"]


def test_cli_refuses_before_working(tmp_path, manifest):
    replay = tmp_path / "summary.jsonl"
    replay.write_text(json.dumps({"stage": 2, "num_steps": 1}) + "\n")
    argv = BASE + ["--test_file", manifest, "--output_dir", str(tmp_path / "o")]
    with pytest.raises(AssertionError, match="Stage mismatch"):
        cli.main(argv + ["--original_args", str(replay), "--stage", "1"])
    with pytest.raises(NotImplementedError, match="evaluation"):
        cli.main(argv + ["--test_references", str(tmp_path)])
    assert not os.path.exists(tmp_path / "o")


def test_demo_and_easy_api(tmp_path):
    out = str(tmp_path / "demo")
    demo.main(BASE + ["--output_dir", out, "--num_teacher_steps", "2"],
              stdin=io.StringIO("a dog barks\n\n"))
    assert sorted(os.listdir(out)) == ["student_0.wav", "teacher_0.wav"]
    model = ConsistencyTTA(pipeline_config=PipelineConfig.tiny(), use_bf16=False,
                           random_init_seed=0, device="cpu", text_len=16)
    wav = model(["a dog barks", "rain"], num_samples=2, seed=1)
    assert wav.shape == (4, TINY_SAMPLES) and np.isfinite(wav).all()
    np.testing.assert_array_equal(model(["a dog barks", "rain"], num_samples=2, seed=1), wav)
    with pytest.raises(ValueError, match="no checkpoint holds"):
        ConsistencyTTA(pipeline_config=PipelineConfig.tiny(), device="cpu")
