"""The port's training CLI (consistencytta_torch/cli/train.py) on the CPU at
the tiny geometry, against the JAX CLI (cli/train.py) where both have the
same function: its flags and defaults; the step, optimizer and schedule
configs it builds from the flags of tests/test_flag_audit.py; the
refusals, before any work; a flag audit (every flag read or refused).

Then the recipe's chain through files, as recipes/train.sh wires it, from a
TANGO-format teacher and an AudioLDM-format VAE of seeded random weights:
stage 1 (--augment) writes `best`; stage 2 (Heun) seeds from that directory
as --stage1_model and writes `step_2`; a resume from `step_2` restores
roles, optimizer, schedule and step bit for bit and takes one more step;
stage 2 with DDIM and with --use_lora; the inference CLI serves the written
`best` with its config replay; the LoRA checkpoint loads as plain modules;
the JAX CLI's loader reads the port's file to the same parameters; the T5
travels with the checkpoint. Then stage 3 from stage 2's `best`, with a
seeded random CLAP checkpoint of small towers at the published frontend:
`--loss_type clap --finetune_vae` for 2 steps writing `step_2`, its resume
(the decoder pair and its EMA bit for bit too) for one more step, the
inference CLI on its `best` through the EMA decoder (--use_ema), the JAX
CLI's loader on its file; one step each of `--loss_type mel` and `stft`.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import cli.train as jtrain
from cli.common import load_frozen_and_roles as jax_load
from consistencytta_tpu.configs import PipelineConfig as JaxPipelineConfig
from consistencytta_tpu.models.pipeline import Pipeline as JaxPipeline
from consistencytta_tpu.training.optim import make_optimizer as jax_make_optimizer
from consistencytta_torch.cli import inference
from consistencytta_torch.cli import train
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.io import checkpoints as ck
from consistencytta_torch.io import from_jax
from consistencytta_torch.io.audio import write_wav
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.tools.random_eval_checkpoints import write_eval_checkpoints
from consistencytta_torch.training import lora
from consistencytta_torch.training.optim import make_optimizer
from tests.torch_eval_common import SMALL_HTSAT, SMALL_ROBERTA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = 64 * 160  # the tiny pipeline's segment
TINY_SAMPLES = 10272
# flags that nothing reads, because the port refuses what they configure
# or, as in the JAX CLI, they are accepted for the recipe's sake
UNREAD = {
    "test_file": "the recipe passes it; the test set is the inference CLI's (as in the JAX CLI)",
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_parser_has_every_flag_of_the_jax_cli():
    want = {a.dest: a.default for a in _jax_actions() if a.dest != "help"}
    got = {a.dest: a.default for a in train._build_parser()._actions if a.dest != "help"}
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"
    for argv in (["--stage", "1"], ["--use_lora", "--augment", "--seed", "3"]):
        got, want = vars(train.parse_args(argv)), vars(jtrain.parse_args(argv))
        assert {k: v for k, v in got.items() if k != "device"} == want


def _jax_actions():
    """The JAX CLI's parser actions (its parse_args builds the parser inline)."""
    import argparse

    actions = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        actions.extend(self._actions)
        return real(self, *a, **kw)

    argparse.ArgumentParser.parse_args = capture
    try:
        jtrain.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return actions


STEP_FLAGS = [[], ["--snr_gamma", "3.5"], ["--teacher_guidance_scale", "-1"],
              ["--target_ema_decay", "0.9"], ["--ema_decay", "0.99"], ["--loss_type", "stft"],
              ["--loss_type", "clap"], ["--gradient_accumulation_steps", "7"], ["--no_remat"],
              ["--uncondition"]]


@pytest.mark.parametrize("flags", STEP_FLAGS, ids=lambda f: " ".join(f) or "defaults")
def test_step_configs_match_jax(flags):
    argv = ["--freeze_text_encoder", "--use_edm"] + flags
    got, want = train.parse_args(argv), jtrain.parse_args(argv)
    assert dataclasses.asdict(train.consistency_step_config_from_args(got)) == \
        dataclasses.asdict(jtrain.consistency_step_config_from_args(want))
    assert dataclasses.asdict(train.guided_step_config_from_args(got)) == \
        dataclasses.asdict(jtrain.guided_step_config_from_args(want))
    # the CLI recomputes the student's forward unless --no_remat, as in JAX
    assert train.consistency_step_config_from_args(got).remat_student == ("--no_remat" not in flags)


@pytest.mark.parametrize("flags", [[], ["--learning_rate", "1e-3"], ["--adam_weight_decay", "0.5"],
                                   ["--adam_epsilon", "1e-2"], ["--num_warmup_steps", "50"],
                                   ["--adam_beta1", "0.5", "--adam_beta2", "0.9"],
                                   ["--lr_scheduler_type", "cosine"]])
def test_optimizer_config_matches_jax(flags):
    got = train.optimizer_config_from_args(train.parse_args(flags), max_steps=100)
    want = jtrain.optimizer_config_from_args(jtrain.parse_args(flags), max_steps=100)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # and the flags reach the update: AdamW's groups and the schedule
    opt, sched = make_optimizer([torch.nn.Parameter(torch.ones(2))], got)
    g = opt.param_groups[0]
    assert (g["betas"], g["eps"], g["weight_decay"]) == \
        ((got.adam_beta1, got.adam_beta2), got.adam_epsilon, got.weight_decay)
    jax_make_optimizer(want)  # the JAX package takes the same values


@pytest.mark.parametrize("flags", [["--use_edm"], ["--use_edm", "--use_karras"],
                                   ["--use_edm", "--num_diffusion_steps", "6"], [],
                                   ["--num_diffusion_steps", "6"], ["--stage", "1"]])
def test_schedules_match_jax(flags):
    got = train.schedule_from_args(train.parse_args(flags), PipelineConfig().scheduler)
    want = jtrain.schedule_from_args(jtrain.parse_args(flags), JaxPipelineConfig().scheduler)
    assert type(got).__name__ == type(want).__name__
    fields = [f for f in ("timesteps", "sigmas", "alphas_cumprod") if hasattr(got, f)]
    assert fields and ("sigmas" in fields) == ("--use_edm" in flags)
    for field in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)


@pytest.mark.parametrize("argv,error,match", [
    (["--loss_type", "clap"], FileNotFoundError, "clap_checkpoint"),
    (["--loss_type", "clap", "--clap_checkpoint", "no/such.pt", "--finetune_vae"],
     FileNotFoundError, "clap_checkpoint"),
    (["--finetune_vae"], ValueError, "finetune_vae requires --loss_type clap"),
    (["--loss_type", "clap", "--use_lora", "--finetune_vae"], ValueError, "exclusive"),
    (["--num_devices", "2"], ValueError, r"--num_devices 2 out of range \(1..0 cards"),
    (["--num_devices", "0"], ValueError, "num_devices"),
    (["--stage", "1", "--use_lora"], ValueError, "use_lora"),
    (["--scheduler_name", "some/other-model"], ValueError, "scheduler_name"),
    (["--lr_scheduler_type", "polynomial"], ValueError, "lr_scheduler_type"),
    ([], RuntimeError, "cuda"),  # the card by default, and there is none
])
def test_refusals_come_before_any_work(tmp_path, monkeypatch, argv, error, match):
    """Nothing is written and no pipeline is made before a refusal."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr(Pipeline, "create", classmethod(lambda cls, *a, **kw: made.append(1)))
    out = tmp_path / "out"
    with pytest.raises(error, match=match):
        train.main(["--freeze_text_encoder", "--output_dir", str(out)] + argv)
    assert not os.path.exists(out) and not made


def test_freeze_text_encoder_asserted(tmp_path):
    with pytest.raises(AssertionError, match="freeze_text_encoder"):
        train.main(["--stage", "2", "--device", "cpu", "--output_dir", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_every_flag_is_read_or_refused():
    """The audit of tests/test_flag_audit.py over the port's CLI modules."""
    cli_dir = os.path.join(REPO, "consistencytta_torch", "cli")
    with open(os.path.join(cli_dir, "train.py")) as f:
        src = f.read()
    dests = re.findall(r'add_argument\(\s*"--([A-Za-z0-9_]+)"', src)
    corpus = ""
    for name in os.listdir(cli_dir):
        if name.endswith(".py"):
            with open(os.path.join(cli_dir, name)) as f:
                corpus += "".join(line for line in f if "add_argument" not in line)
    dead = [d for d in dests if d not in UNREAD
            and not re.search(rf"args\.{d}\b", corpus)
            and not re.search(rf'getattr\([A-Za-z_]+,\s*"{d}"', corpus)]
    assert len(dests) > 50 and not dead, dead
    assert all(d in dests for d in UNREAD)


# -- the chain through files ----------------------------------------------------


def _write_manifest(path, d, names, rng):
    t = np.arange(SEG) / 16000
    with open(path, "w") as f:
        for i, name in enumerate(names):
            wav_path = os.path.join(d, f"{name}.wav")
            f0 = 150.0 * 2 ** (i / 4)
            write_wav(wav_path, 0.3 * np.sin(2 * np.pi * f0 * t)
                      + 0.05 * rng.standard_normal(SEG))
            f.write(json.dumps({"captions": f"A tone {name}", "location": wav_path}) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_chain")
    rng = np.random.default_rng(0)
    wavs = root / "wavs"
    wavs.mkdir()
    train_m = _write_manifest(root / "train.jsonl", wavs, [f"t{i}" for i in range(9)], rng)
    val_m = _write_manifest(root / "val.jsonl", wavs, [f"v{i}" for i in range(4)], rng)
    # reference-format files of seeded random weights: TANGO's teacher, the
    # AudioLDM VAE with its vocoder
    src = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu", seed=3,
                          roles=("teacher",))
    tango, vae = str(root / "tango.bin"), str(root / "vae.ckpt")
    torch.save({"unet." + k: v for k, v in src.unets["teacher"].state_dict().items()}, tango)
    torch.save({"state_dict": {**{"first_stage_model." + k: v
                                  for k, v in src.vae.state_dict().items()},
                               **{"first_stage_model.vocoder." + k: v
                                  for k, v in src.vocoder.state_dict().items()}}}, vae)
    base = ["--device", "cpu", "--pipeline_config", "tiny", "--freeze_text_encoder",
            "--train_file", train_m, "--validation_file", val_m, "--text_len", "8",
            "--tango_model", tango, "--vae_checkpoint", vae, "--snr_gamma", "5",
            "--teacher_guidance_scale", "-1", "--num_diffusion_steps", "4"]
    out = {k: str(root / k) for k in ("stage1", "stage2", "ddim", "lora", "gen", "ftvae", "mel",
                                      "stft")}
    stage1 = train.main(base + [
        "--stage", "1", "--augment", "--per_device_train_batch_size", "2",
        "--gradient_accumulation_steps", "2", "--per_device_eval_batch_size", "2",
        "--max_train_steps", "2", "--checkpointing_steps", "best", "--output_dir",
        out["stage1"]])
    s2 = base + ["--stage", "2", "--stage1_model", os.path.join(out["stage1"], "best"),
                 "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "2",
                 "--per_device_eval_batch_size", "2"]
    stage2 = train.main(s2 + ["--use_edm", "--max_train_steps", "2", "--checkpointing_steps",
                              "2", "--output_dir", out["stage2"]])
    resume_argv = s2 + ["--use_edm", "--max_train_steps", "3", "--checkpointing_steps", "best",
                        "--output_dir", out["stage2"], "--resume_from_checkpoint",
                        os.path.join(out["stage2"], "step_2")]
    resumed = train.prepare(resume_argv)
    restored = {"step": resumed.state.step, **_snapshot(resumed.state)}
    train.run(resumed)
    ddim = train.main(s2 + ["--max_train_steps", "1", "--checkpointing_steps", "none",
                            "--save_every", "1000", "--output_dir", out["ddim"]])
    lora_state = train.main(s2 + ["--use_edm", "--use_lora", "--max_train_steps", "1",
                                  "--output_dir", out["lora"]])
    lora_resumed = train.prepare(s2 + ["--use_edm", "--use_lora", "--output_dir", out["lora"],
                                       "--resume_from_checkpoint",
                                       os.path.join(out["lora"], "best")])
    # stage 3 from stage 2's best (recipes/train.sh), CLAP towers from a file
    clap = write_eval_checkpoints(str(root / "ckpt"), 0, SMALL_HTSAT, SMALL_ROBERTA,
                                  which=("clap",))["clap"]
    s3 = s2[:s2.index("--stage1_model") + 1] + [os.path.join(out["stage2"], "best")] \
        + s2[s2.index("--stage1_model") + 2:] + ["--use_edm", "--clap_checkpoint", clap,
                                                 "--loss_type", "clap", "--finetune_vae"]
    ftvae = train.main(s3 + ["--max_train_steps", "2", "--checkpointing_steps", "2",
                             "--output_dir", out["ftvae"]])
    ftvae_resumed = train.prepare(s3 + ["--max_train_steps", "3", "--checkpointing_steps",
                                        "best", "--output_dir", out["ftvae"],
                                        "--resume_from_checkpoint",
                                        os.path.join(out["ftvae"], "step_2")])
    ftvae_restored = {"step": ftvae_resumed.state.step, **_snapshot(ftvae_resumed.state)}
    train.run(ftvae_resumed)
    other = {loss: train.main(s2 + ["--use_edm", "--loss_type", loss, "--max_train_steps", "1",
                                    "--checkpointing_steps", "none", "--save_every", "1000",
                                    "--output_dir", out[loss]]) for loss in ("mel", "stft")}
    return {"root": root, "out": out, "val": val_m, "vae": vae, "stage1": stage1,
            "stage2": stage2, "restored": restored, "resumed": resumed, "ddim": ddim,
            "lora": lora_state, "lora_resumed": lora_resumed, "ftvae": ftvae,
            "ftvae_restored": ftvae_restored, "ftvae_resumed": ftvae_resumed, **other}


def _snapshot(state):
    """Every tensor of a state, copied: roles, an FTVAE state's decoder pair
    and its EMA, optimizer state, schedule."""
    out = {}
    for role in (*STUDENT_ROLES, "vae_dec", "vae_dec_ema"):
        m = getattr(state, role, None)
        if m is not None:
            out.update({f"{role}.{k}": v.clone() for k, v in m.state_dict().items()})
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"optimizer.{i}.{k}": torch.as_tensor(v).clone() for k, v in s.items()})
    out["lr_scheduler"] = state.lr_scheduler.state_dict()
    return out


def _records(d):
    with open(os.path.join(d, "summary.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_chain_writes_the_checkpoints(chain):
    out = chain["out"]
    files = sorted([ck.MODEL_FILE, ck.OPTIMIZER_FILE, ck.SCHEDULER_FILE, ck.CONFIG_FILE])
    assert sorted(os.listdir(os.path.join(out["stage1"], "best"))) == files
    assert sorted(os.listdir(out["stage2"])) == ["best", "step_2", "summary.jsonl"]
    assert sorted(os.listdir(out["ddim"])) == ["summary.jsonl"]
    sd = torch.load(os.path.join(out["stage1"], "best", ck.MODEL_FILE))
    assert sorted({k.split(".")[0] for k in sd}) == \
        ["student_ema_unet", "student_unet", "teacher_unet", "text_encoder"]
    sd = torch.load(os.path.join(out["stage2"], "step_2", ck.MODEL_FILE))
    assert sorted({k.split(".")[0] for k in sd}) == \
        ["student_ema_unet", "student_target_unet", "student_unet", "teacher_unet",
         "text_encoder"]
    with open(os.path.join(out["stage2"], "step_2", ck.CONFIG_FILE)) as f:
        assert json.load(f) == json.loads(PipelineConfig.tiny().to_json())
    # stage 1: augment gives 3 originals + mixes a batch of 4; 2 steps, val_loss
    rec = [r for r in _records(out["stage1"]) if "train_loss" in r]
    assert rec[-1]["step"] == 2 and "val_loss" in rec[-1] and rec[-1]["validation_batches"] == 2
    for run in ("stage2", "ddim", "lora"):
        rec = [r for r in _records(out[run]) if "loss_w_teacher" in r]
        assert rec and all(np.isfinite(rec[-1][k]) for k in
                           ("loss_w_gt", "loss_w_teacher", "loss_consistency", "loss_teacher"))
    assert chain["ddim"].step == 1 and chain["lora"].step == 1


def test_resume_restores_the_state_bit_for_bit_and_takes_one_step(chain):
    """The stage-2 run ended at step 2, where it wrote step_2; the resumed
    state equals it, tensor for tensor, before its one further step."""
    saved, restored = _snapshot(chain["stage2"]), chain["restored"]
    assert chain["stage2"].step == restored["step"] == 2
    assert sorted(saved) == sorted(k for k in restored if k != "step")
    assert any(k.startswith("optimizer.") and k.endswith("exp_avg_sq") for k in saved)
    for k, v in saved.items():
        if k == "lr_scheduler":
            assert restored[k] == v
        else:
            assert torch.equal(restored[k], v), k
    assert chain["resumed"].state.step == 3
    records = [r for r in _records(chain["out"]["stage2"]) if "train_loss" in r]
    assert [r["steps"] for r in records] == [2, 1]
    assert chain["resumed"].resume_seconds > 0
    assert os.path.exists(os.path.join(chain["out"]["stage2"], "best", ck.MODEL_FILE))


def test_lora_checkpoint_resumes_and_loads_as_plain_modules(chain):
    state, again = chain["lora"], chain["lora_resumed"].state
    assert again.step == 1 and again.lora_base is not None
    for role in STUDENT_ROLES:
        for k, v in getattr(state, role).state_dict().items():
            assert torch.equal(getattr(again, role).state_dict()[k], v)
    a, b = state.optimizer.state_dict()["state"], again.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg"], b[i]["exp_avg"]) for i in a)
    # the file's roles are the merged modules, loaded as plain UNets
    gen = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu", seed=9)
    loaded = ck.load_frozen_and_roles(gen, model_path=os.path.join(chain["out"]["lora"], "best"),
                                      vae_checkpoint=chain["vae"])
    assert set(STUDENT_ROLES) <= set(loaded) and "t5" in loaded
    for role in STUDENT_ROLES:
        want = lora.merged_state_dict(state.lora_base, getattr(state, role))
        got = gen.unets[role].state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), role
    moved = lora.merged_state_dict(state.lora_base, state.student)
    assert any(not torch.equal(moved[k], v) for k, v in state.lora_base.state_dict().items())
    # a full checkpoint does not resume a LoRA run, nor the reverse
    with pytest.raises(ValueError, match="LoRA"):
        ck.load_checkpoint(os.path.join(chain["out"]["stage2"], "step_2"), again)


def test_inference_cli_serves_the_written_best(chain, tmp_path):
    out = str(tmp_path / "gen")
    result = inference.main([
        "--device", "cpu", "--model", os.path.join(chain["out"]["stage2"], "best"),
        "--original_args", os.path.join(chain["out"]["stage2"], "summary.jsonl"),
        "--vae_checkpoint", chain["vae"], "--use_edm", "--use_ema", "--test_file", chain["val"],
        "--batch_size", "2", "--skip_eval", "--seed", "5", "--output_dir", out])
    assert result["num_clips"] == 4
    wavs = sorted(n for n in os.listdir(out) if n.endswith(".wav"))
    assert wavs == [f"v{i}.wav" for i in range(4)]
    for n in wavs:
        sr, data = wavfile.read(os.path.join(out, n))
        assert sr == 16000 and data.shape == (TINY_SAMPLES,) and np.abs(data).max() > 0
    line = json.loads(open(os.path.join(out, "summary.jsonl")).read().splitlines()[-1])
    assert line["pipeline_config"] == "tiny" and line["text_len"] == 8  # replayed


def test_the_t5_travels_with_the_checkpoint(chain):
    """Served from another seed, the pipeline takes the T5 the student was
    trained with from the file, not its own init."""
    best = os.path.join(chain["out"]["stage2"], "best")
    gen = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu", seed=5)
    fresh = {k: v.clone() for k, v in gen.t5.state_dict().items()}
    loaded = ck.load_frozen_and_roles(gen, model_path=best, vae_checkpoint=chain["vae"])
    assert loaded["t5"] == os.path.join(best, ck.MODEL_FILE)
    sd = torch.load(os.path.join(best, ck.MODEL_FILE))
    t5 = ck.strip_prefix(sd, ck.T5_PREFIX)
    assert all(torch.equal(gen.t5.state_dict()[k], v) for k, v in t5.items())
    assert any(not torch.equal(fresh[k], v) for k, v in t5.items())
    trained_t5 = chain["resumed"].pipeline.t5.state_dict()
    assert all(torch.equal(trained_t5[k], v) for k, v in t5.items())


def test_jax_loader_reads_the_port_file(chain):
    """cli/common.py's loader on the port's pytorch_model_2.bin gives the
    parameters the port's loader puts in its modules."""
    path = os.path.join(chain["out"]["stage2"], "best", ck.MODEL_FILE)
    jparams = jax_load(JaxPipeline.create(JaxPipelineConfig.tiny()), model_path=path)
    port = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu",
                           roles=(*STUDENT_ROLES, "teacher"), training=True)
    ck.load_frozen_and_roles(port, model_path=path, random_init_seed=0)
    for role in (*STUDENT_ROLES, "teacher"):
        module = port.unets[role]
        want = from_jax.unet_state_dict(getattr(jparams, role), module.config)
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), role


def test_directory_model_paths(chain, tmp_path):
    os.makedirs(tmp_path / "empty")
    port = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu")
    with pytest.raises(FileNotFoundError, match=ck.MODEL_FILE):
        ck.load_frozen_and_roles(port, model_path=str(tmp_path / "empty"))
    best = os.path.join(chain["out"]["stage1"], "best")
    assert ck.checkpoint_file(best) == os.path.join(best, ck.MODEL_FILE)
    assert ck.checkpoint_file(chain["vae"]) == chain["vae"]


# -- stage 3 --------------------------------------------------------------------


def test_ftvae_writes_the_reference_layout(chain):
    """The FTVAE run's step_2: the roles, the trained decoder pair and its
    EMA under the reference's keys, no CLAP weights; the decoder trained;
    its validation logs loss_decoder_mel."""
    out = chain["out"]["ftvae"]
    assert sorted(os.listdir(out)) == ["best", "step_2", "summary.jsonl"]
    sd = torch.load(os.path.join(out, "step_2", ck.MODEL_FILE))
    assert sorted({k.split(".")[0] for k in sd}) == \
        ["ema_vae_decoder", "ema_vae_pqconv", "student_ema_unet", "student_target_unet",
         "student_unet", "teacher_unet", "text_encoder", "vae"]
    assert not any("branch" in k or "projection" in k for k in sd)
    state = chain["ftvae"]
    trained, ema = ck.extract_ftvae_decoders(sd)
    assert sorted(trained) == sorted(ema) == sorted(state.vae_dec.state_dict())
    opt = torch.load(os.path.join(out, "step_2", ck.OPTIMIZER_FILE))
    n_student = len(list(state.student.parameters()))
    assert len(opt["state"]) == n_student + len(list(state.vae_dec.parameters()))
    rec = [r for r in _records(out) if "loss_decoder_mel" in r]
    assert rec and all(np.isfinite(rec[-1][k]) for k in
                       ("loss_w_teacher", "loss_decoder_mel", "train_loss"))


def test_ftvae_resume_restores_the_decoders_bit_for_bit(chain):
    saved, restored = _snapshot(chain["ftvae"]), chain["ftvae_restored"]
    assert restored["step"] == 2 and chain["ftvae_resumed"].state.step == 3
    assert any(k.startswith("vae_dec_ema.") for k in restored)
    assert sorted(saved) == sorted(k for k in restored if k != "step")
    for k, v in saved.items():
        if k == "lr_scheduler":
            assert restored[k] == v
        else:
            assert torch.equal(restored[k], v), k
    # a full checkpoint does not resume an FTVAE run, nor the reverse
    with pytest.raises(ValueError, match="FTVAE"):
        ck.load_checkpoint(os.path.join(chain["out"]["ftvae"], "best"), chain["resumed"].state)


def test_inference_cli_decodes_through_the_ema_decoder(chain, tmp_path):
    best = os.path.join(chain["out"]["ftvae"], "best")
    gen = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu", seed=9)
    loaded = ck.load_frozen_and_roles(gen, model_path=best, vae_checkpoint=chain["vae"])
    assert {"vae decoder", "vae_ema"} <= set(loaded)
    state = chain["ftvae_resumed"].state
    for module, want in ((gen.vae_ema, state.vae_dec_ema), (gen.vae, state.vae_dec)):
        got = module.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())
    out = str(tmp_path / "gen")
    result = inference.main([
        "--device", "cpu", "--model", best, "--original_args",
        os.path.join(chain["out"]["ftvae"], "summary.jsonl"), "--vae_checkpoint", chain["vae"],
        "--use_edm", "--use_ema", "--test_file", chain["val"], "--batch_size", "2",
        "--skip_eval", "--seed", "5", "--output_dir", out])
    assert result["num_clips"] == 4
    for n in sorted(x for x in os.listdir(out) if x.endswith(".wav")):
        sr, data = wavfile.read(os.path.join(out, n))
        assert sr == 16000 and data.shape == (TINY_SAMPLES,)


def test_jax_loader_reads_the_port_ftvae_file(chain):
    """cli/common.py's loader on the FTVAE run's file: its VAE decoder pair
    and its EMA pair equal the port's."""
    path = os.path.join(chain["out"]["ftvae"], "best", ck.MODEL_FILE)
    jparams = jax_load(JaxPipeline.create(JaxPipelineConfig.tiny()), model_path=path,
                       vae_checkpoint=chain["vae"])
    state = chain["ftvae_resumed"].state
    cfg = PipelineConfig.tiny().vae
    for tree, module in ((jparams.vae, state.vae_dec), (jparams.vae_ema, state.vae_dec_ema)):
        want = from_jax.vae_decoder_state_dict(tree, cfg)
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("loss", ["mel", "stft"])
def test_mel_and_stft_losses_train(chain, loss):
    state = chain[loss]
    assert state.step == 1
    rec = [r for r in _records(chain["out"][loss]) if "train_loss" in r]
    assert rec and np.isfinite(rec[-1]["train_loss"]) and np.isfinite(rec[-1]["loss_w_teacher"])
