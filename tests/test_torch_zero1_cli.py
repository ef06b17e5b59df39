"""The training CLI with `--device cpu --num_devices 2` (two gloo ranks on
the host, consistencytta_torch/cli/train.py and parallel/mesh.py) at the
tiny geometry, from a TANGO-format teacher and an AudioLDM-format VAE of
seeded random weights: stage 2 (Heun) for two steps writes summary.jsonl
once and a `step_2` in the single-rank layout, and its losses equal those of
a `--num_devices 1` run with twice the per-device batch (the same rows, and
the same draws through the ranks' generators); a checkpoint written at 2
ranks restores bit for bit at 1, one written at 1 is re-sharded bit for bit
at 2, and both resumed runs take the same third step; with `--augment` the
ranks' rows together are the 1-rank loader's global batch, exactly; stage 1,
LoRA and the FTVAE stage 3 train at 2 ranks too. Losses are held within
1e-4 of their size (float32 in another batch split).
"""

import json
import os

import numpy as np
import pytest
import torch

from consistencytta_torch.cli import train
from consistencytta_torch.configs import PipelineConfig
from consistencytta_torch.io import checkpoints as ck
from consistencytta_torch.io.audio import write_wav
from consistencytta_torch.models.pipeline import STUDENT_ROLES, Pipeline
from consistencytta_torch.parallel import mesh as pm
from consistencytta_torch.tools.random_eval_checkpoints import write_eval_checkpoints
from tests.torch_eval_common import SMALL_HTSAT, SMALL_ROBERTA

SEG = 64 * 160  # the tiny pipeline's segment
TOL = 1e-4


def _manifest(path, d, names, rng):
    t = np.arange(SEG) / 16000
    with open(path, "w") as f:
        for i, name in enumerate(names):
            wav = os.path.join(d, f"{name}.wav")
            write_wav(wav, 0.3 * np.sin(2 * np.pi * 150.0 * 2 ** (i / 4) * t)
                      + 0.05 * rng.standard_normal(SEG))
            f.write(json.dumps({"captions": f"A tone {name}", "location": wav}) + "\n")
    return str(path)


def _records(d):
    with open(os.path.join(d, "summary.jsonl")) as f:
        return [json.loads(line) for line in f]


def _epochs(d):
    return [r for r in _records(d) if "train_loss" in r]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """Two threads here and one in each spawned rank (the ranks' torch
    reads OMP_NUM_THREADS): the test workers share the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero1_cli")
    rng = np.random.default_rng(0)
    wavs = root / "wavs"
    wavs.mkdir()
    train_m = _manifest(root / "train.jsonl", wavs, [f"t{i}" for i in range(9)], rng)
    val_m = _manifest(root / "val.jsonl", wavs, [f"v{i}" for i in range(4)], rng)
    src = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu", seed=3,
                          roles=("teacher",))
    tango, vae = str(root / "tango.bin"), str(root / "vae.ckpt")
    torch.save({"unet." + k: v for k, v in src.unets["teacher"].state_dict().items()}, tango)
    torch.save({"state_dict": {**{"first_stage_model." + k: v
                                  for k, v in src.vae.state_dict().items()},
                               **{"first_stage_model.vocoder." + k: v
                                  for k, v in src.vocoder.state_dict().items()}}}, vae)
    base = ["--device", "cpu", "--pipeline_config", "tiny", "--freeze_text_encoder",
            "--random_init", "--train_file", train_m, "--validation_file", val_m,
            "--text_len", "8", "--tango_model", tango, "--vae_checkpoint", vae,
            "--snr_gamma", "5", "--teacher_guidance_scale", "-1", "--num_diffusion_steps", "4",
            "--seed", "1", "--gradient_accumulation_steps", "1", "--learning_rate", "1e-3",
            "--adam_epsilon", "1e-3", "--lr_scheduler_type", "constant"]
    s2 = base + ["--stage", "2", "--use_edm"]
    two = ["--num_devices", "2", "--per_device_train_batch_size", "2",
           "--per_device_eval_batch_size", "1"]
    one = ["--per_device_train_batch_size", "4", "--per_device_eval_batch_size", "2"]
    out = {k: str(root / k) for k in ("n2", "n1", "n2_from_n1", "n1_from_n2", "stage1",
                                      "lora", "ftvae", "prepare")}
    steps2 = ["--max_train_steps", "2", "--checkpointing_steps", "2"]
    assert train.main(s2 + two + steps2 + ["--output_dir", out["n2"]]) is None
    train.main(s2 + one + steps2 + ["--output_dir", out["n1"]])
    resume = lambda d: ["--max_train_steps", "3", "--checkpointing_steps", "none",
                        "--save_every", "1000", "--resume_from_checkpoint",
                        os.path.join(d, "step_2")]
    train.main(s2 + two + resume(out["n1"]) + ["--output_dir", out["n2_from_n1"]])
    train.main(s2 + one + resume(out["n2"]) + ["--output_dir", out["n1_from_n2"]])
    once = ["--max_train_steps", "1", "--checkpointing_steps", "1"]
    train.main(base + ["--stage", "1", "--augment"] + two + once + ["--output_dir", out["stage1"]])
    train.main(s2 + ["--use_lora"] + two + once + ["--output_dir", out["lora"]])
    clap = write_eval_checkpoints(str(root / "ckpt"), 0, SMALL_HTSAT, SMALL_ROBERTA,
                                  which=("clap",))["clap"]
    train.main(s2 + ["--loss_type", "clap", "--finetune_vae", "--clap_checkpoint", clap] + two
               + once + ["--output_dir", out["ftvae"]])
    return {"root": root, "out": out, "s2": s2, "two": two, "one": one, "resume": resume}


def test_two_ranks_write_the_summary_once_and_the_single_rank_layout(runs):
    d = runs["out"]["n2"]
    records = _records(d)
    assert len(records) == 2 and records[0]["num_devices"] == 2  # the replay, one epoch
    assert records[1]["step"] == 2 and records[1]["validation_batches"] == 2
    files = sorted([ck.MODEL_FILE, ck.OPTIMIZER_FILE, ck.SCHEDULER_FILE, ck.CONFIG_FILE])
    assert sorted(os.listdir(os.path.join(d, "step_2"))) == files
    got = torch.load(os.path.join(d, "step_2", ck.MODEL_FILE), weights_only=True)
    want = torch.load(os.path.join(runs["out"]["n1"], "step_2", ck.MODEL_FILE), weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:  # two runs of one computation
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=2e-3 * 1e-3 * 2)


def test_losses_equal_one_rank_with_twice_the_batch(runs):
    got, want = _epochs(runs["out"]["n2"]), _epochs(runs["out"]["n1"])
    keys = ("train_loss", "loss_w_gt", "loss_w_teacher", "loss_consistency", "loss_teacher")
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
    g, w = _epochs(runs["out"]["n2_from_n1"])[-1], _epochs(runs["out"]["n1_from_n2"])[-1]
    assert g["step"] == w["step"] == 3 and g["steps"] == w["steps"] == 1
    for k in keys:
        np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)


def _files(d):
    load = lambda name: torch.load(os.path.join(d, name), weights_only=True)
    return load(ck.MODEL_FILE), load(ck.OPTIMIZER_FILE), load(ck.SCHEDULER_FILE)


def test_a_two_rank_checkpoint_restores_bit_for_bit_at_one(runs):
    src = os.path.join(runs["out"]["n2"], "step_2")
    r = train.prepare(runs["s2"] + runs["one"] + ["--resume_from_checkpoint", src,
                                                   "--output_dir", runs["out"]["prepare"]])
    model, opt, sched = _files(src)
    assert r.state.step == sched["step"] == 2
    for role in STUDENT_ROLES:
        sd = getattr(r.state, role).state_dict()
        assert all(torch.equal(v, model[f"{role}_unet.{k}"]) for k, v in sd.items())
    state = r.state.optimizer.state_dict()["state"]
    assert sorted(state) == sorted(opt["state"])
    assert all(torch.equal(state[i][k], opt["state"][i][k]) for i in state for k in state[i])


@pytest.mark.parametrize("rank", [0, 1])
def test_a_one_rank_checkpoint_reshards_bit_for_bit_at_two(runs, rank):
    """prepare() as rank `rank` of 2 (its collectives are not reached
    before the first step): the state's shards are the file's slices; with
    --augment the ranks' rows together are the 1-rank loader's batch."""
    src = os.path.join(runs["out"]["n1"], "step_2")
    mesh = pm.Mesh(rank, 2, torch.device("cpu"))
    argv = runs["s2"] + ["--augment", "--resume_from_checkpoint", src, "--output_dir",
                         runs["out"]["prepare"]]
    r = train.prepare(argv + runs["two"], mesh)
    model, opt, _ = _files(src)
    z = r.state.zero1
    assert r.state.step == 2
    for piece, (i, a, b) in zip(z.optimizer.param_groups[0]["params"], z.ranges):
        assert torch.equal(piece.detach(), model[f"student_unet.{_name(r, i)}"].view(-1)[a:b])
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(z.optimizer.state[piece][k], opt["state"][i][k].view(-1)[a:b])
    ema = r.state.student_ema
    names = [n for n, _ in ema.module.named_parameters()]
    full = torch.cat([model[f"student_ema_unet.{n}"].view(-1) for n in names])
    assert torch.equal(torch.cat(ema.pieces), full[slice(*ema.bounds[rank])])
    assert 0 < ema.nbytes() <= 4 * -(-full.numel() // 2)
    # the loader: every rank builds the global batch, and keeps its rows
    single = train.prepare(argv + ["--per_device_train_batch_size", "4", "--output_dir",
                                   runs["out"]["prepare"]])
    want = next(iter(single.make_train_loader(0)))
    got = pm.shard_batch(next(iter(r.make_train_loader(0))), mesh)
    rows = pm.shard_rows(4, mesh)
    assert got["captions"] == [want["captions"][i] for i in rows]
    assert any(" and " in c for c in want["captions"])  # mixes in the batch
    for k in ("wav", "ids", "mask"):
        np.testing.assert_array_equal(got[k], want[k][rows])


def _name(r, i):
    return [n for n, _ in r.state.student.named_parameters()][i]


@pytest.mark.parametrize("name", ["stage1", "lora", "ftvae"])
def test_other_variants_train_at_two_ranks(runs, name):
    d = runs["out"][name]
    records = _epochs(d)
    assert len(records) == 1 and records[0]["step"] == 1
    assert np.isfinite(records[0]["train_loss"])
    model = torch.load(os.path.join(d, "step_1", ck.MODEL_FILE), weights_only=True)
    assert any(k.startswith("student_ema_unet.") for k in model)
    if name == "ftvae":
        assert any(k.startswith("ema_vae_decoder.") for k in model)
    if name == "lora":
        opt = torch.load(os.path.join(d, "step_1", ck.OPTIMIZER_FILE), weights_only=True)
        assert sorted(opt["lora_factors"]) == sorted(STUDENT_ROLES)
