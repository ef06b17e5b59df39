"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package, and a request for the card where there is none raises instead of
falling back to the CPU."""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "consistencytta_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "consistencytta_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    names = {os.path.relpath(f, REPO) for f in files}
    for new in ("ops/stft.py", "ops/mel.py", "ops/dilated_conv.py", "training/step.py",
                "training/optim.py", "training/ema.py", "training/losses.py",
                "ops/resample.py", "io/audio.py", "io/checkpoints.py", "evaluation/mels.py",
                "training/data.py", "cli/common.py", "cli/inference.py", "cli/demo.py",
                "easy.py", "evaluation/metrics.py", "evaluation/panns.py",
                "evaluation/vggish.py", "evaluation/clap_model.py", "evaluation/clap.py",
                "evaluation/harness.py", "cli/evaluate_existing.py",
                "tools/random_eval_checkpoints.py", "training/lora.py", "training/loop.py",
                "cli/train.py", "training/clap_loss.py", "training/ftvae.py",
                "parallel/__init__.py", "parallel/mesh.py", "tools/ddp_scaling.py",
                "utils.py", "tools/bench.py", "tools/profile_stages.py"):
        assert os.path.join("consistencytta_torch", new) in names
    bad = {}
    for path in files:
        roots = set(_imported_roots(path))
        with open(path) as f:
            text = f.read()
        hits = sorted(roots & set(FORBIDDEN))
        # also catch imports the AST walk cannot see (exec'd or dynamic)
        hits += [w for w in ("import jax", "from jax", "import flax", "from flax",
                             "import consistencytta_tpu", "from consistencytta_tpu",
                             "import_module", "__import__")
                 if w in text]
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad


def test_port_does_not_import_the_converter():
    """tools/orbax_to_torch.py imports both packages; nothing of the port
    imports it (the port's refusal of an orbax directory only names it)."""
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            if any("orbax_to_torch" in n or n == "tools" or n.startswith("tools.")
                   for n in names):
                bad.append(os.path.relpath(path, REPO))
    assert not bad, bad
    assert os.path.exists(os.path.join(REPO, "tools", "orbax_to_torch.py"))


def test_cuda_request_without_card_raises(monkeypatch):
    from consistencytta_torch.configs import PipelineConfig
    from consistencytta_torch.models.pipeline import Pipeline
    from consistencytta_torch.cli import evaluate_existing, inference, train
    from consistencytta_torch.evaluation.clap_model import CLAPMelFrontend, load_clap_towers
    from consistencytta_torch.evaluation.harness import EvaluationHelper
    from consistencytta_torch.evaluation.mels import eval_mel_frontend
    from consistencytta_torch.evaluation.panns import load_cnn14
    from consistencytta_torch.evaluation.vggish import load_vggish
    from consistencytta_torch.ops.stft import MelFrontend
    from consistencytta_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline.create(PipelineConfig.tiny(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        MelFrontend()
    with pytest.raises(RuntimeError, match="cuda"):
        eval_mel_frontend()
    with pytest.raises(RuntimeError, match="cuda"):
        inference.main(["--pipeline_config", "tiny", "--random_init", "--skip_eval"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--freeze_text_encoder", "--pipeline_config", "tiny", "--random_init"])
    # the evaluation entry points: the card by default, the CPU only on request
    with pytest.raises(RuntimeError, match="cuda"):
        EvaluationHelper(cnn14_checkpoint=None, vggish_checkpoint=None, clap_checkpoint=None)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_existing.main(["--gen_dir", ".", "--ref_dir", "."])
    with pytest.raises(RuntimeError, match="cuda"):
        CLAPMelFrontend()
    from consistencytta_torch.tools import bench, profile_stages

    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        profile_stages.main([])
    for load in (load_cnn14, load_clap_towers, load_vggish):
        with pytest.raises(RuntimeError, match="cuda"):
            load(os.devnull)
    assert EvaluationHelper(device="cpu").device.type == "cpu"
    assert MelFrontend(device="cpu").cos_basis.device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("builder", ["build_consistency_train_step", "build_validation_step",
                                     "build_guided_train_step"])
def test_train_step_on_cuda_without_card_raises(monkeypatch, builder):
    """A pipeline that says it lives on the card, where there is none: the
    step builders raise instead of running on the CPU."""
    from consistencytta_torch.configs import PipelineConfig, SchedulerConfig
    from consistencytta_torch.models.pipeline import Pipeline
    from consistencytta_torch.ops import schedulers
    from consistencytta_torch.training import step

    pipe = Pipeline.create(PipelineConfig.tiny(), dtype=torch.float32, device="cpu")
    pipe.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = schedulers.make_ddpm_schedule if "guided" in builder else \
        (lambda cfg: schedulers.make_heun_schedule(cfg, 18))
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(step, builder)(pipe, make(SchedulerConfig()))
    if "guided" not in builder:  # the DDIM branch too
        ddim = schedulers.make_ddim_schedule(SchedulerConfig(), 18)
        with pytest.raises(RuntimeError, match="cuda"):
            getattr(step, builder)(pipe, ddim, step.ConsistencyStepConfig(use_edm=False))


def test_kernel_wrappers_take_the_plain_version_only_for_a_cpu_tensor():
    """The dispatch is on the tensor's device and nothing else: the wrappers'
    sources name no environment switch and catch no exception."""
    for rel in ("ops/stft.py", "ops/dilated_conv.py", "ops/attention.py", "ops/mrf.py"):
        with open(os.path.join(REPO, "consistencytta_torch", rel)) as f:
            tree = ast.parse(f.read())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)], rel
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert "environ" not in names and "getenv" not in names, rel
