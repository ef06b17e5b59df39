"""The command refuses to run, and prints no result, without a card or
without the program beside it."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "gen-b32",
                          "--seed", str(2 ** 32 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch; from benchmark import harness, manifest; "
            "r = harness.run_cell(manifest.cell('gen-b1'), 1, 0.1, False, 'cpu', torch.float32); "
            "harness.print_result(r)")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "consistencytta_torch" in out.stderr
