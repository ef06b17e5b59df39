"""Import rules: nothing under benchmark/ imports JAX or the JAX package,
and the plain reference imports nothing of the port either. Module names
are compared by their top-level name (the part before the first dot)."""

import ast
import os
import subprocess
import sys

from benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
JAX = {"jax", "jaxlib", "flax", "optax", "consistencytta_tpu"}


def roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


def files(sub=""):
    out = []
    for root, _, names in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def test_no_file_of_the_benchmark_imports_jax():
    found = files()
    assert len(found) > 20
    bad = {os.path.relpath(p, HERE): sorted(set(roots(p)) & JAX) for p in found}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_port():
    found = files("reference")
    assert len(found) >= 7
    for p in found:
        names = set(roots(p))
        assert not names & (JAX | {"consistencytta_torch"}), p
        assert names <= {"benchmark", "torch", "numpy", "math", "dataclasses", "typing",
                         "__future__"}, (p, names)


def test_forbidden_loaded_compares_whole_top_level_names():
    code = ("import sys, types; sys.modules['consistencytta_tpu_x'] = types.ModuleType('x'); "
            "from benchmark import harness; print(harness.forbidden_loaded()); "
            "sys.modules['jax.numpy'] = types.ModuleType('y'); print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.split("\n")[:2] == ["[]", "['jax']"], out.stderr
    assert "consistencytta_tpu" in harness.FORBIDDEN_MODULES
