"""Everything is found by name, and a cell, a mix or a metric added as a
file (with its entry in BENCHMARK.json) is picked up with no code change.
BENCHMARK.json keeps to the contract's shape."""

import json
import os
import re
import shutil

from benchmark import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_config_driver_and_metric_is_found():
    bench = manifest.load_benchmark()
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], bench)
        assert cell.chips == 1 and cell.config["name"] == w["config"]
        drv = manifest.driver(cell.driver)
        assert all(callable(getattr(drv, f)) for f in ("setup", "window", "free", "check"))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.reader(m["name"]))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_benchmark_json_shape():
    bench = manifest.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert [w["name"] for w in bench["workloads"]][:3] == ["gen-b32", "teacher-b8", "gen-b1"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_cell_added_as_files_is_found(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "gen-b4", "config": "consistencytta-light",
                               "traffic": "bulk-b4", "chips": 1, "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("gen-b4")
    bench["per_layer"].append({"name": "clips_per_call.b4", "unit": "clips", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "clips_per_s",
                               "workloads": ["gen-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((tmp_path / "benchmark/traffic/bulk-b32.json").read_text())
    (tmp_path / "benchmark/traffic/bulk-b4.json").write_text(json.dumps(dict(mix, batch=4)))
    spec = json.loads((tmp_path / "benchmark/workloads/gen-b32.json").read_text())
    spec["traffic"] = "bulk-b4"
    (tmp_path / "benchmark/workloads/gen-b4.json").write_text(json.dumps(spec))
    (tmp_path / "benchmark/metrics/clips_per_call.b4.py").write_text(
        "def read(run):\n    return 4.0\n")
    cell = manifest.cell("gen-b4", root=str(tmp_path))
    assert cell.traffic["batch"] == 4 and cell.driver == "generate"
    assert [m["name"] for m in cell.end_to_end] == ["clips_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["clips_per_call.b4"]
    assert manifest.reader("clips_per_call.b4", root=str(tmp_path))(None) == 4.0
