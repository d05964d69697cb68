"""The manifest against the contract, and every entry found by name."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_port.harness import spec
from bench_port.harness.runner import execute
from bench_port.harness.spec import ROOT, Cell, load_manifest, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_manifest_keys_and_names():
    m = load_manifest()
    assert set(m) == KEYS
    assert 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]] + \
        [w["name"] for w in m["workloads"]] + \
        [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert {w["chips"] for w in m["workloads"]} == {1}


@pytest.mark.parametrize("name", [w["name"] for w in
                                  load_manifest()["workloads"]])
def test_cell_resolves_by_name(name):
    cell = Cell(load_manifest(), name)
    assert (ROOT / "bench_port" / "loops" /
            f"{cell.traffic['loop']}.py").exists()
    assert cell.config_entry["file"].startswith("bench_port/")
    assert set(cell.limits) and all("limit" in v
                                    for v in cell.limits.values())
    e2e = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell.per_layer()
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(metric_reader(m["name"]))


def test_every_config_is_used_and_unreduced():
    m = load_manifest()
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []


def test_new_cell_from_new_files_alone(tmp_path, tiny_cell, cpu):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell as new files and manifest entries; no harness file changes."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_port", root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = load_manifest()
    cfg = json.loads((ROOT / "bench_port/configs/mixstage8.json").read_text())
    cfg.update(num_clusters=4, name="mixstage4")
    (root / "bench_port/configs/mixstage4.json").write_text(json.dumps(cfg))
    traffic = json.loads(
        (ROOT / "bench_port/traffic/serve.f32.bs32.json").read_text())
    (root / "bench_port/traffic/serve.f32.bs16.json").write_text(
        json.dumps({**traffic, "batch": 16}))
    (root / "bench_port/limits/mixstage4.serve.f32.bs16.json").write_text(
        json.dumps({"pose_err": {"limit": 2e-5}}))
    (root / "bench_port/metrics/calls_traced.py").write_text(
        "def read(r):\n    return r.get('counters', {}).get('calls')\n")
    m["configs"].append({"name": "mixstage4", "source": "https://x",
                         "file": "bench_port/configs/mixstage4.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "mixstage4.serve.f32.bs16",
                           "config": "mixstage4", "traffic":
                           "serve.f32.bs16", "chips": 1, "why": "test"})
    m["end_to_end"][1]["workloads"].append("mixstage4.serve.f32.bs16")
    m["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "serving fn",
                           "moves": "serve_frames_per_s",
                           "workloads": ["mixstage4.serve.f32.bs16"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    full = Cell(spec.load_manifest(root), "mixstage4.serve.f32.bs16", root)
    assert full.config["num_clusters"] == 4
    assert full.traffic["batch"] == 16
    assert [x["name"] for x in full.per_layer()] == ["calls_traced"]
    cell = tiny_cell("mixstage4.serve.f32.bs16", root)
    out = execute(cell, 5, 0.2, True, cpu, 0.0)
    assert out["correct"] and out["metrics"]["calls_traced"]["value"] == 2
