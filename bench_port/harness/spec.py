"""The manifest (``BENCHMARK.json``) and the files it names.

Every cell is found by name: ``workloads[i]`` names a configuration (its
``file``), a traffic mix (``bench_port/traffic/<traffic>.json``) and,
through the metrics that list it, the per-layer readers
(``bench_port/metrics/<metric>.py``, each a ``read(reading)`` function).
The limits of its correctness check are ``bench_port/limits/<cell>.json``.
Adding a cell, a configuration, a mix or a metric adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent


class Cell:
    """One workload of the manifest with everything it names resolved."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(cells)}")
        self.manifest, self.name, self.root = manifest, name, root
        self.workload = cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _load_json(root / self.config_entry["file"])
        self.traffic = _load_json(
            root / "bench_port" / "traffic" / f"{self.workload['traffic']}"
            ".json")
        self.limits = _load_json(
            root / "bench_port" / "limits" / f"{name}.json")

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports (``setup_s`` always)."""
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, or
        that list no cells and move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_manifest(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def metric_reader(name: str, root: Path = ROOT
                  ) -> Callable[[dict], Optional[float]]:
    """``read`` of ``bench_port/metrics/<name>.py``."""
    path = root / "bench_port" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_per_layer(cell: Cell, reading: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds, as
    {name: {"value", "unit"}}; a reader that finds nothing is left out."""
    out = {}
    for m in cell.per_layer():
        value = metric_reader(m["name"], cell.root)(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
