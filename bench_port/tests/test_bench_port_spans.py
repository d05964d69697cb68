"""The readers of the program's own spans (``metrics/*_host_ms.py``,
``batch_*_ms.py``): in a traced run of each tiny cell every such metric
that lists the cell is read, positive and finite, and the others' readers
find nothing there; with no spans recorded no reader finds anything."""

from __future__ import annotations

import math

import pytest

from bench_port.harness.runner import execute
from bench_port.harness.spec import load_manifest, metric_reader
from conftest import SEED

SPAN_METRICS = {
    "train_forward_host_ms", "train_backward_host_ms",
    "train_update_host_ms", "serve_backbone_host_ms",
    "batch_queue_wait_ms", "batch_fill_ms", "batch_service_ms",
    "batch_call_host_ms"}
LOOPS = ("train", "serve", "open_loop")


@pytest.fixture(autouse=True)
def empty_registry():
    from mixstage_tpu_torch.train import profiling

    profiling.reset()
    yield
    profiling.reset()


def _listed(cell_name):
    return {m["name"] for m in load_manifest()["per_layer"]
            if m["name"] in SPAN_METRICS and cell_name in m["workloads"]}


def test_every_span_metric_has_an_entry():
    entries = {m["name"]: m for m in load_manifest()["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"]) == \
            ("ms", "lower", "program_counter")
        assert m["workloads"]


@pytest.mark.parametrize("name", [w["name"] for w in
                                  load_manifest()["workloads"]])
def test_span_metrics_read_in_their_cells(tiny_cell, cpu, name):
    cell = tiny_cell(name)
    out = execute(cell, SEED, 0.3, True, cpu, 0.0)
    assert out["correct"] is True
    got = {k: v["value"] for k, v in out["metrics"].items()
           if k in SPAN_METRICS}
    assert set(got) == _listed(name)
    assert got, "every cell lists a span metric"
    for k, v in got.items():
        assert math.isfinite(v) and v > 0, (k, v)
    # the other loops' readers find nothing in this loop's records
    reading = {"busy_s": 0.0, "window_s": 1.0, "counters": {},
               "loop": cell.traffic["loop"]}
    for metric in SPAN_METRICS - set(got):
        assert metric_reader(metric)(reading) is None, metric


def test_readers_find_nothing_without_spans():
    from mixstage_tpu_torch.train import profiling

    assert profiling.records() == []
    reading = {"busy_s": 0.0, "window_s": 1.0, "counters": {}}
    for metric in SPAN_METRICS:
        for loop in LOOPS:
            assert metric_reader(metric)({**reading, "loop": loop}) is None
