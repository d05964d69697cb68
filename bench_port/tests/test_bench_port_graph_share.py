"""The reader of ``train_graph_share``: on hand-made span records, the %
of the train steps that carry the id ``graph`` and ran as a replay; None
where no step carries it (no spans, or a program whose step spans have
no such id) and outside the train loop; in a traced tiny train cell on the
CPU, where every step runs op by op, 0."""

from __future__ import annotations

import pytest

from bench_port.harness.runner import execute
from bench_port.harness.spec import load_manifest, metric_reader
from conftest import SEED

READ = metric_reader("train_graph_share")


def _span(name, **ids):
    from mixstage_tpu_torch.train.profiling import Span

    return Span(name, 0, None, 0, 0.0, 1.0, ids)


G, D = "train.g_step", "train.d_step"


@pytest.mark.parametrize("spans, want", [
    ([_span(G, graph=1), _span(D, graph=1)], 100.0),
    ([_span(G, graph=0), _span(D, graph=1), _span(G, graph=1),
      _span(D, graph=1)], 75.0),
    ([_span(G, graph=0), _span(D, graph=0)], 0.0),
    # phases and captures are not steps
    ([_span(G, graph=1), _span("train.capture", kind="g"),
      _span("train.forward"), _span(D, graph=0)], 50.0),
    ([], None),
    ([_span(G), _span(D)], None),       # step spans without the id
], ids=["all_replay", "mixed", "all_eager", "phases", "none", "no_id"])
def test_reader_on_hand_made_records(monkeypatch, spans, want):
    from mixstage_tpu_torch.train import profiling

    monkeypatch.setattr(profiling, "records", lambda: list(spans))
    reading = {"busy_s": 0.0, "window_s": 1.0, "counters": {}}
    assert READ({**reading, "loop": "train"}) == want
    for loop in ("serve", "open_loop"):
        assert READ({**reading, "loop": loop}) is None


def test_entry_lists_the_train_cells():
    m, = [m for m in load_manifest()["per_layer"]
          if m["name"] == "train_graph_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) \
        == ("%", "higher", "program_counter", "train steps",
            "train_frames_per_s")
    assert m["workloads"] == [w["name"] for w in load_manifest()["workloads"]
                              if w["name"].split(".")[1] == "train"]


def test_op_by_op_steps_read_zero_on_the_cpu(tiny_cell, cpu):
    from mixstage_tpu_torch.train import profiling

    profiling.reset()
    try:
        out = execute(tiny_cell("s2g.train.f32.bs32"), SEED, 0.3, True, cpu,
                      0.0)
    finally:
        profiling.reset()
    assert out["correct"] is True
    assert out["metrics"]["train_graph_share"]["value"] == 0.0
