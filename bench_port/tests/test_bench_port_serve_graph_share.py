"""The readers of ``serve_graph_share`` (the serving cell) and
``serve_graph_share.open`` (the open loop): on hand-made span records, the
% of the serving calls that carry the id ``graph`` and ran as a replay;
None where no call carries it (no spans, or a program whose call spans
have no such id) and outside the reader's loop; in the traced tiny cells
on the CPU, where every call runs op by op, 0."""

from __future__ import annotations

import pytest

from bench_port.harness.runner import execute
from bench_port.harness.spec import load_manifest, metric_reader
from conftest import SEED

# metric: (its loop, its cell, the end-to-end metric it moves)
METRICS = {
    "serve_graph_share": ("serve", "mixstage8.serve.f32.bs32",
                          "serve_frames_per_s"),
    "serve_graph_share.open": ("open_loop", "mixstage8.serve.open.f32",
                               "clip_p95_ms"),
}


def _span(name, **ids):
    from mixstage_tpu_torch.train.profiling import Span

    return Span(name, 0, None, 0, 0.0, 1.0, ids)


C = "serve.call"


@pytest.mark.parametrize("spans, want", [
    ([_span(C, graph=1), _span(C, graph=1)], 100.0),
    ([_span(C, graph=0), _span(C, graph=1), _span(C, graph=1),
      _span(C, graph=1)], 75.0),
    ([_span(C, graph=0), _span(C, graph=0)], 0.0),
    # backbones, captures and the batcher's spans are not calls
    ([_span(C, graph=1), _span("serve.capture"), _span("serve.features"),
      _span("batcher.service", batch=1), _span(C, graph=0)], 50.0),
    ([], None),
    ([_span(C), _span(C)], None),       # call spans without the id
], ids=["all_replay", "mixed", "all_eager", "others", "none", "no_id"])
@pytest.mark.parametrize("metric", list(METRICS))
def test_reader_on_hand_made_records(monkeypatch, spans, want, metric):
    from mixstage_tpu_torch.train import profiling

    monkeypatch.setattr(profiling, "records", lambda: list(spans))
    reading = {"busy_s": 0.0, "window_s": 1.0, "counters": {}}
    read = metric_reader(metric)
    for loop in ("serve", "open_loop", "train"):
        got = read({**reading, "loop": loop})
        assert got == (want if loop == METRICS[metric][0] else None), loop


@pytest.mark.parametrize("metric", list(METRICS))
def test_entry_lists_its_serving_cell(metric):
    m, = [m for m in load_manifest()["per_layer"] if m["name"] == metric]
    _, cell, moves = METRICS[metric]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("%", "higher", "program_counter",
                                "serving fn", moves, [cell])


@pytest.mark.parametrize("metric", list(METRICS))
def test_op_by_op_calls_read_zero_on_the_cpu(tiny_cell, cpu, metric):
    from mixstage_tpu_torch.train import profiling

    profiling.reset()
    try:
        out = execute(tiny_cell(METRICS[metric][1]), SEED, 0.3, True, cpu,
                      0.0)
    finally:
        profiling.reset()
    assert out["correct"] is True
    assert out["metrics"][metric]["value"] == 0.0
