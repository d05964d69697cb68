"""The port's spans (``mixstage_tpu_torch/train/profiling.py``): taken only
under a ``torch.profiler`` trace, as ``mixstage.`` ranges on the profiler's
clock and as records in memory, nested alike.

* With no profiler on, a G step, a D step, a serving call and 64 requests
  through the micro-batcher make no record and open no range (neither the
  spans' ``RecordFunction`` nor a ``record_function``).
* Under ``torch.profiler``: each G and D step is one step span holding
  exactly one ``train.forward``, ``train.backward`` and ``train.update``;
  a serving call is a ``serve.call`` (``graph=0``: op by op on the CPU)
  holding one ``serve.features`` (the exported program's body takes
  none); the micro-batcher records one ``batcher.queue_wait`` per
  request and one ``batcher.gather`` and one ``batcher.service`` per
  batch, all with the batch's id, the service holding the serving call.
  The profiler's ``mixstage.`` events nest as the records say, on the
  records' threads (read for a D step, a serving call and the batcher).
* ``reset()`` and ``trace()`` clear the registry.

A small flagship configuration (in_channels 64, 2 clusters, 2 speakers,
B=2, T=64, 32 mel bins) on the CPU.
"""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.models.layers import reset_parameters_
from mixstage_tpu_torch.serve import build_serving_fn
from mixstage_tpu_torch.serving import DynamicBatcher
from mixstage_tpu_torch.train import StepConfig, StepFactory
from mixstage_tpu_torch.train import profiling

B, T, MEL, FEATS, S = 2, 64, 32, 96, 2
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=S,
           model_kwargs=(("in_channels", 64),))
STEP = {"g": "train.g_step", "d": "train.d_step"}
PHASES = ("train.forward", "train.backward", "train.update")


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def trainer():
    torch.set_num_threads(2)
    factory = StepFactory(StepConfig(**CFG), device="cpu")
    state = factory.init(seed=0)
    rng = np.random.default_rng(0)
    batch = {"x": (rng.normal(size=(B, T, MEL)).astype(np.float32),),
             "y": rng.normal(size=(B, T, FEATS)).astype(np.float32),
             "labels": rng.integers(0, 2, size=(B, T)),
             "style": np.repeat(rng.integers(0, S, size=(B, 1)), T, 1)}
    return factory.make_steps(), state, batch


@pytest.fixture(scope="module")
def serving():
    torch.set_num_threads(2)
    model = JointLateClusterSoftStyle4_G(num_clusters=2, num_speakers=S,
                                         in_channels=64)
    reset_parameters_(model, torch.Generator().manual_seed(0),
                      random_bn_stats=True)
    return build_serving_fn(model, device="cpu")


def _clips(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, T, MEL)).astype(np.float32),
            np.eye(S, dtype=np.float32)[rng.integers(0, S, size=n)])


def _through_batcher(serve_fn, n, batch_size, max_wait_ms=2.0):
    """Submit ``n`` clips at once; every pose back; the worker joined."""
    batcher = DynamicBatcher(serve_fn, batch_size=batch_size,
                             max_wait_ms=max_wait_ms,
                             max_queue=max(n, 4 * batch_size))
    try:
        audio, style = _clips(n)
        futures = [batcher.submit(a, s) for a, s in zip(audio, style)]
        for f in futures:
            f.result(timeout=60)
    finally:
        batcher.close()
    assert not batcher._worker.is_alive()
    return batcher


def _work(kind, trainer, serving):
    if kind in STEP:
        steps, state, batch = trainer
        steps[kind](state, batch, 0)
    elif kind == "serve":
        serving(*_clips(B))
    else:
        _through_batcher(lambda a, s: a, 64, 8)


@pytest.mark.parametrize("kind", ["g", "d", "serve", "batcher"])
def test_no_profiler_no_record_and_no_range(kind, trainer, serving,
                                            monkeypatch):
    entered = []
    real = profiling._range

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    class CountingRange:
        def __init__(self, name):
            entered.append(name)
            self.inner = real(name)

        def __enter__(self):
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    monkeypatch.setattr(profiling, "_range", CountingRange)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    assert not profiling.enabled()
    _work(kind, trainer, serving)
    assert profiling.records() == []
    assert entered == []


def _events(prof):
    """The profiler's ``mixstage.`` ranges: (name, start µs, end µs,
    thread), by start."""
    return sorted(((e.name[len(profiling.PREFIX):], e.time_range.start,
                    e.time_range.end, e.thread) for e in prof.events()
                   if e.name.startswith(profiling.PREFIX)),
                  key=lambda e: e[1])


def _assert_events_match(prof, recs):
    """The events are the records (ranges only), nested as the records
    say, each record's thread one event thread."""
    spans = sorted((r for r in recs if r.name != "batcher.queue_wait"),
                   key=lambda r: r.start)
    events = _events(prof)
    assert [e[0] for e in events] == [r.name for r in spans]
    event = {r.id: e for r, e in zip(spans, events)}
    threads = {(r.thread, e[3]) for r, e in zip(spans, events)}
    assert len(threads) == len({t for t, _ in threads}) == \
        len({t for _, t in threads})
    for r in spans:
        if r.parent is not None and r.parent in event:
            outer, inner = event[r.parent], event[r.id]
            assert outer[3] == inner[3]
            assert outer[1] <= inner[1] and inner[2] <= outer[2]


def _children(recs, parent_id):
    return sorted(r.name for r in recs if r.parent == parent_id)


@pytest.mark.parametrize("kind", ["g", "d"])
def test_train_step_spans(kind, trainer):
    steps, state, batch = trainer
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        steps[kind](state, batch, 0)
    recs = profiling.records()
    tops = [r for r in recs if r.parent is None]
    assert [r.name for r in tops] == [STEP[kind]]
    assert _children(recs, tops[0].id) == sorted(PHASES)
    assert len(recs) == 4
    phase = {r.name: r for r in recs if r.name in PHASES}
    assert phase["train.forward"].end <= phase["train.backward"].start
    assert phase["train.backward"].end <= phase["train.update"].start
    for r in recs:
        assert tops[0].start <= r.start <= r.end <= tops[0].end
    if kind == "d":     # a G step's 20,000 events take 1.5 s to read
        _assert_events_match(prof, recs)


def test_serving_call_spans_and_program_none(serving):
    audio, style = _clips(B)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pose = serving(audio, style)
    recs = profiling.records()
    call, = [r for r in recs if r.name == "serve.call"]
    assert call.parent is None and call.ids == {"graph": 0}
    assert serving.graphs is None           # the CPU runs op by op
    assert _children(recs, call.id) == ["serve.features"]
    assert len(recs) == 2
    _assert_events_match(prof, recs)

    # the exported program's body runs the same call with no span
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.inference_mode():
        again = serving.program(*serving.bound_args, torch.as_tensor(audio),
                                torch.as_tensor(style))
    assert profiling.records() == [] and _events(prof) == []
    torch.testing.assert_close(again, pose, rtol=0, atol=0)


def test_batcher_records(serving):
    n, size = 19, 8
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        _through_batcher(serving, n, size)
    recs = profiling.records()
    by = {name: [r for r in recs if r.name == name] for name in
          ("batcher.queue_wait", "batcher.gather", "batcher.service",
           "serve.call", "serve.features")}
    gathers = {r.ids["batch"]: r for r in by["batcher.gather"]}
    services = {r.ids["batch"]: r for r in by["batcher.service"]}
    assert len(gathers) == len(by["batcher.gather"]) == len(services) == \
        len(by["batcher.service"]) == len(by["serve.call"])
    assert set(gathers) == set(services)
    assert sum(g.ids["size"] for g in gathers.values()) == n
    waits = [r.ids["batch"] for r in by["batcher.queue_wait"]]
    assert len(waits) == n
    for b, g in gathers.items():
        assert waits.count(b) == g.ids["size"] <= size
        assert g.ids["full"] == (g.ids["size"] == size)
        assert g.end <= services[b].start
        assert _children(recs, services[b].id) == ["serve.call"]
    for w in by["batcher.queue_wait"]:
        assert w.start <= w.end <= gathers[w.ids["batch"]].end
    worker = {r.thread for r in recs}
    assert len(worker) == 1 and threading.get_ident() not in worker
    _assert_events_match(prof, recs)


def test_reset_and_trace_clear_the_registry(trainer, tmp_path):
    steps, state, batch = trainer
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", batch=3) as s:
            profiling.record("inner", 1.0, 2.0, batch=3)
            s.note(size=2)
    outer, = [r for r in profiling.records() if r.name == "outer"]
    inner, = [r for r in profiling.records() if r.name == "inner"]
    assert outer.ids == {"batch": 3, "size": 2} and inner.parent == outer.id
    profiling.reset()
    assert profiling.records() == []

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    assert profiling.records()
    with profiling.trace(str(tmp_path)):
        assert profiling.records() == []
        steps["d"](state, batch, 0)
    assert [r.name for r in profiling.records()
            if r.parent is None] == ["train.d_step"]
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
