"""The serving function's CUDA graphs (``mixstage_tpu_torch/serve.py``:
``ServingGraphs``, ``ServingGraph``).

On the CPU:

* the graphs' bookkeeping, on a stand-in capture: the first call at a key
  runs op by op, the second captures and replays, later ones replay; the
  key tells the batch, the frames, the audio's dtype and the style's form
  apart, and every capture shares the first's memory pool; at most
  ``SERVE_GRAPHS`` keys are kept, the least recently used dropped (its
  next call runs op by op again), a bound that holds every key the pose
  server sends; a call of more than ``SERVE_GRAPH_FRAMES`` audio frames
  runs op by op and keeps no key; ``serve.call`` spans carry
  ``graph`` (0 op by op, 1 a replay) and a capture is a ``serve.capture``
  inside its call;
* the CPU and the ``devices`` layouts build no graphs (``fn.graphs`` is
  None).

On the card (``cuda``; they skip without one, and import neither JAX nor
the JAX package), at the flagship widths (8 clusters and speakers, 256
channels, 128 mels, 96 pose features), under PyTorch's deterministic
algorithms:

* f32, bf16 and the int8 tier, on the kernel and the plain route: four
  calls at bs32 x 64 (op by op, captured, replayed twice), each pose bit
  for bit the op-by-op body's on its own inputs, computed after all four,
  and K1's and K4's launch counters reading the op-by-op count per call;
* a pose kept from one call is unchanged by the next;
* new shapes (bs17, a 128-frame bucket, style rows) get graphs of their
  own, each right from its first call, beside the first key's;
* the least-recently-used bound with real graphs, and six keys in a
  shuffled order under a bound of four, every pose bit for bit;
* the micro-batcher's worker captures while the main thread runs CUDA
  work (``thread_local`` capture mode), and while a waveform request and
  a streaming session are served, and while another thread draws from a
  generator of its own;
* each injected fault fails the check written for it: a stale static
  input, a returned alias of the static output, and the weights frozen at
  capture, before a ``load_state_dict``.
"""

import copy
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mixstage_tpu_torch import serve
from mixstage_tpu_torch.serve import ServingGraphs, build_serving_fn
from mixstage_tpu_torch.train import profiling


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


# ---------------------------------------------------------------------------
# on the CPU: the bookkeeping, on a stand-in capture
# ---------------------------------------------------------------------------

class StandIn:
    """A capture that keeps the body and calls it on each replay."""
    made = []

    def __init__(self, body, audio, style, device, pool):
        self.body = body
        self.pool = ("pool", len(StandIn.made)) if pool is None else pool
        StandIn.made.append((tuple(audio.shape), tuple(style.shape)))

    def __call__(self, audio, style):
        return self.body(audio, style)


@pytest.fixture
def stand_in(monkeypatch):
    StandIn.made = []
    monkeypatch.setattr(serve, "ServingGraph", StandIn)
    routes = []

    def body(audio, style, traced=False):
        routes.append("op" if traced else "graph")
        return audio.float().sum(-1) + style.float().reshape(
            len(style), -1).sum(-1, keepdim=True)

    return ServingGraphs(body, torch.device("cpu"), torch.float32,
                         False), routes


def _clip(B, T, rows=False, dtype=np.float32):
    style = np.eye(3, dtype=np.float32)[np.arange(B) % 3] if rows \
        else np.arange(B) % 3
    return np.ones((B, T, 4), dtype), style


def test_first_call_op_by_op_second_captures_later_replay(stand_in):
    graphs, routes = stand_in
    for _ in range(3):
        pose = graphs(*_clip(2, 8))
    assert routes == ["op", "graph", "graph"]
    assert StandIn.made == [((2, 8, 4), (2,))]
    torch.testing.assert_close(pose, torch.full((2, 8), 4.0) +
                               torch.tensor([[0.0], [1.0]]))


@pytest.mark.parametrize("other", [
    dict(B=3, T=8), dict(B=2, T=16), dict(B=2, T=8, rows=True),
    dict(B=2, T=8, dtype=np.float64)],
    ids=["batch", "frames", "style_rows", "audio_dtype"])
def test_each_part_of_the_key_gets_its_own_graph(stand_in, other):
    graphs, routes = stand_in
    for clip in (_clip(2, 8), _clip(**other)):
        graphs(*clip)
        graphs(*clip)
    assert routes == ["op", "graph"] * 2
    assert len(StandIn.made) == len(graphs.graphs) == 2
    # every capture shares the first one's memory pool
    assert [g.pool for g in graphs.graphs.values()] == [("pool", 0)] * 2


def test_least_recently_used_key_dropped_beyond_the_bound(stand_in,
                                                          monkeypatch):
    monkeypatch.setattr(serve, "SERVE_GRAPHS", 2)
    graphs, routes = stand_in
    a, b, c = _clip(1, 8), _clip(2, 8), _clip(3, 8)
    for clip in (a, a, b, b, a, c, c, b, a):
        graphs(*clip)
    # a is used after b, so c's entry drops b; b's return drops a, and a's
    # drops c: both run op by op again
    assert routes == ["op", "graph", "op", "graph", "graph", "op", "graph",
                      "op", "op"]
    assert [k[0] for k in graphs.graphs] == [(2, 8, 4), (1, 8, 4)]
    assert list(graphs.graphs.values()) == [None, None]
    assert len(StandIn.made) == 3


def test_calls_above_the_frame_limit_run_op_by_op_and_keep_no_key(
        stand_in, monkeypatch):
    monkeypatch.setattr(serve, "SERVE_GRAPH_FRAMES", 16)
    graphs, routes = stand_in
    small, large = _clip(2, 8), _clip(2, 9)       # 16 and 18 audio frames
    for clip in (large, small, large, small, large):
        graphs(*clip)
    assert routes == ["op", "op", "op", "graph", "op"]
    assert [k[0] for k in graphs.graphs] == [(2, 8, 4)]
    assert StandIn.made == [((2, 8, 4), (2,))]


def test_call_spans_carry_graph_and_a_capture_inside_its_call(stand_in):
    graphs, _ = stand_in
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            graphs(*_clip(2, 8))
    recs = profiling.records()
    calls = [r for r in recs if r.name == "serve.call"]
    assert [c.ids for c in calls] == [{"graph": 0}, {"graph": 1},
                                      {"graph": 1}]
    capture, = [r for r in recs if r.name == "serve.capture"]
    assert capture.parent == calls[1].id


@pytest.mark.parametrize("frames", [1, 63, 64, 65, 1000, 4095, 4096])
def test_the_bound_holds_every_key_of_the_pose_server(frames):
    """A request of any length the pose server takes pads to one of its
    buckets, and ``SERVE_GRAPHS`` holds every bucket with the style as ids
    and as rows: steady traffic evicts nothing."""
    import inspect

    from mixstage_tpu_torch.ops.bucketing import next_pow2, pow2_buckets
    from mixstage_tpu_torch.serving import PoseService

    defaults = inspect.signature(PoseService).parameters
    floor, cap = defaults["frames"].default, defaults["max_frames"].default
    buckets = pow2_buckets(floor, cap)
    assert buckets == (64, 128, 256, 512, 1024, 2048, 4096)
    assert next_pow2(frames, floor) in buckets
    assert serve.SERVE_GRAPHS == 2 * len(buckets)


def _tiny_model():
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_

    model = JointLateClusterSoftStyle4_G(num_clusters=2, num_speakers=2,
                                         in_channels=32)
    return reset_parameters_(model, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("layout", [None, "batch", "expert"])
def test_cpu_and_layouts_build_no_graphs(layout):
    kw = {} if layout is None else dict(devices=["cpu"] * 2,
                                        partition=layout)
    fn = build_serving_fn(_tiny_model(), device="cpu", **kw)
    assert fn.graphs is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

B, T, MEL, S = 32, 64, 128, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture the card's "
                    "kernels, and the serving call runs op by op elsewhere "
                    "(the CPU tests above)")
    from mixstage_tpu_torch import resolve_device
    return resolve_device("cuda")


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms, so that two op-by-op calls agree
    bit for bit and a replay is held to them bit for bit."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


def _model(dtype=torch.float32, seed=1):
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_

    model = JointLateClusterSoftStyle4_G(
        num_clusters=8, num_speakers=S, in_channels=256, style_dim=10,
        out_feats=96, dtype=dtype)
    return reset_parameters_(model, torch.Generator().manual_seed(seed),
                             random_bn_stats=True)


def _batches(n, b=B, t=T, rows=False, seed=2):
    """``n`` distinct host batches: (audio (b, t, mel) float32, style (b,)
    int64 ids or (b, S) float32 rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, S, b)
        out.append((rng.standard_normal((b, t, MEL), dtype=np.float32),
                    np.eye(S, dtype=np.float32)[ids] if rows else ids))
    return out


def _fn(model, int8=False, use_kernel=True):
    calib = _batches(1, seed=9)[0] if int8 else None
    return build_serving_fn(model, use_kernel=use_kernel,
                            quantize_int8=int8, calib=calib)


@torch.inference_mode()
def _op_by_op(fn, audio, style):
    """The op-by-op pose at these inputs: the body a graph captures, run
    outside one."""
    return fn.graphs.body(torch.as_tensor(audio), torch.as_tensor(style))


def _launches():
    from mixstage_tpu_torch.ops.cuda import fused_conv, quant
    k1, k4 = fused_conv.fused_mixstage_decoder, \
        quant.fused_mixstage_decoder_int8
    return (k1.launches, k1.launches_bf16, k4.launches, k4.launches_bf16)


def _check_replays(fn, batches):
    """One call a batch at one key (op by op, captured, then replays), each
    pose bit for bit the op-by-op body's on its own inputs, computed after
    all the calls: a stale input, or a pose the next replay rewrites,
    fails."""
    poses = [fn(a, s) for a, s in batches]
    key = fn.graphs.key(*map(torch.as_tensor, batches[0]))
    assert isinstance(fn.graphs.graphs[key], serve.ServingGraph)
    for i, ((a, s), pose) in enumerate(zip(batches, poses)):
        assert pose.dtype == torch.float32 and pose.is_cuda
        assert torch.equal(pose, _op_by_op(fn, a, s)), i


def _check_kept(fn, batches):
    """A pose kept from a replay is unchanged by the calls after it."""
    for a, s in batches[:2]:                        # op by op, captured
        fn(a, s)
    kept = fn(*batches[2])
    held = kept.clone()
    for a, s in batches[3:]:
        fn(a, s)
    assert torch.equal(kept, held)


def _check_reload(fn, model, batches):
    """A replay after an in-place ``load_state_dict`` into the model
    computes what the op-by-op body then does, and not what it did."""
    for a, s in batches[:2]:
        fn(a, s)
    before = fn(*batches[2])
    model.load_state_dict(_model(seed=5).state_dict())
    after = fn(*batches[2])
    assert not torch.equal(after, before)
    assert torch.equal(after, _op_by_op(fn, *batches[2]))


# (dtype, int8 tier, kernel route): K1's and K4's launches a call (all, bf16)
CASES = {
    "f32-kernel": (torch.float32, False, True, (2, 0, 0, 0)),
    "f32-plain": (torch.float32, False, False, (0, 0, 0, 0)),
    "bf16-kernel": (torch.bfloat16, False, True, (2, 2, 0, 0)),
    "bf16-plain": (torch.bfloat16, False, False, (0, 0, 0, 0)),
    "int8-kernel": (torch.float32, True, True, (1, 0, 1, 0)),
    "int8-plain": (torch.float32, True, False, (0, 0, 0, 0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_replays_equal_op_by_op_calls_bit_for_bit(cuda, deterministic,
                                                  case):
    dtype, int8, use_kernel, per_call = CASES[case]
    fn = _fn(_model(dtype), int8, use_kernel)
    batches = _batches(4)
    before = _launches()
    _check_replays(fn, batches)
    # the four calls and their four op-by-op references
    assert tuple(n - b for n, b in zip(_launches(), before)) == \
        tuple(8 * c for c in per_call)


@pytest.mark.cuda
def test_a_kept_pose_is_unchanged_by_the_next_call(cuda):
    _check_kept(_fn(_model()), _batches(4))


@pytest.mark.cuda
def test_new_shapes_get_their_own_graphs_right_from_their_first_call(
        cuda, deterministic):
    fn = _fn(_model())
    first = _batches(3)
    _check_replays(fn, first)
    for other in (_batches(3, b=17, seed=3), _batches(3, t=128, seed=4),
                  _batches(3, rows=True, seed=5)):
        _check_replays(fn, other)
    assert len(fn.graphs.graphs) == 4
    _check_replays(fn, _batches(2, seed=6))         # the first key replays


@pytest.mark.cuda
def test_least_recently_used_graph_dropped_beyond_the_bound(
        cuda, deterministic, monkeypatch):
    monkeypatch.setattr(serve, "SERVE_GRAPHS", 2)
    fn = _fn(_model())
    keys = [_batches(2, b=b, seed=b) for b in (8, 16, 24)]
    for batches in keys:
        _check_replays(fn, batches)
    assert [k[0][0] for k in fn.graphs.graphs] == [16, 24]
    with profile(activities=[ProfilerActivity.CPU]):
        _check_replays(fn, keys[0])         # op by op again, then captured
    calls = [r.ids["graph"] for r in profiling.records()
             if r.name == "serve.call"]
    assert calls == [0, 1]
    assert [k[0][0] for k in fn.graphs.graphs] == [24, 8]


@pytest.mark.cuda
def test_batcher_worker_captures_while_the_main_thread_runs_cuda_work(
        cuda, deterministic):
    """The worker's capture waits, inside the capture, for the main thread
    to allocate, compute and synchronise on the card; in the global
    capture mode that work would fail or break the capture."""
    from mixstage_tpu_torch.serving import DynamicBatcher

    fn = _fn(_model())
    body, capturing, main_done, threads = fn.graphs.body, \
        threading.Event(), threading.Event(), []

    def spied(audio, style, traced=False):
        if torch.cuda.is_current_stream_capturing():
            threads.append(threading.get_ident())
            capturing.set()
            assert main_done.wait(timeout=60)
        return body(audio, style, traced)

    fn.graphs.body = spied
    size = 8
    batcher = DynamicBatcher(fn, batch_size=size, max_wait_ms=1.0,
                             input_shape=(None, MEL), max_queue=256)
    clips = _batches(1, b=4 * size, rows=True, seed=7)[0]
    try:
        futures = []
        for i in range(4 * size):
            futures.append(batcher.submit(clips[0][i], clips[1][i]))
            if i == 2 * size - 1:       # the second batch is captured
                assert capturing.wait(timeout=60)
                x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)
                assert (x * 2).sum().item() == (1 << 20) * ((1 << 20) - 1)
                main_done.set()
        poses = [f.result(timeout=120) for f in futures]
    finally:
        main_done.set()
        batcher.close()
    assert len(threads) == 1 and threads[0] != threading.get_ident()
    for i, pose in enumerate(poses):
        audio = np.repeat(clips[0][i:i + 1], size, axis=0)
        style = np.repeat(clips[1][i:i + 1], size, axis=0)
        want = _op_by_op(fn, audio, style)[0].cpu().numpy()
        err = np.linalg.norm(pose - want) / np.linalg.norm(want)
        assert err <= 1e-6, (i, err)


@pytest.mark.cuda
def test_keys_in_any_order_with_evictions_stay_bit_for_bit(
        cuda, deterministic, monkeypatch):
    """Six keys (three frame buckets, ids and rows) called in a shuffled
    order under a bound of four: their graphs share one memory pool, each
    replay rewrites blocks another graph's output once lay in, and evicted
    keys are captured again while others live.  Every pose, kept until the
    end, is the op-by-op body's on its own inputs."""
    monkeypatch.setattr(serve, "SERVE_GRAPHS", 4)
    captures, init = [], serve.ServingGraph.__init__

    def counted(self, *args):
        captures.append(tuple(args[1].shape))
        init(self, *args)

    monkeypatch.setattr(serve.ServingGraph, "__init__", counted)
    fn = _fn(_model())
    shapes = [(t, rows) for t in (64, 128, 256) for rows in (False, True)]
    order = np.random.default_rng(11).permutation(np.repeat(np.arange(6), 6))
    calls = [_batches(1, b=8, t=shapes[k][0], rows=shapes[k][1],
                      seed=100 + i)[0] for i, k in enumerate(order)]
    poses = [fn(a, s) for a, s in calls]
    assert len(fn.graphs.graphs) == 4
    assert len(captures) > len(shapes)         # evicted keys came back
    for i, ((a, s), pose) in enumerate(zip(calls, poses)):
        assert torch.equal(pose, _op_by_op(fn, a, s)), i


@pytest.mark.cuda
def test_streaming_and_waveform_requests_during_a_capture_succeed(
        cuda, deterministic):
    """While the pose batcher's worker holds a capture open, a raw-audio
    request runs the log-mel frontend and its first, op-by-op call on the
    waveform batcher's worker, and a streaming session's windows queue on
    the pose batcher.  Neither draws from the card's default generator,
    which the capture holds; each gives what the same request gives with
    no capture under way."""
    from concurrent.futures import ThreadPoolExecutor

    from mixstage_tpu_torch.serve import build_waveform_serving_fn
    from mixstage_tpu_torch.serving import DynamicBatcher, PoseService

    model = _model()
    fn, wav_fn = _fn(model), build_waveform_serving_fn(model)
    body, capturing, release = fn.graphs.body, threading.Event(), \
        threading.Event()

    def spied(audio, style, traced=False):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            assert release.wait(timeout=60)
        return body(audio, style, traced)

    fn.graphs.body = spied
    batchers = [DynamicBatcher(fn, batch_size=4, max_wait_ms=1.0,
                               input_shape=(None, MEL)),
                DynamicBatcher(wav_fn, batch_size=4, max_wait_ms=1.0,
                               input_shape=(None,))]
    service = PoseService(batchers[0], num_styles=S,
                          waveform_batcher=batchers[1])
    rng = np.random.default_rng(8)
    clip = {"audio": rng.standard_normal((T, MEL), dtype=np.float32)
            .tolist(), "style": 1}
    wave = {"audio": (0.1 * rng.standard_normal(
        wav_fn.n_samples, dtype=np.float32)).tolist(), "style": 2}
    stream_in = rng.standard_normal((3 * T // 2, MEL), dtype=np.float32)

    def stream():
        sid = service.stream_open({"style": 3})["session"]
        fed = service.stream_feed(sid, {"audio": stream_in.tolist()})
        return np.concatenate([np.reshape(p, (-1, 96)) for p in (
            fed["pose"], service.stream_finish(sid)["pose"])])

    def waveform():
        return np.asarray(service.infer_json(wave, waveform=True)["pose"])

    try:
        service.infer_json(clip)            # op by op; the next captures
        with ThreadPoolExecutor(2) as pool:
            captured = pool.submit(service.infer_json, clip)
            assert capturing.wait(timeout=60)
            streamed = pool.submit(stream)
            during = waveform()
            assert not release.is_set() and not captured.done()
            release.set()
            captured.result(timeout=120)
            streamed = streamed.result(timeout=120)
        after = [waveform() for _ in range(2)]    # captured, replayed
        again = stream()
    finally:
        release.set()
        for b in batchers:
            b.close()
    assert during.shape == (T, 96) and streamed.shape == (3 * T // 2, 96)
    for pose in after:
        np.testing.assert_array_equal(during, pose)
    np.testing.assert_array_equal(streamed, again)


@pytest.mark.cuda
def test_a_draw_from_its_own_generator_runs_during_a_capture(cuda):
    """What ``build_serving_fn``'s docstring tells code that shares the
    process: a capture holds only the default generator, so a draw on the
    card from a ``torch.Generator`` of its own runs while one is open."""
    from mixstage_tpu_torch.ops.cuda.graphs import CapturedGraph

    capturing, release, made = threading.Event(), threading.Event(), []

    def body():
        capturing.set()
        assert release.wait(timeout=60)
        return torch.ones(4, device=cuda) * 2

    worker = threading.Thread(target=lambda: made.append(CapturedGraph(
        body, capture_error_mode="thread_local")))
    worker.start()
    try:
        assert capturing.wait(timeout=60)
        gen = torch.Generator(device=cuda).manual_seed(3)
        drawn = torch.randn(1 << 10, device=cuda, generator=gen)
        assert torch.isfinite(drawn).all().item()
    finally:
        release.set()
        worker.join(timeout=60)
    assert torch.equal(drawn, torch.randn(
        1 << 10, device=cuda, generator=gen.manual_seed(3)))
    assert torch.equal(made[0].replay(), torch.full((4,), 2.0, device=cuda))


def _stale_input(self, audio, style):
    return self.graph.replay().clone()


def _alias(self, audio, style):
    self.load(audio, style)
    return self.graph.replay()


# fault: the check it must fail
FAULTS = {"stale_input": _check_replays, "alias": _check_kept,
          "weights_at_capture": _check_reload}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_injected_fault_fails_its_check(cuda, deterministic,
                                             monkeypatch, fault):
    model = _model()
    fn = _fn(model)
    if fault == "weights_at_capture":
        # the capture reads a copy of the model made as it starts
        init, pose, frozen = serve.ServingGraph.__init__, serve._pose, []

        def capture_on_a_copy(self, *args):
            frozen.append(copy.deepcopy(model))
            with monkeypatch.context() as m:
                m.setattr(serve, "_pose",
                          lambda _, *a, **k: pose(frozen[-1], *a, **k))
                init(self, *args)

        monkeypatch.setattr(serve.ServingGraph, "__init__",
                            capture_on_a_copy)
    else:
        monkeypatch.setattr(serve.ServingGraph, "__call__",
                            {"stale_input": _stale_input,
                             "alias": _alias}[fault])
    with pytest.raises(AssertionError):
        if fault == "weights_at_capture":
            _check_reload(fn, model, _batches(3))
        else:
            FAULTS[fault](fn, _batches(4))


@pytest.mark.cuda
def test_a_replay_after_load_state_dict_reads_the_new_weights(
        cuda, deterministic):
    model = _model()
    _check_reload(_fn(model), model, _batches(3))
