"""Serving endpoint: dynamic micro-batching + a stdlib HTTP front door.

Counterpart of ``mixstage_tpu/serving/server.py`` (``DynamicBatcher``
``:74-253``, ``PoseService`` ``:255-478`` with ``static_frames``
``:263-276, 345-349, 363``, the handler ``:481-602``,
``start_http_server`` ``:615``).
Requests queue up; one worker drains up to ``batch_size`` of them (or what
arrived within ``max_wait_ms``), pads to the batch size, runs ONE serving
call and scatters the results.

* ``POST /v1/pose`` — JSON ``{"audio": [[...T×mel...]], "style": int or
  [weights]}`` → ``{"pose": [[...]]}``; or ``application/octet-stream``
  carrying an ``.npz`` with ``audio``/``style`` → raw ``.npy`` pose bytes.
  Any length up to ``max_frames`` pads to a power-of-two bucket of at least
  ``frames`` frames and is trimmed back; a server over a static-shape
  graph (``static_frames``, the exported artifact's T) takes exactly that
  many frames instead.
* ``POST /v1/pose_from_waveform`` — the same with raw 16 kHz samples (a
  1-D ``audio``), served by ``waveform_batcher`` over
  ``serve.build_waveform_serving_fn``; 404 when none is configured.
* ``POST /v1/stream`` — open a streaming session (``{"style": ..., "hop":
  ...}`` → ``{"session": id, "window", "hop"}``); ``POST /v1/stream/<id>``
  feeds mel frames and returns the newly final pose frames, ``POST
  /v1/stream/<id>/finish`` flushes and closes, ``DELETE /v1/stream/<id>``
  drops the session.  Sessions run overlapped windows with a crossfade
  (``streaming.py``) and submit their windows through the same batcher, so
  concurrent streams share device batches.
* ``GET /healthz`` — liveness, backend, batch size.
* ``GET /stats`` — request/batch counters, occupancy, latency percentiles,
  live streaming sessions.
"""

from __future__ import annotations

import collections
import io
import itertools
import json
import queue
import threading
import time
import uuid
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mixstage_tpu_torch.ops.bucketing import pow2_pad
from mixstage_tpu_torch.streaming import StreamingSession
from mixstage_tpu_torch.train.profiling import enabled, record, span


class Overloaded(RuntimeError):
    """Raised by ``DynamicBatcher.submit`` when the queue is full (load
    shedding — the HTTP layer maps it to 429)."""


def _style_form(style):
    """A request's style as a scalar int id or a 1-D float32 weight vector;
    ValueError (→ HTTP 400) on anything else."""
    arr = np.asarray(style)
    if arr.ndim == 0:
        if float(arr) != int(arr):
            raise ValueError(
                f"scalar style must be an integer id, got {float(arr)} "
                f"(send a weight VECTOR for soft mixtures)")
        return int(arr)
    if arr.ndim != 1:
        raise ValueError(f"style must be a scalar id or a 1-D mixture "
                         f"weight vector, got shape {arr.shape}")
    return arr.astype(np.float32)


class DynamicBatcher:
    """Gather single requests into device batches of ``batch_size``.

    ``serve_fn``: ``(audio (B, T, mel), style (B,) int32 or (B, S) float32)
    -> pose (B, T, F)`` (a numpy array or a tensor on any device).
    ``input_shape`` is an optional per-request shape contract, e.g.
    ``(None, 64)`` for 64-mel windows of any length or ``(64, 128)`` for a
    static-T graph (``None`` matches any extent); a request that breaks it
    raises ``ValueError`` in the caller's thread at submit time.
    ``max_queue`` (default ``4 * batch_size``) bounds the backlog; beyond it
    ``submit`` sheds with :class:`Overloaded`.  Requests whose audio shape
    or style form differ go to separate batches.

    Under a ``torch.profiler`` trace (``train/profiling.py``) the worker
    records, with each batch's id: its gather (``batcher.gather``), its
    service (``batcher.service``, the serving call's ``serve.call``
    inside) and each of its requests' queue wait (``batcher.queue_wait``,
    from ``submit`` to the worker taking it).
    """

    def __init__(self, serve_fn: Callable, batch_size: int,
                 max_wait_ms: float = 5.0,
                 input_shape: Optional[Sequence[Optional[int]]] = None,
                 max_queue: Optional[int] = None):
        self.serve_fn = serve_fn
        self.batch_size = int(batch_size)
        self.max_wait_s = max_wait_ms / 1e3
        self.input_shape = None if input_shape is None else tuple(input_shape)
        self.max_queue = int(max_queue or 4 * self.batch_size)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._pending: "collections.deque" = collections.deque()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="pose-batcher")
        self.requests = 0
        self.batches = 0
        self.occupancy_sum = 0
        self.shed = 0
        self.latencies_ms: list = []
        self._stats_lock = threading.Lock()
        self._batch_ids = itertools.count()
        self._worker.start()

    def submit(self, audio: np.ndarray, style) -> Future:
        """Enqueue one (T, mel) window; resolves to a (T, feats) pose."""
        fut: Future = Future()
        audio = np.asarray(audio, np.float32)
        if self.input_shape is not None and not (
                audio.ndim == len(self.input_shape) and all(
                    want is None or have == want
                    for have, want in zip(audio.shape, self.input_shape))):
            raise ValueError(
                f"audio shape {audio.shape} does not match the serving "
                f"graph's expected {self.input_shape} (None = any)")
        style = _style_form(style)
        # backpressure covers the queue and the stragglers in _pending
        if self._queue.qsize() + len(self._pending) >= self.max_queue:
            with self._stats_lock:
                self.shed += 1
            raise Overloaded(
                f"serving queue full ({self.max_queue} waiting); retry later")
        try:
            self._queue.put_nowait((audio, style, fut, time.perf_counter()))
        except queue.Full:
            with self._stats_lock:
                self.shed += 1
            raise Overloaded(
                f"serving queue full ({self.max_queue} waiting); retry later"
            ) from None
        return fut

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    def stats(self) -> dict:
        with self._stats_lock:
            lats = sorted(self.latencies_ms[-4096:])
            pct = (lambda q: round(lats[int(q * (len(lats) - 1))], 2)) \
                if lats else (lambda q: None)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "mean_occupancy": round(self.occupancy_sum
                                        / max(1, self.batches), 2),
                "batch_size": self.batch_size,
                "shed": self.shed,
                "queue_depth": self._queue.qsize() + len(self._pending),
                "latency_ms_p50": pct(0.50),
                "latency_ms_p99": pct(0.99),
            }

    @staticmethod
    def _batch_key(item):
        audio, style = item[0], item[1]
        return (audio.shape,
                "id" if isinstance(style, int) else np.shape(style))

    def _drain(self):
        """Block for one request, then take what else arrives within the
        wait budget, up to the batch size: (the requests, the batch's id),
        or None.  Only requests matching the first one's batch key join;
        the rest wait in ``_pending``."""
        if self._pending:
            first = self._pending.popleft()
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return None
        batch = next(self._batch_ids)
        traced = enabled()
        held = time.perf_counter() if traced else 0.0
        with span("batcher.gather", batch=batch) as gather:
            key = self._batch_key(first)
            items = [first]
            keep = collections.deque()
            while self._pending and len(items) < self.batch_size:
                it = self._pending.popleft()
                (items if self._batch_key(it) == key else keep).append(it)
            keep.extend(self._pending)
            self._pending = keep
            if traced:        # the first request and the stragglers
                for it in items:
                    record("batcher.queue_wait", it[3], held, batch=batch)
            deadline = time.perf_counter() + self.max_wait_s
            while len(items) < self.batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    it = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if self._batch_key(it) == key:
                    items.append(it)
                    if traced:
                        record("batcher.queue_wait", it[3],
                               time.perf_counter(), batch=batch)
                else:
                    self._pending.append(it)
            gather.note(size=len(items),
                        full=len(items) == self.batch_size)
        return items, batch

    def _run(self):
        while not self._stop.is_set():
            drained = self._drain()
            if drained is None:
                continue
            items, batch = drained
            with span("batcher.service", batch=batch):
                self._serve(items)

    def _serve(self, items):
        """One device batch: stack and pad the requests, run the serving
        call, copy the pose to the host and set every future."""
        n = len(items)
        try:  # nothing in here may kill the worker thread
            audio = np.stack([it[0] for it in items])
            styles = [it[1] for it in items]
            style = (np.asarray(styles, np.int32)
                     if all(np.ndim(s) == 0 for s in styles)
                     else np.stack([np.asarray(s, np.float32)
                                    for s in styles]))
            if n < self.batch_size:   # pad to the batch size
                pad = self.batch_size - n
                audio = np.concatenate(
                    [audio, np.repeat(audio[:1], pad, axis=0)])
                style = np.concatenate(
                    [style, np.repeat(style[:1], pad, axis=0)])
            pose = self.serve_fn(audio, style)
            if isinstance(pose, torch.Tensor):
                pose = pose.detach().cpu().numpy()
            pose = np.asarray(pose)
        except Exception as exc:  # propagate to every waiter
            for _, _, fut, _ in items:
                fut.set_exception(exc)
            return
        now = time.perf_counter()
        with self._stats_lock:
            self.requests += n
            self.batches += 1
            self.occupancy_sum += n
            self.latencies_ms.extend(
                (now - it[3]) * 1e3 for it in items)
            del self.latencies_ms[:-8192]
        for i, (_, _, fut, _) in enumerate(items):
            fut.set_result(pose[i])


class PoseService:
    """The request-level protocol over a DynamicBatcher (and, optionally, a
    second one for raw waveforms), with streaming sessions."""

    def __init__(self, batcher: DynamicBatcher, backend: str = "unknown",
                 timeout_s: float = 30.0, num_styles: Optional[int] = None,
                 waveform_batcher: Optional[DynamicBatcher] = None,
                 frames: int = 64, stream_idle_s: float = 300.0,
                 mel_bins: Optional[int] = None,
                 static_frames: Optional[int] = None, max_streams: int = 64,
                 max_frames: int = 4096,
                 max_body_bytes: int = 64 * 2 ** 20):
        self.batcher = batcher
        self.backend = backend
        self.timeout_s = timeout_s
        # when known, scalar ids are one-hot encoded so hard ids and soft
        # weights share one server (uniform batch shapes)
        self.num_styles = num_styles
        self.mel_bins = mel_bins
        # a static-shape graph (the exported artifact) takes exactly this T
        self.static_frames = static_frames
        self.waveform_batcher = waveform_batcher
        # the streaming window, and the smallest pow-2 bucket of /v1/pose
        self.frames = int(frames)
        self.stream_idle_s = stream_idle_s
        self.max_streams = int(max_streams)  # bounds abandoned sessions
        # caps the request length: a handful of pow-2 buckets in all; the
        # waveform cap is its sample count at the frontend's 160-sample hop
        self.max_frames = int(max_frames)
        self.max_wave_samples = self.max_frames * 160
        self.max_body_bytes = int(max_body_bytes)   # enforced before reading
        # id -> [StreamingSession, last used, lock]
        self._streams: dict = {}
        self._streams_lock = threading.Lock()

    def _pick(self, waveform: bool) -> DynamicBatcher:
        if not waveform:
            return self.batcher
        if self.waveform_batcher is None:
            raise LookupError("waveform endpoint not configured (the model "
                              "must use audio/log_mel_400)")
        return self.waveform_batcher

    def _style(self, style):
        sty = _style_form(style)
        if isinstance(sty, int):
            if self.num_styles is None:
                return sty
            if not 0 <= sty < self.num_styles:
                raise ValueError(f"style id {sty} out of range "
                                 f"[0, {self.num_styles})")
            return np.eye(self.num_styles, dtype=np.float32)[sty]
        if self.num_styles is not None and sty.shape != (self.num_styles,):
            raise ValueError(f"style mixture must have {self.num_styles} "
                             f"weights, got shape {sty.shape}")
        return sty

    def _mel(self, audio) -> np.ndarray:
        arr = np.asarray(audio, np.float32)
        if arr.ndim != 2:
            raise ValueError(f"audio must be a (frames, mel) matrix, got "
                             f"shape {arr.shape}")
        if self.mel_bins is not None and arr.shape[1] != self.mel_bins:
            raise ValueError(f"audio has {arr.shape[1]} mel bins, the model "
                             f"expects {self.mel_bins}")
        return arr

    def _audio(self, audio, waveform: bool = False) -> np.ndarray:
        """Validate a request's audio; ValueError (→ HTTP 400)."""
        if waveform:
            arr = np.asarray(audio, np.float32)
            if arr.ndim != 1:
                raise ValueError(f"waveform endpoint expects a 1-D 16 kHz "
                                 f"sample array, got shape {arr.shape}")
            if arr.shape[0] > self.max_wave_samples:
                raise ValueError(
                    f"waveform has {arr.shape[0]} samples, over this "
                    f"server's cap of {self.max_wave_samples}; split the "
                    f"request or use the streaming endpoint")
            return arr
        arr = self._mel(audio)
        if arr.shape[0] < 1:
            raise ValueError("audio must have at least 1 frame")
        if arr.shape[0] > self.max_frames:
            raise ValueError(
                f"audio has {arr.shape[0]} frames, over this server's cap "
                f"of {self.max_frames}; split the request or use the "
                f"streaming endpoint")
        if self.static_frames is not None and \
                arr.shape[0] != self.static_frames:
            raise ValueError(f"this server's graph is compiled for exactly "
                             f"{self.static_frames} frames, got "
                             f"{arr.shape[0]}")
        return arr

    def _infer(self, audio, style, waveform: bool = False) -> np.ndarray:
        """Bucket mel windows to a pow-2 frame count (repeat-last padding),
        serve, and trim back to the true length; waveforms, and the windows
        of a static-frame server (validated instead), go as they are."""
        audio, true_len = self._audio(audio, waveform), None
        batcher = self._pick(waveform)
        if not waveform and self.static_frames is None:
            audio, true_len = pow2_pad(audio, floor=self.frames)
        pose = batcher.submit(audio, self._style(style)).result(
            self.timeout_s)
        return pose if true_len is None else pose[:true_len]

    def infer_json(self, payload: dict, waveform: bool = False) -> dict:
        if "audio" not in payload:
            raise ValueError("payload must carry an 'audio' field")
        return {"pose": self._infer(payload["audio"], payload.get("style", 0),
                                    waveform).tolist()}

    def infer_npz(self, body: bytes, waveform: bool = False) -> bytes:
        with np.load(io.BytesIO(body)) as z:
            if "audio" not in z:
                raise ValueError("npz must carry an 'audio' array")
            audio = z["audio"]
            style = z["style"] if "style" in z else 0
        buf = io.BytesIO()
        np.save(buf, self._infer(audio, style, waveform))
        return buf.getvalue()

    # ---------------------------------------------------- streaming sessions
    def _sweep_streams(self):
        """Drop sessions idle past the budget (caller holds the lock)."""
        now = time.time()
        for sid in [k for k, v in self._streams.items()
                    if now - v[1] > self.stream_idle_s]:
            del self._streams[sid]

    def _stream(self, sid: str):
        with self._streams_lock:
            self._sweep_streams()
            entry = self._streams.get(sid)
        if entry is None:
            raise LookupError(f"unknown or expired session {sid!r}")
        return entry

    def stream_open(self, payload: dict) -> dict:
        """Create a streaming session whose windows go through the shared
        batcher."""
        style = self._style(payload.get("style", 0))
        hop = payload.get("hop")

        def infer(window, sty):
            return self.batcher.submit(window, sty).result(self.timeout_s)

        sess = StreamingSession(infer, style, window=self.frames,
                                hop=None if hop is None else int(hop))
        sid = uuid.uuid4().hex[:16]
        with self._streams_lock:
            self._sweep_streams()
            if len(self._streams) >= self.max_streams:
                raise Overloaded(
                    f"too many live streaming sessions ({self.max_streams});"
                    f" close or finish some first")
            self._streams[sid] = [sess, time.time(), threading.Lock()]
        return {"session": sid, "window": sess.window, "hop": sess.hop}

    def stream_feed(self, sid: str, payload: dict) -> dict:
        entry = self._stream(sid)
        if "audio" not in payload:
            raise ValueError("payload must carry an 'audio' field")
        audio = self._mel(payload["audio"])
        with entry[2]:              # one feed at a time per session
            out = entry[0].feed(audio)
            entry[1] = time.time()
            buffered = entry[0].frames_buffered
        return {"pose": out.tolist(), "frames_buffered": buffered}

    def stream_finish(self, sid: str) -> dict:
        entry = self._stream(sid)
        with entry[2]:
            out = entry[0].finish()
        with self._streams_lock:
            self._streams.pop(sid, None)
        return {"pose": out.tolist()}

    def stream_close(self, sid: str) -> dict:
        with self._streams_lock:
            dropped = self._streams.pop(sid, None) is not None
        return {"closed": dropped}

    def stream_count(self) -> int:
        with self._streams_lock:
            self._sweep_streams()
            return len(self._streams)

    def healthz(self) -> dict:
        return {"ok": True, "backend": self.backend,
                "batch_size": self.batcher.batch_size}


def _make_handler(service: PoseService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _not_found(self):
            self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, service.healthz())
            elif self.path == "/stats":
                self._send_json(200, {**service.batcher.stats(),
                                      "streams": service.stream_count()})
            else:
                self._not_found()

        def do_DELETE(self):
            parts = self.path.strip("/").split("/")
            if len(parts) == 3 and parts[:2] == ["v1", "stream"]:
                self._send_json(200, service.stream_close(parts[2]))
            else:
                self._not_found()

        def _drain(self, length: int):
            """Discard a refused body in bounded chunks so the client sees
            the error response rather than a broken pipe; a body declared
            over 4x the cap closes the connection instead."""
            if length > 4 * service.max_body_bytes:
                self.close_connection = True
                return
            left = length
            try:
                while left > 0:
                    chunk = self.rfile.read(min(left, 64 * 1024))
                    if not chunk:
                        break
                    left -= len(chunk)
            except OSError:
                pass
            if left:
                self.close_connection = True

        def do_POST(self):
            raw_length = self.headers.get("Content-Length", 0)
            try:
                length = int(raw_length)
            except ValueError:
                length = -1
            if length < 0:
                self.close_connection = True
                self._send_json(400, {"error": f"malformed Content-Length "
                                               f"header {raw_length!r}"})
                return
            if length > service.max_body_bytes:
                self._send_json(413, {
                    "error": f"request body of {length} bytes exceeds the "
                             f"{service.max_body_bytes}-byte cap"})
                self._drain(length)
                return
            body = self.rfile.read(length)
            parts = self.path.strip("/").split("/")
            try:
                if parts[:2] == ["v1", "stream"]:
                    self._stream(parts, body)
                elif self.path in ("/v1/pose", "/v1/pose_from_waveform"):
                    waveform = self.path.endswith("waveform")
                    if self.headers.get("Content-Type", "").startswith(
                            "application/octet-stream"):
                        self._send(200, service.infer_npz(body, waveform),
                                   "application/octet-stream")
                    else:
                        self._send_json(200, service.infer_json(
                            json.loads(body.decode()), waveform))
                else:
                    self._not_found()
            except Overloaded as exc:       # queue full → shed, retryable
                self._send_json(429, {"error": str(exc)})
            except LookupError as exc:      # unknown session or endpoint
                self._send_json(404, {"error": f"{type(exc).__name__}: "
                                               f"{exc}"})
            except FuturesTimeout:          # device stuck / overloaded
                self._send_json(503, {"error": "inference timed out; server "
                                               "overloaded or backend "
                                               "unavailable"})
            except Exception as exc:  # noqa: BLE001 — surface to the client
                self._send_json(400, {"error": f"{type(exc).__name__}: {exc}"})

        def _stream(self, parts, body: bytes):
            """``/v1/stream`` opens, ``/v1/stream/<id>`` feeds,
            ``/v1/stream/<id>/finish`` flushes."""
            payload = json.loads(body.decode()) if body else {}
            if len(parts) == 2:
                self._send_json(200, service.stream_open(payload))
            elif len(parts) == 3:
                self._send_json(200, service.stream_feed(parts[2], payload))
            elif len(parts) == 4 and parts[3] == "finish":
                self._send_json(200, service.stream_finish(parts[2]))
            else:
                self._not_found()

    return Handler


class PoseHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a TCP accept backlog of 128 (socketserver's
    default of 5 resets bursts of clients before the batcher can shed)."""

    request_queue_size = 128


def start_http_server(service: PoseService, port: int = 0,
                      host: str = "127.0.0.1"):
    """Serve on a daemon thread; returns the server (``server_address[1]``
    is the bound port — ``port=0`` picks a free one).  Stop it with
    ``shutdown()`` and ``server_close()``."""
    server = PoseHTTPServer((host, port), _make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="pose-http").start()
    return server
