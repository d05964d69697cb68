"""Serving endpoint: dynamic micro-batching + a stdlib HTTP front door.

Counterpart of ``mixstage_tpu/serving/server.py`` (``DynamicBatcher``
``:74-253``, ``PoseService`` ``:255-478``, ``start_http_server`` ``:615``).
Requests queue up; one worker drains up to ``batch_size`` of them (or what
arrived within ``max_wait_ms``), pads to the batch size, runs ONE serving
call and scatters the results.

* ``POST /v1/pose`` — JSON ``{"audio": [[...T×mel...]], "style": int or
  [weights]}`` → ``{"pose": [[...]]}``; or ``application/octet-stream``
  carrying an ``.npz`` with ``audio``/``style`` → raw ``.npy`` pose bytes.
  Any length up to ``max_frames`` pads to a power-of-two bucket of at least
  ``frames`` frames and is trimmed back.
* ``GET /healthz`` — liveness, backend, batch size.
* ``GET /stats`` — request/batch counters, occupancy, latency percentiles.

The streaming (``/v1/stream…``) and waveform (``/v1/pose_from_waveform``)
endpoints come with a later slice; until then they answer 404, as the JAX
server does for an endpoint it was not configured with.
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from mixstage_tpu_torch.ops.bucketing import pow2_pad


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
    ``max_queue`` (default ``4 * batch_size``) bounds the backlog; beyond it
    ``submit`` sheds with :class:`Overloaded`.  Requests whose audio shape
    or style form differ go to separate batches.
    """

    def __init__(self, serve_fn: Callable, batch_size: int,
                 max_wait_ms: float = 5.0, max_queue: Optional[int] = None):
        self.serve_fn = serve_fn
        self.batch_size = int(batch_size)
        self.max_wait_s = max_wait_ms / 1e3
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
        self._worker.start()

    def submit(self, audio: np.ndarray, style) -> Future:
        """Enqueue one (T, mel) window; resolves to a (T, feats) pose."""
        fut: Future = Future()
        audio = np.asarray(audio, np.float32)
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
        wait budget, up to the batch size.  Only requests matching the first
        one's batch key join; the rest wait in ``_pending``."""
        if self._pending:
            first = self._pending.popleft()
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return None
        key = self._batch_key(first)
        items = [first]
        keep = collections.deque()
        while self._pending and len(items) < self.batch_size:
            it = self._pending.popleft()
            (items if self._batch_key(it) == key else keep).append(it)
        keep.extend(self._pending)
        self._pending = keep
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
            else:
                self._pending.append(it)
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
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
                continue
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
    """The request-level protocol over a DynamicBatcher."""

    def __init__(self, batcher: DynamicBatcher, backend: str = "unknown",
                 timeout_s: float = 30.0, num_styles: Optional[int] = None,
                 frames: int = 64, mel_bins: Optional[int] = None,
                 max_frames: int = 4096,
                 max_body_bytes: int = 64 * 2 ** 20):
        self.batcher = batcher
        self.backend = backend
        self.timeout_s = timeout_s
        # when known, scalar ids are one-hot encoded so hard ids and soft
        # weights share one server (uniform batch shapes)
        self.num_styles = num_styles
        self.mel_bins = mel_bins
        self.frames = int(frames)
        # caps the request length: a handful of pow-2 buckets in all
        self.max_frames = int(max_frames)
        self.max_body_bytes = int(max_body_bytes)   # enforced before reading

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

    def _audio(self, audio) -> np.ndarray:
        """Validate a request's audio; ValueError (→ HTTP 400)."""
        arr = np.asarray(audio, np.float32)
        if arr.ndim != 2:
            raise ValueError(f"audio must be a (frames, mel) matrix, got "
                             f"shape {arr.shape}")
        if arr.shape[0] < 1:
            raise ValueError("audio must have at least 1 frame")
        if arr.shape[0] > self.max_frames:
            raise ValueError(
                f"audio has {arr.shape[0]} frames, over this server's cap "
                f"of {self.max_frames}; split the request")
        if self.mel_bins is not None and arr.shape[1] != self.mel_bins:
            raise ValueError(f"audio has {arr.shape[1]} mel bins, the model "
                             f"expects {self.mel_bins}")
        return arr

    def _infer(self, audio, style) -> np.ndarray:
        """Bucket to a pow-2 frame count (repeat-last padding), serve, and
        trim back to the true length."""
        audio, true_len = pow2_pad(self._audio(audio), floor=self.frames)
        pose = self.batcher.submit(audio, self._style(style)).result(
            self.timeout_s)
        return pose if true_len is None else pose[:true_len]

    def infer_json(self, payload: dict) -> dict:
        if "audio" not in payload:
            raise ValueError("payload must carry an 'audio' field")
        return {"pose": self._infer(payload["audio"],
                                    payload.get("style", 0)).tolist()}

    def infer_npz(self, body: bytes) -> bytes:
        with np.load(io.BytesIO(body)) as z:
            if "audio" not in z:
                raise ValueError("npz must carry an 'audio' array")
            audio = z["audio"]
            style = z["style"] if "style" in z else 0
        buf = io.BytesIO()
        np.save(buf, self._infer(audio, style))
        return buf.getvalue()

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
            self._send_json(404, {"error": f"unknown or unconfigured path "
                                           f"{self.path}"})

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, service.healthz())
            elif self.path == "/stats":
                self._send_json(200, service.batcher.stats())
            else:
                self._not_found()

        def do_DELETE(self):
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
            if self.path != "/v1/pose":
                self._not_found()
                return
            try:
                if self.headers.get("Content-Type", "").startswith(
                        "application/octet-stream"):
                    self._send(200, service.infer_npz(body),
                               "application/octet-stream")
                else:
                    self._send_json(200, service.infer_json(
                        json.loads(body.decode())))
            except Overloaded as exc:       # queue full → shed, retryable
                self._send_json(429, {"error": str(exc)})
            except FuturesTimeout:          # device stuck / overloaded
                self._send_json(503, {"error": "inference timed out; server "
                                               "overloaded or backend "
                                               "unavailable"})
            except Exception as exc:  # noqa: BLE001 — surface to the client
                self._send_json(400, {"error": f"{type(exc).__name__}: {exc}"})

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
