"""Streaming audio→pose inference: overlapped windows + crossfade.

The port's own copy of ``mixstage_tpu/streaming.py``.  The generator cannot
be streamed exactly: its UNet1D bottleneck downsamples the 64-frame window
by 2^5, so every output frame depends on (nearly) the whole window.
Instead, consecutive windows overlap by ``window - hop`` frames and the
overlap is linearly crossfaded — the streamed output is, per frame, a
convex combination of at most two window inferences, giving bounded
algorithmic latency instead of whole-interval batch latency:

* a frame is FINAL once no future window can overlap it — worst-case
  ``window`` frames of input after it arrives (≈4.3 s at 15 fps with the
  default 64/32), tunable via ``hop``;
* feeding granularity does not matter: frame-at-a-time and all-at-once
  produce bit-identical output;
* ``infer`` is a SINGLE-EXAMPLE callable, so HTTP streaming sessions can
  ride the serving ``DynamicBatcher`` — concurrent sessions batch together
  into one device call.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


class StreamingSession:
    """Stateful mel-frames → pose-frames streamer over a window ``infer`` fn.

    ``infer(window (window, mel) f32, style) -> (window, F) f32`` runs ONE
    window; ``style`` is passed through verbatim (an int id or a soft
    mixture row).  ``feed`` returns newly *finalized* pose frames (possibly
    empty); ``finish`` flushes the tail (right-pads the last window by
    repeating the final mel frame, a standard streaming-DSP edge treatment,
    then trims to the true input length).
    """

    def __init__(self, infer: Callable, style, window: int = 64,
                 hop: Optional[int] = None):
        if window < 2:
            raise ValueError("window must be >= 2")
        hop = window // 2 if hop is None else int(hop)
        if not 0 < hop <= window:
            raise ValueError(f"hop must be in (0, {window}], got {hop}")
        self.infer = infer
        self.style = style
        self.window = int(window)
        self.hop = hop
        # buffers hold only the live suffix: consumed input (before the next
        # window start) and emitted output are dropped eagerly, so memory is
        # O(window + feed chunk) for arbitrarily long sessions instead of
        # O(stream length); *_base counters map list/array indices back to
        # absolute frame positions
        self._in: list = []          # buffered mel frames from _in_base on
        self._in_base = 0            # absolute index of _in[0]
        self._out: Optional[np.ndarray] = None   # stitched pose suffix
        self._out_base = 0           # absolute index of _out[0]
        self._next_start = 0         # absolute start of the next window
        self._emitted = 0            # frames already returned to the caller
        self._finished = False
        self._true_len = 0           # input length excluding finish() padding
        # overlap ramp: new window fades IN over the first (window - hop)
        # overlapped frames; by symmetry the previous window fades out
        ov = self.window - self.hop
        ramp = (np.arange(1, ov + 1, dtype=np.float32) / (ov + 1)
                if ov else np.zeros((0,), np.float32))
        self._fade_in = np.concatenate(
            [ramp, np.ones(self.window - ov, np.float32)])

    # ------------------------------------------------------------- plumbing
    def _run_window(self, start: int):
        rel = start - self._in_base
        chunk = np.asarray(self._in[rel:rel + self.window], np.float32)
        # NOTE: infer() runs before any state mutation, so a failed window
        # (batcher overload, timeout) leaves the session retryable
        pose = np.asarray(self.infer(chunk, self.style), np.float32)
        if pose.shape[0] != self.window:
            raise ValueError(f"infer returned {pose.shape[0]} frames for a "
                             f"{self.window}-frame window")
        F = pose.shape[-1]
        o = start - self._out_base
        end = o + self.window
        if self._out is None:
            self._out = np.zeros((end, F), np.float32)
        elif end > self._out.shape[0]:
            grow = end - self._out.shape[0]
            self._out = np.concatenate(
                [self._out, np.zeros((grow, F), np.float32)])
        # first window fades in over nothing — use full weight there
        w = self._fade_in if start else np.ones((self.window,), np.float32)
        self._out[o:end] *= (1.0 - w)[:, None]
        self._out[o:end] += w[:, None] * pose
        self._next_start = start + self.hop

    def _drain(self) -> np.ndarray:
        """Return frames that no future window can change.

        While live, a frame is final once the next window starts after it;
        on finish, everything up to the TRUE input length (padding frames
        are never emitted)."""
        if self._out is None:
            return np.zeros((0, 0), np.float32)
        covered = self._out_base + self._out.shape[0]
        final_upto = (self._true_len if self._finished
                      else min(self._next_start, covered))
        if final_upto <= self._emitted:
            return np.zeros((0, self._out.shape[-1]), np.float32)
        out = self._out[self._emitted - self._out_base:
                        final_upto - self._out_base].copy()
        self._emitted = final_upto
        # drop the emitted prefix (copy() so the big backing array frees)
        self._out = self._out[final_upto - self._out_base:].copy()
        self._out_base = final_upto
        return out

    # ------------------------------------------------------------------ API
    def feed(self, mel_frames) -> np.ndarray:
        """Buffer mel frames; run any now-complete windows; return newly
        finalized pose frames ((n, F), n possibly 0)."""
        if self._finished:
            raise RuntimeError("session already finished")
        mel_frames = np.asarray(mel_frames, np.float32)
        if mel_frames.ndim == 1:
            mel_frames = mel_frames[None]
        self._in.extend(mel_frames)
        while len(self._in) + self._in_base >= self._next_start + self.window:
            self._run_window(self._next_start)
        # input before the next window start can never be read again
        drop = self._next_start - self._in_base
        if drop > 0:
            del self._in[:drop]
            self._in_base = self._next_start
        return self._drain()

    def finish(self) -> np.ndarray:
        """Flush: right-pad the final partial window by repeating the last
        mel frame, run it, return the remaining pose frames (trimmed to the
        true input length)."""
        if self._finished:
            raise RuntimeError("session already finished")
        n = self._in_base + len(self._in)
        covered = 0 if self._out is None else \
            self._out_base + self._out.shape[0]
        if covered < n:
            # feed() drained all complete windows, so exactly ONE padded
            # window (at _next_start < n <= _next_start + window) remains
            pad = self._next_start + self.window - n
            keep = len(self._in)
            if pad > 0:
                self._in.extend([self._in[-1]] * pad)
            try:
                self._run_window(self._next_start)
            finally:
                # retry safety: a transient infer failure (overload/timeout)
                # must not leave padding in the buffer, or a retried finish
                # would emit padding frames as real output
                del self._in[keep:]
        self._true_len = n
        self._finished = True
        return self._drain()

    @property
    def frames_buffered(self) -> int:
        if self._finished:
            return 0
        return self._in_base + len(self._in) - self._emitted


def session_over_serving_fn(serve_fn, style, hop: Optional[int] = None):
    """StreamingSession over a ``serve.build_serving_fn`` or artifact fn.

    Wraps the batched fn as a single-example ``infer`` (batch 1); the pose
    comes back to the host as numpy.  ``serve_fn.frames`` (the artifact
    loader's) or 64 (the training window) sets the window length.  An
    artifact (``export.load_serving``) has a static batch: the window is
    tiled to ``serve_fn.static_batch`` rows and row 0 kept, as a batch of
    one would fail the loader's static-shape guard.
    """
    window = int(getattr(serve_fn, "frames", 64))
    B = int(getattr(serve_fn, "static_batch", 1) or 1)

    def infer(window_mel, sty):
        sty = np.asarray(sty)
        pose = serve_fn(np.repeat(window_mel[None], B, axis=0),
                        np.repeat(sty[None], B, axis=0))
        if isinstance(pose, torch.Tensor):
            pose = pose.detach().cpu().numpy()
        return np.asarray(pose)[0]

    return StreamingSession(infer, style, window=window, hop=hop)
