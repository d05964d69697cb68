"""Minimal client for the pose-serving endpoint (stdlib urllib + numpy).

Counterpart of ``mixstage_tpu/serving/client.py``.  ``pose`` and
``pose_from_waveform`` use the binary npz transport, ``pose_json`` the JSON
one; ``stream`` opens a streaming session (``PoseStream``).  Styles may be
scalar ids or mixture-weight vectors.
"""

from __future__ import annotations

import io
import json
import urllib.request

import numpy as np


class PoseClient:
    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def health(self) -> dict:
        return self._get("/healthz")

    def stats(self) -> dict:
        return self._get("/stats")

    def _post(self, path: str, data: bytes, ctype: str) -> bytes:
        req = urllib.request.Request(self.base_url + path, data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read()

    def _post_npz(self, path: str, audio: np.ndarray, style) -> np.ndarray:
        buf = io.BytesIO()
        np.savez(buf, audio=np.asarray(audio, np.float32),
                 style=np.asarray(style))
        body = self._post(path, buf.getvalue(), "application/octet-stream")
        return np.load(io.BytesIO(body))

    def _post_json(self, path: str, payload: dict) -> dict:
        return json.loads(self._post(path, json.dumps(payload).encode(),
                                     "application/json"))

    def pose(self, audio: np.ndarray, style=0) -> np.ndarray:
        """One (T, mel) log-mel window → (T, feats) pose (npz transport)."""
        return self._post_npz("/v1/pose", audio, style)

    def pose_from_waveform(self, waveform: np.ndarray,
                           style=0) -> np.ndarray:
        """Raw 16 kHz samples → pose (servers with the log_mel_400
        frontend)."""
        return self._post_npz("/v1/pose_from_waveform", waveform, style)

    def stream(self, style=0, hop=None) -> "PoseStream":
        """Open a streaming session (overlapped windows, crossfaded)."""
        payload = {"style": np.asarray(style).tolist()}
        if hop is not None:
            payload["hop"] = int(hop)
        return PoseStream(self, self._post_json("/v1/stream", payload))

    def pose_json(self, audio: np.ndarray, style=0) -> np.ndarray:
        """The same request over the JSON transport."""
        payload = {"audio": np.asarray(audio, np.float32).tolist(),
                   "style": np.asarray(style).tolist()}
        return np.asarray(self._post_json("/v1/pose", payload)["pose"],
                          np.float32)


class PoseStream:
    """Client handle of one streaming session: feed mel frames, receive the
    newly final pose frames."""

    def __init__(self, client: PoseClient, info: dict):
        self._client = client
        self.session = info["session"]
        self.window = info["window"]
        self.hop = info["hop"]

    def feed(self, mel_frames: np.ndarray) -> np.ndarray:
        out = self._client._post_json(
            f"/v1/stream/{self.session}",
            {"audio": np.asarray(mel_frames, np.float32).tolist()})
        return np.asarray(out["pose"], np.float32)

    def finish(self) -> np.ndarray:
        out = self._client._post_json(f"/v1/stream/{self.session}/finish",
                                      {})
        return np.asarray(out["pose"], np.float32)
