"""Minimal client for the pose-serving endpoint (stdlib urllib + numpy).

Counterpart of ``mixstage_tpu/serving/client.py`` for the endpoints the
port serves so far (``/v1/pose``, ``/healthz``, ``/stats``).  ``pose`` uses
the binary npz transport; ``pose_json`` the JSON one.  Styles may be scalar
ids or mixture-weight vectors.
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

    def pose(self, audio: np.ndarray, style=0) -> np.ndarray:
        """One (T, mel) log-mel window → (T, feats) pose (npz transport)."""
        buf = io.BytesIO()
        np.savez(buf, audio=np.asarray(audio, np.float32),
                 style=np.asarray(style))
        body = self._post("/v1/pose", buf.getvalue(),
                          "application/octet-stream")
        return np.load(io.BytesIO(body))

    def pose_json(self, audio: np.ndarray, style=0) -> np.ndarray:
        """The same request over the JSON transport."""
        payload = {"audio": np.asarray(audio, np.float32).tolist(),
                   "style": np.asarray(style).tolist()}
        body = self._post("/v1/pose", json.dumps(payload).encode(),
                          "application/json")
        return np.asarray(json.loads(body)["pose"], np.float32)
