"""AVI writer without ffmpeg: MJPEG video and 16-bit PCM audio.

The port's copy of ``mixstage_tpu/animation/aviwriter.py``.  It fills the
reference's audio-mux role (chahuja/mix-stage
``src/animation/animation.py:251-271``, an ffmpeg subprocess) where the
binary is absent, so a rendered pose video still carries the interval's
speech.  The container is RIFF AVI 1.0: MJPEG ('MJPG') frames encoded by
PIL's JPEG codec (PIL imported when a frame is encoded), interleaved with
'01wb' PCM blocks, and an 'idx1' index.
"""

from __future__ import annotations

import io
import struct
from typing import List, Optional, Tuple

import numpy as np

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    """One RIFF chunk, word-aligned (odd payloads gain a pad byte that the
    size field excludes, per the RIFF spec)."""
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def encode_jpeg(frame: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    # subsampling=0 (4:4:4): skeleton renders are thin colored lines on a
    # flat background; 4:2:0 chroma smears them for ~no size win here.
    Image.fromarray(np.ascontiguousarray(frame, np.uint8)).save(
        buf, "JPEG", quality=quality, subsampling=0)
    return buf.getvalue()


class AviWriter:
    """Streaming writer with the same ``add(frames) … close()`` contract as
    ``raster.GifWriter``/``Mp4Writer``.  Frames are JPEG-compressed as they
    arrive (so buffering stays ~30× smaller than raw RGB); the RIFF tree is
    assembled at ``close`` when the counts that go in the headers are known.
    """

    def __init__(self, path: str, fps: int, quality: int = 90):
        self.path = path
        self.fps = int(fps)
        self.quality = quality
        self._frames: List[bytes] = []
        self._wh: Optional[Tuple[int, int]] = None
        self._pcm: Optional[np.ndarray] = None
        self._rate: int = 0

    def add(self, frames: np.ndarray) -> None:
        frames = np.ascontiguousarray(frames, np.uint8)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"expected (T, H, W, 3) uint8, got {frames.shape}")
        _, H, W, _ = frames.shape
        if self._wh is None:
            self._wh = (W, H)
        elif self._wh != (W, H):
            raise ValueError(f"frame size changed {self._wh} -> {(W, H)}")
        self._frames.extend(encode_jpeg(f, self.quality) for f in frames)

    def set_audio(self, pcm: np.ndarray, sample_rate: int) -> None:
        """Attach a mono int16 track (float input in [-1, 1] is converted).
        Scale conversion happens BEFORE channel averaging: int16 stereo must
        be averaged in the int16 scale, not pushed through the [-1, 1] clip."""
        pcm = np.asarray(pcm)
        if pcm.dtype != np.int16:  # float in [-1, 1] -> int16 scale
            pcm = np.clip(pcm, -1.0, 1.0) * 32767.0
        if pcm.ndim > 1:           # average channels (float64, int16 scale)
            pcm = pcm.mean(axis=-1)
        if pcm.dtype != np.int16:
            pcm = np.round(pcm).astype(np.int16)
        self._pcm = np.ascontiguousarray(pcm)
        self._rate = int(sample_rate)

    # -- RIFF assembly -----------------------------------------------------

    def _strl_video(self, n_frames: int, max_sz: int) -> bytes:
        W, H = self._wh
        strh = struct.pack(
            "<4s4sIHHIIIIIIiI4h",
            b"vids", b"MJPG", 0, 0, 0, 0,
            1, self.fps,          # dwScale / dwRate → fps
            0, n_frames, max_sz,
            -1, 0,                # quality, sample size
            0, 0, W, H)           # rcFrame
        strf = struct.pack("<IiiHH4sIiiII",
                           40, W, H, 1, 24, b"MJPG", W * H * 3, 0, 0, 0, 0)
        return _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))

    def _strl_audio(self, n_samples: int, max_blk: int) -> bytes:
        strh = struct.pack(
            "<4s4sIHHIIIIIIiI4h",
            b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0,
            1, self._rate,        # dwScale / dwRate → samples per second
            0, n_samples, max_blk,
            -1, 2,                # dwSampleSize = block align (16-bit mono)
            0, 0, 0, 0)
        strf = struct.pack("<HHIIHH", 1, 1, self._rate, self._rate * 2, 2, 16)
        return _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))

    def _interleave(self) -> List[Tuple[bytes, bytes]]:
        """(fourcc, payload) sequence: each video frame followed by its
        slice of the audio track, remainder samples spread evenly."""
        out: List[Tuple[bytes, bytes]] = []
        n = len(self._frames)
        if self._pcm is None or n == 0:
            return [(b"00dc", f) for f in self._frames]
        edges = np.linspace(0, len(self._pcm), n + 1).astype(np.int64)
        for i, f in enumerate(self._frames):
            out.append((b"00dc", f))
            blk = self._pcm[edges[i]:edges[i + 1]]
            if blk.size:
                out.append((b"01wb", blk.tobytes()))
        return out

    def close(self) -> None:
        if self._wh is None:
            raise ValueError("no frames added")
        W, H = self._wh
        n = len(self._frames)
        has_audio = self._pcm is not None and self._pcm.size > 0
        max_vid = max(len(f) for f in self._frames)

        chunks = self._interleave()
        strls = self._strl_video(n, max_vid)
        max_blk = 0
        if has_audio:
            blocks = [len(p) for f4, p in chunks if f4 == b"01wb"]
            max_blk = max(blocks) if blocks else 0
            strls += self._strl_audio(int(self._pcm.size), max_blk)

        avih = struct.pack(
            "<IIIIIIIIII4I",
            int(round(1e6 / self.fps)),
            (max_vid + max_blk) * self.fps,   # dwMaxBytesPerSec (upper bound)
            0, AVIF_HASINDEX, n, 0,
            2 if has_audio else 1,
            max(max_vid, max_blk), W, H, 0, 0, 0, 0)

        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strls)
        # idx1 offsets: absolute file positions of each chunk's fourcc.
        # Both absolute and movi-relative are found in the wild and players
        # auto-detect; absolute is what OpenCV's built-in MJPEG container
        # parser (an independent decoder of these files) resolves.
        movi_fourcc_abs = 12 + len(hdrl) + 8
        movi_body = bytearray(b"movi")   # bytearray: linear-time appends
        idx1 = bytearray()
        for fourcc, payload in chunks:
            idx1 += struct.pack("<4sIII", fourcc, AVIIF_KEYFRAME,
                                movi_fourcc_abs + len(movi_body), len(payload))
            movi_body += _chunk(fourcc, payload)
        riff_body = b"AVI " + hdrl + _chunk(b"LIST", bytes(movi_body)) \
            + _chunk(b"idx1", bytes(idx1))
        with open(self.path, "wb") as fh:
            fh.write(_chunk(b"RIFF", riff_body))


# -- decoding helpers (mux sources + tests) --------------------------------


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV → (mono int16, sample_rate) with the standard library only.
    8/16/32-bit PCM; multi-channel is averaged."""
    import wave

    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        pcm = np.frombuffer(raw, np.int16)
    elif width == 4:
        pcm = (np.frombuffer(raw, np.int32) >> 16).astype(np.int16)
    elif width == 1:  # unsigned 8-bit
        pcm = ((np.frombuffer(raw, np.uint8).astype(np.int16) - 128) << 8)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if nch > 1:
        pcm = pcm.reshape(-1, nch).mean(axis=1).astype(np.int16)
    return pcm, sr


def decode_audio(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """Best-effort decode to (mono int16, rate): WAV via the stdlib, other
    formats via soundfile when installed, else None (caller falls back to a
    silent render, matching the old ffmpeg-missing behavior)."""
    p = str(path)
    if p.lower().endswith(".wav"):
        try:
            return read_wav(p)
        except Exception:
            pass  # e.g. IEEE-float / EXTENSIBLE wav: fall through to soundfile
    try:
        import soundfile as sf
    except ImportError:
        return None
    try:
        y, sr = sf.read(p, always_2d=False)
    except Exception:
        return None
    if y.ndim > 1:
        y = y.mean(axis=-1)
    return (np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16), int(sr)


def parse_avi(path: str) -> dict:
    """Minimal RIFF walker for tests/tools: returns header fields, the JPEG
    frame payloads, and the concatenated PCM track."""
    blob = open(path, "rb").read()
    assert blob[:4] == b"RIFF" and blob[8:12] == b"AVI "
    out = {"frames": [], "pcm": b"", "headers": {}}

    def walk(buf: bytes, pos: int, end: int) -> None:
        while pos + 8 <= end:
            fourcc = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            body = buf[pos + 8:pos + 8 + size]
            if fourcc == b"LIST":
                walk(buf, pos + 12, pos + 8 + size)
            elif fourcc == b"avih":
                f = struct.unpack("<10I", body[:40])
                out["headers"]["avih"] = dict(
                    usec_per_frame=f[0], flags=f[3], total_frames=f[4],
                    streams=f[6], width=f[8], height=f[9])
            elif fourcc == b"strh":
                kind = body[:4].decode()
                scale, rate = struct.unpack("<II", body[20:28])
                length = struct.unpack("<I", body[32:36])[0]
                out["headers"].setdefault("streams", []).append(
                    dict(kind=kind, scale=scale, rate=rate, length=length))
            elif fourcc == b"00dc":
                out["frames"].append(body)
            elif fourcc == b"01wb":
                out["pcm"] += body
            elif fourcc == b"idx1":
                out["headers"]["idx1_entries"] = size // 16
            pos += 8 + size + (size & 1)

    walk(blob, 12, len(blob))
    return out
