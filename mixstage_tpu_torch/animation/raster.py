"""Skeleton rasteriser: pose tensors → RGB frame stacks → GIF / mp4 / AVI.

The port's copy of ``mixstage_tpu/animation/raster.py``.  Per bone an
anti-aliased capsule whose linewidth ramps min → peak → min along the bone
(the reference's tapered ``lwidths``, chahuja/mix-stage
``src/animation/animation.py:44-76``), drawn into a ``(T, H, W, 3)`` uint8
buffer by the host C++ library ``raster.cpp`` (threads across frames).
Colours, widths and the world-to-pixel mapping are the JAX package's.

The library is built at first use by ``g++`` with the JAX package's
``native/Makefile`` flags and ``-ffp-contract=off`` into
``build/torch_kernels/``, named by a hash of its source, the flags and the
host CPU's features (``-march=native``); a failed build raises with g++'s
log.
``rasterize_plain`` is the same math in numpy: the plain version the tests
and ``chip_smoke.py`` hold the library to, never a quiet fallback.

Captions reproduce the reference's word-highlight semantics
(``animation.py:179-231``), drawn with PIL (imported when a caption is
drawn) on a strip below the panels.  Writers: animated GIF by the
library's encoder, mp4 through an ffmpeg rawvideo pipe where the binary
exists, MJPEG + PCM AVI (``aviwriter.py``, PIL).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from mixstage_tpu_torch import hostlib

SOURCE = Path(__file__).resolve().parent / "raster.cpp"
BUILD_DIR = hostlib.BUILD_DIR
# the JAX package's native/Makefile flags, and no contraction of a * b + c
# into one FMA (GCC contracts by default where -march=native has FMA), so
# that the library rounds as its numpy plain version does
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread", "-ffp-contract=off"]
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()   # save_animation renders on a thread pool

# matplotlib's default prop cycle (tab10): the reference gives bone i the
# cycle colour i % 10 through repeated ax.plot calls
_TAB10_HEX = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
              "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]
TAB10_RGB = np.array([[int(h[1:3], 16), int(h[3:5], 16), int(h[5:7], 16)]
                      for h in _TAB10_HEX], np.uint8)

# matplotlib linewidths are points at the figure's dpi (100): 1 pt = dpi/72
# px.  Body bones (the first 9) taper 1 → 3 → 1 pt, fingers stay 1 pt.
_DPI = 100.0
_PT = _DPI / 72.0
MIN_W_PX = 1.0 * _PT
PEAK_W_PX = 3.0 * _PT
N_BODY_BONES = 9


def library_path() -> Path:
    """Where the library lives: named by a hash of the source, the flags
    and the host CPU's features (``hostlib.library_path``)."""
    return hostlib.library_path(SOURCE, CXX_FLAGS, "libraster", BUILD_DIR)


def build(force: bool = False) -> Path:
    """Compile ``raster.cpp`` with g++ (reused when a library of the same
    source exists, unless ``force``); raises ``RuntimeError`` with the
    compiler's log when it fails."""
    return hostlib.build(SOURCE, CXX_FLAGS, "libraster", BUILD_DIR, force)


def get_lib() -> ctypes.CDLL:
    """The rasteriser library, built and loaded at first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.rasterize_poses.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p,
                u8p, f32p, ctypes.c_float, ctypes.c_int64, ctypes.c_float,
                ctypes.c_int64, u8p]
            lib.rasterize_poses.restype = None
            lib.encode_gif.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, u8p, u8p, ctypes.c_int64]
            lib.encode_gif.restype = ctypes.c_int64
            _lib = lib
    return _lib


def bone_colors(n_bones: int) -> np.ndarray:
    return TAB10_RGB[np.arange(n_bones) % len(TAB10_RGB)]


def bone_peak_widths(n_bones: int, scale: float = 1.0) -> np.ndarray:
    w = np.full(n_bones, MIN_W_PX * scale, np.float32)
    w[:N_BODY_BONES] = PEAK_W_PX * scale
    return w


def _stack(ys, parents):
    """(P, T, 2, J) float32 poses (T the shortest panel's), int32 parents."""
    if not isinstance(ys, (list, tuple)):
        ys = [ys]
    T = min(int(y.shape[0]) for y in ys)
    stack = np.ascontiguousarray(
        np.stack([np.asarray(y)[:T] for y in ys]), np.float32)
    parents = np.ascontiguousarray(parents, np.int32)
    if parents.shape != (stack.shape[-1],):
        raise ValueError(f"parents has {parents.shape[0]} entries for "
                         f"{stack.shape[-1]}-joint poses")
    return stack, parents


def rasterize_plain(ys, parents, panel: int = 480,
                    world_half: float = 500.0) -> np.ndarray:
    """``rasterize`` in numpy, the same math as ``raster.cpp`` (each bone's
    coverage, per-bone uint8 blending): the library's plain version."""
    stack, parents = _stack(ys, parents)
    P, T, _, J = stack.shape
    colors = bone_colors(J - 1)
    peak_w = bone_peak_widths(J - 1)
    min_w = float(MIN_W_PX)
    scale = panel / (2.0 * world_half)
    out = np.full((T, panel, P * panel, 3), 255, np.uint8)
    for p in range(P):
        for t in range(T):
            img = out[t]
            for j in range(1, J):
                par = int(parents[j])
                if par < 0:
                    continue
                if not np.isfinite(stack[p, t, :, [par, j]]).all():
                    continue                 # the library's guard
                x0 = (stack[p, t, 0, par] + world_half) * scale
                y0 = (stack[p, t, 1, par] + world_half) * scale
                x1 = (stack[p, t, 0, j] + world_half) * scale
                y1 = (stack[p, t, 1, j] + world_half) * scale
                half_min = 0.5 * min_w
                half_peak = 0.5 * max(peak_w[j - 1], min_w)
                rmax = half_peak + 1.0
                c0 = max(int(np.floor(min(x0, x1) - rmax)), 0)
                c1 = min(int(np.ceil(max(x0, x1) + rmax)), panel - 1)
                r0 = max(int(np.floor(min(y0, y1) - rmax)), 0)
                r1 = min(int(np.ceil(max(y0, y1) + rmax)), panel - 1)
                if c1 < c0 or r1 < r0:
                    continue
                cc, rr = np.meshgrid(np.arange(c0, c1 + 1, dtype=np.float32),
                                     np.arange(r0, r1 + 1, dtype=np.float32))
                px, py = cc + 0.5, rr + 0.5
                dx, dy = x1 - x0, y1 - y0
                len2 = dx * dx + dy * dy
                tt = (((px - x0) * dx + (py - y0) * dy) / len2
                      if len2 > 0 else np.zeros_like(px))
                tt = np.clip(tt, 0.0, 1.0)
                qx, qy = x0 + tt * dx - px, y0 + tt * dy - py
                d = np.sqrt(qx * qx + qy * qy)
                radius = half_min + (half_peak - half_min) * \
                    (1.0 - np.abs(2.0 * tt - 1.0))
                a = np.clip(radius - d + 0.5, 0.0, 1.0)[..., None]
                rgb = colors[j - 1].astype(np.float32)
                col_off = p * panel
                region = img[r0:r1 + 1, col_off + c0:col_off + c1 + 1]
                region[:] = np.floor(
                    region.astype(np.float32) * (1.0 - a) + rgb * a + 0.5
                ).astype(np.uint8)
    return out


def rasterize(ys, parents, panel: int = 480, world_half: float = 500.0,
              n_threads: Optional[int] = None) -> np.ndarray:
    """Render pose sequence(s) to an RGB frame stack with the library.

    ys: (T, 2, J) array or a list of them (side-by-side panels).
    Returns (T, panel, P*panel, 3) uint8.
    """
    stack, parents = _stack(ys, parents)
    P, T, _, J = stack.shape
    colors = np.ascontiguousarray(bone_colors(J - 1))
    peak_w = np.ascontiguousarray(bone_peak_widths(J - 1), np.float32)
    out = np.empty((T, panel, P * panel, 3), np.uint8)
    nt = n_threads if n_threads is not None else (os.cpu_count() or 1)
    get_lib().rasterize_poses(stack, P, T, J, parents, colors, peak_w,
                              ctypes.c_float(MIN_W_PX), panel,
                              ctypes.c_float(world_half), nt, out)
    return out


# ---------------------------------------------------------------- captions

CAPTION_H = 28


class CaptionOverlay:
    """Stateful caption strip with the reference's word-highlight state
    machine (``animation.py:179-231``): the caption line advances, at most
    one line a frame, when the frame passes the line's last ``end_frame``;
    the first word whose ``end_frame`` is still ahead is highlighted.  The
    state lets long clips stream through in chunks: call ``apply`` on
    consecutive frame ranges.  ``text`` is a ``text/meta`` ``Table``."""

    def __init__(self, text, max_length: int = 27):
        from PIL import ImageFont

        from mixstage_tpu_torch.animation.animation import split_text

        self.subs = split_text(text, max_length=max_length)
        self.idx = 0
        self.end_frame = (float(self.subs[0]["end_frame"][-1])
                          if self.subs else 0.0)
        try:
            self.font = ImageFont.load_default(size=16)
        except TypeError:  # older Pillow: a fixed-size bitmap font
            self.font = ImageFont.load_default()
        self.char_w = (max(1, int(self.font.getbbox("M")[2]
                                  - self.font.getbbox("M")[0]))
                       if hasattr(self.font, "getbbox") else 8)

    def apply(self, frames: np.ndarray, frame_offset: int = 0) -> np.ndarray:
        from PIL import Image, ImageDraw

        T, H, W, _ = frames.shape
        out = np.full((T, H + CAPTION_H, W, 3), 255, np.uint8)
        out[:, :H] = frames
        if not self.subs:
            return out
        for i in range(T):
            frame = frame_offset + i
            if frame >= self.end_frame and self.idx + 1 < len(self.subs):
                self.idx += 1
                self.end_frame = float(self.subs[self.idx]["end_frame"][-1])
            sub = self.subs[self.idx]
            words = [str(w) for w in sub["Word"]]
            ahead = np.flatnonzero(frame < np.asarray(sub["end_frame"],
                                                      np.float64))
            current = int(ahead[0]) if len(ahead) else 0
            strip = Image.fromarray(out[i, H:])
            draw = ImageDraw.Draw(strip)
            x0 = 4
            for wi, word in enumerate(words):
                color = (214, 39, 40) if wi == current else (0, 0, 0)
                draw.text((x0, 4), word, fill=color, font=self.font)
                x0 += (len(word) + 1) * self.char_w
            out[i, H:] = np.asarray(strip)
        return out


def overlay_captions(frames: np.ndarray, text, max_length: int = 27
                     ) -> np.ndarray:
    """One-shot caption strip (``CaptionOverlay`` streams)."""
    overlay = CaptionOverlay(text, max_length=max_length)
    return overlay.apply(frames) if overlay.subs else frames


# ----------------------------------------------------------------- writers

def gif_palette() -> np.ndarray:
    """The colours the rasteriser draws: white, each tab10 bone colour at
    16 alpha levels over white (the anti-aliasing ramp), and 16 black
    levels (caption text).  (177, 3) uint8, index 0 white."""
    levels = np.arange(1, 17, dtype=np.float32)[:, None] / 16.0
    ramps = [np.array([[255, 255, 255]], np.float32)]
    for rgb in np.concatenate([TAB10_RGB, [[0, 0, 0]]]).astype(np.float32):
        ramps.append(255.0 * (1.0 - levels) + rgb[None, :] * levels)
    return np.ascontiguousarray(
        np.floor(np.concatenate(ramps) + 0.5).astype(np.uint8))


def encode_gif(frames: np.ndarray, delay_cs: int, write_header: bool = True,
               prev: Optional[np.ndarray] = None) -> bytes:
    """The library's GIF encoding of ``frames`` (T, H, W, 3) uint8, without
    the trailer: the header when ``write_header``, then each frame, delta
    encoded against its predecessor (``prev`` for the first, when given)."""
    lib = get_lib()
    frames = np.ascontiguousarray(frames, np.uint8)
    pal = gif_palette()
    T, H, W, _ = frames.shape
    ref = np.ascontiguousarray(prev if prev is not None else frames[0])
    cap = T * H * W // 2 + T * 4096 + (1 << 14)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.encode_gif(frames, T, H, W, pal, len(pal), delay_cs,
                           int(write_header), int(prev is not None), ref,
                           out, cap)
        if n >= 0:
            return out[:n].tobytes()
        if cap >= 2 * T * H * W + (1 << 16):
            raise RuntimeError("gif encode buffer overflow")
        cap *= 2


class GifWriter:
    """Streaming GIF writer over the library's encoder: each ``add`` chunk
    is encoded and written, so memory stays bounded by the chunk."""

    def __init__(self, path: str, fps: int):
        self.path = path
        self.fps = fps
        self.delay_cs = max(2, int(round(100.0 / fps)))
        get_lib()                               # build before opening
        self._file = open(path, "wb")
        self._prev: Optional[np.ndarray] = None  # delta-encode across chunks

    def add(self, frames: np.ndarray) -> None:
        frames = np.ascontiguousarray(frames, np.uint8)
        self._file.write(encode_gif(frames, self.delay_cs,
                                    write_header=self._prev is None,
                                    prev=self._prev))
        self._prev = frames[-1].copy()

    def close(self) -> None:
        self._file.write(b"\x3B")  # GIF trailer
        self._file.close()


class Mp4Writer:
    """Streaming rawvideo pipe into ffmpeg (no intermediate PNGs)."""

    def __init__(self, path: str, fps: int, bitrate: int = 1000):
        self.path = path
        self.fps = fps
        self.bitrate = bitrate
        self.proc = None

    def add(self, frames: np.ndarray) -> None:
        frames = np.ascontiguousarray(frames, np.uint8)
        if self.proc is None:
            _, H, W, _ = frames.shape
            cmd = ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                   "-s", f"{W}x{H}", "-r", str(self.fps), "-i", "-",
                   "-pix_fmt", "yuv420p", "-b:v", f"{self.bitrate}k",
                   self.path]
            self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                         stdout=subprocess.DEVNULL,
                                         stderr=subprocess.DEVNULL)
        self.proc.stdin.write(frames.tobytes())

    def close(self) -> None:
        if self.proc is None:
            return
        self.proc.stdin.close()
        if self.proc.wait() != 0:
            raise RuntimeError(f"ffmpeg rawvideo encode failed for {self.path}")


def write_gif(frames: np.ndarray, path: str, fps: int) -> None:
    writer = GifWriter(path, fps)
    writer.add(frames)
    writer.close()


def write_mp4(frames: np.ndarray, path: str, fps: int,
              bitrate: int = 1000) -> None:
    writer = Mp4Writer(path, fps, bitrate)
    writer.add(frames)
    writer.close()


def render_to_file(ys, parents, filename: str, text=None, fps: int = 15,
                   bitrate: int = 1000, panel: int = 480,
                   world_half: float = 500.0, chunk_frames: int = 64,
                   audio=None) -> str:
    """Rasterise, caption and encode one clip (GIF, mp4 or MJPEG AVI by
    extension), ``chunk_frames`` at a time: a 375-frame prediction beside
    ground truth at 480 px is ~0.5 GB as one stack.  ``audio`` is an
    optional ``(int16_pcm, sample_rate)`` pair muxed into ``.avi``
    output (``aviwriter.py``)."""
    if not isinstance(ys, (list, tuple)):
        ys = [ys]
    T = min(int(y.shape[0]) for y in ys)
    captions = (CaptionOverlay(text)
                if text is not None and len(text) else None)
    if filename.endswith(".mp4"):
        writer = Mp4Writer(filename, fps, bitrate)
    elif filename.endswith(".avi"):
        from mixstage_tpu_torch.animation.aviwriter import AviWriter

        writer = AviWriter(filename, fps)
        if audio is not None:
            writer.set_audio(audio[0], audio[1])
    else:
        writer = GifWriter(filename, fps)
    for t0 in range(0, T, chunk_frames):
        t1 = min(T, t0 + chunk_frames)
        frames = rasterize([np.asarray(y)[t0:t1] for y in ys], parents,
                           panel=panel, world_half=world_half)
        if captions is not None:
            frames = captions.apply(frames, frame_offset=t0)
        writer.add(frames)
    writer.close()
    return filename


def decode_gif(data: bytes) -> List[np.ndarray]:
    """The frames of a GIF89a stream as (H, W, 3) uint8 arrays, composited
    as a viewer shows them (each sub-rectangle over the previous frame,
    the transparent index keeping it): a small reader of what
    ``encode_gif`` writes (a global colour table, no local tables, no
    interlace), for checks on a machine without PIL."""
    pos = 0

    def take(n):
        nonlocal pos
        out = data[pos:pos + n]
        if len(out) != n:
            raise ValueError("truncated GIF")
        pos += n
        return out

    def sub_blocks():
        out = bytearray()
        while True:
            n = take(1)[0]
            if n == 0:
                return bytes(out)
            out += take(n)

    if take(6) not in (b"GIF89a", b"GIF87a"):
        raise ValueError("not a GIF")
    W, H = int.from_bytes(take(2), "little"), int.from_bytes(take(2), "little")
    flags = take(3)[0]
    if not flags & 0x80:
        raise ValueError("GIF without a global colour table")
    palette = np.frombuffer(take(3 * (2 << (flags & 7))),
                            np.uint8).reshape(-1, 3)
    canvas = np.zeros((H, W, 3), np.uint8)
    frames: List[np.ndarray] = []
    transparent = None
    while True:
        block = take(1)[0]
        if block == 0x3B:
            return frames
        if block == 0x21:                      # an extension
            label = take(1)[0]
            body = sub_blocks()
            if label == 0xF9:                  # graphic control
                transparent = body[3] if body[0] & 1 else None
            continue
        if block != 0x2C:
            raise ValueError(f"GIF block 0x{block:02x}")
        x, y, w, h = (int.from_bytes(take(2), "little") for _ in range(4))
        if take(1)[0] & 0xC0:
            raise ValueError("local colour tables and interlace are not read")
        min_size = take(1)[0]
        idx = _lzw_decode(sub_blocks(), min_size, w * h).reshape(h, w)
        draw = idx != transparent if transparent is not None else \
            np.ones_like(idx, bool)
        region = canvas[y:y + h, x:x + w]
        region[draw] = palette[idx[draw]]
        frames.append(canvas.copy())


def _lzw_decode(payload: bytes, min_size: int, n: int) -> np.ndarray:
    """GIF's variable-width LZW, least significant bit first."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    table: List[bytes] = []
    size = min_size + 1
    prev: Optional[bytes] = None
    acc = nacc = 0
    for byte in payload:
        acc |= byte << nacc
        nacc += 8
        while nacc >= size:
            code = acc & ((1 << size) - 1)
            acc >>= size
            nacc -= size
            if code == clear:
                table = [bytes([i]) for i in range(clear)] + [b"", b""]
                size, prev = min_size + 1, None
                continue
            if code == end:
                return _pixels(out, n)
            if prev is None:
                entry = table[code]
            else:
                entry = table[code] if code < len(table) else prev + prev[:1]
                if len(table) < 4096:
                    table.append(prev + entry[:1])
            out += entry
            prev = entry
            if len(table) == (1 << size) and size < 12:
                size += 1
    return _pixels(out, n)


def _pixels(out: bytearray, n: int) -> np.ndarray:
    if len(out) < n:
        raise ValueError(f"LZW stream holds {len(out)} of {n} pixels")
    return np.frombuffer(bytes(out[:n]), np.uint8)
