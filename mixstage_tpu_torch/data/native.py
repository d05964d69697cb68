"""The host window gatherer: ``batcher.cpp`` through ``ctypes``.

The port's counterpart of ``mixstage_tpu/data/native.py``.  Three C
functions on contiguous buffers:

* ``gather_windows(data, starts, steps, stride)``: strided windows of one
  interval's (rows, cols) array → (n, steps, cols) float64, rows past the
  end clamped to the last (``DataLoader.iter_all``'s bulk path);
* ``znorm_mask(x, mean, var, mask)``: ZNorm and RemoveJoints fused, (n, t,
  2·J) float64 → (n, t, 2·(J - |mask|)) float32;
* ``znorm_f32(x, mean, var)``: ZNorm → float32 over the last axis.

ZNorm here is ``(x - mean) · (1 / std)`` in float64 with ``std =
sqrt(max(var, 0))`` and ``std = 0`` taken as ``eps``.

The library is built at first use by g++ with the JAX package's
``native/Makefile`` flags into ``build/torch_kernels/libbatcher_<hash>.so``
(``hostlib.py``).  A failed build raises ``RuntimeError`` with g++'s log,
where the JAX package falls back to numpy without a word.  The ``*_plain``
functions are the same arithmetic in numpy, the versions the tests and
``chip_smoke.py`` hold the library to, bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mixstage_tpu_torch import hostlib

SOURCE = Path(__file__).resolve().parent / "batcher.cpp"
BUILD_DIR = hostlib.BUILD_DIR
# mixstage_tpu/native/Makefile:2
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()    # prefetch workers can race the first build


def build(force: bool = False) -> Path:
    """Compile ``batcher.cpp`` (reused when built, unless ``force``);
    ``RuntimeError`` with the compiler's log when it fails."""
    return hostlib.build(SOURCE, CXX_FLAGS, "libbatcher", BUILD_DIR, force)


def get_lib() -> ctypes.CDLL:
    """The gatherer library, built and loaded at first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i64 = ctypes.c_int64
            lib.gather_windows.argtypes = [f64p, i64, i64, i64p, i64, i64,
                                           i64, f64p]
            lib.znorm_mask.argtypes = [f64p, i64, i64, i64, f64p, f64p, i64p,
                                       i64, ctypes.c_double, f32p]
            lib.znorm_f32.argtypes = [f64p, i64, i64, f64p, f64p,
                                      ctypes.c_double, f32p]
            for fn in (lib.gather_windows, lib.znorm_mask, lib.znorm_f32):
                fn.restype = None
            _lib = lib
    return _lib


def _gather_args(data, starts):
    return (np.ascontiguousarray(data, np.float64),
            np.ascontiguousarray(starts, np.int64).reshape(-1))


def gather_windows(data: np.ndarray, starts: Sequence[int], steps: int,
                   stride: int) -> np.ndarray:
    """(rows, cols) + n window starts → (n, steps, cols) float64:
    ``out[b, t] = data[min(starts[b] + t·stride, rows - 1)]``."""
    data, starts = _gather_args(data, starts)
    out = np.empty((len(starts), steps, data.shape[1]), np.float64)
    get_lib().gather_windows(data, data.shape[0], data.shape[1], starts,
                             len(starts), steps, stride, out)
    return out


def gather_windows_plain(data: np.ndarray, starts: Sequence[int],
                         steps: int, stride: int) -> np.ndarray:
    """``gather_windows`` in numpy."""
    data, starts = _gather_args(data, starts)
    idx = starts[:, None] + stride * np.arange(steps)[None, :]
    return data[np.minimum(idx, data.shape[0] - 1)]


def _stats(mean, var, feats: int):
    mean = np.ascontiguousarray(np.broadcast_to(mean, (feats,)), np.float64)
    var = np.ascontiguousarray(np.broadcast_to(var, (feats,)), np.float64)
    return mean, var


def _inv_std(var: np.ndarray, eps: float) -> np.ndarray:
    std = np.sqrt(np.where(var >= 0, var, 0.0))
    return 1.0 / np.where(std == 0, eps, std)


def _keep(joints: int, mask: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(sorted(set(range(joints)) - set(mask)),
                                np.int64)


def znorm_mask(x: np.ndarray, mean: np.ndarray, var: np.ndarray,
               mask: Sequence[int], eps: float = 1e-8) -> np.ndarray:
    """ZNorm then RemoveJoints: (n, t, 2·J) → (n, t, 2·(J - |mask|))
    float32, the kept joints' x plane then their y plane."""
    x = np.ascontiguousarray(x, np.float64)
    n, t, feats = x.shape
    keep = _keep(feats // 2, mask)
    mean, var = _stats(mean, var, feats)
    out = np.empty((n, t, 2 * len(keep)), np.float32)
    get_lib().znorm_mask(x, n, t, feats, mean, var, keep, len(keep), eps,
                         out)
    return out


def znorm_mask_plain(x: np.ndarray, mean: np.ndarray, var: np.ndarray,
                     mask: Sequence[int], eps: float = 1e-8) -> np.ndarray:
    """``znorm_mask`` in numpy."""
    x = np.ascontiguousarray(x, np.float64)
    n, t, feats = x.shape
    joints = feats // 2
    keep = _keep(joints, mask)
    mean, var = _stats(mean, var, feats)
    z = ((x - mean) * _inv_std(var, eps)).astype(np.float32)
    return z.reshape(n, t, 2, joints)[..., keep].reshape(n, t, -1)


def znorm_f32(x: np.ndarray, mean: np.ndarray, var: np.ndarray,
              eps: float = 1e-8) -> np.ndarray:
    """ZNorm to float32 over the last axis."""
    x = np.ascontiguousarray(x, np.float64)
    feats = x.shape[-1]
    outer = int(np.prod(x.shape[:-1]))
    mean, var = _stats(mean, var, feats)
    out = np.empty(x.shape, np.float32)
    get_lib().znorm_f32(x.reshape(outer, feats), outer, feats, mean, var,
                        eps, out.reshape(outer, feats))
    return out


def znorm_f32_plain(x: np.ndarray, mean: np.ndarray, var: np.ndarray,
                    eps: float = 1e-8) -> np.ndarray:
    """``znorm_f32`` in numpy."""
    x = np.ascontiguousarray(x, np.float64)
    mean, var = _stats(mean, var, x.shape[-1])
    return ((x - mean) * _inv_std(var, eps)).astype(np.float32)
