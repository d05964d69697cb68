"""Build the port's CUDA kernels from the repo's sources, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds, not minutes).  Libraries land in
``build/torch_kernels/`` at the repo root, named by a hash of the source and
flags, so an edited source never loads a stale library.  Importing this
module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = {"fused_decoder": CSRC / "fused_decoder.cu",
           "train_decoder": CSRC / "train_decoder.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise FileNotFoundError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """Where the library of kernel source ``name`` lives."""
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def start_build(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    """Start ``nvcc`` on source ``name``; finish it with ``finish_build``."""
    target = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def finish_build(name: str, target: Path, tmp: Path,
                 proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)      # atomic: a concurrent loader sees all or none
    return log


def build_all(force: bool = False) -> Dict[str, Tuple[float, str]]:
    """Compile every kernel source, one ``nvcc`` per source, all started
    together.  Returns {name: (seconds, compiler log)}; a library already
    built from the same source is reused unless ``force``."""
    t0 = time.perf_counter()
    started = {name: start_build(name) for name in SOURCES
               if force or not library_path(name).exists()}
    out = {name: (0.0, "cached: " + str(library_path(name)))
           for name in SOURCES if name not in started}
    for name, job in started.items():
        log = finish_build(name, *job)
        out[name] = (time.perf_counter() - t0, log)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, building it first if
    needed (once per process)."""
    with _lock:
        if name not in _libs:
            target = library_path(name)
            if not target.exists():
                finish_build(name, *start_build(name))
            _libs[name] = ctypes.CDLL(str(target))
        return _libs[name]
