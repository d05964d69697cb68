"""Host C++ libraries built by g++ at first use (the rasteriser
``animation/raster.cpp``, the window gatherer ``data/batcher.cpp``).

A library is compiled once into ``build/torch_kernels/`` under a name that
hashes its source, the flags and the host CPU's features (the flags carry
``-march=native``, so a library built on another CPU is not reused), and
loaded with ``ctypes``.  A failed build raises ``RuntimeError`` with the
compiler's log: the port has no quiet fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"


def host_tag() -> bytes:
    """The host CPU's feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.encode()
    except OSError:
        pass
    import platform

    return platform.processor().encode()


def library_path(source: Path, flags: Sequence[str], stem: str,
                 build_dir: Path = BUILD_DIR) -> Path:
    """``build_dir/<stem>_<hash>.so``: the hash covers the source, the
    flags and the host CPU's features."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(flags).encode()
                            + host_tag()).hexdigest()
    return Path(build_dir) / f"{stem}_{digest[:16]}.so"


def build(source: Path, flags: Sequence[str], stem: str,
          build_dir: Path = BUILD_DIR, force: bool = False) -> Path:
    """Compile ``source`` with g++ (``$CXX`` where set) into its
    ``library_path``, reused when it exists unless ``force``; raises
    ``RuntimeError`` with the compiler's log when it fails."""
    target = library_path(source, flags, stem, build_dir)
    if target.exists() and not force:
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx} to build {source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {source} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)     # atomic: a concurrent loader sees all or none
    return target
