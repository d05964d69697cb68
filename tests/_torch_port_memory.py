"""A module-scoped fixture that hands memory back after a test module.

The suite's workers run side by side with a test that compiles the
scanned GAN step of the JAX package in about 38 GB
(``tests/test_e2e.py::test_scan_steps_training``), and each worker keeps
the heap its earlier modules grew: JAX's compiled programs and the
allocator's free but unreturned pages (1.2-1.6 GB after a trainer test).
A test module takes the fixture by importing it:
``from _torch_port_memory import release_memory  # noqa: F401``.
"""

import ctypes
import gc

import pytest


@pytest.fixture(scope="module", autouse=True)
def release_memory():
    yield
    gc.collect()
    import jax

    jax.clear_caches()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:             # not glibc
        pass
