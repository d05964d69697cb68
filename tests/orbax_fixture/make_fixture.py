"""Write ``ocdbt/``, an orbax checkpoint directory in orbax's default
(OCDBT) layout, and ``checksums.json`` beside it: the SHA-256 of each
array's bytes (C order, little-endian), its dtype and shape, keyed by its
dotted key path.

The tree is seeded and shaped like the JAX package's ``-ckpt_backend
orbax`` checkpoint (``{"model": ..., "train": ...}``, an optax-like
nesting of tuples, named tuples and empty states), with arrays below and
above the inline-value limit (1024 bytes), a bfloat16 moment and scalar
counters.  ``chip_smoke.py`` phase 26 and
``tests/test_torch_port_orbax.py`` read it with ``interop/orbax.py`` and
hold every array to its checksum.  Needs JAX, orbax and ml_dtypes:

    JAX_PLATFORMS=cpu python tests/orbax_fixture/make_fixture.py
"""

import hashlib
import json
import os
import shutil
from collections import namedtuple
from pathlib import Path

import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp

HERE = Path(__file__).resolve().parent
Adam = namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
Empty = namedtuple("EmptyState", [])


def tree(rng):
    def conv(cin, cout, k=3):
        return {"conv": {"kernel": rng.normal(size=(k, cin, cout)).astype(
                             np.float32),
                         "bias": rng.normal(size=(cout,)).astype(np.float32)},
                "norm": {"scale": rng.normal(size=(cout,)).astype(np.float32),
                         "bias": np.zeros((cout,), np.float32)}}
    params = {"decoder0": conv(64, 64), "logits": conv(64, 8, 1),
              "style_emb": {"embedding": rng.normal(size=(4, 8)).astype(
                  np.float32)}}
    stats = {"decoder0": {"norm": {"mean": rng.normal(size=(64,)).astype(
        np.float32), "var": rng.random(64).astype(np.float32) + 0.5}}}
    mu = {k: {"conv": {n: (v * 1e-3).astype(ml_dtypes.bfloat16)
                       for n, v in m["conv"].items()}}
          for k, m in params.items() if "conv" in m}
    nu = {k: {"conv": {n: np.square(v) * 1e-6 for n, v in m["conv"].items()}}
          for k, m in params.items() if "conv" in m}
    opt = (Empty(), (Adam(np.asarray(5, np.int32), mu, nu),
                     Empty()))
    return {"model": {"g_params": {"gen": params}, "g_state": {"gen": stats},
                      "d_params": {}, "d_state": {}},
            "train": {"g_opt_state": opt, "d_opt_state": {},
                      "counters": {k: np.asarray(v, np.int32) for k, v in (
                          ("step", 9), ("g_step", 5), ("lambda_step", 3),
                          ("curriculum_step", 2))}}}


def leaves(t, path=()):
    if hasattr(t, "_fields"):
        t = {f: getattr(t, f) for f in t._fields}
    if isinstance(t, dict):
        for k, v in t.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(t, tuple):
        for i, v in enumerate(t):
            yield from leaves(v, path + (str(i),))
    elif t is not None:
        yield ".".join(path), np.asarray(t)


def main():
    out = HERE / "ocdbt"
    shutil.rmtree(out, ignore_errors=True)
    t = tree(np.random.default_rng(2020))
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(out), t)
    sums = {name: {"sha256": hashlib.sha256(np.ascontiguousarray(
                       a).tobytes()).hexdigest(),
                   "dtype": str(a.dtype), "shape": list(a.shape)}
            for name, a in leaves(t)}
    (HERE / "checksums.json").write_text(json.dumps(sums, indent=1,
                                                    sort_keys=True) + "\n")
    print(f"{len(sums)} arrays, "
          f"{sum(f.stat().st_size for f in out.rglob('*') if f.is_file())} "
          f"bytes in {out}")


if __name__ == "__main__":
    main()
