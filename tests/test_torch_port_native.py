"""The port's C++ window gatherer (``data/batcher.cpp`` through
``data/native.py``) against its numpy versions and the JAX package's
``mixstage_tpu/data/native.py``.

Inputs are drawn from numpy seeds; every comparison is bit for bit (the
same float64 arithmetic in the same order: no tolerance).  The JAX
package's ``znorm_*`` are held through its own library (its numpy path
divides by ``std`` where the C code multiplies by ``1 / std``, which
rounds differently).  ``DataLoader.iter_all`` gathers through the library
(``test_torch_port_data.py`` holds its batches to JAX's); a compiler that
fails raises with its log.
"""

import numpy as np
import pytest

from mixstage_tpu.data import native as jnative
from mixstage_tpu_torch.data import dataset as pds
from mixstage_tpu_torch.data import native as pnative

GATHER = {  # rows, cols, starts, steps, stride
    "pose": (500, 104, [0, 17, 100, 380], 64, 1),
    "strided": (4000, 128, [0, 6, 1200, 3500], 64, 6),
    "clamped": (70, 8, [0, 50, 69], 32, 2),          # past the last row
    "one_window": (64, 3, [0], 64, 1),
    "bs32x64": (2000, 104, list(range(0, 1920, 60)), 64, 1),
}


def _gather_inputs(case, seed=0):
    rows, cols, starts, steps, stride = GATHER[case]
    data = np.random.default_rng(seed).normal(size=(rows, cols))
    return data, np.asarray(starts, np.int64), steps, stride


@pytest.mark.parametrize("case", sorted(GATHER))
def test_gather_windows_equals_numpy_and_jax(case):
    data, starts, steps, stride = _gather_inputs(case)
    got = pnative.gather_windows(data, starts, steps, stride)
    assert got.shape == (len(starts), steps, data.shape[1])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(
        got, pnative.gather_windows_plain(data, starts, steps, stride))
    np.testing.assert_array_equal(
        got, jnative.gather_windows(data, starts, steps, stride))


def _stats(rng, feats, degenerate):
    mean = rng.normal(size=(feats,))
    var = np.abs(rng.normal(size=(feats,))) + 0.1
    if degenerate:                       # std 0 → eps; a negative var → 0
        var[[1, 5]] = 0.0
        var[7] = -0.5
    return mean, var


@pytest.mark.parametrize("degenerate", [False, True],
                         ids=["stats", "zero_and_negative_var"])
@pytest.mark.parametrize("mask", [[0, 7, 8, 9], [], [51]],
                         ids=["mask4", "no_mask", "last"])
def test_znorm_mask_equals_numpy_and_jax(mask, degenerate):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 64, 104)) * 30
    mean, var = _stats(rng, 104, degenerate)
    got = pnative.znorm_mask(x, mean, var, mask)
    assert got.dtype == np.float32 and got.shape == (4, 64,
                                                     2 * (52 - len(mask)))
    np.testing.assert_array_equal(
        got, pnative.znorm_mask_plain(x, mean, var, mask))
    assert jnative.get_lib() is not None
    np.testing.assert_array_equal(got, jnative.znorm_mask(x, mean, var,
                                                          mask))


@pytest.mark.parametrize("degenerate", [False, True],
                         ids=["stats", "zero_and_negative_var"])
def test_znorm_f32_equals_numpy_and_jax(degenerate):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 64, 128))
    mean, var = _stats(rng, 128, degenerate)
    got = pnative.znorm_f32(x, mean, var)
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, pnative.znorm_f32_plain(x, mean,
                                                               var))
    assert jnative.get_lib() is not None
    np.testing.assert_array_equal(got, jnative.znorm_f32(x, mean, var))
    # the JAX package's numpy path divides: within one float32 rounding
    np.testing.assert_allclose(
        got, ((x - mean) / np.where(var > 0, np.sqrt(np.maximum(var, 0)),
                                    1e-8)).astype(np.float32), rtol=1e-6)


def test_iter_all_gathers_through_the_library(monkeypatch, tmp_path):
    """The loader's bulk path calls the library, and its batches equal a
    numpy gather of the same windows."""
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(str(tmp_path), ["oliver"], 2)
    from mixstage_tpu_torch.data.dataset import Data

    data = Data(str(tmp_path), ["oliver"], batch_size=4, window_hop=5)
    calls = []
    real = pds.gather_windows

    def counted(*a):
        calls.append(a[1:])
        return real(*a)
    monkeypatch.setattr(pds, "gather_windows", counted)
    batches = list(data.train.iter_all(batch_size=8))
    assert calls and batches
    monkeypatch.setattr(pds, "gather_windows",
                        pnative.gather_windows_plain)
    for a, b in zip(batches, data.train.iter_all(batch_size=8)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "batcher.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed for .*batcher.cpp") as e:
        pnative.build()
    assert "error" in str(e.value)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        pnative.build(force=True)


def test_library_is_named_by_source_flags_and_host():
    path = pnative.build()
    assert path.parent == pnative.BUILD_DIR
    assert path.name.startswith("libbatcher_") and path.suffix == ".so"
    assert path == pnative.build()               # reused, not rebuilt
