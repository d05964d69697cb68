"""The port's flax msgpack reader and writer (``interop/flax_msgpack.py``)
against ``flax.serialization`` on the same trees.

Trees are drawn by hypothesis: nested maps of numpy arrays (float32,
float64, bfloat16, int32, int64, uint8, bool; 0-d, empty and up to 3-d,
values from a seeded numpy generator), numpy scalars and Python scalars.
The reader must return flax's ``msgpack_restore`` tree leaf for leaf,
bit for bit (a bfloat16 leaf as a ``torch.bfloat16`` tensor of the same
bits), and ``packb`` must write ``msgpack_serialize``'s bytes exactly.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mixstage_tpu_torch.interop import flax_msgpack as fm

DTYPES = [np.float32, np.float64, ml_dtypes.bfloat16, np.int32, np.int64,
          np.uint8, np.bool_]
KEYS = st.text(alphabet="abcdefghij_0123456789", min_size=1, max_size=10)


@st.composite
def arrays(draw):
    dtype = draw(st.sampled_from(DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 31)))
    values = np.asarray(rng.normal(size=shape) * 100)   # 0-d: an array
    if dtype == np.bool_:
        return values > 0
    return values.astype(dtype)


SCALARS = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=False),
    st.booleans(), st.none(), KEYS,
    st.integers(-2 ** 63, 2 ** 63 - 1).map(np.int64),
    st.floats(width=32, allow_nan=False).map(np.float32))
TREES = st.recursive(st.one_of(arrays(), SCALARS),
                     lambda children: st.dictionaries(KEYS, children,
                                                      max_size=5),
                     max_leaves=12)


def _port_leaves(tree):
    """The tree as the port hands it to ``packb``: bfloat16 arrays as
    ``torch.bfloat16`` tensors of the same bits."""
    if isinstance(tree, dict):
        return {k: _port_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return tree


def _assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=TREES)
def test_reader_matches_msgpack_restore(tree):
    blob = serialization.msgpack_serialize(tree)
    _assert_same(fm.unpackb(blob), serialization.msgpack_restore(blob))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=TREES)
def test_packb_writes_flax_bytes(tree):
    assert fm.packb(_port_leaves(tree)) == \
        serialization.msgpack_serialize(tree)


def _checkpoint_tree():
    rng = np.random.default_rng(0)
    return {
        "g_params": {"gen": {"conv": {
            "kernel": rng.normal(size=(3, 4, 5)).astype(np.float32),
            "bias": np.zeros(5, np.float32)}}},
        "g_state": {"gen": {"norm": {"mean": np.zeros(5, np.float32),
                                     "var": np.ones(5, np.float32)}}},
        "d_params": {}, "d_state": {},
        "counters": {"step": np.array(7, np.int32),
                     "big": np.int64(2 ** 40)},
        "mu": {"w": rng.normal(size=(6,)).astype(ml_dtypes.bfloat16)},
        "empty": np.zeros((0, 3), np.float32),
        "complex": 1.5 - 2.0j}


def test_checkpoint_shaped_tree_round_trips():
    """A checkpoint-shaped tree: empty D maps, int32 and int64 counters, a
    bf16 moment, an empty array and a native complex, both ways."""
    tree = _checkpoint_tree()
    blob = serialization.msgpack_serialize(tree)
    assert fm.packb(_port_leaves(tree)) == blob
    got = fm.unpackb(blob)
    _assert_same(got, serialization.msgpack_restore(blob))
    assert fm.packb(got) == blob


@pytest.mark.parametrize("chunk", [8, 64])
def test_chunked_leaves(monkeypatch, chunk):
    """Arrays over ``MAX_CHUNK_SIZE`` bytes are written as flax's chunked
    leaves (in flax's key order: the chunk map is made after the sorted
    copy) and rejoined on reading; the limit is lowered in both packages
    so a small tree crosses it."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(1)
    tree = {"b": {"w": rng.normal(size=(5, 7)).astype(np.float32)},
            "a": rng.normal(size=(45,)).astype(ml_dtypes.bfloat16),
            "small": np.arange(2, dtype=np.int32)}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    assert fm.packb(_port_leaves(tree)) == blob
    _assert_same(fm.unpackb(blob), serialization.msgpack_restore(blob))


@pytest.mark.parametrize("blob, match", [
    (b"\x84\xa8g_params\x80", "truncated"),      # a map of 4 cut after 1
    (b"\x81\xa1a\x01\x00", "after the object"),
    (b"\x81\xa1a\xc1", "not in flax's msgpack subset"),
    (b"\x81\xa1a\xd4\x07\x00", "ext type 7"),
    (b"\x81\x01\x02", "map key"),
])
def test_malformed_bytes_raise(blob, match):
    with pytest.raises(ValueError, match=match):
        fm.unpackb(blob)


def test_bfloat16_scalar_reads_as_0d_tensor():
    """A numpy bfloat16 scalar (flax's ext 3) reads as a 0-d
    ``torch.bfloat16`` tensor of its bits."""
    blob = serialization.msgpack_serialize({"s": ml_dtypes.bfloat16(1.5)})
    got = fm.unpackb(blob)["s"]
    assert torch.is_tensor(got) and got.dtype == torch.bfloat16
    assert got.shape == () and float(got) == 1.5


def test_is_flax_msgpack_tells_torch_files_apart(tmp_path):
    blob = serialization.msgpack_serialize(_checkpoint_tree())
    assert fm.is_flax_msgpack(blob[:1])
    path = tmp_path / "w.p"
    torch.save({"gen": {}}, path)
    assert not fm.is_flax_msgpack(path.read_bytes()[:1])
    assert not fm.is_flax_msgpack(b"")
