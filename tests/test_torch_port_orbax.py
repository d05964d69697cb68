"""Orbax checkpoint directories (``-ckpt_backend orbax``) between the JAX
package and the port: ``interop/orbax.py`` and ``BookKeeper``'s orbax
backend against the JAX package's ``BookKeeper._save_orbax`` /
``_load_orbax`` (orbax 0.11 through tensorstore).

One JAX experiment at the test sizes of ``test_torch_port_jax_checkpoint.py``
(2 speakers, 3 synthetic intervals each, ``in_channels`` 64, 2 clusters),
its state given the optimizer state of a run some steps in (seeded), saved
by the JAX ``BookKeeper`` with ``-ckpt_backend orbax -save_optim 1`` (the
OCDBT layout, zstd chunks) and, from the same state, as flax msgpack.
Held, every comparison bit for bit (no tolerance: the same bytes):

* the port's restore of JAX's directory (weights, Adam moments and counts,
  the four counters) equals JAX's state carried over by the bridge, and
  equals the port's restore of the msgpack files of the same state;
* a directory the port writes (the plain layout, no compression) restores
  in JAX's ``_load_orbax`` into the state it was written from, optimizer
  and counters included;
* the ``.old`` recovery, the sanitised directory name and its args file;
* ``cli.serve -load <JAX orbax directory>`` serves the restored model;
* a truncated manifest, node, data file or chunk, a flipped checksum byte
  and a missing ``_METADATA`` raise ``ValueError`` naming the file.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from mixstage_tpu.bookkeeping import BookKeeper as JaxBookKeeper
from mixstage_tpu.config import config_from_dict as jax_cfg
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu.train.trainer import Trainer as JaxTrainer
from mixstage_tpu_torch.bookkeeping import BookKeeper, read_checkpoint
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.interop import load_jax_train_state
from mixstage_tpu_torch.interop import orbax as porbax
from mixstage_tpu_torch.train.trainer import Trainer
from test_torch_port_jax_checkpoint import (_as_if_trained,
                                            _assert_equal_states, base)

SUB = ["exp", "cpk", "speaker", "model", "note"]


@pytest.fixture(scope="module")
def jexp(tmp_path_factory):
    """The JAX experiment saved as an orbax directory and as msgpack."""
    root = tmp_path_factory.mktemp("orbax")
    data = str(root / "data")
    make_synthetic_dataset(data, ["oliver", "maher"], 3)
    save = str(root / "jax")
    jt = JaxTrainer(jax_cfg(base(data, save_dir=save, save_optim=1,
                                 ckpt_backend="orbax")), SUB, {})
    jt.state = _as_if_trained(jt.state, np.random.default_rng(3))
    jt.book._save_model(jt.state)
    jt.book.args.ckpt_backend = "msgpack"
    jt.book._save_model(jt.state)           # PREFIX_weights.p + trainstate
    jt.book.args.ckpt_backend = "orbax"
    return dict(root=root, data=data, save=save, jt=jt,
                orbax=jt.book._orbax_path(),
                weights=jt.book.name("weights", "p", save))


def _port(jexp, load, save_dir=None, update=None, **kw):
    cfg = base(jexp["data"], save_dir=save_dir or jexp["save"], load=load,
               **kw)
    return Trainer(config_from_dict(cfg), SUB, update or {}, device="cpu")


def _flat(tree, path=()):
    """(path, leaf) of a JAX tree, named tuples and tuples by position."""
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flat(getattr(tree, f), path + (f,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    elif tree is not None:
        yield path, np.asarray(tree)


def test_jax_writes_ocdbt_which_the_reader_reads(jexp):
    """JAX's directory is OCDBT with zstd chunks; ``read_checkpoint``
    returns its whole tree, each array equal to orbax's own restore in
    value and dtype."""
    meta = json.loads(Path(jexp["orbax"], "_METADATA").read_text())
    assert meta["use_ocdbt"] and not meta["use_zarr3"]
    assert Path(jexp["orbax"], "manifest.ocdbt").read_bytes()[:4] == \
        bytes.fromhex("0cdb3a2a")
    kind, tree = read_checkpoint(jexp["orbax"])
    assert kind == "orbax" and sorted(tree) == ["model", "train"]
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        ref = ckptr.restore(jexp["orbax"])
    want = dict(_flat(ref))
    got = dict(_flat(tree))
    assert sorted(got) == sorted(want) and len(want) > 600
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_port_restores_jax_orbax_bit_for_bit(jexp):
    """``-load <JAX PREFIX_weights.orbax> -save_optim 1``: the weights,
    Adam moments and counts and the four counters equal JAX's state
    through the bridge, at JAX's step; the same state read from JAX's
    msgpack files is the same."""
    pt = _port(jexp, jexp["orbax"], save_optim=1)
    want = load_jax_train_state(pt.factory, jexp["jt"].state)
    _assert_equal_states(pt.state, want)
    assert (pt.state.step, pt.state.g_step, pt.state.lambda_step,
            pt.state.curriculum_step) == (9, 5, 3, 2)
    assert pt.state.g_opt.count == pt.state.d_opt.count == 5
    _assert_equal_states(pt.state,
                         _port(jexp, jexp["weights"], save_optim=1).state)


def test_without_save_optim_only_the_weights_load(jexp):
    """As JAX's ``_load_orbax``: without ``-save_optim`` the optimizer and
    the counters stay as initialised (the restored experiment's args say
    ``-save_optim 1``: the flag typed at the load overrides them)."""
    pt = _port(jexp, jexp["orbax"], update={"save_optim": 0})
    fresh = pt.factory.init(seed=0)
    assert pt.state.step == 0 and pt.state.g_opt.count == 0
    for t in pt.state.g_opt.slots()["mu"]:
        assert not t.any()
    want = load_jax_train_state(pt.factory, jexp["jt"].state)
    for a, b in zip(pt.state.gen.state_dict().values(),
                    want.gen.state_dict().values()):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        pt.state.gen.state_dict().values(), fresh.gen.state_dict().values()))


def test_jax_restores_what_the_port_writes(jexp, tmp_path):
    """The port's ``-ckpt_backend orbax`` directory (plain layout,
    ``"compressor": null``) restores in JAX's ``_load_orbax`` into the
    state it was written from: weights, optimizer states, counters."""
    jt = jexp["jt"]
    source = _as_if_trained(jt.state, np.random.default_rng(11))
    pt = _port(jexp, None, save_dir=str(tmp_path), ckpt_backend="orbax",
               save_optim=1)
    pt.state = load_jax_train_state(pt.factory, source)
    pt.book._save_model(pt.state)
    path = pt.book._orbax_path()
    meta = json.loads(Path(path, "_METADATA").read_text())
    assert meta["use_ocdbt"] is False
    assert not [p for p in os.listdir(tmp_path) if p.endswith((".tmp",
                                                               ".old"))]
    jbook = JaxBookKeeper(jax_cfg(base(jexp["data"], save_dir=str(tmp_path),
                                       save_optim=1)), SUB)
    restored = jbook._load_orbax(jt.state, path)
    want = dict(_flat(JaxBookKeeper._state_to_full_ckpt(source)))
    got = dict(_flat(JaxBookKeeper._state_to_full_ckpt(restored)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # and the port reads its own directory back
    back = _port(jexp, path, save_dir=str(tmp_path), save_optim=1)
    _assert_equal_states(back.state, pt.state)


def test_old_directory_is_recovered(jexp, tmp_path):
    """A crash between ``_save_orbax``'s two renames leaves only
    ``.old``: the experiment's own load renames it back and restores it;
    the sanitised name finds the experiment's args file."""
    pt = _port(jexp, None, save_dir=str(tmp_path), ckpt_backend="orbax",
               save_optim=1)
    pt.state = load_jax_train_state(pt.factory, jexp["jt"].state)
    pt.book._save_model(pt.state)
    path = pt.book._orbax_path()
    assert "[" not in path and "'" not in path and path.endswith(".orbax")
    os.rename(path, path + ".old")
    book = BookKeeper(pt.book.args, SUB)
    state = book._load_train_state(book._load_model(pt.factory.init(seed=4)))
    assert os.path.isdir(path) and not os.path.exists(path + ".old")
    _assert_equal_states(state, pt.state)
    restored = BookKeeper(config_from_dict(dict(load=path)), SUB)
    assert restored.args.ckpt_backend == "orbax"
    assert restored.args.exp == pt.book.args.exp


def test_cli_serve_loads_the_jax_orbax_directory(jexp):
    """``cli.serve -load <JAX orbax directory>``: the HTTP poses equal the
    serving function of the model restored from JAX's msgpack files."""
    from mixstage_tpu_torch.serve import build_serving_fn
    from test_torch_port_serve_cli import check_requests, serve, stop

    server, batchers, client = serve(["-load", jexp["orbax"], "-path2data",
                                      jexp["data"]])
    try:
        tr = Trainer(config_from_dict(dict(load=jexp["weights"],
                                           path2data=jexp["data"])),
                     SUB, {"window_hop": 0, "render": 0}, device="cpu")
        direct = build_serving_fn(tr.state.gen, device="cpu")
        assert check_requests(client, direct, 128) == 2
    finally:
        stop(server, batchers)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _truncate(path, keep=None):
    blob = Path(path).read_bytes()
    Path(path).write_bytes(blob[:len(blob) // 2 if keep is None else keep])
    return path


def _flip(path, at):
    blob = bytearray(Path(path).read_bytes())
    blob[at] ^= 0x40
    Path(path).write_bytes(bytes(blob))
    return path


def _largest(root, pattern):
    return max(Path(root).glob(pattern), key=lambda p: p.stat().st_size)


# each case breaks one file of a copy of a checkpoint and names it
BROKEN = {
    "manifest_truncated": ("jax", lambda d: _truncate(
        d / "manifest.ocdbt")),
    "manifest_checksum": ("jax", lambda d: _flip(d / "manifest.ocdbt", 20)),
    "node_truncated": ("jax", lambda d: _truncate(
        _largest(d, "d/*"))),
    "data_file_truncated": ("jax", lambda d: _truncate(
        _largest(d, "ocdbt.process_0/d/*"), 64)),
    "metadata_missing": ("jax", lambda d: (d / "_METADATA").unlink() or
                         d / "_METADATA"),
    "chunk_truncated": ("port", lambda d: _truncate(
        _largest(d, "*/0*"))),
    "zarray_malformed": ("port", lambda d: (
        _largest(d, "*/0*").parent / ".zarray").write_text("{") or
        (_largest(d, "*/0*").parent / ".zarray")),
}


@pytest.fixture(scope="module")
def port_dir(jexp, tmp_path_factory):
    save = tmp_path_factory.mktemp("port_orbax")
    pt = _port(jexp, None, save_dir=str(save), ckpt_backend="orbax")
    pt.book._save_model(pt.state)
    return pt.book._orbax_path()


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_malformed_directory_raises_naming_the_file(jexp, port_dir,
                                                    tmp_path, case):
    which, breaks = BROKEN[case]
    d = _copy(jexp["orbax"] if which == "jax" else port_dir,
              tmp_path / "x_weights.orbax")
    broken = breaks(d)
    with pytest.raises(ValueError) as e:
        read_checkpoint(str(d))
    assert os.path.basename(str(broken)) in str(e.value), str(e.value)


def test_crc32c_and_zstd_match_their_references():
    """The checksum on the standard check value and a random buffer; the
    libzstd binding against ``zstandard`` on frames with and without a
    stated size."""
    import zstandard

    assert porbax.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(0)
    data = rng.integers(0, 4, 300_000, dtype=np.uint8).tobytes()
    sized = zstandard.ZstdCompressor(level=1).compress(data)
    cobj = zstandard.ZstdCompressor(level=1).compressobj()
    streamed = cobj.compress(data) + cobj.flush()
    assert porbax.zstd_decompress(sized, None, "sized") == data
    assert porbax.zstd_decompress(streamed, None, "streamed") == data
    assert porbax.zstd_decompress(streamed, len(data), "streamed") == data
    with pytest.raises(ValueError, match="cut"):
        porbax.zstd_decompress(streamed[:len(streamed) // 2], None, "cut")


def test_cli_train_with_the_orbax_backend_equals_the_torch_backend(
        jexp, tmp_path):
    """``cli.train -ckpt_backend orbax -save_optim 1``, then its sampling
    pass from the directory: the same checkpointed weights, optimizer
    state, counters and sampled keypoints as the default backend's run
    with the same seed, bit for bit; no ``PREFIX_weights.p``."""
    import h5py

    from mixstage_tpu_torch.bookkeeping import optim_of, weights_of
    from mixstage_tpu_torch.cli import train as cli_train
    from test_torch_port_lifecycle import cfg

    runs = {}
    for backend in ("msgpack", "orbax"):
        save = tmp_path / backend
        kept = {}
        orig = Trainer.sample

        def keep(self, exp_num):
            orig(self, exp_num)
            kept["sampler"] = self
        Trainer.sample = keep
        try:
            cli_train.loop(cfg(jexp["data"], save, ckpt_backend=backend,
                               save_optim=1), 0, device="cpu")
        finally:
            Trainer.sample = orig
        runs[backend] = (save, kept["sampler"])
    (msave, mtr), (osave, otr) = runs["msgpack"], runs["orbax"]
    prefix = otr.book.name.prefix
    assert not (osave / f"{prefix}_weights.p").exists()
    assert Path(otr.book._orbax_path()).is_dir()
    _assert_equal_states(otr.state, mtr.state)
    book = BookKeeper(config_from_dict(dict(load=otr.book._orbax_path(),
                                            save_optim=1)), SUB)
    full = book._load_model(otr.state)
    assert optim_of(full)["counters"]["step"] > 0
    files = sorted((osave / prefix).rglob("*.h5"))
    assert len(files) == 12
    for f in files:
        with h5py.File(f) as a, h5py.File(msave / f.relative_to(osave)) as b:
            np.testing.assert_array_equal(a["pose/data"][()],
                                          b["pose/data"][()])
    assert weights_of(otr.state).keys() == weights_of(mtr.state).keys()


@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 1}],
                         ids=["raw", "zstd"])
def test_chunked_arrays_read_as_tensorstore_wrote_them(tmp_path, compressor):
    """Arrays of several chunks, edge chunks cut (what orbax writes for a
    large leaf), written by tensorstore's zarr driver: the reader puts
    every chunk in its place, in float32 and bfloat16."""
    import ml_dtypes
    import tensorstore as ts

    rng = np.random.default_rng(4)
    arrays = {"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": rng.normal(size=(9,)).astype(ml_dtypes.bfloat16)}
    chunks = {"a": [2, 3], "b": [4]}
    for name, arr in arrays.items():
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "file", "path": str(tmp_path / name)},
            "metadata": {"chunks": chunks[name], "compressor": compressor,
                         "dimension_separator": "."}},
            create=True, dtype=ts.bfloat16 if name == "b" else ts.float32,
            shape=arr.shape).result()
        store.write(arr).result()
    got_a = porbax._read_array(porbax._PlainStore(str(tmp_path)), "a", "t")
    got_b = porbax._read_array(porbax._PlainStore(str(tmp_path)), "b", "t")
    np.testing.assert_array_equal(got_a, arrays["a"])
    np.testing.assert_array_equal(got_b.float().numpy(),
                                  arrays["b"].astype(np.float32))
    (tmp_path / "a" / "2.2").unlink()
    with pytest.raises(ValueError, match="a/2.2 is missing"):
        porbax._read_array(porbax._PlainStore(str(tmp_path)), "a", "t")


FIXTURE = Path(__file__).resolve().parent / "orbax_fixture"


def test_committed_ocdbt_fixture_matches_its_checksums():
    """``tests/orbax_fixture/ocdbt`` (written by JAX's orbax through
    ``make_fixture.py``; ``chip_smoke.py`` phase 26 reads it on the card):
    every array's bytes, dtype and shape as ``checksums.json`` records,
    and as orbax restores it."""
    import hashlib

    import orbax.checkpoint as ocp

    want = json.loads((FIXTURE / "checksums.json").read_text())
    tree = porbax.read_directory(str(FIXTURE / "ocdbt"))
    got = {name: {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                  "dtype": dtype, "shape": list(a.shape)}
           for name, a, dtype in porbax.array_leaves(tree)}
    assert got == want
    with ocp.StandardCheckpointer() as ckptr:
        ref = ckptr.restore(str(FIXTURE / "ocdbt"))
    for (k, v) in _flat(ref):
        name = ".".join(k)
        assert want[name]["sha256"] == hashlib.sha256(
            np.ascontiguousarray(v).tobytes()).hexdigest(), name


def test_port_tree_matches_jax_full_checkpoint_structure(jexp):
    """``interop/weights.py::full_tree_of`` nests the port's state as
    JAX's ``_state_to_full_ckpt`` nests its own: the same key paths and
    the same empty nodes (optax's ``EmptyState`` as orbax records
    ``None``)."""
    from mixstage_tpu_torch.interop.weights import full_tree_of

    pt = _port(jexp, None)
    jtree = JaxBookKeeper._state_to_full_ckpt(jexp["jt"].state)

    def paths(tree, path=()):
        if hasattr(tree, "_fields"):
            tree = {f: getattr(tree, f) for f in tree._fields} or None
        if isinstance(tree, dict) and tree:
            for k, v in tree.items():
                yield from paths(v, path + (k,))
        elif isinstance(tree, (tuple, list)) and tree:
            for i, v in enumerate(tree):
                yield from paths(v, path + (str(i),))
        else:
            yield path, ("none" if tree is None else
                         "dict" if isinstance(tree, dict) else "leaf")
    assert dict(paths(full_tree_of(pt.state))) == dict(paths(jtree))
    assert jax.tree.leaves(jtree)
