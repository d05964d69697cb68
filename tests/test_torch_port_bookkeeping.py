"""The port's bookkeeping: the experiment names and files the JAX
package's ``BookKeeper`` writes, the early-stopping policy, and the torch
checkpoints: weights, optimizer and counters saved and loaded bit for bit,
and the preemption snapshot."""

import json
import os

import numpy as np
import pytest
import torch

from mixstage_tpu.bookkeeping import BookKeeper as JaxBookKeeper
from mixstage_tpu.config import config_from_dict as jax_cfg
from mixstage_tpu_torch.bookkeeping import (BookKeeper, optim_of,
                                            weights_of)
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.train import StepConfig, StepFactory

SUB = ["exp", "cpk", "speaker", "model", "note"]
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=2,
           model_kwargs=(("in_channels", 64),))


def _args(save_dir, **kw):
    d = dict(save_dir=str(save_dir), speaker=["oliver", "maher"],
             model="JointLateClusterSoftStyle4_G", note="n1", dev_key="dev")
    d.update(kw)
    return d


@pytest.mark.parametrize("exp", [None, 7])
def test_names_and_files_match_jax(tmp_path, exp):
    """The same PREFIX, experiment numbering, args / name files, and res
    file and log lines for the same updates."""
    books = {}
    for name, (cls, cfg) in {"jax": (JaxBookKeeper, jax_cfg),
                             "port": (BookKeeper, config_from_dict)}.items():
        save = tmp_path / name
        os.makedirs(save)
        (save / "exp_3_old_args.args").write_text("{}")
        book = cls(cfg(_args(save, exp=exp)), SUB, {"window_hop": 0})
        book.update_res({"train": 1.5, "dev": 2.0})
        book.update_res({"dev": 1.0, "dev_pck": 0.25})
        book._save_res()
        books[name] = book
    j, p = books["jax"], books["port"]
    assert p.name.prefix == j.name.prefix
    assert p.args.exp == j.args.exp == (4 if exp is None else 7)
    for suffix, ext in (("args", "args"), ("name", "name"), ("res", "json")):
        a = j.name(suffix, ext, j.save_dir)
        b = p.name(suffix, ext, p.save_dir)
        assert os.path.basename(a) == os.path.basename(b)
        if ext == "args":     # the port's config has the JAX package's flags
            want, got = json.load(open(a)), json.load(open(b))
            assert want.pop("save_dir") != got.pop("save_dir")
            assert got == want
        else:
            assert open(a).read() == open(b).read()


def test_restore_args_from_checkpoint(tmp_path):
    book = BookKeeper(config_from_dict(_args(tmp_path, exp=2, lr=0.5)), SUB)
    weights = book.name("weights", "p", book.save_dir)
    restored = BookKeeper(config_from_dict(dict(load=weights, lr=0.1,
                                                save_dir="elsewhere")),
                          SUB, {"window_hop": 0})
    assert restored.args.lr == 0.5 and restored.args.load == weights
    assert restored.args.window_hop == 0
    assert restored.name.prefix == book.name.prefix


def test_stop_training_matches_jax(tmp_path):
    """Greedy save and early stopping on the same dev curve."""
    curve = [3.0, 2.0, 2.5, 2.4, 2.6, 1.0]
    saved = {}
    for name, (cls, cfg) in {"jax": (JaxBookKeeper, jax_cfg),
                             "port": (BookKeeper, config_from_dict)}.items():
        book = cls(cfg(_args(tmp_path / name, exp=1, stop_thresh=3)), SUB)
        book._save_model = lambda state, n=name: saved.setdefault(
            n, []).append(len(book.res["dev"]))
        stops = []
        for epoch, dev in enumerate(curve):
            book.update_res({"dev": dev})
            stops.append(book.stop_training(None, epoch))
        saved[name + "_stops"] = stops
    assert saved["port"] == saved["jax"] == [1, 2, 6]
    assert saved["port_stops"] == saved["jax_stops"]
    assert saved["port_stops"].index(True) == 4


@pytest.fixture(scope="module")
def trained_state():
    """A port state after a few real steps: moved weights, BN statistics,
    Adam moments and counters."""
    f = StepFactory(StepConfig(**CFG), device="cpu")
    state = f.init(seed=3)
    rng = np.random.default_rng(0)
    batch = {"x": (rng.normal(size=(2, 64, 128)).astype(np.float32),),
             "y": rng.normal(size=(2, 64, 96)).astype(np.float32),
             "labels": rng.integers(0, 2, size=(2, 64)),
             "style": np.zeros((2, 64), np.int32)}
    steps = f.make_steps()
    for step in ("g", "d", "g"):
        state, _, _ = steps[step](state, batch)
    return f, state


def _assert_states_equal(a, b):
    for m, sd in weights_of(a).items():
        other = weights_of(b)[m]
        assert sorted(sd) == sorted(other), m
        for k, v in sd.items():
            assert torch.equal(v, other[k]), (m, k)
    oa, ob = optim_of(a), optim_of(b)
    assert oa["counters"] == ob["counters"]
    for name in ("g_opt", "d_opt"):
        assert oa[name]["count"] == ob[name]["count"] > 0
        for x, y in zip(oa[name]["mu"] + oa[name]["nu"],
                        ob[name]["mu"] + ob[name]["nu"]):
            assert torch.equal(x, y), name


def test_checkpoint_round_trip_is_exact(tmp_path, trained_state):
    f, state = trained_state
    book = BookKeeper(config_from_dict(_args(tmp_path, exp=1,
                                             save_optim=1)), SUB)
    book._save_model(state)
    path = book.name("weights", "p", book.save_dir)
    assert os.path.exists(path)
    assert os.path.exists(book.name("trainstate", "p", book.save_dir))
    fresh = f.init(seed=4)
    loader = BookKeeper(config_from_dict(dict(load=path)), SUB)
    fresh = loader._load_model(fresh)
    fresh = loader._load_train_state(fresh)
    _assert_states_equal(fresh, state)
    # the file holds tensors and ints only: weights_only loading
    ckpt = torch.load(path, weights_only=True)
    assert sorted(ckpt) == ["disc", "gen", "psenc"]


def test_preempt_snapshot_round_trip(tmp_path, trained_state):
    f, state = trained_state
    book = BookKeeper(config_from_dict(_args(tmp_path, exp=1)), SUB)
    assert book.load_preempt(f.init(seed=5)) is None
    book.save_preempt(state, {"epoch_next": 2, "step": state.step})
    restored, meta = book.load_preempt(f.init(seed=5))
    assert meta == {"epoch_next": 2, "step": state.step}
    _assert_states_equal(restored, state)
    book.clear_preempt()
    assert book.load_preempt(f.init(seed=5)) is None


def test_foreign_checkpoint_is_refused(tmp_path, trained_state):
    """A torch file of neither kind raises ``NotImplementedError``; a
    directory without orbax's ``_METADATA`` and truncated msgpack (a map
    of four keys cut after one) raise ``ValueError`` naming the file; a
    ``-ckpt_backend`` other than msgpack and orbax raises ``ValueError``.
    JAX checkpoints load (``test_torch_port_jax_checkpoint.py``,
    ``test_torch_port_orbax.py``)."""
    f, _ = trained_state
    path = tmp_path / "ref_weights.p"
    torch.save({"G": {"w": torch.zeros(1)}}, path)      # neither kind
    orbax = tmp_path / "jax_weights.orbax"
    orbax.mkdir()
    msgpack = tmp_path / "jax_weights.p"
    msgpack.write_bytes(b"\x84\xa8g_params\x80")         # truncated msgpack
    for p in (path, orbax, msgpack):
        book = BookKeeper(config_from_dict(dict(load=str(p),
                                                save_dir=str(tmp_path))), SUB)
        if p == msgpack:
            with pytest.raises(ValueError,
                               match="jax_weights.p is malformed flax "
                                     "msgpack"):
                book._load_model(f.init(seed=6))
        elif p == orbax:
            with pytest.raises(ValueError, match="_METADATA"):
                book._load_model(f.init(seed=6))
        else:
            with pytest.raises(NotImplementedError,
                               match="neither a checkpoint of the port"):
                book._load_model(f.init(seed=6))
    with pytest.raises(ValueError, match="'msgpack' or 'orbax'"):
        BookKeeper(config_from_dict(_args(tmp_path, ckpt_backend="zarr")),
                   SUB)
