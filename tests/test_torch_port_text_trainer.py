"""The port's ``Trainer`` on text against the JAX package's, on the CPU.

Synthetic PATS (2 speakers, 3 intervals each) with ``text/w2v``, a
``text/meta`` word table and a ``text/pos`` stream of tag classes below
the cluster count; the flagship generator at a small width (in_channels
64, 2 clusters), batch 4, one epoch of 3 steps (``debug`` 2), on audio +
``text/w2v`` with ``-optim_separate 1e-5``, ``-pos 1`` (``text/pos``
loaded, not an input: its classes are the cluster labels) and ``-filler
1``.  As in ``test_torch_port_trainer.py``, the JAX trainer is built
first (it writes the ZNorm and k-means caches the port reads), the port
starts from its initial state through the weight bridge (the partitioned
optimizer state included), and both train one epoch from one coin
generator.

Tolerances: the batches each step gets bit for bit; the same coins; the
trained parameters within steps × 2·lr and each optimizer group's count,
as ``test_torch_port_trainer.py``; per-step losses at rtol 1e-3 and the
epoch losses of ``PREFIX_res.json`` likewise, its metric entries the same
keys, finite.  The losses of the steps before any update agree to 5e-6;
the coins here make the first G step a curriculum pose-input one, whose
float32 leaky-unit flips move G's weights by 2·lr in a few elements (the
``g_pose_input`` case of ``test_torch_port_train_steps.py``), and the D
step after it then differs by up to 4.1e-4 (``fake_D``; the later eval
steps by up to 1.7e-5); the sampled metrics count keypoints under a
threshold, so one flipped keypoint moves them by 1/768.  The step
configuration each trainer builds equals JAX's field for field (dtypes
mapped), for this run and for a registered Disentangle generator with
``-style_losses``.
"""

from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import (JaxDisentangle, PortDisentangle, flat_tree,
                                 record_steps)
from mixstage_tpu.config import config_from_dict as jax_cfg
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu.models import registry as jreg
from mixstage_tpu.models.speech2gesture import Speech2Gesture_D as JaxD
from mixstage_tpu.train.trainer import Trainer as JaxTrainer
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.data.text import write_text_meta
from mixstage_tpu_torch.interop import jax_train_state_of, load_jax_train_state
from mixstage_tpu_torch.models import registry as preg
from mixstage_tpu_torch.models.speech2gesture import Speech2Gesture_D
from mixstage_tpu_torch.train.state import SeparateTextOptimizer
from mixstage_tpu_torch.train.trainer import Trainer

SUB = ["exp", "cpk", "speaker", "model", "note"]
LR, TEXT_LR = 1e-4, 1e-5
LOSS_RTOL = 1e-3
MODS = ["pose/data", "audio/log_mel_512", "text/w2v", "text/pos"]
INPUTS = ["audio/log_mel_512", "text/w2v"]
DISENTANGLE = "JointLateClusterSoftStyleDisentangle9_G"


def base(path2data, **kw):
    d = dict(path2data=path2data, speaker=["oliver", "maher"], batch_size=4,
             num_epochs=1, window_hop=5, exp=1, num_iters=2, debug=2,
             model="JointLateClusterSoftStyle4_G", gan=1, loss="L1Loss",
             num_clusters=2, modelKwargs={"in_channels": 64}, lr=LR,
             modalities=MODS, input_modalities=INPUTS, fs_new=[15] * 4,
             optim_separate=TEXT_LR, pos=1, filler=1)
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pats_text_trainer"))
    make_synthetic_dataset(path, ["oliver", "maher"], 3, with_text=True)
    rng = np.random.default_rng(5)
    for f in sorted(Path(path, "processed").glob("*/*.h5")):
        with h5py.File(f, "r") as h5:
            n = h5["pose/data"].shape[0]
        starts = np.arange(0, n, 6)
        write_text_meta(f, {"Word": [["the", "hand", "a", "go"][i] for i in
                                     rng.integers(0, 4, len(starts))],
                            "start_frame": starts,
                            "end_frame": np.minimum(starts + 6, n)})
        with h5py.File(f, "a") as h5:
            h5["text/pos"] = rng.integers(0, 2, n).astype(np.float64)
    return path


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    root = tmp_path_factory.mktemp("text_trainer")
    jt = JaxTrainer(jax_cfg(base(data, save_dir=str(root / "jax"))), SUB, {})
    pt = Trainer(config_from_dict(base(data, save_dir=str(root / "port"))),
                 SUB, {}, device="cpu")
    pt.state = load_jax_train_state(pt.factory, jt.state)
    logs = {"jax": [], "port": []}
    record_steps(jt, logs["jax"])
    record_steps(pt, logs["port"])
    batch = next(pt.data_train.iter_all(batch_size=4))
    processed = (jt.get_processed_batch(batch)[0],
                 pt.get_processed_batch(batch)[0], batch)
    jt.train(1)
    pt.train(1)
    return dict(jt=jt, pt=pt, logs=logs, processed=processed, root=root)


def test_text_batches_and_pos_labels_match_jax(runs):
    jb, pb, raw = runs["processed"]
    assert sorted(jb) == sorted(pb)
    for a, b in zip(jb["x"], pb["x"], strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert pb["x"][1].shape[-1] == 300
    for k in ("y", "labels", "style"):
        np.testing.assert_array_equal(np.asarray(jb[k]), pb[k], err_msg=k)
    # -pos: the raw text/pos classes are the labels, not the k-means ones
    np.testing.assert_array_equal(pb["labels"], raw["text/pos"])
    assert "text/filler" in raw and "text/token_duration" in raw


def test_text_steps_match_jax(runs):
    jlog, plog = runs["logs"]["jax"], runs["logs"]["port"]
    kinds = [(k, p) for k, p, _, _ in jlog]
    assert kinds == [(k, p) for k, p, _, _ in plog]
    assert {"g", "d", "eval"} <= {k for k, _ in kinds}
    for i, ((kind, _, jb, jl), (_, _, pb, pl)) in enumerate(zip(jlog, plog)):
        for k in jb:
            np.testing.assert_array_equal(jb[k], pb[k],
                                          err_msg=f"step {i} {k}")
        assert sorted(jl) == sorted(pl), (i, kind)
        for k in jl:
            np.testing.assert_allclose(pl[k], jl[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{i} {kind} {k}")


def test_text_trained_state_matches_jax(runs):
    js, pt = runs["jt"].state, runs["pt"].state
    ps = jax_train_state_of(pt)
    train_steps = sum(k in ("g", "d") for k, _, _, _ in runs["logs"]["jax"])
    want = flat_tree({"g": js.g_params, "d": js.d_params})
    got = flat_tree({"g": ps["g_params"], "d": ps["d_params"]})
    assert sorted(got) == sorted(want)
    assert any("text_encoder" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=train_steps * 2 * LR + 1e-6,
                                   err_msg=k)
    opt = pt.g_opt
    assert isinstance(opt, SeparateTextOptimizer)
    assert opt.groups["text"].count == opt.groups["rest"].count == \
        int(js.g_step)
    res_j, res_p = runs["jt"].book.res, runs["pt"].book.res
    assert sorted(res_j) == sorted(res_p)
    for k in ("train", "dev", "test"):
        np.testing.assert_allclose(res_p[k], res_j[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert all(np.isfinite(v).all() for v in res_p.values())


def _same_step_config(jcfg, pcfg):
    dtypes = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
              jnp.float64: torch.float64}
    fields = set(jcfg.__dataclass_fields__)
    assert fields == set(pcfg.__dataclass_fields__)
    for f in sorted(fields):
        want, got = getattr(jcfg, f), getattr(pcfg, f)
        if f == "dtype":
            want = dtypes[want]
        assert got == want, (f, got, want)


def test_step_config_matches_jax_field_for_field(runs):
    cfg = runs["pt"].step_cfg
    _same_step_config(runs["jt"].step_cfg, cfg)
    assert cfg.text_channels == 300 and cfg.optim_separate == TEXT_LR
    assert cfg.input_modalities == tuple(INPUTS)
    # -style_losses reaches the configuration whatever the model
    assert dict(cfg.style_losses) == dict(runs["pt"].args.style_losses)


def test_disentangle_trainer_config_matches_jax(data, tmp_path):
    """A registered Disentangle generator with ``-style_losses``: the step
    configuration and the weights its generator gets equal JAX's."""
    weights = {"content_+": 2.0, "id_a": 0.5, "H": 1.0}
    jreg.register_model(DISENTANGLE, JaxDisentangle)
    jreg.register_model(DISENTANGLE[:-1] + "D", JaxD)
    preg.register_model(DISENTANGLE, PortDisentangle)
    preg.register_model(DISENTANGLE[:-1] + "D", Speech2Gesture_D)
    try:
        kw = dict(model=DISENTANGLE, style_losses=weights,
                  modalities=MODS[:3], input_modalities=None,
                  fs_new=[15] * 3, pos=0, filler=0, optim_separate=None)
        jt = JaxTrainer(jax_cfg(base(data, save_dir=str(tmp_path / "j"),
                                     **kw)), SUB, {})
        pt = Trainer(config_from_dict(base(data, save_dir=str(
            tmp_path / "p"), **kw)), SUB, {}, device="cpu")
        _same_step_config(jt.step_cfg, pt.step_cfg)
        assert dict(jt.factory.gen.style_losses) == \
            pt.state.gen.style_losses == weights
    finally:
        for reg in (jreg, preg):
            reg.MODEL_REGISTRY.pop(DISENTANGLE, None)
            reg.MODEL_REGISTRY.pop(DISENTANGLE[:-1] + "D", None)


def test_text_model_samples_with_style_transfer(runs):
    """Sampling whole intervals on the text model, and style transfer:
    keypoints of every interval in each speaker's own style and in the
    other's."""
    tr = runs["pt"]
    tr.sample(1)
    root = Path(tr.dir_name)
    same = sorted(p.name for p in (root / "keypoints").rglob("*.h5"))
    style = sorted(p.name for p in (root / "keypoints_style").rglob("*.h5"))
    assert len(same) == len(style) == 6
    with h5py.File(next((root / "keypoints_style").rglob("*.h5"))) as h5:
        pose = h5["pose/data"][()]
    assert pose.shape[1:] == (2, 52) and np.isfinite(pose).all()


def test_text_checkpoint_round_trips(runs, tmp_path):
    """The trained text state's checkpoint (the text encoder, both
    optimizer groups' moments and counts) through ``torch.save`` into a
    fresh state, bit for bit."""
    from mixstage_tpu_torch.bookkeeping import (load_optim, load_weights,
                                                optim_of, weights_of)

    st = runs["pt"].state
    path = tmp_path / "ckpt.p"
    torch.save({"weights": weights_of(st), "optim": optim_of(st)}, path)
    saved = torch.load(path, weights_only=True)
    fresh = runs["pt"].factory.init(seed=3)
    load_optim(load_weights(fresh, saved["weights"]), saved["optim"])
    for m in ("gen", "psenc", "disc"):
        a, b = getattr(st, m).state_dict(), getattr(fresh, m).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), m
    assert any(k.startswith("text_encoder.") for k in st.gen.state_dict())
    for g, opt in st.g_opt.groups.items():
        twin = fresh.g_opt.groups[g]
        assert twin.count == opt.count > 0, g
        for slot, tensors in opt.slots().items():
            assert all(torch.equal(x, y) for x, y in
                       zip(tensors, twin.slots()[slot])), (g, slot)
