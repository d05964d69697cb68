"""The port's ``Trainer`` against the JAX package's for the other model
families and the weighted GAN, and the style Inception Score from a
classifier checkpoint.

One synthetic PATS fixture (2 speakers, 3 intervals each), batch 4,
``debug`` 1 (two train steps an epoch).  As in ``test_torch_port_trainer.py``
the JAX trainer is built first (it writes the ZNorm and k-means caches),
the port starts from its initial state through
``interop.load_jax_train_state``, and both train from one ``-seed``:

* ``-gan 0`` (the Mix-StAGE generator alone, one epoch): the same step
  calls on the same batches (no D/G coin), per-step losses at rtol 1e-4,
  final parameters within steps × 2·lr, the results file's losses and
  metrics at rtol 1e-4 (a PCK within 2.5e-3: it counts keypoints under a
  threshold, and one keypoint of 512 flips);
* ``-model StyleClassifier_G`` (one epoch): the same, and the accuracy
  metric ``{split}_acc`` of ``PREFIX_res.json`` exactly (a share of eight
  windows);
* ``-gan 1 -weighted 2 -update_D_prob_flag 1`` (two epochs of two steps):
  the same D/G coins, each step's ``W`` at rtol 1e-4, the D/G coin
  probability after each epoch and the weighted sampler's weights (fed
  from W, renormalised after each epoch) at rtol 1e-4, and so the same
  windows drawn in the second epoch;
* the IS metric: a ``StyleClassifier_G`` drawn in flax layout, written as
  a JAX msgpack checkpoint and as the port's, each behind
  ``-pretrained_model_weights``; both trainers' metric cascades on the
  same poses give the same ``style_IS`` values (rtol 1e-5: float32
  logits), and the port's ``cli.train -model StyleClassifier_G`` writes a
  checkpoint (``gen`` only) that a second run reads for its IS metric.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import flat_tree, flax_variables
from mixstage_tpu.config import config_from_dict as jax_cfg
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu.models.style_classifier import \
    StyleClassifier_G as JaxClassifier
from mixstage_tpu.train.trainer import Trainer as JaxTrainer
from mixstage_tpu_torch.cli import train as cli_train
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.data.common import SPEAKERS
from mixstage_tpu_torch.interop import (jax_train_state_of,
                                        load_flax_state, load_jax_train_state)
from mixstage_tpu_torch.models import StyleClassifier_G
from mixstage_tpu_torch.train.trainer import Trainer

SUB = ["exp", "cpk", "speaker", "model", "note"]
# lr 1e-6, as test_torch_port_train_steps.py runs its k-step driver: at
# 1e-4 a flipped noise-level gradient moves a weight by 2·lr a step, and
# the next step's losses drift apart by more than a step's tolerance
# (id_in by 1.7e-3 after one non-GAN step)
LR = 1e-6
LOSS_RTOL = 1e-4
PCK_ATOL = 2.5e-3
FEATS = 96            # 104 pose features less the 4 masked joints' 8
# the IS classifier scores every PATS speaker (trainer.py:584-614)
N_ALL = len(SPEAKERS)


def base(path2data, **kw):
    d = dict(path2data=path2data, speaker=["oliver", "maher"], batch_size=4,
             num_epochs=1, window_hop=5, exp=1, num_iters=1, debug=1,
             model="JointLateClusterSoftStyle4_G", gan=1, loss="L1Loss",
             num_clusters=2, modelKwargs={"in_channels": 32}, lr=LR,
             seed=3)
    d.update(kw)
    return d


CONFIGS = {
    "non_gan": dict(gan=0),
    "classifier": dict(model="StyleClassifier_G", gan=0, num_clusters=None,
                       modelKwargs={}),
    "weighted": dict(weighted=2, update_D_prob_flag=1, num_epochs=2),
}


def _scalars(losses):
    return {k: np.asarray(v.float() if torch.is_tensor(v) else v,
                          np.float64) for k, v in losses.items()}


def _record(trainer, log):
    """Wrap the trainer's steps: log (kind, batch idx-free arrays, losses,
    D/G coin probability) per call."""
    for kind in list(trainer.steps):
        fn = trainer.steps[kind]

        def wrapped(state, batch, *a, _fn=fn, _kind=kind, **kw):
            out = _fn(state, batch, *a, **kw)
            losses = out[0] if _kind == "eval" else out[1]
            log.append((_kind, {k: np.asarray(v) for k, v in batch.items()
                                if k != "x"}, _scalars(losses),
                        trainer._d_prob))
            return out
        trainer.steps[kind] = wrapped


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("lifecycle_rest")
    path = str(root / "data")
    make_synthetic_dataset(path, ["oliver", "maher"], 3)
    return root, path


@pytest.fixture(scope="module")
def runs(data):
    root, path = data
    out = {}
    for name, change in CONFIGS.items():
        jt = JaxTrainer(jax_cfg(base(path, save_dir=str(root / f"jax_{name}"),
                                     **change)), SUB, {})
        pt = Trainer(config_from_dict(base(
            path, save_dir=str(root / f"port_{name}"), **change)), SUB, {},
            device="cpu")
        pt.state = load_jax_train_state(pt.factory, jt.state)
        logs = {"jax": [], "port": []}
        _record(jt, logs["jax"])
        _record(pt, logs["port"])
        sampler_w = {"jax": [], "port": []}
        for side, tr in (("jax", jt), ("port", pt)):
            orig = tr._renormalize_sampler_weights

            def renorm(_orig=orig, _tr=tr, _side=side):
                _orig()
                _side_w = np.array(_tr.data_train.sampler.weights)
                sampler_w[_side].append((_side_w, _tr._d_prob))
            tr._renormalize_sampler_weights = renorm
        jt.train(1)
        pt.train(1)
        out[name] = dict(jt=jt, pt=pt, logs=logs, sampler_w=sampler_w)
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_steps_match_jax(runs, name):
    """The same step calls in the same order (the coins), on the same
    batches, with the same losses (rtol 1e-4) and D/G coin probability."""
    jlog, plog = runs[name]["logs"]["jax"], runs[name]["logs"]["port"]
    assert [e[0] for e in jlog] == [e[0] for e in plog]
    kinds = {e[0] for e in jlog}
    assert kinds == ({"g", "d", "eval"} if name == "weighted"
                     else {"train", "eval"})
    for i, ((kind, jb, jl, jp), (_, pb, pl, pp)) in enumerate(zip(jlog,
                                                                  plog)):
        for k in jb:
            np.testing.assert_array_equal(jb[k], pb[k],
                                          err_msg=f"step {i} {k}")
        assert sorted(jl) == sorted(pl), (i, kind)
        for k in jl:
            np.testing.assert_allclose(pl[k], jl[k], rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f"{i} {kind} {k}")
        assert pp == pytest.approx(jp, rel=1e-6), i


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trained_state_and_results_match_jax(runs, name):
    jt, pt = runs[name]["jt"], runs[name]["pt"]
    ps = jax_train_state_of(pt.state)
    steps = sum(e[0] != "eval" for e in runs[name]["logs"]["jax"])
    assert steps >= 2 and int(jt.state.step) == pt.state.step == steps
    fields = ("g_params",) + (("d_params",) if name == "weighted" else ())
    for field in fields:
        want = flat_tree(getattr(jt.state, field))
        got = flat_tree(ps[field])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=steps * 2 * LR + 1e-6,
                                       err_msg=k)
    res_j, res_p = jt.book.res, pt.book.res
    assert sorted(res_j) == sorted(res_p)
    for k, want in res_j.items():
        if k.endswith(("_per_sec", "_ms_p50", "_ms_p99")):
            continue
        if k in ("train_acc", "dev_acc", "test_acc"):    # not W1_acc
            assert res_p[k] == want, k
        elif "_pck" in k:
            # a share of keypoints within a threshold: one that lies within
            # float32 rounding of it flips between the packages (one of
            # 512, 0.0020, measured)
            np.testing.assert_allclose(res_p[k], want, rtol=0,
                                       atol=PCK_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(res_p[k], want, rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    if name == "classifier":
        assert {"train_acc", "dev_acc", "test_acc"} <= set(res_p)


def test_weighted_feedback_matches_jax(runs):
    """The sampler's weights after each epoch (set from each step's W,
    then standardised) and the adapted D/G coin probability; epoch 2 draws
    its windows from those weights, the same in both packages."""
    sw = runs["weighted"]["sampler_w"]
    assert len(sw["jax"]) == len(sw["port"]) == 2
    for (jw, jp), (pw, pp) in zip(sw["jax"], sw["port"]):
        np.testing.assert_allclose(pw, jw, rtol=1e-4)
        assert pp == pytest.approx(jp, rel=1e-4)
        assert not np.allclose(pw, 1.0)        # the feedback moved them
    assert sw["port"][-1][1] != runs["weighted"]["pt"].step_cfg.d_prob
    jlog = runs["weighted"]["logs"]["jax"]
    ws = [e[2]["W"] for e in jlog if e[0] in ("g", "d")]
    assert all(w.shape == (4,) and (w >= 0.1).all() and (w <= 10).all()
               for w in ws)


@pytest.fixture(scope="module")
def classifier_ckpts(data):
    """One StyleClassifier_G's weights (flax layout, seeded) as a JAX
    msgpack checkpoint and as the port's."""
    from flax import serialization

    root, _ = data
    jm = JaxClassifier(in_channels=FEATS, num_speakers=N_ALL)
    params, stats = flax_variables(jm, jnp.zeros((2, 64, FEATS)), None,
                                   train=False, seed=7)
    msgpack = root / "clf_jax.msgpack"
    msgpack.write_bytes(serialization.msgpack_serialize(
        {"g_params": {"gen": params}, "g_state": {"gen": stats}}))
    tm = StyleClassifier_G(in_channels=FEATS, num_speakers=N_ALL)
    load_flax_state(tm, params, stats)
    port = root / "clf_port_weights.p"
    torch.save({"gen": tm.state_dict()}, port)
    return msgpack, port


def _is_values(trainer, desc="test"):
    avgs = trainer.IS.get_averages(desc)
    return avgs[0] if isinstance(avgs, tuple) else avgs


def test_inception_score_matches_jax(data, classifier_ckpts):
    root, path = data
    msgpack, port = classifier_ckpts
    jt = JaxTrainer(jax_cfg(base(path, save_dir=str(root / "jax_is"),
                                 pretrained_model_weights=str(msgpack))),
                    SUB, {})
    pt = Trainer(config_from_dict(base(
        path, save_dir=str(root / "port_is"),
        pretrained_model_weights=str(port))), SUB, {}, device="cpu")
    assert jt.IS is not None and pt.IS is not None
    rng = np.random.default_rng(4)
    for batch in list(pt.data_train.iter_all(batch_size=4))[:2]:
        step_batch, y_, insert = pt.get_processed_batch(batch)
        y_cap = rng.normal(size=step_batch["y"].shape)
        for tr in (jt, pt):
            tr.calculate_metrics(y_cap, y_, "same", insert=insert,
                                 style=step_batch["style"])
    want, got = _is_values(jt), _is_values(pt)
    assert sorted(got) == sorted(want) and "test_style_IS" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    # the JAX checkpoint behind the port's flag raises (queue 1 item 7)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        Trainer(config_from_dict(base(
            path, save_dir=str(root / "port_is2"),
            pretrained_model_weights=str(msgpack))), SUB, {}, device="cpu")


def test_classifier_checkpoint_feeds_the_is_metric(data):
    """``cli.train -model StyleClassifier_G -speaker all`` (train, then its
    sampling pass: the accuracy on each split) writes a ``gen``-only
    checkpoint; a GAN run with it behind ``-pretrained_model_weights``
    reports ``{split}_style_IS`` in ``PREFIX_res.json``."""
    root, path = data
    save = root / "cli_clf"
    cli_train.loop(config_from_dict(base(
        path, save_dir=str(save), **{**CONFIGS["classifier"],
                                     "speaker": ["all"]})), 0,
        device="cpu")
    weights = next(save.glob("*_weights.p"))
    ckpt = torch.load(weights, weights_only=True)
    assert sorted(ckpt) == ["gen"]
    assert ckpt["gen"]["classifier5.conv.bias"].shape == (N_ALL,)
    with open(next(save.glob("*_res.json"))) as f:
        res = json.load(f)
    assert {"train_acc", "dev_acc", "test_acc"} <= set(res)
    tr = Trainer(config_from_dict(base(
        path, save_dir=str(root / "cli_gan"),
        pretrained_model_weights=str(weights))), SUB, {}, device="cpu")
    assert tr.IS is not None
    tr.train(1)
    assert np.isfinite(tr.book.res["train_style_IS"]).all()
