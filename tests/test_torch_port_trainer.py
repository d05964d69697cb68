"""The port's ``Trainer`` against the JAX package's, end to end on the CPU.

One synthetic PATS fixture (2 speakers, 3 intervals each), the flagship
generator at a small width (``in_channels`` 64, 2 clusters), batch 4, one
epoch of 3 steps (``debug`` 2).  The JAX trainer is built first and writes
the ZNorm and k-means caches under ``preprocessing/``; the port reads them
(the JAX package's k-means fit is unseeded, so the two trainers share its
centres).  The port starts from the JAX trainer's initial state through
``interop.load_jax_train_state``, both train one epoch with the same coin
generator, and each then samples (whole intervals, style transfer) from the
same trained weights.

Tolerances, those of one train step (``test_torch_port_train_steps.py``)
carried over the epoch:
* the batches each step gets, bit for bit;
* the D/G and curriculum coins, the same sequence;
* per-step losses at rtol 1e-4;
* final params within steps × 2·lr (Adam moves a weight by at most lr a
  step; a flipped noise-level gradient moves it by 2·lr);
* BN statistics within 1e-4 of each leaf's scale, which for a running
  mean is the scale of the activations it averages, max(|mean|, √var):
  D's ``conv2_0`` mean lies near 0 (max 3.7e-2 against a std near 0.8)
  and moves by 6.1e-5 of that std after three steps whose weights already
  differ by up to 2·lr (4.8e-5 absolute, 1.3e-3 of its own max);
* sampled poses within 1e-4 of mean |pose| (measured: 8.2e-7);
* the sampled metrics JSON (``cummMetrics``, ``metrics``): the same keys,
  each value within 1e-5 of its magnitude (+1e-8; measured: 1.2e-7); the
  cluster ``histogram`` counts equal.  Swapping the style-transfer target
  for the speaker's own style moves the ``style`` metrics by more than 1e-2
  (``test_metric_tolerance_catches_a_swapped_style_target``);
* ``-tb 1``: both trainers write tensorboard event files, read back with
  tensorboard's ``EventAccumulator``: the same tags and steps, the values
  (the epoch's losses and metrics) at the results' rtol 1e-4.
"""

import json
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from mixstage_tpu.config import config_from_dict as jax_cfg
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu.train.trainer import Trainer as JaxTrainer
from mixstage_tpu_torch.bookkeeping import weights_of
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.interop import jax_train_state_of, load_jax_train_state
from mixstage_tpu_torch.train.trainer import Trainer

SUB = ["exp", "cpk", "speaker", "model", "note"]
LR = 1e-4
LOSS_RTOL = 1e-4
STAT_TOL = 1e-4
POSE_TOL = 1e-4
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-8
SAMPLE = {"window_hop": 0, "sample_all_styles": 0}


def base(path2data, **kw):
    d = dict(path2data=path2data, speaker=["oliver", "maher"], batch_size=4,
             num_epochs=1, window_hop=5, exp=1, num_iters=2, debug=2,
             model="JointLateClusterSoftStyle4_G", gan=1, loss="L1Loss",
             num_clusters=2, modelKwargs={"in_channels": 64}, lr=LR)
    d.update(kw)
    return d


def _scalars(losses):
    return {k: float(np.asarray(v.float() if torch.is_tensor(v) else v))
            for k, v in losses.items() if np.ndim(v) == 0}


def _record(trainer, log):
    """Wrap the trainer's steps: log (kind, batch, losses) per call."""
    for kind in ("g", "d", "eval"):
        fn = trainer.steps[kind]

        def wrapped(state, batch, *a, _fn=fn, _kind=kind, **kw):
            out = _fn(state, batch, *a, **kw)
            losses = out[0] if _kind == "eval" else out[1]
            log.append((_kind, kw.get("use_pose_input", False),
                        {k: np.asarray(v) for k, v in batch.items()
                         if k != "x"}, _scalars(losses)))
            return out
        trainer.steps[kind] = wrapped


def sample_port(path2data, save_dir, jax_trained, factory, **overrides):
    """The port's sampling trainer, from a checkpoint of the JAX-trained
    state carried over by the bridge."""
    path = Path(save_dir) / "bridged_weights.p"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(weights_of(load_jax_train_state(factory, jax_trained)), path)
    tr = Trainer(config_from_dict(base(path2data, save_dir=save_dir,
                                       load=str(path))), SUB,
                 dict(SAMPLE, **overrides), device="cpu")
    tr.sample(1)
    return tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lifecycle")
    data = str(root / "data")
    make_synthetic_dataset(data, ["oliver", "maher"], 3)
    jt = JaxTrainer(jax_cfg(base(data, save_dir=str(root / "jax"), tb=1)),
                    SUB, {})
    pt = Trainer(config_from_dict(base(data, save_dir=str(root / "port"),
                                       tb=1)), SUB, {}, device="cpu")
    pt.state = load_jax_train_state(pt.factory, jt.state)
    logs = {"jax": [], "port": []}
    _record(jt, logs["jax"])
    _record(pt, logs["port"])
    batch = next(pt.data_train.iter_all(batch_size=4))   # draws no coin
    processed = (jt.get_processed_batch(batch), pt.get_processed_batch(batch))
    jt.train(1)
    pt.train(1)
    js = JaxTrainer(jax_cfg(base(data, save_dir=str(root / "jax"),
                                 load=jt.book.name("weights", "p",
                                                   str(root / "jax")))),
                    SUB, dict(SAMPLE))
    js.sample(1)
    ps = sample_port(data, str(root / "port_sample"), js.state, pt.factory)
    return dict(data=data, root=root, jt=jt, pt=pt, js=js, ps=ps, logs=logs,
                processed=processed)


def test_processed_batches_match_jax(runs):
    (jb, jy, jins), (pb, py, pins) = runs["processed"]
    assert sorted(jb) == sorted(pb)
    for k in jb:
        if k == "x":
            for a, b in zip(jb[k], pb[k], strict=True):
                np.testing.assert_array_equal(np.asarray(a), b)
        else:
            a = np.asarray(jb[k])
            assert a.dtype == pb[k].dtype, k
            np.testing.assert_array_equal(a, pb[k], err_msg=k)
    np.testing.assert_array_equal(jy, py)
    np.testing.assert_array_equal(jins, pins)


def test_steps_match_jax(runs):
    """Same calls in the same order (coins), on the same batches, with
    per-step losses at rtol 1e-4."""
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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def test_trained_state_matches_jax(runs):
    js, pt = runs["jt"].state, runs["pt"].state
    ps = jax_train_state_of(pt)
    train_steps = sum(k in ("g", "d") for k, _, _, _ in runs["logs"]["jax"])
    for k in ("step", "g_step", "lambda_step", "curriculum_step"):
        assert int(ps[k]) == int(getattr(js, k)), k
    assert int(js.step) == train_steps
    want = _flat({"g": js.g_params, "d": js.d_params})
    got = _flat({"g": ps["g_params"], "d": ps["d_params"]})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=train_steps * 2 * LR + 1e-6,
                                   err_msg=k)
    want = _flat({"g": js.g_state, "d": js.d_state})
    got = _flat({"g": ps["g_state"], "d": ps["d_state"]})
    for k in want:
        scale = np.abs(want[k]).max()
        if k.endswith("/mean"):            # the activations' own scale
            scale = max(scale, np.sqrt(want[k[:-len("mean")] + "var"].max()))
        assert np.abs(got[k] - want[k]).max() <= STAT_TOL * scale, k


def test_results_match_jax(runs):
    """``PREFIX_res.json``: the same keys; losses and metrics at rtol 1e-4
    (the step timings and rates are each package's own)."""
    res_j, res_p = runs["jt"].book.res, runs["pt"].book.res
    assert sorted(res_j) == sorted(res_p)
    timing = ("_per_sec", "_ms_p50", "_ms_p99")
    for k, want in res_j.items():
        if k.endswith(timing):
            continue
        np.testing.assert_allclose(res_p[k], want, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def _tb_scalars(trainer):
    """{tag: [(step, value)]} of the event files in the trainer's
    experiment directory."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(trainer.book.name.dir(trainer.book.save_dir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax(runs):
    want, got = _tb_scalars(runs["jt"]), _tb_scalars(runs["pt"])
    cpk = runs["pt"].args.cpk
    assert sorted(got) == sorted(want)
    assert {f"{cpk}/{s}" for s in ("train", "dev", "test")} <= set(got)
    for tag, events in want.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in events], tag
        np.testing.assert_allclose([v for _, v in got[tag]],
                                   [v for _, v in events], rtol=1e-4,
                                   atol=1e-7, err_msg=tag)


def _h5_tree(d: Path):
    return sorted(p.relative_to(d).as_posix() for p in d.rglob("*.h5"))


def test_sampled_keypoints_match_jax(runs):
    jd, pd_ = Path(runs["js"].dir_name), Path(runs["ps"].dir_name)
    files = _h5_tree(jd)
    assert files == _h5_tree(pd_)
    assert any(f.startswith("keypoints_style/") for f in files)
    assert len(files) == 2 * 6                    # same + style, 6 intervals
    for f in files:
        with h5py.File(jd / f) as a, h5py.File(pd_ / f) as b:
            want, got = a["pose/data"][()], b["pose/data"][()]
        assert got.shape == want.shape and want.shape[1:] == (2, 52), f
        assert np.abs(got - want).max() <= POSE_TOL * np.abs(want).mean(), f


def metric_violations(want_trainer, got_trainer):
    """Keys and values of the sampled metric files that break the stated
    tolerance (empty when they agree)."""
    bad = []
    for name in ("cummMetrics", "metrics", "histogram"):
        with open(want_trainer.book.name(name, "json",
                                         want_trainer.book.save_dir)) as f:
            want = _flat({"": json.load(f)})
        with open(got_trainer.book.name(name, "json",
                                        got_trainer.book.save_dir)) as f:
            got = _flat({"": json.load(f)})
        if sorted(want) != sorted(got):
            bad.append((name, "keys", sorted(set(want) ^ set(got))))
            continue
        for k in want:
            tol = 0.0 if name == "histogram" else \
                METRIC_RTOL * np.abs(want[k]) + METRIC_ATOL
            if np.any(np.abs(got[k] - want[k]) > tol):
                bad.append((name, k, got[k], want[k]))
    return bad


def test_sampled_metrics_match_jax(runs):
    assert metric_violations(runs["js"], runs["ps"]) == []
    with open(runs["ps"].book.name("cummMetrics", "json",
                                   runs["ps"].book.save_dir)) as f:
        cumm = json.load(f)
    assert np.isfinite(cumm["test_pck"]) and cumm["test_pck"] > 0


def test_metric_tolerance_catches_a_swapped_style_target(runs, monkeypatch):
    """A mutant sampler whose style transfer targets the speaker's own
    style: the ``style`` entries fail the metric tolerance."""
    def own_style(self, style):
        yield style, None
        yield style, "style"
    monkeypatch.setattr(Trainer, "update_kwargs_styles", own_style)
    mutant = sample_port(runs["data"], str(runs["root"] / "mutant"),
                         runs["js"].state, runs["pt"].factory)
    bad = metric_violations(runs["js"], mutant)
    assert bad and all("style" in str(b[1]) or b[0] == "cummMetrics"
                       for b in bad)
    assert any(b[0] == "metrics" and b[1].startswith("/style/")
               and abs(b[2] - b[3]) > 1e-2 * abs(b[3]) for b in bad)
