"""JAX experiments behind the port's ``-load``: the flax msgpack files the
JAX package's ``BookKeeper`` writes, read by ``interop/flax_msgpack.py``
and carried over by the weight bridge.

One JAX experiment at the test sizes of ``test_torch_port_trainer.py``
(2 speakers, 3 synthetic intervals each, ``in_channels`` 64, 2 clusters,
batch 4), saved by the JAX ``BookKeeper`` with ``-save_optim 1`` from a
state whose Adam moments, counts and counters are those of a run some
steps in (seeded: a JAX train step is not compiled for it), and a seeded
JAX ``StyleClassifier_G`` checkpoint behind ``-pretrained_model_weights``.
Held against the JAX package:

* the port's ``cli.sample -load`` of the JAX ``PREFIX_weights.p`` (the
  eval forward over every interval, both styles): each sampled keypoint
  file within 1e-4 of the JAX sampler's mean |pose|, the forward
  tolerance of ``test_torch_port_trainer.py``;
* the resumed state (weights, Adam moments, counts and the four counters
  from ``PREFIX_trainstate.p``) bit for bit with JAX's restored state
  through the bridge, then one G step and one D step from it against
  JAX's at ``test_torch_port_train_steps.py``'s limits (D's conv1
  moments at twice their measured gap, ``MOMENT_TOL_RESUMED``), which a
  resume without the optimizer state fails;
* the JAX preemption snapshot (``PREFIX_preempt.p``) restored bit for bit;
* the style IS of the JAX classifier checkpoint at rtol 1e-5.
"""

import json
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import flax_variables
from flax import serialization
from mixstage_tpu.bookkeeping import BookKeeper as JaxBookKeeper
from mixstage_tpu.config import config_from_dict as jax_cfg
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu.models.style_classifier import \
    StyleClassifier_G as JaxClassifier
from mixstage_tpu.train.trainer import Trainer as JaxTrainer
from mixstage_tpu_torch.bookkeeping import (BookKeeper, load_optim,
                                            load_weights, optim_of,
                                            weights_of)
from mixstage_tpu_torch.cli import sample as cli_sample
from mixstage_tpu_torch.config import (_typed_flag_names, config_from_dict,
                                       get_args_perm)
from mixstage_tpu_torch.data.common import SPEAKERS
from mixstage_tpu_torch.interop import load_jax_train_state
from mixstage_tpu_torch.interop.flax_msgpack import unpackb
from mixstage_tpu_torch.train.trainer import Trainer
from test_torch_port_train_steps import (MOMENT_TOL, POSE_TOL,
                                         assert_losses_close,
                                         assert_states_close)

SUB = ["exp", "cpk", "speaker", "model", "note"]
LR = 1e-4
FEATS = 96
POSE_RTOL = 1e-4          # of mean |pose|, test_torch_port_trainer.py's
IS_RTOL = 1e-5
# Adam moments of one step from the restored state, module by module
# (relative Frobenius): test_torch_port_train_steps.py's limits, but D's
# conv1 (no BatchNorm before its leaky units, whose float32 sign flips move
# its gradient: test_d_step_moment_gap_is_conditioning) at twice the gap
# measured over the first three training batches from this state, 1.6e-2
# (G's largest: 7.2e-4, gen/audio_encoder)
MOMENT_TOL_RESUMED = {"g": MOMENT_TOL["g"],
                      "d": {**MOMENT_TOL["d"], "conv1": 3.2e-2}}


def base(path2data, **kw):
    # window_hop 0, as the samplers of cli.train and cli.sample set it: the
    # JAX trainer samples from its checkpoint as JAX's cli.sample does
    d = dict(path2data=path2data, speaker=["oliver", "maher"], batch_size=4,
             num_epochs=1, window_hop=0, exp=1, num_iters=2, debug=2,
             model="JointLateClusterSoftStyle4_G", gan=1, loss="L1Loss",
             num_clusters=2, modelKwargs={"in_channels": 64}, lr=LR)
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """The JAX experiment: its ``BookKeeper``'s ``-save_optim 1`` files
    (``PREFIX_weights.p`` and ``PREFIX_trainstate.p``) of a state with the
    optimizer state of a run some steps in, sampled from that checkpoint,
    and a seeded classifier checkpoint in flax msgpack."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    data = str(root / "data")
    make_synthetic_dataset(data, ["oliver", "maher"], 3)
    jm = JaxClassifier(in_channels=FEATS, num_speakers=len(SPEAKERS))
    params, stats = flax_variables(jm, jnp.zeros((2, 64, FEATS)), None,
                                   train=False, seed=7)
    clf = root / "clf_weights.p"
    clf.write_bytes(serialization.msgpack_serialize(
        {"g_params": {"gen": params}, "g_state": {"gen": stats},
         "d_params": {}, "d_state": {}}))
    save = str(root / "jax")
    jt = JaxTrainer(jax_cfg(base(data, save_dir=save, save_optim=1,
                                 pretrained_model_weights=str(clf))),
                    SUB, {})
    jt.state = _as_if_trained(jt.state, np.random.default_rng(3))
    jt.book._save_model(jt.state)           # the greedy save of an epoch
    weights = jt.book.name("weights", "p", save)
    jt.sample(1)      # from its checkpoint, as JAX's cli.sample (hop 0)
    return dict(root=root, data=data, save=save, weights=weights, clf=clf,
                jax_kp=Path(jt.dir_name), jt=jt)


def _as_if_trained(state, rng):
    """A JAX ``TrainState`` with the optimizer state and counters of a run
    some steps in (seeded Adam moments, counts 5, the four counters apart
    from 0), without compiling a JAX train step.  ``nu`` is 4 mu² + 1e-8,
    as a history of gradients of one sign gives it, so that a step moves a
    weight by less than lr."""
    def opt(opt_state):
        clip, (adam, schedule) = opt_state
        mu = jax.tree.map(lambda a: rng.normal(size=a.shape) * 1e-3,
                          adam.mu)
        adam = adam._replace(
            count=jnp.asarray(5, adam.count.dtype),
            mu=jax.tree.map(lambda m, a: jnp.asarray(m, a.dtype), mu,
                            adam.mu),
            nu=jax.tree.map(lambda m, a: jnp.asarray(4 * m * m + 1e-8,
                                                     a.dtype), mu, adam.nu))
        return clip, (adam, schedule._replace(
            count=jnp.asarray(5, schedule.count.dtype)))
    return state.replace(
        g_opt_state=opt(state.g_opt_state),
        d_opt_state=opt(state.d_opt_state),
        step=jnp.asarray(9, jnp.int32), g_step=jnp.asarray(5, jnp.int32),
        lambda_step=jnp.asarray(3, jnp.int32),
        curriculum_step=jnp.asarray(2, jnp.int32))


def cli_args(argv):
    """A ``Config`` as ``argparse_n_loop`` hands it to a CLI's loop."""
    _, perms = get_args_perm(argv)
    cfg = config_from_dict(perms[0])
    cfg.typed_flags = _typed_flag_names(argv)
    return cfg


def test_files_are_flax_msgpack(exp):
    """What the JAX BookKeeper wrote is what the reader reads: the weights'
    four trees, the train state's optimizer states and counters."""
    with open(exp["weights"], "rb") as f:
        weights = unpackb(f.read())
    assert sorted(weights) == ["d_params", "d_state", "g_params", "g_state"]
    assert sorted(weights["g_params"]) == ["gen", "psenc"]
    trainstate = exp["weights"].replace("_weights.p", "_trainstate.p")
    with open(trainstate, "rb") as f:
        full = unpackb(f.read())
    assert sorted(full) == ["counters", "d_opt_state", "g_opt_state"]
    assert int(full["counters"]["step"]) > 0


def test_cli_sample_of_a_jax_checkpoint_matches_jax(exp):
    """``cli.sample -load <JAX PREFIX_weights.p>``: the port's sampled
    keypoints (every interval, both styles) against the JAX sampler's."""
    port_save = str(exp["root"] / "port_sample")
    captured = {}
    orig = Trainer.sample

    def keep(self, exp_num):
        orig(self, exp_num)
        captured["tr"] = self
    Trainer.sample = keep
    try:
        cli_sample.loop(cli_args(["-load", exp["weights"], "-path2data",
                                  exp["data"], "-save_dir", port_save]), 0,
                        device="cpu")
    finally:
        Trainer.sample = orig
    port_kp = Path(captured["tr"].dir_name)
    assert port_kp != exp["jax_kp"]
    for tree in ("keypoints", "keypoints_style"):
        want_files = sorted((exp["jax_kp"] / tree).rglob("*.h5"))
        assert len(want_files) == 6, tree
        for wf in want_files:
            pf = port_kp / wf.relative_to(exp["jax_kp"])
            with h5py.File(wf) as a, h5py.File(pf) as b:
                want, got = a["pose/data"][()], b["pose/data"][()]
            assert got.shape == want.shape, pf
            err = np.abs(got - want).max() / np.abs(want).mean()
            assert err <= POSE_RTOL, (pf, err)


@pytest.fixture(scope="module")
def resumed(exp):
    """The JAX trainer that wrote the checkpoint (its state is the one it
    saved at the end of its one epoch) and the port's trainer restored
    from that experiment with ``-save_optim 1`` (weights, optimizer
    states, counters)."""
    cfg = base(exp["data"], save_dir=exp["save"], load=exp["weights"],
               save_optim=1, pretrained_model_weights=str(exp["clf"]))
    pt = Trainer(config_from_dict(cfg), SUB, {}, device="cpu")
    return exp["jt"], pt


def _assert_equal_states(a, b):
    wa, wb = weights_of(a), weights_of(b)
    assert sorted(wa) == sorted(wb)
    for m in wa:
        for k, v in wa[m].items():
            assert torch.equal(v, wb[m][k]), (m, k)
    oa, ob = optim_of(a), optim_of(b)
    assert oa["counters"] == ob["counters"]
    for name in ("g_opt", "d_opt"):
        assert oa[name]["count"] == ob[name]["count"], name
        for slot in ("mu", "nu"):
            for x, y in zip(oa[name][slot], ob[name][slot]):
                assert torch.equal(x, y), (name, slot)


def test_resumed_state_is_jax_state(resumed):
    """The port's ``-load`` + ``-save_optim 1`` restore equals JAX's
    restored ``TrainState`` carried over by the bridge, bit for bit, at
    JAX's step."""
    jt, pt = resumed
    want = load_jax_train_state(pt.factory, jt.state)
    _assert_equal_states(pt.state, want)
    assert (pt.state.step, pt.state.g_step, pt.state.lambda_step,
            pt.state.curriculum_step) == (9, 5, 3, 2)
    assert pt.state.g_opt.count == pt.state.d_opt.count == 5


@pytest.mark.parametrize("branch", ["g", "d"])
def test_resumed_step_matches_jax(resumed, branch):
    """One G (or D) step from the resumed states on the same batch:
    losses, pose, params, BN statistics and counters at
    ``test_torch_port_train_steps.py``'s limits, Adam moments at
    ``MOMENT_TOL_RESUMED``."""
    jt, pt = resumed
    # a training batch, as each trainer prepares it (the shapes the JAX
    # trainer's steps were compiled for)
    raw = next(iter(pt.data_train.iter_all(batch_size=4)))
    jbatch, _, _ = jt.get_processed_batch(raw)
    batch, _, _ = pt.get_processed_batch(raw)
    jstate = jax.tree.map(jnp.array, jt.state)       # the steps donate it
    js, jl, jpose = jt.steps[branch](jstate, jbatch, jax.random.key(1),
                                     use_pose_input=False)
    ps, pl, ppose = pt.steps[branch](_copy_state(pt), batch,
                                     use_pose_input=False)
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), **POSE_TOL)
    assert_states_close(ps, js, MOMENT_TOL_RESUMED[branch])
    # a resume that lost the optimizer (moments and count at 0) is far
    # outside these limits
    lost = _copy_state(pt)
    opt = lost.g_opt if branch == "g" else lost.d_opt
    with torch.no_grad():
        for tensors in opt.slots().values():
            for t in tensors:
                t.zero_()
    opt.count = 0
    ps0, _, _ = pt.steps[branch](lost, batch, use_pose_input=False)
    with pytest.raises(AssertionError):
        assert_states_close(ps0, js, MOMENT_TOL_RESUMED[branch])


def _copy_state(pt):
    """The trainer's restored state, copied (a step updates in place)."""
    state = pt.factory.init(seed=1)
    load_weights(state, weights_of(pt.state))
    return load_optim(state, optim_of(pt.state))


def test_preempt_snapshot_restores(exp, resumed, tmp_path):
    """A JAX preemption snapshot (``PREFIX_preempt.p``, the live state
    with the optimizer and counters) restores in the port bit for bit."""
    jt, pt = resumed
    save = tmp_path / "preempt"
    cfg = base(exp["data"], save_dir=str(save))
    jbook = JaxBookKeeper(jax_cfg(cfg), SUB)
    jbook.save_preempt(jt.state, {"epoch_next": 1, "step": 3})
    book = BookKeeper(config_from_dict(cfg), SUB)
    state, meta = book.load_preempt(pt.factory.init(seed=2))
    assert meta == {"epoch_next": 1, "step": 3}
    _assert_equal_states(state, load_jax_train_state(pt.factory, jt.state))


def test_jax_classifier_checkpoint_gives_jax_is(exp, resumed):
    """``-pretrained_model_weights`` of a JAX ``StyleClassifier_G``
    checkpoint: the style IS values of the same poses equal JAX's."""
    jt, pt = resumed
    assert jt.IS is not None and pt.IS is not None
    rng = np.random.default_rng(4)
    for tr in (jt, pt):
        tr.metrics_reset()
    for batch in list(pt.data_train.iter_all(batch_size=4))[:2]:
        step_batch, y_, insert = pt.get_processed_batch(batch)
        y_cap = rng.normal(size=step_batch["y"].shape)
        for tr in (jt, pt):
            tr.calculate_metrics(y_cap, y_, "same", insert=insert,
                                 style=step_batch["style"])

    def values(tr):
        avgs = tr.IS.get_averages("test")
        return avgs[0] if isinstance(avgs, tuple) else avgs
    want, got = values(jt), values(pt)
    assert sorted(got) == sorted(want) and "test_style_IS" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=IS_RTOL, atol=1e-8,
                                   err_msg=k)


def test_args_of_the_jax_experiment_restore(exp):
    """The JAX ``PREFIX_args.args`` restores in the port's ``BookKeeper``
    without rewriting it (the JAX experiment's record stays as written)."""
    args_file = exp["weights"].replace("_weights.p", "_args.args")
    before = Path(args_file).read_text()
    book = BookKeeper(config_from_dict(dict(load=exp["weights"])), SUB)
    assert book.args.save_optim == 1 and book.args.lr == LR
    assert Path(args_file).read_text() == before
    assert json.loads(before)["model"] == book.args.model
