"""Speech2Gesture_G, StyleClassifier_G, the 2-class and joint D, the
non-GAN step and the classifier step against the JAX package.

Weights are drawn with numpy in flax layout and loaded into both packages
(``interop/weights.py``, which round-trips every tree here).  Small sizes:
B=2, T=64, 32 mel bins, 96 pose features, in_channels 32.

Tolerances: forwards max |port - JAX| ≤ 1e-4 · max |JAX|, the
generator forward's tolerance in ``test_torch_port_model.py`` (float32
summation order; 1.4e-5 measured for Speech2Gesture_G in training mode); a step's losses at rtol 1e-4, its pose at rtol 1e-3 /
atol 1e-4, parameters at 2·lr (+1e-6), BatchNorm statistics at 1e-4 of
each leaf's scale and the Adam moments per module at ``MOMENT_TOL``
relative Frobenius (about twice the largest gap measured, noted beside
it; ``test_torch_port_train_steps.py`` says why float32 moments drift);
the classifier's accuracy exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import (flat_tree, flax_variables, jax_train_state,
                                 port_state)
from mixstage_tpu.models import speech2gesture as JS2G
from mixstage_tpu.models.style_classifier import \
    StyleClassifier_G as JaxClassifier
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.models import (Speech2Gesture_D, Speech2Gesture_G,
                                       StyleClassifier_G, get_model_def,
                                       register_model)
from mixstage_tpu_torch.train import StepConfig, StepFactory

B, T, MEL, FEATS, C = 2, 64, 32, 96, 32
LR = 1e-4
FWD_TOL = 1e-4
LOSS_RTOL = 1e-4
STAT_TOL = 1e-4
POSE_TOL = dict(rtol=1e-3, atol=1e-4)
CONFIGS = {
    "s2g_nongan": dict(model="Speech2Gesture_G", gan=False,
                       model_kwargs=(("in_channels", C),)),
    "s2g_gan": dict(model="Speech2Gesture_G", gan=True,
                    model_kwargs=(("in_channels", C),)),
    # both packages ignore -fused_decoder without the mixture decoder
    "s2g_gan_fused": dict(model="Speech2Gesture_G", gan=True,
                          fused_decoder=True,
                          model_kwargs=(("in_channels", C),)),
    "mixstage_nongan": dict(model="JointLateClusterSoftStyle4_G", gan=False,
                            num_clusters=2,
                            model_kwargs=(("in_channels", C),)),
    "classifier": dict(model="StyleClassifier_G", gan=False),
}
# relative Frobenius per module [largest gap measured, mu or nu]
MOMENT_TOL = {"s2g_nongan": 3e-4,          # [1.3e-4 gen/unet]
              "s2g_gan": 2e-4,             # [6.0e-5 gen/logits]
              "s2g_gan_fused": 2e-4,       # the same step
              "mixstage_nongan": 3e-2,     # [1.3e-2 gen/unet]
              "classifier": 4e-3}          # [1.8e-3 gen/classifier1]


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(B, T, MEL)).astype(np.float32),),
            "y": rng.normal(size=(B, T, FEATS)).astype(np.float32),
            "labels": rng.integers(0, 2, size=(B, T)),
            "style": np.repeat(np.array([[0], [1]]), T, 1)}


def close(got, want, tol=FWD_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_speech2gesture_g_forward(train):
    jm = JS2G.Speech2Gesture_G(in_channels=C, out_feats=FEATS)
    x = np.random.default_rng(0).normal(size=(B, T, MEL)).astype(np.float32)
    params, stats = flax_variables(jm, jnp.asarray(x), train=False, seed=3)
    out = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(x), train=train, mutable=["batch_stats"])
    (want, internal), new_stats = out
    tm = Speech2Gesture_G(in_channels=C, out_feats=FEATS)
    W.load_flax_state(tm, params, stats)
    tm.train(train)
    with torch.no_grad():
        got, t_internal = tm(torch.from_numpy(x))
    assert internal == [] and t_internal == []
    close(got.numpy(), want)
    # the weight bridge round-trips the tree (names decoder{i}, logits)
    p2, s2 = W.to_flax_state(tm)
    assert sorted(flat_tree(p2)) == sorted(flat_tree(params))
    if train:
        for k, v in flat_tree(new_stats["batch_stats"]).items():
            close(flat_tree(s2)[k], v, STAT_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_style_classifier_forward(train):
    jm = JaxClassifier(in_channels=FEATS, num_speakers=3)
    y = np.random.default_rng(1).normal(size=(B, T, FEATS)).astype(
        np.float32)
    params, stats = flax_variables(jm, jnp.asarray(y), None, train=False,
                                   seed=4)
    (want, _), _ = jm.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(y), None, train=train,
                            mutable=["batch_stats"])
    tm = StyleClassifier_G(in_channels=FEATS, num_speakers=3)
    W.load_flax_state(tm, params, stats)
    tm.train(train)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(y))
    assert got.shape == (B, 3)
    close(got.numpy(), want)
    assert [n for n, _ in tm.named_children()] == [
        f"classifier{i}" for i in range(6)]


@pytest.mark.parametrize("in_channels,out_shape", [(FEATS, 2),
                                                   (FEATS + 128, 1)],
                         ids=["two_class", "joint"])
def test_discriminator_out_shape_and_width(in_channels, out_shape):
    """The weighted GAN's 2-class D ((B, T', 2) scores) and the joint D's
    wider input against flax, in training mode."""
    jm = JS2G.Speech2Gesture_D(in_channels=in_channels, out_shape=out_shape)
    v = np.random.default_rng(2).normal(size=(B, T, in_channels)).astype(
        np.float32)
    params, stats = flax_variables(jm, jnp.asarray(v), train=False, seed=5)
    (want, _), _ = jm.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(v), train=True,
                            mutable=["batch_stats"])
    tm = Speech2Gesture_D(in_channels=in_channels, out_shape=out_shape)
    W.load_flax_state(tm, params, stats)
    with torch.no_grad():
        got, _ = tm.train()(torch.from_numpy(v))
    # 64 frames: conv1 → 32, conv2_0 → 16, conv3 → 15, logits (k4) → 12
    assert got.shape == want.shape == ((B, 12, 2) if out_shape == 2
                                       else (B, 12))
    close(got.numpy(), want)


@pytest.fixture(scope="module")
def jax_runs():
    """Each config's initial state and one train step (the classifier's
    eval step too), as numpy."""
    out = {}
    for name, cfg in CONFIGS.items():
        f = JaxStepFactory(JaxStepConfig(**cfg, num_speakers=2, lr=LR),
                           donate=False)
        state0 = jax_train_state(f, jax.tree.map(jnp.asarray,
                                                 make_batch(0)))
        steps = f.make_steps()
        batch = jax.tree.map(jnp.asarray, make_batch(1))
        key = "g" if f.cfg.gan else "train"
        js, jl, jout = steps[key](state0, batch, jax.random.key(1))
        runs = {"state0": _np(state0), "train": (_np(jl), np.asarray(jout),
                                                 _np(js))}
        if name == "classifier":
            jl, logits, _ = steps["eval"](state0, batch)
            runs["eval"] = (_np(jl), np.asarray(logits))
        out[name] = runs
    return out


def module_gaps(got, want):
    num, den = {}, {}
    for k, b in want.items():
        if k.endswith("conv/bias"):
            continue
        parts = k.split("/")
        m = "/".join(parts[:2])
        num[m] = num.get(m, 0.0) + float(np.sum((got[k] - b) ** 2))
        den[m] = den.get(m, 0.0) + float(np.sum(b ** 2))
    return {m: np.sqrt(num[m]) / max(np.sqrt(den[m]), 1e-30) for m in num}


def assert_state_close(ps, js, name):
    port = W.jax_train_state_of(ps)
    fields = ["g_params", "g_state"] + (["d_params", "d_state"]
                                        if ps.disc is not None else [])
    for field in fields:
        got, want = flat_tree(port[field]), flat_tree(getattr(js, field))
        assert sorted(got) == sorted(want), field
        for k, b in want.items():
            err = np.abs(got[k] - b).max()
            if field.endswith("params"):
                assert err <= 2 * LR + 1e-6, (field, k, err)
            else:
                assert err <= STAT_TOL * np.abs(b).max(), (field, k, err)
    nodes = W._opt_nodes(js.g_opt_state)
    assert port["g_opt_state"]["count"] == int(nodes["count"]) == 1
    for slot in ("mu", "nu"):
        gaps = module_gaps(flat_tree(port["g_opt_state"][slot]),
                           flat_tree(nodes[slot]))
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= MOMENT_TOL[name], (slot, worst, gaps[worst])
    for k in W.COUNTERS:
        assert getattr(ps, k) == int(getattr(js, k)), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_jax(jax_runs, name):
    cfg = CONFIGS[name]
    factory = StepFactory(StepConfig(**cfg, num_speakers=2, lr=LR),
                          device="cpu")
    steps = factory.make_steps()
    assert sorted(steps) == (["d", "eval", "g"] if cfg["gan"]
                             else ["eval", "train"])
    ps = port_state(factory, jax_runs[name]["state0"])
    assert (ps.psenc is None) == (name != "mixstage_nongan")
    assert (ps.disc is None) == (not cfg["gan"])
    ps, pl, pout = steps["g" if cfg["gan"] else "train"](ps, make_batch(1),
                                                         rng=1)
    jl, jout, js = jax_runs[name]["train"]
    assert sorted(pl) == sorted(jl)
    for k, v in jl.items():
        if k == "W":
            np.testing.assert_array_equal(pl[k].numpy(), v)
        elif k == "acc":
            assert float(pl[k]) == float(v)
        else:
            np.testing.assert_allclose(float(pl[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(pout.numpy(), jout, **POSE_TOL)
    assert_state_close(ps, js, name)


def test_classifier_eval_step_matches_jax(jax_runs):
    factory = StepFactory(StepConfig(**CONFIGS["classifier"], num_speakers=2,
                                     lr=LR), device="cpu")
    ps = port_state(factory, jax_runs["classifier"]["state0"])
    pl, logits, aux = factory.make_steps()["eval"](ps, make_batch(1))
    jl, jlogits = jax_runs["classifier"]["eval"]
    assert aux == {} and sorted(pl) == ["acc", "pose", "total"]
    close(logits.numpy(), jlogits)
    np.testing.assert_allclose(float(pl["total"]), float(jl["total"]),
                               rtol=LOSS_RTOL)
    assert float(pl["acc"]) == float(jl["acc"])
    assert ps.gen.training is False
    with pytest.raises(ValueError, match="classifier"):
        factory.make_scan_train_step(2)


def test_non_gan_scan_driver_matches_per_step():
    """``make_scan_train_step`` without a GAN: every step the non-GAN step
    (the coins are ignored, as the JAX package ignores them), equal to the
    per-step calls bit for bit."""
    factory = StepFactory(StepConfig(**CONFIGS["mixstage_nongan"],
                                     num_speakers=2, lr=LR, noise=0.01),
                          device="cpu")
    k = 3
    batches = [make_batch(20 + i) for i in range(k)]
    stacked = {key: ((np.stack([b[key][0] for b in batches]),)
                     if key == "x" else np.stack([b[key] for b in batches]))
               for key in batches[0]}
    ps, losses, poses = factory.make_scan_train_step(k)(
        factory.init(seed=1), stacked, [True] * k, rngs=[5, 6, 7])
    seq = factory.init(seed=1)
    for i in range(k):
        seq, sl, pose = factory.make_steps()["train"](seq, batches[i],
                                                      rng=5 + i)
        assert torch.equal(losses["total"][i], sl["total"])
        assert float(losses["G_gan"][i]) == 0.0
        assert torch.equal(poses[i], pose)
    for a, b in zip(ps.g_opt.params, seq.g_opt.params):
        assert torch.equal(a, b)
    assert ps.step == seq.step == k and ps.lambda_step == 0


def test_registry_names_every_model_and_refuses_disentangle():
    for name in ("Speech2Gesture_G", "StyleClassifier_G",
                 "JointLateClusterSoftStyle4_G", "Speech2Gesture_D",
                 "JointLateClusterSoftStyle4_D"):
        assert get_model_def(name) is not None
    # JAX's message: the reference ships no Disentangle generator
    with pytest.raises(NotImplementedError, match="upstream-incomplete"):
        get_model_def("JointLateClusterSoftStyleDisentangle_G")
    with pytest.raises(KeyError):
        get_model_def("NoSuchModel_G")
    from mixstage_tpu_torch.models.registry import MODEL_REGISTRY

    register_model("Speech2Gesture2_G", Speech2Gesture_G)
    try:
        assert get_model_def("Speech2Gesture2_G") is Speech2Gesture_G
    finally:
        MODEL_REGISTRY.pop("Speech2Gesture2_G")
