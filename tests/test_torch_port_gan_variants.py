"""The weighted GAN, the joint discriminator, pose noise and the confidence
loss: the port's steps against the JAX package's, from one state.

A small Mix-StAGE configuration (in_channels 32, 2 clusters, 2 speakers,
B=2, T=64, 128 mel bins: the joint D's input width is the JAX package's
fixed 96 + 128 for ``audio/log_mel_512``) against ``Speech2Gesture_D``.

* weighted + joint, float32: the G and D steps and the k-step driver with
  ``W`` (a (k, B) entry), against JAX's, and the driver against the
  per-step calls bit for bit;
* noise 0.01 and a seeded ``confidence`` array, float32: the port's one
  noise draw (``steps.pose_noise``) returns JAX's draw
  (``jax.random.normal(split(rng)[0], ...)``), so both steps see the same
  noisy pose;
* all four together in float64 (JAX's x64 scoped to its fixture);
* the joint D's input for streams of other lengths (100 and 37 frames
  against 64) equals JAX's ``jax.image.resize(..., "nearest")`` bit for
  bit, and the confidence entropy loss equals JAX's element for element.

Tolerances: float32 as ``test_torch_port_train_steps.py`` holds a step
(the k-step driver at its lr 1e-6, params 2·lr per step)
(losses and W rtol 1e-4, pose rtol 1e-3 / atol 1e-4, parameters 2·lr,
BatchNorm statistics 1e-4 of each leaf's scale), the Adam moments by
module at ``MOMENT_TOL`` (relative Frobenius; a leaky unit within ~1e-6
of 0 flips between the packages and moves the gradients upstream of it,
that file says why; the largest gaps measured are noted beside it; in
float64 the same steps agree to 1e-9, so the gaps are float32's);
float64 at 1e-9 per leaf (``test_torch_port_f64_steps.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import flat_tree, jax_train_state, port_state
from mixstage_tpu.models.layers import \
    confidence_entropy_loss as jax_confidence
from mixstage_tpu.train.losses import adaptive_d_prob as jax_adaptive
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.models.layers import confidence_entropy_loss
from mixstage_tpu_torch.train import StepConfig, StepFactory
from mixstage_tpu_torch.train import steps as port_steps
from mixstage_tpu_torch.train.losses import adaptive_d_prob

B, T, MEL, FEATS = 2, 64, 128, 96
LR = 1e-4
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=2, lr=LR,
           model_kwargs=(("in_channels", 32),))
VARIANTS = {"wj": dict(weighted=True, joint=True),
            "noise": dict(noise=0.01)}
LOSS_RTOL = 1e-4
STAT_TOL = 1e-4
POSE_TOL = dict(rtol=1e-3, atol=1e-4)
# Adam moments, relative Frobenius per module, about twice the largest gap
# measured: one step [7.0e-3 gen/classify_cluster, weighted + joint G step;
# 6.9e-4 with noise; D steps 6.6e-4]; the k-step driver G, D, G [2.04e-2,
# the same in every G module: the clip divides by a global norm of ~80 that
# a few leaves dominate, so their gap scales every clipped gradient alike;
# JAX's own scan and its per-step calls differ by 1.3e-3 there]
MOMENT_TOL = {"step": 1.5e-2, "scan": 4e-2}
TOL64 = 1e-9
K = 3
# the k-step driver at lr 1e-6, as test_torch_port_train_steps.py runs it:
# at 1e-4 a flipped noise-level gradient moves a weight by 2·lr per step and
# the later steps' poses drift apart by more than a step's tolerance
SCAN_LR = 1e-6
COINS = np.array([False, True, False])          # G, D, G


def make_batch(seed, confidence=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b = {"x": (rng.normal(size=(B, T, MEL)).astype(dtype),),
         "y": rng.normal(size=(B, T, FEATS)).astype(dtype),
         "labels": rng.integers(0, 2, size=(B, T)),
         "style": np.repeat(rng.integers(0, 2, size=(B, 1)), T, 1)}
    if confidence:
        b["confidence"] = rng.uniform(0.0, 1.5, size=(B, T, FEATS)).astype(
            dtype)
    return b


def jax_noise(shape, dtype, device, generator, key):
    """JAX's noise draw of a step keyed ``key`` (``steps.py:511-514``), in
    float64 under x64 as the float64 step draws it."""
    with jax.enable_x64(dtype == torch.float64):
        draw = jax.random.normal(jax.random.split(key)[0], shape,
                                 jnp.dtype(str(dtype).split(".")[-1]))
        return torch.from_numpy(np.array(draw)).to(device)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """Each variant's initial state and its G and D steps (and the k-step
    driver for "wj"), as numpy; the float64 variant under x64."""
    out = {}
    for name, change in VARIANTS.items():
        f = JaxStepFactory(JaxStepConfig(**CFG, **change), donate=False)
        state0 = jax_train_state(f, jax.tree.map(jnp.asarray,
                                                 make_batch(0)))
        steps = f.make_steps()
        runs = {"state0": _np(state0)}
        conf = name == "noise"
        for branch, seed in (("g", 1), ("d", 2)):
            js, jl, jpose = steps[branch](
                state0, jax.tree.map(jnp.asarray, make_batch(seed, conf)),
                jax.random.key(seed))
            runs[branch] = (_np(jl), np.asarray(jpose), _np(js))
        if name == "wj":
            stacked = jax.tree.map(lambda *a: np.stack(a),
                                   *[make_batch(10 + i) for i in range(K)])
            f = JaxStepFactory(JaxStepConfig(**{**CFG, "lr": SCAN_LR},
                                             **change), donate=False)
            js, jl, jposes = f.make_scan_train_step(K)(
                state0, jax.tree.map(jnp.asarray, stacked),
                jnp.asarray(COINS),
                jnp.stack([jax.random.key(i) for i in range(K)]))
            runs["scan"] = (_np(jl), np.asarray(jposes), _np(js), stacked)
        out[name] = runs
    with jax.enable_x64(True):
        change = dict(weighted=True, joint=True, noise=0.01)
        f = JaxStepFactory(JaxStepConfig(**CFG, **change,
                                         dtype=jnp.float64), donate=False)
        state0 = jax_train_state(f, jax.tree.map(
            jnp.asarray, make_batch(0, dtype=np.float64)), dtype=np.float64)
        steps = f.make_steps()
        runs = {"state0": _np(state0)}
        for branch, seed in (("g", 1), ("d", 2)):
            js, jl, jpose = steps[branch](
                state0, jax.tree.map(jnp.asarray, make_batch(
                    seed, True, np.float64)), jax.random.key(seed))
            runs[branch] = (_np(jl), np.asarray(jpose), _np(js))
        out["f64"] = runs
    return out


def module_gaps(got, want):
    """Relative Frobenius error of each module's leaves (``gen/unet``,
    ``psenc/stack``, D's ``conv1``), the pre-BN conv biases apart."""
    num, den = {}, {}
    for k, b in flat_tree(want).items():
        if k.endswith("conv/bias"):
            continue
        parts = k.split("/")
        m = "/".join(parts[:2]) if parts[0] in ("gen", "psenc") else parts[0]
        num[m] = num.get(m, 0.0) + float(np.sum((got[k] - b) ** 2))
        den[m] = den.get(m, 0.0) + float(np.sum(b ** 2))
    return {m: np.sqrt(num[m]) / max(np.sqrt(den[m]), 1e-30) for m in num}


def assert_state_close(ps, js, f64=False, param_atol=2 * LR + 1e-6,
                       moment_tol=MOMENT_TOL["step"]):
    port = W.jax_train_state_of(ps)
    for field in ("g_params", "d_params", "g_state", "d_state"):
        got, want = flat_tree(port[field]), flat_tree(getattr(js, field))
        assert sorted(got) == sorted(want), field
        for k, b in want.items():
            err = np.abs(got[k] - b).max()
            scale = np.abs(b).max()
            if f64:
                assert err <= TOL64 * scale, (field, k, err)
            elif field.endswith("params"):
                assert err <= param_atol, (field, k, err)
            else:
                assert err <= STAT_TOL * scale, (field, k, err)
    for field in ("g_opt_state", "d_opt_state"):
        nodes = W._opt_nodes(getattr(js, field))
        assert port[field]["count"] == int(nodes["count"])
        for slot in ("mu", "nu"):
            got, want = flat_tree(port[field][slot]), flat_tree(nodes[slot])
            if f64:
                for k, b in want.items():
                    err = np.abs(got[k] - b).max()
                    if k.endswith("conv/bias"):
                        assert err <= 1e-12, (field, slot, k, err)
                    else:
                        assert err <= TOL64 * np.abs(b).max(), \
                            (field, slot, k, err)
            else:
                gaps = module_gaps(got, want)
                worst = max(gaps, key=gaps.get)
                assert gaps[worst] <= moment_tol, (field, slot, worst,
                                                   gaps[worst])
    for k in W.COUNTERS:
        assert getattr(ps, k) == int(getattr(js, k)), k


def assert_losses_close(got, want, rtol=LOSS_RTOL):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-7), \
            (k, a, b)


def run_port(jax_runs, name, branch, seed, monkeypatch, f64=False):
    change = dict(weighted=True, joint=True, noise=0.01) if f64 \
        else VARIANTS[name]
    dtype = torch.float64 if f64 else torch.float32
    factory = StepFactory(StepConfig(**CFG, **change, dtype=dtype),
                          device="cpu")
    monkeypatch.setattr(port_steps, "pose_noise",
                        lambda *a: jax_noise(*a, key=jax.random.key(seed)))
    ps = port_state(factory, jax_runs[name]["state0"])
    conf = f64 or name == "noise"
    return factory.make_steps()[branch](
        ps, make_batch(seed, conf, np.float64 if f64 else np.float32),
        rng=seed)


@pytest.mark.parametrize("name,branch", [("wj", "g"), ("wj", "d"),
                                         ("noise", "g"), ("noise", "d")])
def test_variant_step_matches_jax_f32(jax_runs, monkeypatch, name, branch):
    seed = {"g": 1, "d": 2}[branch]
    ps, pl, ppose = run_port(jax_runs, name, branch, seed, monkeypatch)
    jl, jpose, js = jax_runs[name][branch]
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(ppose.numpy(), jpose, **POSE_TOL)
    assert_state_close(ps, js)
    if name == "wj":
        W_ = pl["W"].numpy()
        assert W_.shape == (B,) and (W_ >= 0.1).all() and (W_ <= 10).all()


@pytest.mark.parametrize("branch", ["g", "d"])
def test_variants_together_match_jax_f64(jax_runs, monkeypatch, branch):
    seed = {"g": 1, "d": 2}[branch]
    ps, pl, ppose = run_port(jax_runs, "f64", branch, seed, monkeypatch,
                             f64=True)
    jl, jpose, js = jax_runs["f64"][branch]
    assert_losses_close(pl, jl, rtol=TOL64)
    np.testing.assert_allclose(ppose.numpy(), jpose, rtol=0,
                               atol=TOL64 * np.abs(jpose).max())
    assert_state_close(ps, js, f64=True)


def test_scan_driver_with_weights(jax_runs):
    """k steps (G, D, G) in one call: ``W`` stacks to (k, B); the call
    equals k per-step calls bit for bit and follows JAX's scan."""
    factory = StepFactory(StepConfig(**{**CFG, "lr": SCAN_LR},
                                     **VARIANTS["wj"]), device="cpu")
    jl, jposes, js, stacked = jax_runs["wj"]["scan"]
    state0 = jax_runs["wj"]["state0"]
    assert "W" in factory.union_keys()
    ps, losses, poses = factory.make_scan_train_step(K)(
        port_state(factory, state0), stacked, COINS, rngs=list(range(K)))
    assert losses["W"].shape == (K, B) and losses["total"].shape == (K,)
    seq = port_state(factory, state0)
    steps = factory.make_steps()
    for i in range(K):
        batch = {k: (tuple(a[i] for a in v) if k == "x" else v[i])
                 for k, v in stacked.items()}
        seq, sl, pose = steps["d" if COINS[i] else "g"](seq, batch, rng=i)
        for key in losses:
            assert torch.equal(losses[key][i], sl.get(
                key, torch.zeros(())).float()), (i, key)
        assert torch.equal(poses[i], pose)
    for a, b in zip(ps.g_opt.params + ps.d_opt.params,
                    seq.g_opt.params + seq.d_opt.params):
        assert torch.equal(a, b)
    assert_losses_close(losses, jl)
    np.testing.assert_allclose(poses.numpy(), jposes, **POSE_TOL)
    assert_state_close(ps, js, param_atol=2 * SCAN_LR * K + 1e-6,
                       moment_tol=MOMENT_TOL["scan"])


@pytest.mark.parametrize("length", [100, 37])
def test_joint_d_input_resizes_as_jax(length):
    """A stream of another length than the pose goes to D resized by
    ``jax.image.resize``'s nearest rule (half-pixel centres), which is
    torch's "nearest-exact", not its "nearest"."""
    jf = JaxStepFactory(JaxStepConfig(**CFG, **VARIANTS["wj"]),
                        donate=False)
    pf = StepFactory(StepConfig(**CFG, **VARIANTS["wj"]), device="cpu")
    rng = np.random.default_rng(length)
    pose = rng.normal(size=(B, T, FEATS)).astype(np.float32)
    x = rng.normal(size=(B, length, MEL)).astype(np.float32)
    want = np.asarray(jf._d_input(jnp.asarray(pose), [jnp.asarray(x)]))
    got = pf._d_input(torch.from_numpy(pose), [torch.from_numpy(x)])
    assert got.shape == (B, T, FEATS + MEL)
    np.testing.assert_array_equal(got.numpy(), want)
    xt = torch.from_numpy(x).permute(0, 2, 1)
    exact = torch.nn.functional.interpolate(xt, size=T,
                                            mode="nearest-exact")
    np.testing.assert_array_equal(exact.permute(0, 2, 1).numpy(),
                                  want[..., FEATS:])
    plain = torch.nn.functional.interpolate(xt, size=T, mode="nearest")
    assert not np.array_equal(plain.permute(0, 2, 1).numpy(),
                              want[..., FEATS:])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_confidence_entropy_loss_matches_jax(dtype):
    rng = np.random.default_rng(5)
    y, y_cap = (rng.normal(size=(B, T, FEATS)).astype(dtype)
                for _ in range(2))
    conf = rng.uniform(0.0, 1.5, size=(B, T, FEATS)).astype(dtype)
    got = confidence_entropy_loss(*(torch.from_numpy(a)
                                    for a in (y, y_cap, conf))).numpy()
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_confidence(jnp.asarray(y), jnp.asarray(y_cap),
                                         jnp.asarray(conf)))
    assert got.dtype == want.dtype == dtype
    # relative to the largest |loss| (elements near 0 carry the absolute
    # rounding of the log: 2.4e-7 in float32)
    tol = 1e-6 if dtype == np.float32 else 1e-13
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("W,d_prob,ratio", [
    ([2.0, 2.9], 0.5, 1.0), ([0.1, 0.1, 0.2], 0.5, 1.0),
    ([10.0] * 4, 0.9, 2.0), ([1.0, np.nan], 0.4, 1.0)],
    ids=["weak_d", "strong_d", "clipped", "nan"])
def test_adaptive_d_prob_matches_jax(W, d_prob, ratio):
    """``-update_D_prob_flag``'s coin probability, exactly JAX's host math
    (a non-finite mean W leaves it as it was)."""
    got = adaptive_d_prob(d_prob, np.asarray(W, np.float32), ratio)
    assert got == jax_adaptive(d_prob, np.asarray(W, np.float32), ratio)
