"""The port's GAN steps at the bfloat16 compute dtype.

* One G and one D step from the same state against the JAX package's
  ``StepFactory(dtype=bfloat16)`` (its batch cast to bf16, as
  ``bench.py:227-229`` does; compiled with XLA's excess precision off,
  ``jax_nominal``), each output's drift from the float32 step (the port's,
  which matches JAX's to 1e-4, ``test_torch_port_train_steps.py``) held
  by the bf16 rule (``_torch_port_helpers.bf16_rule``): the pose, the loss
  terms, and BatchNorm's running statistics module by module.  Not held
  to it: the terms computed by a train-mode network on the generated pose
  (G_gan, id_out and the total in the G step; fake_D and the total in the
  D step) and the Adam moments.  There a bf16 rounding of the generated pose
  (5-6% from float32 after the generator's train-mode BatchNorms, whose
  bottleneck normalises over B·2 rows here) meets another train-mode
  network, and two valid roundings land 2-3x apart from the truth (measured
  at B = 8 over three batches: G_gan 0.3-1.9%, fake_D 2.3-3.6%; Adam mu
  30-100% per module from float32 in JAX and in the port alike).  Those
  are held by the 50-step trajectory below, as the JAX package holds its
  own bf16 training.
* The fused bf16 G step (K3's bf16 mode; its plain version here) against
  the unfused one, each against the float32 step: pose and total loss by
  the bf16 rule.
* 50 interleaved G/D steps from the same weights, bf16 against float32:
  median per-step pose-loss divergence < 2%, 50-step level gap < 2%
  (``tests/test_steps.py::test_bf16_training_dynamics_bound``); bf16 eval
  against float32 eval: drift < 5%, PCK@0.2 > 0.99
  (``test_bf16_eval_pck_parity``); the k-step driver at bf16 equals its
  steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import as_np, bf16_rule, flax_variables, \
    jax_nominal
from mixstage_tpu.train.state import TrainState as JaxTrainState
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import to_flax_state
from mixstage_tpu_torch.train import StepConfig, StepFactory

B, T, MEL, FEATS = 8, 64, 32, 96
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=2, lr=1e-4,
           model_kwargs=(("in_channels", 64),))
BF16 = dict(dtype=torch.bfloat16)
# the loss terms whose network sees only the batch, or the generated pose
# through a network in eval mode (see the module docstring)
HELD = {"g": ("pose", "id_in", "label"),
        "d": ("real_D", "id_in", "id_out", "label")}


def make_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(b, T, MEL)).astype(np.float32),),
            "y": rng.normal(size=(b, T, FEATS)).astype(np.float32),
            "labels": rng.integers(0, 2, size=(b, T)),
            "style": np.repeat(rng.integers(0, 2, size=(b, 1)), T, 1)}


def jax_batch(batch, dtype=jnp.float32):
    return {k: (tuple(jnp.asarray(a, dtype) for a in v) if k == "x" else
                jnp.asarray(v, dtype) if np.asarray(v).dtype.kind == "f"
                else jnp.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's bf16 factory and an initial state (drawn through its float32
    factory's modules)."""
    f32 = JaxStepFactory(JaxStepConfig(**CFG), donate=False)
    f16 = JaxStepFactory(JaxStepConfig(**CFG, dtype=jnp.bfloat16),
                         donate=False)
    batch = jax_batch(make_batch(0))
    gp, gs = flax_variables(f32.gen, list(batch["x"]), batch["y"],
                            jnp.zeros((B, T, 2)),
                            input_modalities=["audio/log_mel_512"],
                            use_pose_input=False, train=False, seed=1)
    pp, ps = flax_variables(f32.psenc, batch["y"], train=False, seed=2)
    dp, ds = flax_variables(f32.disc, batch["y"], train=False, seed=3)
    g_params = {"gen": gp, "psenc": pp}
    state = JaxTrainState(g_params=g_params,
                          g_state={"gen": gs, "psenc": ps},
                          g_opt_state=f32.g_tx.init(g_params), d_params=dp,
                          d_state=ds, d_opt_state=f32.d_tx.init(dp))
    return f16, state


def port_state(factory, jstate):
    return factory.init_from_flax(jstate.g_params, jstate.g_state,
                                  jstate.d_params, jstate.d_state,
                                  jstate.g_opt_state, jstate.d_opt_state)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = as_np(v).ravel()
    return out


def _module_stats(tree):
    """BatchNorm statistics by module (``gen/unet``, ``psenc/stack``, D's
    ``conv2_0``), each module's leaves concatenated in path order."""
    out = {}
    for key, a in sorted(_leaves(tree).items()):
        parts = key.split("/")
        m = "/".join(parts[:2]) if parts[0] in ("gen", "psenc") else parts[0]
        out[m] = np.concatenate([out[m], a]) if m in out else a
    return out


@pytest.mark.parametrize("branch", ["g", "d"])
def test_bf16_step_follows_jax_bf16(jax_side, branch):
    f16, jstate = jax_side
    batch = make_batch(1)
    args16 = (jstate, jax_batch(batch, jnp.bfloat16), jax.random.key(1))
    qs, ql, qpose = jax_nominal(getattr(f16, f"_{branch}_step"), *args16)
    f32 = StepFactory(StepConfig(**CFG), device="cpu")
    rs, rl, rpose = f32.make_steps()[branch](port_state(f32, jstate), batch)
    factory = StepFactory(StepConfig(**CFG, **BF16), device="cpu")
    ps, pl, ppose = factory.make_steps()[branch](port_state(factory, jstate),
                                                 batch)
    assert ppose.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in pl.values())
    assert all(bool(torch.isfinite(v).all()) for v in pl.values())
    dp, dq, ok = bf16_rule(as_np(ppose), as_np(qpose), as_np(rpose))
    assert ok, ("pose", dp, dq)
    for key in HELD[branch]:
        dp, dq, ok = bf16_rule(as_np(pl[key]), as_np(ql[key]),
                               as_np(rl[key]))
        assert ok, (key, dp, dq)
    if branch == "g":
        got, truth = ({"gen": to_flax_state(st.gen)[1],
                       "psenc": to_flax_state(st.psenc)[1]}
                      for st in (ps, rs))
        want = qs.g_state
    else:
        got, truth = (to_flax_state(st.disc)[1] for st in (ps, rs))
        want = qs.d_state
    got, want, truth = (_module_stats(t) for t in (got, want, truth))
    for m in truth:
        dp, dq, ok = bf16_rule(got[m], want[m], truth[m], frobenius=True)
        assert ok, (m, dp, dq)


def test_bf16_fused_g_step_follows_unfused():
    """K3's bf16 mode (its plain version on the CPU) through the G step:
    the fused step's pose and total loss drift from the float32 step as the
    unfused bf16 step's do."""
    batch = make_batch(2)
    out = {}
    for name, kw in (("f32", {}), ("unfused", BF16),
                     ("fused", dict(BF16, fused_decoder=True))):
        factory = StepFactory(StepConfig(**CFG, **kw), device="cpu")
        out[name] = factory.make_steps()["g"](factory.init(seed=0), batch)
    (_, r_l, r_pose), (_, q_l, q_pose), (_, p_l, p_pose) = (
        out[k] for k in ("f32", "unfused", "fused"))
    dp, dq, ok = bf16_rule(as_np(p_pose), as_np(q_pose), as_np(r_pose))
    assert ok, ("pose", dp, dq)
    dp, dq, ok = bf16_rule(as_np(p_l["total"]), as_np(q_l["total"]),
                           as_np(r_l["total"]))
    assert ok, ("total", dp, dq)


def _factories():
    return (StepFactory(StepConfig(**CFG), device="cpu"),
            StepFactory(StepConfig(**CFG, **BF16), device="cpu"))


def test_bf16_training_dynamics_bound():
    """50 interleaved G/D steps (every third a D step) from the same float32
    weights, one arm computing in bf16: the pose loss tracks the float32
    trajectory (median per-step divergence < 2%, mean level gap < 2%)."""
    f32, f16 = _factories()
    s32, s16 = f32.init(seed=3), f16.init(seed=3)
    steps32, steps16 = f32.make_steps(), f16.make_steps()
    batch = make_batch(3, b=2)
    l32, l16 = [], []
    for step in range(50):
        branch = "d" if step % 3 == 2 else "g"
        s32, o32, _ = steps32[branch](s32, batch)
        s16, o16, _ = steps16[branch](s16, batch)
        assert bool(torch.isfinite(o16["total"])) and \
            bool(torch.isfinite(o32["total"]))
        if branch == "g":
            l32.append(float(o32["pose"]))
            l16.append(float(o16["pose"]))
    a32, a16 = np.asarray(l32), np.asarray(l16)
    med = float(np.median(np.abs(a16 - a32) / np.abs(a32)))
    level = abs(a16.mean() - a32.mean()) / a32.mean()
    assert med < 0.02, med
    assert level < 0.02, level


def test_bf16_eval_pck_parity():
    """Same weights, bf16 against float32 eval: drift < 5%, and PCK@0.2 of
    the bf16 poses against the float32 ones > 0.99."""
    from mixstage_tpu.evaluation.metrics import PCK

    f32, f16 = _factories()
    batch = make_batch(7)
    _, pose32, _ = f32.make_steps()["eval"](f32.init(seed=4), batch,
                                            sample_flag=True)
    _, pose16, _ = f16.make_steps()["eval"](f16.init(seed=4), batch,
                                            sample_flag=True)
    p32, p16 = (as_np(p).astype(np.float64) for p in (pose32, pose16))
    assert np.abs(p16 - p32).mean() / np.abs(p32).mean() < 0.05
    joints = p32.shape[-1] // 2
    pck = PCK(alphas=[0.2], num_joints=joints)
    pck(p16.reshape(-1, 2, joints), p32.reshape(-1, 2, joints))
    assert pck.avg_meters["pck"].avg > 0.99


def test_bf16_scan_driver_equals_its_steps():
    """``make_scan_train_step`` at bf16: float32 loss rows, bf16 poses, the
    same results as its steps called one by one."""
    _, f16 = _factories()
    k, coins = 3, np.array([False, True, False])            # G, D, G
    batches = [make_batch(20 + i, b=2) for i in range(k)]
    stacked = {key: (tuple(np.stack([b["x"][0] for b in batches])[None])
                     if key == "x" else np.stack([b[key] for b in batches]))
               for key in batches[0]}
    stacked["x"] = (stacked["x"][0],)
    state, losses, poses = f16.make_scan_train_step(k)(f16.init(seed=5),
                                                       stacked, coins)
    assert poses.dtype == torch.bfloat16 and poses.shape == (k, 2, T, FEATS)
    seq = f16.init(seed=5)
    steps = f16.make_steps()
    for i in range(k):
        seq, step_losses, pose = steps["d" if coins[i] else "g"](seq,
                                                                  batches[i])
        assert torch.equal(poses[i], pose)
        for key, row in losses.items():
            assert row.dtype == torch.float32
            want = step_losses.get(key, torch.zeros(()))
            assert float(row[i]) == float(want), (i, key)
    for a, b in zip(state.g_opt.params, seq.g_opt.params):
        assert torch.equal(a, b)
