"""The Disentangle losses' plumbing, port against the JAX package.

A port of ``tests/test_disentangle.py``: the reference ships no
Disentangle generator, so an unregistered one fails loudly with the JAX
package's message; once one is registered (``register_model``), the
``-style_losses`` weights reach it, its named internal losses join the G
total and, detached, the D total, and the k-step driver carries their
keys.  The generator here is the JAX test's, in both packages: the
Mix-StAGE generator emitting the 11 internal losses, each weighted by
``style_losses``.  On one state drawn with numpy (the small flagship
configuration, B=2, T=64, 128 mel bins), float64 G and D steps against
JAX's under x64 within 1e-9 (losses, pose, parameters), the float64
contract of ``test_torch_port_f64_steps.py``.  The fused G step runs the
generator's ``backbone`` (K3's plain version here), which emits no
internal loss in either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import (JaxDisentangle, PortDisentangle, flat_tree,
                                 jax_train_state, port_state)
from mixstage_tpu.models import registry as jreg
from mixstage_tpu.models.speech2gesture import Speech2Gesture_D as JaxD
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.models import registry as preg
from mixstage_tpu_torch.models.speech2gesture import Speech2Gesture_D
from mixstage_tpu_torch.train import StepConfig, StepFactory

NAME = "JointLateClusterSoftStyleDisentangle9_G"
INTERNAL = preg.DISENTANGLE_INTERNAL_LOSSES
B, T, MEL, FEATS = 2, 64, 128, 96
WEIGHTS = dict({k: 1.0 for k in INTERNAL if k != "H"}, **{"content_+": 2.0})
CFG = dict(model=NAME, gan=True, criterion="L1Loss", num_clusters=2,
           num_speakers=2, lr=1e-4, model_kwargs=(("in_channels", 64),),
           style_losses=tuple(sorted(WEIGHTS.items())))
TOL = 1e-9
G_PARTS = ["pose", "G_gan", "label", "id_in", "id_out"]
D_PARTS = ["real_D", "fake_D", "label", "id_in", "id_out"]


@pytest.fixture(scope="module")
def registered():
    jreg.register_model(NAME, JaxDisentangle)
    jreg.register_model(NAME[:-1] + "D", JaxD)
    preg.register_model(NAME, PortDisentangle)
    preg.register_model(NAME[:-1] + "D", Speech2Gesture_D)
    yield
    for reg in (jreg, preg):
        reg.MODEL_REGISTRY.pop(NAME, None)
        reg.MODEL_REGISTRY.pop(NAME[:-1] + "D", None)


def make_batch(seed, k=None):
    rng = np.random.default_rng(seed)
    lead = () if k is None else (k,)
    return {"x": (rng.normal(size=lead + (B, T, MEL)),),
            "y": rng.normal(size=lead + (B, T, FEATS)),
            "labels": rng.integers(0, 2, size=lead + (B, T)),
            "style": np.repeat(rng.integers(0, 2, size=lead + (B, 1)), T,
                               -1)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs(registered):
    with jax.enable_x64(True):
        f = JaxStepFactory(JaxStepConfig(**CFG, dtype=jnp.float64),
                           donate=False)
        state0 = jax_train_state(f, jax.tree.map(jnp.asarray, make_batch(0)),
                                 dtype=np.float64)
        steps = f.make_steps()
        out = {"state0": _np(state0)}
        for branch in ("g", "d"):
            js, jl, jpose = steps[branch](
                state0, jax.tree.map(jnp.asarray, make_batch(1)),
                jax.random.key(1), use_pose_input=False)
            out[branch] = (_np(jl), np.asarray(jpose), _np(js))
    return out


def test_unregistered_disentangle_fails_loudly():
    with pytest.raises(NotImplementedError, match="upstream-incomplete"):
        preg.get_model_def("JointLateClusterSoftStyleDisentangle7_G")
    with pytest.raises(NotImplementedError, match="upstream-incomplete"):
        StepFactory(StepConfig(**dict(CFG, model="JointLateClusterSoft"
                                      "StyleDisentangle7_G")), device="cpu")


def test_loss_vocabulary_matches_jax():
    assert preg.DISENTANGLE_INTERNAL_LOSSES == \
        jreg.DISENTANGLE_INTERNAL_LOSSES
    assert preg.DISENTANGLE_LOSS_KINDS == jreg.DISENTANGLE_LOSS_KINDS
    # display slots 4+ map 1:1 onto the internal loss names
    assert len(preg.DISENTANGLE_LOSS_KINDS) - 4 == len(INTERNAL)


def test_style_losses_reach_the_model(registered):
    f = StepFactory(StepConfig(**CFG), device="cpu")
    gen = f.build_modules()[0]
    assert isinstance(gen, PortDisentangle)
    assert gen.style_losses == WEIGHTS


@pytest.mark.parametrize("branch", ["g", "d"])
def test_f64_steps_sum_internal_losses_as_jax(jax_runs, branch):
    """The G total is pose + G_gan + the style losses + the internal
    ones; the D total real + fake + the same (detached: D's step leaves
    G's parameters as they were); every loss, the pose and the new state
    as JAX's."""
    f = StepFactory(StepConfig(**CFG, dtype=torch.float64), device="cpu")
    ps = port_state(f, jax_runs["state0"])
    g0 = [p.detach().clone() for p in ps.g_opt.params]
    ps, pl, ppose = f.make_steps()[branch](ps, make_batch(1))
    jl, jpose, js = jax_runs[branch]
    assert sorted(pl) == sorted(jl)
    for k, v in jl.items():
        v = np.asarray(v)
        assert np.abs(pl[k].numpy() - v).max() <= TOL * np.abs(v).max(), k
    np.testing.assert_allclose(ppose.numpy(), jpose, rtol=0,
                               atol=TOL * np.abs(jpose).max())
    parts = (G_PARTS if branch == "g" else D_PARTS) + INTERNAL
    total = sum(float(pl[p]) for p in parts)
    assert abs(float(pl["total"]) - total) <= 1e-12 * abs(total)
    # content_+ (weight 2, slot 0) equals content_- (weight 1, slot 1)
    assert float(pl["content_+"]) == pytest.approx(float(pl["content_-"]),
                                                   rel=1e-12)
    port = W.jax_train_state_of(ps)
    for field in ("g_params", "d_params"):
        got, want = flat_tree(port[field]), flat_tree(getattr(js, field))
        for k, b in want.items():
            assert np.abs(got[k] - b).max() <= TOL * np.abs(b).max(), \
                (field, k)
    if branch == "d":
        assert all(torch.equal(a, b) for a, b in zip(g0, ps.g_opt.params))


def test_fused_g_step_emits_no_internal_losses(jax_runs):
    """The fused G step runs the generator's backbone and the decoder
    through K3 (its plain version here): no internal loss, as in the JAX
    package (``steps.py:323-356``); its pose and pose loss are JAX's
    unfused step's."""
    f = StepFactory(StepConfig(**CFG, dtype=torch.float64,
                               fused_decoder=True), device="cpu")
    ps = port_state(f, jax_runs["state0"])
    _, pl, ppose = f.make_steps()["g"](ps, make_batch(1))
    assert not set(INTERNAL) & set(pl)
    total = sum(float(pl[p]) for p in G_PARTS)
    assert abs(float(pl["total"]) - total) <= 1e-12 * abs(total)
    jl, jpose, _ = jax_runs["g"]
    np.testing.assert_allclose(ppose.numpy(), jpose, rtol=0,
                               atol=TOL * np.abs(jpose).max())
    assert float(pl["pose"]) == pytest.approx(float(jl["pose"]), rel=TOL)


def test_discriminator_fallback_and_explicit_flag(registered):
    """An undefined ``<prefix>_D`` falls back to ``Speech2Gesture_D``
    (``steps.py:164-177``), as does the explicit flag naming it."""
    preg.register_model(NAME[:-3] + "8_G", PortDisentangle)
    try:
        for disc in (None, "Speech2Gesture_D"):
            f = StepFactory(StepConfig(**dict(
                CFG, model=NAME[:-3] + "8_G", discriminator=disc)),
                device="cpu")
            assert f.disc_cls is Speech2Gesture_D
    finally:
        preg.MODEL_REGISTRY.pop(NAME[:-3] + "8_G", None)


def test_scan_driver_carries_the_extended_keys(registered):
    f = StepFactory(StepConfig(**CFG), device="cpu")
    k = 3
    coins = np.array([True, False, False])
    _, losses, _ = f.make_scan_train_step(k)(f.init(seed=0),
                                             make_batch(2, k=k), coins,
                                             list(range(k)))
    assert set(INTERNAL) <= set(losses)
    for name in INTERNAL:
        assert tuple(losses[name].shape) == (k,), name
        assert bool(torch.isfinite(losses[name]).all()), name
        assert bool((losses[name] != 0).all()), name
