"""The port's float64 steps against the JAX package's float64 steps.

The JAX package's parity mode (``dtype=float64``: float64 parameters,
statistics, optimizer state and compute, under JAX's x64, here scoped to
the fixture with ``jax.enable_x64``) against the port's
``StepConfig(dtype=torch.float64)``, from one state drawn in float64 with
numpy, on the small flagship configuration of
``test_torch_port_train_steps.py`` (in_channels 64, 2 clusters, 2
speakers, B=2, T=64, 32 mel bins).

Tolerance: ``TOL`` = 1e-9, relative, for every loss, and for every leaf of
the parameters, the BatchNorm statistics and the Adam moments (max |port -
JAX| ≤ TOL · max |JAX| per leaf), with one exception: the moments of the
conv biases before a train BatchNorm, whose gradient is 0 analytically
and float noise in both packages, are held absolutely (≤ 1e-12).  The
float32 steps cannot be held this tightly: there a leaky unit within ~1e-6
of 0 flips sign between the two packages and moves the moments upstream
of it by up to 1.7e-2 (``MOMENT_TOL`` of the float32 tests).  In float64
no unit lies that close.  The largest gaps measured: parameters 9.4e-12
(D's pre-BN conv bias after the D step 1.6e-10, its update Adam's sign of
float noise), BatchNorm statistics 2.2e-14, Adam moments 1.0e-11, their
pre-BN biases 3.9e-16 absolute.

The fused G step (K3's plain version in float64 on the CPU) is held to
JAX's unfused float64 G step: the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import flat_tree, jax_train_state, port_state
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.train import StepConfig, StepFactory
from mixstage_tpu_torch.train import steps as port_steps

B, T, MEL, FEATS = 2, 64, 32, 96
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=2, lr=1e-4,
           model_kwargs=(("in_channels", 64),))
TOL = 1e-9
BIAS_MOMENT_ATOL = 1e-12
# name: (JAX branch, port factory kwargs, step kwargs, batch seed)
RUNS = {
    "g": ("g", {}, {}, 1),
    "d": ("d", {}, {}, 1),
    "g_pose_input": ("g", {}, {"use_pose_input": True}, 2),
    "fused_g": ("g", {"fused_decoder": True}, {}, 3),
}


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(B, T, MEL)),),
            "y": rng.normal(size=(B, T, FEATS)),
            "labels": rng.integers(0, 2, size=(B, T)),
            "style": np.repeat(rng.integers(0, 2, size=(B, 1)), T, 1)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's initial state and each run's (losses, pose, state), all
    computed under x64 and returned as numpy."""
    with jax.enable_x64(True):
        f = JaxStepFactory(JaxStepConfig(**CFG, dtype=jnp.float64),
                           donate=False)
        jbatch = jax.tree.map(jnp.asarray, make_batch(0))
        state0 = jax_train_state(f, jbatch, dtype=np.float64)
        assert state0.g_params["gen"]["unet"]["pre0"]["conv"][
            "kernel"].dtype == np.float64
        steps = f.make_steps()
        out = {"state0": _np(state0)}
        for name, (branch, _, kw, seed) in RUNS.items():
            js, jl, jpose = steps[branch](
                state0, jax.tree.map(jnp.asarray, make_batch(seed)),
                jax.random.key(1), **kw)
            out[name] = (_np(jl), np.asarray(jpose), _np(js))
        jl, jpose, _ = steps["eval"](
            state0, jax.tree.map(jnp.asarray, make_batch(4)),
            use_pose_input=False, sample_flag=True)
        out["eval"] = (_np(jl), np.asarray(jpose))
    assert not jax.config.jax_enable_x64
    return out


def leaf_gaps(got, want, moments=False):
    """{leaf: max |got - want| / max |want|}; the pre-BN conv biases of a
    moment tree apart, as {leaf: max |got - want|} under "abs"."""
    got, want = flat_tree(got), flat_tree(want)
    assert sorted(got) == sorted(want)
    rel, absolute = {}, {}
    for k, b in want.items():
        d = float(np.abs(got[k] - b).max())
        if moments and k.endswith("conv/bias"):
            absolute[k] = d
        else:
            rel[k] = d / max(float(np.abs(b).max()), 1e-300)
    return rel, absolute


def assert_state_close(ps, js):
    port = W.jax_train_state_of(ps)
    for field in ("g_params", "g_state", "d_params", "d_state"):
        rel, _ = leaf_gaps(port[field], getattr(js, field))
        worst = max(rel, key=rel.get)
        assert rel[worst] <= TOL, (field, worst, rel[worst])
    for field in ("g_opt_state", "d_opt_state"):
        nodes = W._opt_nodes(getattr(js, field))
        assert port[field]["count"] == int(nodes["count"])
        for slot in ("mu", "nu"):
            rel, absolute = leaf_gaps(port[field][slot], nodes[slot], True)
            worst = max(rel, key=rel.get)
            assert rel[worst] <= TOL, (field, slot, worst, rel[worst])
            assert max(absolute.values()) <= BIAS_MOMENT_ATOL, \
                (field, slot, max(absolute.values()))
    for k in W.COUNTERS:
        assert getattr(ps, k) == int(getattr(js, k)), k


def assert_losses_close(got, want):
    for k, v in want.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        assert got[k].dtype == torch.float64, k
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-300), \
            (k, a, b)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_f64_step_matches_jax(jax_runs, name):
    branch, fkw, kw, seed = RUNS[name]
    factory = StepFactory(StepConfig(**CFG, dtype=torch.float64, **fkw),
                          device="cpu")
    ps = port_state(factory, jax_runs["state0"])
    assert ps.gen.unet.pre0.conv.weight.dtype == torch.float64
    assert ps.g_opt.mu[0].dtype == torch.float64
    ps, pl, ppose = factory.make_steps()[branch](ps, make_batch(seed), **kw)
    jl, jpose, js = jax_runs[name]
    assert_losses_close(pl, jl)
    assert ppose.dtype == torch.float64
    np.testing.assert_allclose(ppose.numpy(), jpose, rtol=0,
                               atol=TOL * np.abs(jpose).max())
    assert_state_close(ps, js)


def test_f64_eval_step_matches_jax(jax_runs):
    factory = StepFactory(StepConfig(**CFG, dtype=torch.float64),
                          device="cpu")
    ps = port_state(factory, jax_runs["state0"])
    pl, ppose, _ = factory.make_steps()["eval"](ps, make_batch(4),
                                                sample_flag=True)
    jl, jpose = jax_runs["eval"]
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(ppose.numpy(), jpose, rtol=0,
                               atol=TOL * np.abs(jpose).max())
    # eval leaves every statistic (and the optimizer) as it was
    assert_state_close(ps, jax_runs["state0"])


def test_f64_fused_decoder_refused_on_the_card(monkeypatch):
    """K3 has no float64 mode: a float64 fused config asks for the card
    and is refused there (the device is faked: the refusal comes before
    anything touches it); K3's wrappers refuse float64 tensors off the
    CPU (a meta tensor stands in for a CUDA one)."""
    monkeypatch.setattr(port_steps, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="float64"):
        StepFactory(StepConfig(**CFG, dtype=torch.float64,
                               fused_decoder=True))
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    with pytest.raises(NotImplementedError, match="float64"):
        td._check(x=torch.empty((2, 2), dtype=torch.float64,
                                device="meta"))
