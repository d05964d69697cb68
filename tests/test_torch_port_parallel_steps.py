"""The port's data-parallel G and D steps against the JAX package's, on the
CPU.

Two gloo ranks (child processes that import no JAX) each keep 4 rows of a
B=8, T=64 batch and run one G step and, from the same start, one D step,
fused (K3's plain versions, their statistics exchanged between the ranks)
and unfused, from one state bridged from JAX's trees.  They are held
against JAX's single-device step on the whole batch and against its step
on the 8-device CPU mesh (``make_mesh(8)``, GSPMD), at the tolerances of
JAX's data-parallel test (``tests/test_parallel.py:31-70``): losses rtol
2e-4, atol 1e-5; the global pose rtol 2e-3, atol 2e-4; BatchNorm running
statistics within 1e-4 of each leaf's scale; parameters within 2·lr (Adam's
first update is ±lr·sign(g), so a noise-level gradient flipped by the sum
order moves a weight by 2·lr, ``test_torch_port_train_steps.py``).  A
ragged B=3 batch, replicated over the ranks, gives the one-process step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import jax_train_state, port_state
from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_parallel import flatten, run_ranks
from mixstage_tpu.parallel.mesh import (make_mesh, replicate_state,
                                        shard_batch)
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.train import StepConfig, StepFactory

B, T, MEL, FEATS, LR = 8, 64, 32, 96, 1e-4
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=2, lr=LR,
           model_kwargs=(("in_channels", 64),))
LOSS = dict(rtol=2e-4, atol=1e-5)
POSE = dict(rtol=2e-3, atol=2e-4)
STAT_TOL = 1e-4
PARAM_ATOL = 2 * LR + 1e-6


def make_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(b, T, MEL)).astype(np.float32),),
            "y": rng.normal(size=(b, T, FEATS)).astype(np.float32),
            "labels": rng.integers(0, 2, size=(b, T)).astype(np.int32),
            "style": np.repeat(rng.integers(0, 2, size=(b, 1)), T,
                               1).astype(np.int32)}


def batch_arrays(prefix, batch):
    return {f"{prefix}/x": batch["x"][0], f"{prefix}/y": batch["y"],
            f"{prefix}/labels": batch["labels"],
            f"{prefix}/style": batch["style"]}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's steps (one device and the 8-device mesh), the port's state
    factory and the two ranks' results."""
    f = JaxStepFactory(JaxStepConfig(**CFG), donate=False)
    batch, ragged = make_batch(0), make_batch(1, b=3)
    jstate = jax_train_state(f, jax.tree.map(jnp.asarray, batch))
    steps = f.make_steps()
    mesh8 = make_mesh(8)
    jax_out = {}
    for kind, key in (("g", 1), ("d", 2)):
        jax_out[kind] = steps[kind](jstate, jax.tree.map(jnp.asarray, batch),
                                    jax.random.key(key),
                                    use_pose_input=False)
        jax_out[kind + "8"] = steps[kind](
            replicate_state(jstate, mesh8), shard_batch(batch, mesh8),
            jax.random.key(key), use_pose_input=False)
    arrays = {**flatten({"g_params": jstate.g_params,
                         "g_state": jstate.g_state,
                         "d_params": jstate.d_params,
                         "d_state": jstate.d_state}),
              **batch_arrays("batch", batch),
              **batch_arrays("ragged", ragged)}
    cfg = {k: (list(map(list, v)) if k == "model_kwargs" else v)
           for k, v in CFG.items()}
    ranks = run_ranks("steps", tmp_path_factory.mktemp("dp_steps"), 2,
                      {"cfg": cfg}, arrays)
    factory = StepFactory(StepConfig(**CFG), device="cpu")
    return factory, jstate, jax_out, ranks, ragged


def _state_dicts(state):
    return {f"{name}/{k}": v.detach().double().numpy()
            for name in ("gen", "psenc", "disc")
            for k, v in getattr(state, name).state_dict().items()}


def check_state(got, tag, want):
    """BN running statistics within ``STAT_TOL`` of scale, parameters
    within 2·lr."""
    for k, ref in want.items():
        a = got[f"{tag}/{k}"]
        if "running_" in k:
            assert np.abs(a - ref).max() <= STAT_TOL * np.abs(ref).max(), k
        else:
            np.testing.assert_allclose(a, ref, rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)


def check_losses(got, tag, losses):
    for k, v in losses.items():
        np.testing.assert_allclose(got[f"{tag}/loss/{k}"], np.asarray(v),
                                   err_msg=k, **LOSS)


@pytest.mark.parametrize("kind", ["g", "d"])
@pytest.mark.parametrize("mode", ["unfused", "fused"])
@pytest.mark.parametrize("ref", ["one_device", "mesh8"])
def test_dp_step_matches_jax(world, kind, mode, ref):
    factory, _, jax_out, ranks, _ = world
    jstate, losses, pose = jax_out[kind + ("8" if ref == "mesh8" else "")]
    want = _state_dicts(port_state(factory, jstate))
    tag = f"{mode}/{kind}"
    for out in ranks:                     # every rank holds the global step
        check_losses(out, tag, losses)
        np.testing.assert_allclose(out[f"{tag}/pose"], np.asarray(pose),
                                   **POSE)
        check_state(out, tag, want)


def test_ranks_agree_bit_for_bit(world):
    """Both ranks report the same losses and pose and hold the same state
    after each step (the gradients are averaged before the update)."""
    _, _, _, ranks, _ = world
    assert sorted(ranks[0]) == sorted(ranks[1])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("mode", ["f64_unfused", "f64_fused"])
def test_dp_gradients_equal_one_process_in_float64(world, mode):
    """The gradients themselves: in float64 no leaky unit flips, so G's
    Adam mu after the data-parallel step (0.1 × the clipped gradient,
    BatchNorm's and K3's cross-rank terms included) equals the one-process
    step's to rounding (2e-14 measured), every leaf within 1e-9 relative
    or 1e-10 of the tree's largest |mu|.  In float32 rounding flips move
    them by 2e-3-3e-3 at this size, which the parameters' 2·lr bound
    cannot see."""
    factory, jstate, _, ranks, _ = world
    f = StepFactory(StepConfig(**CFG, dtype=torch.float64,
                               fused_decoder=mode == "f64_fused"),
                    device="cpu")
    state = port_state(f, jstate)
    state, losses, _ = f.make_steps()["g"](state, make_batch(0), 1)
    mu = dict(zip(state.g_opt.names,
                  (m.numpy() for m in state.g_opt.slots()["mu"])))
    # the conv biases before a train BN have gradient 0 analytically (their
    # mu is noise, ~1e-19): every leaf is held at the tree's scale
    atol = 1e-10 * max(np.abs(v).max() for v in mu.values())
    for out in ranks:
        np.testing.assert_allclose(out[f"{mode}/total"],
                                   losses["total"].numpy(), rtol=1e-12)
        for n, ref in mu.items():
            np.testing.assert_allclose(out[f"{mode}/mu/{n}"], ref, rtol=1e-9,
                                       atol=atol, err_msg=n)


def test_ragged_batch_is_the_one_process_step(world):
    """B=3 does not split over 2 ranks: every rank runs it whole and takes
    the one-process step."""
    factory, jstate, _, ranks, ragged = world
    state = port_state(factory, jstate)
    state, losses, pose = factory.make_steps()["g"](state, ragged, 1)
    for out in ranks:
        check_losses(out, "ragged/g", {k: v.numpy()
                                       for k, v in losses.items()})
        np.testing.assert_allclose(out["ragged/g/pose"], pose.numpy(),
                                   rtol=1e-6, atol=1e-6)
        check_state(out, "ragged/g", _state_dicts(state))
