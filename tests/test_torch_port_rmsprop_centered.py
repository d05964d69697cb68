"""Centered and bias-corrected RMSprop (``optax.rmsprop(centered=True,
bias_correction=True)``, optax 0.2.6) in the port against optax.

The same parameters and gradients through the JAX package's
``make_optimizer("RMSprop", lr, grad_clip=1.0, ...)`` and the port's
``ClippedRMSprop`` over six updates (the first clipped, the later ones
smaller), in each of the four modes and with the options.  Held:

* every parameter and state tensor (``mu``, ``nu``, ``trace``) within
  max |got - want| ≤ 1e-6 · max |want| in float32 (largest gap measured:
  2.0e-7 of it), 1e-12 in float64 (largest 1.3e-13); centered with bias
  correction from ``nu = 0`` only in float64, its first update being
  degenerate (``DEGENERATE_F32``);
* the count (the bias correction's, ``ScaleByRStdDevWithCountState``) and
  the extra slots through the opt-state bridge both ways: optax's state
  into the port (``load_flax_opt_state``), the port's state back in
  optax's nesting (``optax_tree_of``) written as an orbax directory and
  restored by orbax into optax's own state, bit for bit; the same for
  every other optimizer and ``-optim_separate``'s partitioned state;
* the G step of a centered, bias-corrected trainer against JAX's
  ``StepFactory`` (``test_torch_port_train_steps.py``'s limits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mixstage_tpu.train import state as JS
from mixstage_tpu_torch.interop import orbax as porbax
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.train import state as TS
from test_torch_port_optimizers import (_leaf_list, _state_nodes, _tree,
                                        assert_close)

LR = 1e-2
TOL = {np.float32: 1e-6, np.float64: 1e-12}
CASES = {
    "centered": {"centered": True},
    "bias_correction": {"bias_correction": True},
    "centered_bias": {"centered": True, "bias_correction": True},
    "centered_bias_momentum": {"centered": True, "bias_correction": True,
                               "momentum": 0.5, "decay": 0.8},
    "centered_bias_scaled": {"centered": True, "bias_correction": True,
                             "initial_scale": 0.1},
    "centered_bias_scaled_momentum": {"centered": True,
                                      "bias_correction": True,
                                      "initial_scale": 0.1, "momentum": 0.5,
                                      "decay": 0.8},
    "centered_options": {"centered": True, "eps_in_sqrt": False,
                         "initial_scale": 0.1, "momentum": 0.9,
                         "nesterov": True},
}
# centered with bias correction from nu = 0: at the first update the
# corrected moments give nu_hat - mu_hat² = 0 in exact arithmetic, so the
# update is g · rsqrt(rounding + eps), decided by how the rounding falls
# (XLA contracts nu_hat - mu_hat·mu_hat into one fused multiply-add): held
# in float64, where both agree to 1.3e-13, not in float32
DEGENERATE_F32 = ("centered_bias", "centered_bias_momentum")
SCALES = (3.0, 0.5, 0.2, 0.1, 0.05, 0.02)


def run_both(kwargs, dtype, steps=len(SCALES)):
    rng = np.random.default_rng(11)
    params = _tree(rng, 1.0, dtype)
    grads = [_tree(rng, s, dtype) for s in SCALES[:steps]]
    tx = JS.make_optimizer("RMSprop", LR, grad_clip=1.0, **kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    tparams = [torch.from_numpy(a.copy()) for a in _leaf_list(params)]
    opt = TS.make_optimizer("RMSprop", LR, **kwargs)(
        list(zip(("a.kernel", "b"), tparams)))
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in _leaf_list(g)])
    return jp, js, tparams, opt


def _check(jp, js, tparams, opt, tol):
    for got, want in zip(tparams, _leaf_list(jp)):
        assert_close(got.numpy(), want, tol)
    nodes = _state_nodes(js)
    assert sorted(opt.slots()) == sorted(nodes)
    for field, tensors in opt.slots().items():
        for got, w in zip(tensors, _leaf_list(nodes[field][0])):
            assert_close(got.numpy(), w, tol)


@pytest.mark.parametrize("case", sorted(set(CASES) - set(DEGENERATE_F32)))
def test_rmsprop_matches_optax_f32(case):
    jp, js, tparams, opt = run_both(CASES[case], np.float32)
    _check(jp, js, tparams, opt, TOL[np.float32])
    assert opt.count == len(SCALES)
    if CASES[case].get("bias_correction"):
        assert int(js[1][0].count) == opt.count


@pytest.mark.parametrize("case", ["centered", "centered_bias",
                                  "centered_bias_momentum"])
def test_rmsprop_matches_optax_f64(case):
    with jax.enable_x64(True):
        jp, js, tparams, opt = run_both(CASES[case], np.float64)
        assert tparams[0].dtype == torch.float64
        _check(jp, js, tparams, opt, TOL[np.float64])


def test_first_centered_corrected_update_is_degenerate():
    """From nu = 0 the first centered, corrected denominator is zero in
    exact arithmetic: in float64 both packages' nu_hat - mu_hat² are within
    1e-15 of the squared gradient's scale, and the update is the gradient
    times ~rsqrt(eps) = 1e4, which the initial scale 0.1 avoids."""
    with jax.enable_x64(True):
        jp, js, tparams, opt = run_both(CASES["centered_bias"], np.float64,
                                        steps=1)
        params = _tree(np.random.default_rng(11), 1.0, np.float64)
        step = np.abs(tparams[1].numpy() - params["b"]).max()
    assert step > 10.0                     # lr 1e-2 · ~1e4 · clipped g
    _, _, scaled, _ = run_both(CASES["centered_bias_scaled"], np.float32,
                               steps=1)
    assert np.abs(scaled[1].numpy() - params["b"]).max() < 0.1


class _TextModule(torch.nn.Module):
    """Parameters named like a flax tree with a ``text_encoder`` subtree,
    the one ``-optim_separate`` gives its own group."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Conv1d(4, 5, 3)
        self.text_encoder = torch.nn.Module()
        self.text_encoder.b = torch.nn.Conv1d(2, 3, 3)


# the optimizers whose optax nesting goes through the bridge both ways:
# name, kwargs, text_lr (-optim_separate: a partitioned, masked state)
BRIDGE = {
    "centered_bias": ("RMSprop", CASES["centered_bias"], None),
    "centered_bias_momentum": ("RMSprop", CASES["centered_bias_momentum"],
                               None),
    "bias_correction": ("RMSprop", CASES["bias_correction"], None),
    "centered": ("RMSprop", CASES["centered"], None),
    "RMSprop": ("RMSprop", {}, None),
    "Adam": ("Adam", {}, None),
    "Adam_mu_bf16": ("Adam", {"mu_dtype": "bfloat16"}, None),
    "AdamW": ("AdamW", {}, None),
    "SGD": ("SGD", {}, None),
    "SGD_momentum": ("SGD", {"momentum": 0.9}, None),
    "Adam_text": ("Adam", {}, 1e-3),
    "centered_bias_text": ("RMSprop", CASES["centered_bias"], 1e-3),
}


@pytest.mark.parametrize("case", sorted(BRIDGE))
def test_state_through_the_bridge_both_ways(case, tmp_path):
    """optax's state (after three updates, under a schedule) into the
    port's optimizer; the port's state back in optax's nesting
    (``optax_tree_of``: the chain's empty states, the schedule's count,
    ``multi_transform``'s masked groups), through an orbax directory,
    restored by orbax into optax's state: every leaf and count bit for
    bit (a bfloat16 ``mu`` through float32, exact)."""
    import orbax.checkpoint as ocp

    name, kwargs, text_lr = BRIDGE[case]
    m = _TextModule()
    rng = np.random.default_rng(5)
    params = {"a": {"kernel": rng.normal(size=(3, 4, 5)).astype(np.float32),
                    "bias": rng.normal(size=(5,)).astype(np.float32)},
              "text_encoder": {"b": {
                  "kernel": rng.normal(size=(3, 2, 3)).astype(np.float32),
                  "bias": rng.normal(size=(3,)).astype(np.float32)}}}
    tx = JS.make_optimizer(name, LR, grad_clip=1.0, schedule=lambda c: LR,
                           text_lr=text_lr, **kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    for s in (2.0, 0.3, 0.1):
        g = jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32) * s), params)
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    opt = TS.make_optimizer(name, LR, schedule=lambda c: LR,
                            text_lr=text_lr, **kwargs)(
        list(m.named_parameters()))
    W.load_flax_opt_state(opt, {None: m}, js)
    path = str(tmp_path / "opt.orbax")
    porbax.write_directory(path, {"opt": W.optax_tree_of(opt, {None: m})})
    with ocp.StandardCheckpointer() as ckptr:
        back = ckptr.restore(path, target={"opt": jax.tree.map(
            np.asarray, tx.init(jp))})["opt"]
    want = jax.tree_util.tree_flatten_with_path(js)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype, k
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(k))
    if name == "RMSprop" and kwargs.get("bias_correction"):
        assert opt.count == 3


def test_centered_g_step_matches_jax():
    """One G step of the Mix-StAGE GAN with centered, bias-corrected
    RMSprop (initial scale 0.1) from one bridged state: losses, pose,
    parameters and statistics at the train-step tests' limits, the
    optimizer's ``mu`` / ``nu`` module by module at twice the gradient's
    own gap."""
    from _torch_port_helpers import jax_train_state
    from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
    from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
    from mixstage_tpu_torch.train.steps import StepConfig, StepFactory
    from test_torch_port_train_steps import (CFG, POSE_TOL,
                                             assert_losses_close,
                                             assert_states_close, jax_batch,
                                             make_batch, port_state)

    change = dict(optim="RMSprop", optim_kwargs=(
        ("centered", True), ("bias_correction", True),
        ("initial_scale", 0.1)))
    batch = make_batch(4)
    jf = JaxStepFactory(JaxStepConfig(**{**CFG, **change}), donate=False)
    port = StepFactory(StepConfig(**{**CFG, **change}), device="cpu")
    jstate = jax_train_state(jf, jax_batch(batch))
    state = port_state(port, jstate)
    assert state.g_opt.centered and state.g_opt.bias_correction
    js, jl, jpose = jf.make_steps()["g"](jstate, jax_batch(batch),
                                         jax.random.key(1),
                                         use_pose_input=False)
    ps, pl, ppose = port.make_steps()["g"](state, batch,
                                           use_pose_input=False)
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), **POSE_TOL)
    assert ps.g_opt.count == int(js.g_opt_state[1][0].count) == 1
    # mu is 0.1 of the clipped gradient after one step, so its gap is the
    # gradient's: on this batch and state the port's Adam mu differs from
    # optax's by the same 3.2e-3 (gen/style_emb) and 2.2-2.3e-3 (each
    # decoder) as centered RMSprop's mu here (the Adam G-step limit of 2e-3
    # was set on another state): twice the largest
    assert_states_close(ps, js, {"*": 6.4e-3})
