"""The port's optimizers against optax on identical gradients.

Each optimizer is the JAX package's ``make_optimizer(name, lr,
grad_clip=1.0)`` (``optax.chain(clip_by_global_norm(1), <optimizer>)``)
and the port's counterpart, from the same parameters, over three updates
of the same gradients (the first two clipped, the third kept).

Tolerances: each parameter and state tensor within max |got - want| ≤
1e-6 · max |want| in float32, the rounding of a few float32 operations
apart: with a momentum trace one parameter element of 60, where the
update nearly cancels it, differs by 1.0e-8 (1.8e-6 of its own value),
which an element-wise rtol of 1e-6 would refuse; in float64 (JAX's x64
scoped to the test) 1e-12.
Adam's bfloat16 ``mu`` is held bit for bit: it is the cast of a float32
sum that both compute alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mixstage_tpu.train import state as JS
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.train import state as TS

TOL = {np.float32: 1e-6, np.float64: 1e-12}
LR = 1e-2
CASES = {
    "Adam": ("Adam", {}),
    "Adam_mu_bf16": ("Adam", {"mu_dtype": "bfloat16"}),
    "AdamW": ("AdamW", {}),
    "AdamW_wd": ("AdamW", {"weight_decay": 0.05, "b1": 0.8}),
    "SGD": ("SGD", {}),
    "SGD_momentum": ("SGD", {"momentum": 0.9}),
    "SGD_nesterov": ("SGD", {"momentum": 0.9, "nesterov": True}),
    "RMSprop": ("RMSprop", {}),
    "RMSprop_momentum": ("RMSprop", {"momentum": 0.5, "decay": 0.8}),
    "RMSprop_options": ("RMSprop", {"eps_in_sqrt": False,
                                    "initial_scale": 0.1, "momentum": 0.9,
                                    "nesterov": True}),
}


def assert_close(got, want, tol):
    """max |got - want| ≤ tol · max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _tree(rng, scale, dtype):
    return {"a": {"kernel": (rng.normal(size=(3, 4, 5)) * scale).astype(
                dtype)},
            "b": (rng.normal(size=(7,)) * scale).astype(dtype)}


def _leaf_list(tree):
    return [tree["a"]["kernel"], tree["b"]]


def _state_nodes(opt_state):
    """{field: tree} of every optax state node with tensor fields."""
    out = {}

    def walk(node):
        if hasattr(node, "_fields"):
            for f in node._fields:
                if f != "count" and isinstance(getattr(node, f), dict):
                    out.setdefault(f, []).append(getattr(node, f))
        if isinstance(node, (tuple, list)):
            for n in node:
                walk(n)
    walk(opt_state)
    return out


def run_both(name, kwargs, dtype, steps=3):
    rng = np.random.default_rng(7)
    params = _tree(rng, 1.0, dtype)
    grads = [_tree(rng, s, dtype) for s in (3.0, 2.0, 0.01)][:steps]
    tx = JS.make_optimizer(name, LR, grad_clip=1.0, **kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    tparams = [torch.from_numpy(a.copy()) for a in _leaf_list(params)]
    opt = TS.make_optimizer(name, LR, **kwargs)(
        list(zip(("a.kernel", "b"), tparams)))
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(a) for a in _leaf_list(g)])
    return jp, js, tparams, opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax_f32(case):
    name, kwargs = CASES[case]
    jp, js, tparams, opt = run_both(name, kwargs, np.float32)
    for got, want in zip(tparams, _leaf_list(jp)):
        assert_close(got.numpy(), want, TOL[np.float32])
    nodes = _state_nodes(js)
    assert sorted(opt.slots()) == sorted(nodes)
    for field, tensors in opt.slots().items():
        want = _leaf_list(nodes[field][0])
        for got, w in zip(tensors, want):
            w = np.asarray(jnp.asarray(w).astype(jnp.float32))
            got = got.float().numpy()
            if field == "mu" and kwargs.get("mu_dtype"):
                assert tensors[0].dtype == torch.bfloat16
                np.testing.assert_array_equal(got, w)
            else:
                assert_close(got, w, TOL[np.float32])
    if name in ("Adam", "AdamW"):
        assert opt.count == 3


@pytest.mark.parametrize("case", ["Adam", "AdamW", "SGD_momentum",
                                  "RMSprop"])
def test_optimizer_matches_optax_f64(case):
    name, kwargs = CASES[case]
    with jax.enable_x64(True):
        jp, js, tparams, opt = run_both(name, kwargs, np.float64)
        assert tparams[0].dtype == torch.float64
        for got, want in zip(tparams, _leaf_list(jp)):
            assert np.asarray(want).dtype == np.float64
            assert_close(got.numpy(), want, TOL[np.float64])
        nodes = _state_nodes(js)
        for field, tensors in opt.slots().items():
            for got, w in zip(tensors, _leaf_list(nodes[field][0])):
                assert_close(got.numpy(), w, TOL[np.float64])


class _Module(torch.nn.Module):
    """Parameters named like a flax tree's leaves (``a.weight`` ↔
    ``a/kernel`` through the weight bridge's layout rule)."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Conv1d(4, 5, 3)


@pytest.mark.parametrize("case", ["Adam", "AdamW", "SGD", "SGD_momentum",
                                  "RMSprop", "Adam_mu_bf16"])
def test_opt_state_bridge_round_trip(case):
    """An optax state loads into the port's optimizer (every slot, the
    count) and ``to_flax_opt_state`` gives it back leaf for leaf."""
    name, kwargs = CASES[case]
    m = _Module()
    rng = np.random.default_rng(3)
    fparams = {"a": {"kernel": rng.normal(size=(3, 4, 5)).astype(np.float32),
                     "bias": rng.normal(size=(5,)).astype(np.float32)}}
    tx = JS.make_optimizer(name, LR, grad_clip=1.0, **kwargs)
    jp = jax.tree.map(jnp.asarray, fparams)
    js = tx.init(jp)
    for s in (2.0, 0.5):
        g = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * s,
                                               a.dtype), jp)
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    opt = TS.make_optimizer(name, LR, **kwargs)(list(m.named_parameters()))
    W.load_flax_opt_state(opt, {None: m}, js)
    back = W.to_flax_opt_state(opt, {None: m})
    nodes = _state_nodes(js)
    assert sorted(k for k in back if k != "count") == sorted(nodes)
    for field, trees in nodes.items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(
                np.asarray(jnp.asarray(back[field]["a"][leaf]).astype(
                    jnp.float32)),
                np.asarray(jnp.asarray(trees[0]["a"][leaf]).astype(
                    jnp.float32)))
    if name in ("Adam", "AdamW"):
        assert opt.count == back["count"] == 2


def test_unknown_and_refused_optimizer_options():
    with pytest.raises(KeyError, match="Adagrad"):
        TS.make_optimizer("Adagrad", 0.1)
    with pytest.raises(TypeError):
        TS.make_optimizer("SGD", 0.1, b1=0.5)([("p", torch.zeros(2))])
    # -optim_separate: the text encoder's leaves in their own group
    opt = TS.make_optimizer("Adam", 0.1, text_lr=1e-5)(
        [("gen.text_encoder.stack.conv0.conv.weight", torch.zeros(2)),
         ("gen.unet.pre0.conv.weight", torch.zeros(3))])
    assert isinstance(opt, TS.SeparateTextOptimizer)
    assert [o.names for o in opt.groups.values()] == [
        ["gen.text_encoder.stack.conv0.conv.weight"],
        ["gen.unet.pre0.conv.weight"]]
    # centered RMSprop keeps the gradients' mean too
    # (test_torch_port_rmsprop_centered.py)
    opt = TS.make_optimizer("RMSprop", 0.1, centered=True)(
        [("p", torch.zeros(2))])
    assert sorted(opt.slots()) == ["mu", "nu"]
