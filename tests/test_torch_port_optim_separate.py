"""``-optim_separate``: the text encoder's own learning rate, port against
optax's ``multi_transform``.

The JAX package's ``make_optimizer(name, lr, grad_clip=1.0,
schedule=..., text_lr=...)`` is ``chain(clip_by_global_norm(1),
multi_transform({"text": <optimizer>(text_lr), "rest": <optimizer>(lr or
schedule)}))`` with every leaf under a ``text_encoder`` key in "text"; the
port's is ``state.SeparateTextOptimizer``.  Both start from one tree (a
generator holding a text encoder, a concat encoder and a pose-style
encoder beside it) and take the same gradients four times under a
linear-decay schedule: the first two clipped (global norm above 1), the
last two kept.

Tolerances: parameters, first moments and momentum traces of both groups
within max |got - want| ≤ 1e-6 · max |want| in float32 (the rounding of a
few float32 operations, as ``test_torch_port_optimizers.py``; largest
measured 9.2e-7), second moments within 4e-6 (squares of the clipped
gradients, whose global norm the two packages sum over 70 leaves in
other orders: twice the relative rounding; largest measured 1.7e-6), the
counts equal.  The optax state carries into the port's optimizer group by group
and back leaf for leaf.  One float64 G step of the text generator with
``optim_separate`` (JAX's x64 scoped to the fixture) within 1e-9, as the
float64 steps are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import flat_tree, jax_train_state, port_state
from mixstage_tpu.train import state as JS
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.models.layers import (ConvNormRelu,
                                              PoseStyleEncoder,
                                              TextEncoder1D)
from mixstage_tpu_torch.train import StepConfig, StepFactory
from mixstage_tpu_torch.train import state as TS

LR, TEXT_LR = 1e-2, 3e-3
TOL = {"params": 1e-6, "mu": 1e-6, "trace": 1e-6, "nu": 4e-6}
CASES = {
    "Adam": ("Adam", {}),
    "AdamW": ("AdamW", {"weight_decay": 0.05}),
    "SGD_momentum": ("SGD", {"momentum": 0.9}),
    "RMSprop": ("RMSprop", {}),
}
SCHEDULE = ("linear_decay", LR, 0.9, 2, 6, 3)   # kind, lr, gamma, warm-up,
#                                                  total, steps per epoch


class Gen(nn.Module):
    """A generator's tree in miniature: a text encoder, a concat encoder."""

    def __init__(self):
        super().__init__()
        self.text_encoder = TextEncoder1D(input_channels=6)
        self.concat_encoder = ConvNormRelu(8, 4, type="1d", leaky=True)


def modules():
    torch.manual_seed(0)
    return {"gen": Gen(), "psenc": PoseStyleEncoder(input_channels=4,
                                                     num_speakers=2)}


def named(mods):
    return [(f"{k}.{n}", p) for k, m in mods.items()
            for n, p in m.named_parameters()]


def flax_params(mods):
    return {k: W.torch_params_to_flax(m, dict(m.named_parameters()))
            for k, m in mods.items()}


def grads_tree(params, rng, scale):
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(
        np.float32), params)


def to_port_grads(mods, tree):
    """A flax-layout gradient tree → the port's list, in ``named`` order."""
    out = []
    for k, m in mods.items():
        g = W.flax_params_to_torch(m, tree[k])
        out += [torch.from_numpy(g[n]) for n, _ in m.named_parameters()]
    return out


def assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def run_both(name, kwargs, steps=4):
    mods = modules()
    params = flax_params(mods)
    rng = np.random.default_rng(11)
    grads = [grads_tree(params, rng, s) for s in (30.0, 20.0, 0.01, 0.02)]
    tx = JS.make_optimizer(name, LR, grad_clip=1.0,
                           schedule=JS.make_schedule(*SCHEDULE),
                           text_lr=TEXT_LR, **kwargs)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    opt = TS.make_optimizer(name, LR, schedule=TS.make_schedule(*SCHEDULE),
                            text_lr=TEXT_LR, **kwargs)(named(mods))
    for g in grads[:steps]:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(to_port_grads(mods, g))
    return mods, jp, js, opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_separate_text_lr_matches_multi_transform(case):
    name, kwargs = CASES[case]
    mods, jp, js, opt = run_both(name, kwargs)
    assert isinstance(opt, TS.SeparateTextOptimizer)
    text = [n for n in opt.names if ".text_encoder." in n]
    assert opt.groups["text"].names == text and len(text) == 24
    got = flat_tree(flax_params(mods))
    for k, want in flat_tree(jax.tree.map(np.asarray, jp)).items():
        assert_close(got[k], want, TOL["params"], k)
    inner = W._partition(js)
    back = W.to_flax_opt_state(opt, mods)["inner_states"]
    for g in ("text", "rest"):
        nodes = W._opt_nodes(inner[g])
        sub = opt.groups[g]
        assert sorted(k for k in nodes if k != "count") == sorted(
            sub.slots())
        if "count" in nodes:
            assert int(nodes["count"]) == sub.count == 4
        for slot in sub.slots():
            mine = flat_tree(back[g][slot])
            want = {}
            for path, v in W._leaves(nodes[slot]):
                if not W._masked(v):
                    want["/".join(path)] = np.asarray(v, np.float64)
            assert sorted(mine) == sorted(want), (g, slot)
            assert all(("text_encoder" in k) == (g == "text") for k in want)
            for k, w in want.items():
                assert_close(mine[k], w, TOL[slot], (g, slot, k))
    # the text group ran at the constant text_lr, the rest on the schedule
    assert opt.groups["text"].learning_rate() == TEXT_LR
    assert opt.learning_rate() == pytest.approx(
        float(JS.make_schedule(*SCHEDULE)(4)), rel=1e-6)


@pytest.mark.parametrize("case", ["Adam", "SGD_momentum", "RMSprop"])
def test_partitioned_state_bridges_both_ways(case):
    """optax's partitioned state (``MaskedNode`` at the other group's
    leaves) loads into the port's groups, counts included, and
    ``to_flax_opt_state`` gives each group's leaves back bit for bit."""
    name, kwargs = CASES[case]
    _, jp, js, _ = run_both(name, kwargs, steps=2)
    mods = modules()
    opt = TS.make_optimizer(name, LR, text_lr=TEXT_LR, **kwargs)(
        named(mods))
    W.load_flax_opt_state(opt, mods, js)
    inner = W._partition(js)
    back = W.to_flax_opt_state(opt, mods)["inner_states"]
    for g in ("text", "rest"):
        nodes = W._opt_nodes(inner[g])
        if "count" in nodes:
            assert opt.groups[g].count == int(nodes["count"]) == 2
            assert int(back[g]["count"]) == 2
        for slot in opt.groups[g].slots():
            mine = flat_tree(back[g][slot])
            for path, v in W._leaves(nodes[slot]):
                if not W._masked(v):
                    np.testing.assert_array_equal(
                        mine["/".join(path)], np.asarray(v, np.float64))
    # a state of the other layout is refused
    with pytest.raises(KeyError):
        W.load_flax_opt_state(opt, mods, JS.make_optimizer(
            name, LR, grad_clip=1.0, **kwargs).init(jp))


def test_one_group_path_unchanged():
    """Without ``text_lr`` the optimizer is the plain rule, bit for bit
    the same update as one group of the separate optimizer at the same
    rate on the same (already clipped) gradients."""
    mods = modules()
    plain = TS.make_optimizer("Adam", LR)(named(mods))
    assert not isinstance(plain, TS.SeparateTextOptimizer)
    twin = modules()
    sep = TS.make_optimizer("Adam", LR, text_lr=LR)(named(twin))
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)
                              * 0.01) for p in plain.params]
        plain.step(g)
        sep.step(g)
    for a, b in zip(plain.params, sep.params):
        assert torch.equal(a, b)


# ---------------------------------------------- a float64 G step with it
B, T, MEL, FEATS = 2, 64, 128, 96
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=2, lr=1e-4,
           model_kwargs=(("in_channels", 64),),
           input_modalities=("audio/log_mel_512", "text/w2v"),
           text_channels=300, optim_separate=1e-5)
F64_TOL = 1e-9


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(B, T, MEL)), rng.normal(size=(B, T, 300))),
            "y": rng.normal(size=(B, T, FEATS)),
            "labels": rng.integers(0, 2, size=(B, T)),
            "style": np.repeat(rng.integers(0, 2, size=(B, 1)), T, 1)}


def test_f64_g_step_with_separate_text_lr_matches_jax():
    with jax.enable_x64(True):
        f = JaxStepFactory(JaxStepConfig(**CFG, dtype=jnp.float64),
                           donate=False)
        state0 = jax_train_state(f, jax.tree.map(jnp.asarray, make_batch(0)),
                                 dtype=np.float64)
        js, jl, _ = f.make_steps()["g"](
            state0, jax.tree.map(jnp.asarray, make_batch(1)),
            jax.random.key(1), use_pose_input=False)
        state0, js = (jax.tree.map(np.asarray, state0),
                      jax.tree.map(np.asarray, js))
    factory = StepFactory(StepConfig(**CFG, dtype=torch.float64),
                          device="cpu")
    ps = port_state(factory, state0)
    assert isinstance(ps.g_opt, TS.SeparateTextOptimizer)
    before = {n: p.detach().clone() for n, p in zip(ps.g_opt.names,
                                                   ps.g_opt.params)}
    ps, pl, _ = factory.make_steps()["g"](ps, make_batch(1))
    for k, v in jl.items():
        v = np.asarray(v)
        assert np.abs(pl[k].numpy() - v).max() <= \
            F64_TOL * np.abs(v).max(), k
    got = flat_tree(W.jax_train_state_of(ps)["g_params"])
    for k, want in flat_tree(js.g_params).items():
        assert np.abs(got[k] - want).max() <= \
            F64_TOL * np.abs(want).max(), k
    # Adam's first step moves a leaf by at most its group's rate
    step = {g: max(float((p.detach() - before[n]).abs().max())
                   for n, p in zip(sub.names, sub.params))
            for g, sub in ps.g_opt.groups.items()}
    assert 0.5e-5 < step["text"] <= 1e-5 * (1 + 1e-9)
    assert 0.5e-4 < step["rest"] <= 1e-4 * (1 + 1e-9)
    back = W.jax_train_state_of(ps)["g_opt_state"]["inner_states"]
    inner = W._partition(js.g_opt_state)
    for g in ("text", "rest"):
        nodes = W._opt_nodes(inner[g])
        assert int(back[g]["count"]) == int(nodes["count"]) == 1
        for slot in ("mu", "nu"):
            mine = flat_tree(back[g][slot])
            for path, v in W._leaves(nodes[slot]):
                if W._masked(v):
                    continue
                k, v = "/".join(path), np.asarray(v)
                err = float(np.abs(mine[k] - v).max())
                if (k.endswith("conv/bias") and "logits" not in k) or \
                        not np.any(v):
                    assert err <= 1e-12, (g, slot, k, err)
                else:
                    assert err <= F64_TOL * float(np.abs(v).max()), \
                        (g, slot, k, err)
