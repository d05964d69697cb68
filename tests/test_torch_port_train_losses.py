"""The port's losses, optimizer and schedules against the JAX package's
(optax for the update rule), at 1e-6: the same float32 arithmetic in the
same order, so only the last bits may differ."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mixstage_tpu.train import losses as JL
from mixstage_tpu.train import state as JS
from mixstage_tpu_torch.train import losses as TL
from mixstage_tpu_torch.train import state as TS

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name,kwargs", [
    ("L1Loss", {}), ("MSELoss", {}), ("SmoothL1Loss", {}),
    ("SmoothL1Loss", {"beta": 0.5}), ("HuberLoss", {"delta": 0.7}),
    ("HuberLoss", {"reduction": "mean"})])
def test_criteria_match_jax(name, kwargs):
    a, b = _pair(np.random.default_rng(0), 3, 8, 5)
    ref = JL.get_criterion(name, **dict(kwargs))(jnp.asarray(a),
                                                  jnp.asarray(b))
    out = TL.get_criterion(name, **dict(kwargs))(torch.from_numpy(a),
                                                  torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_unknown_criterion_raises():
    with pytest.raises(KeyError, match="known"):
        TL.get_criterion("CosineLoss")


def test_helpers_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 4)).astype(np.float32)
    labels = rng.integers(0, 4, size=6)
    np.testing.assert_allclose(
        float(TL.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))),
        float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        **TOL)
    pose = rng.normal(size=(2, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(TL.velocity(torch.from_numpy(pose)).numpy(),
                               np.asarray(JL.velocity(jnp.asarray(pose))),
                               **TOL)
    loss, w = _pair(rng, 3, 4, 2)[0], rng.uniform(size=3).astype(np.float32)
    np.testing.assert_allclose(
        float(TL.sample_wise_weight_mean(torch.from_numpy(loss),
                                         torch.from_numpy(w))),
        float(JL.sample_wise_weight_mean(jnp.asarray(loss), jnp.asarray(w))),
        **TOL)
    for step in (0, 1, 7, 150, 299, 300, 1000):
        for init in (1.0, 0.3):
            assert TL.lambda_schedule(step, init) == pytest.approx(
                float(JL.lambda_schedule(step, init)), rel=1e-6), step


def _tree(rng, scale):
    return {"a": {"kernel": (rng.normal(size=(3, 4, 5)) * scale).astype(
                np.float32)},
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [3.0, 0.01], ids=["clipped", "kept"])
def test_clip_and_adam_match_optax(grad_scale):
    """Two updates of optax's chain(clip_by_global_norm(1), adam) and the
    port's ClippedAdam from the same params and grads, with the global norm
    above 1 (clipped) and below it (kept)."""
    rng = np.random.default_rng(2)
    params = _tree(rng, 1.0)
    grads = [_tree(rng, grad_scale) for _ in range(2)]
    tx = JS.make_optimizer("Adam", 1e-3, grad_clip=1.0)
    jp, js = jax.tree.map(jnp.asarray, params), tx.init(params)
    tparams = [torch.from_numpy(params["a"]["kernel"].copy()),
               torch.from_numpy(params["b"].copy())]
    opt = TS.make_optimizer("Adam", 1e-3)(
        [("a", tparams[0]), ("b", tparams[1])])
    for g in grads:
        assert (np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                            for x in jax.tree.leaves(g))) > 1) == \
            (grad_scale > 1)
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g["a"]["kernel"]),
                  torch.from_numpy(g["b"])])
    adam = js[1][0]
    np.testing.assert_allclose(tparams[0].numpy(), jp["a"]["kernel"], **TOL)
    np.testing.assert_allclose(tparams[1].numpy(), jp["b"], **TOL)
    np.testing.assert_allclose(opt.mu[0].numpy(), adam.mu["a"]["kernel"],
                               **TOL)
    np.testing.assert_allclose(opt.nu[1].numpy(), adam.nu["b"], **TOL)
    assert opt.count == int(adam.count) == 2


def test_schedules_match_jax():
    for kind, kw in (("linear_decay", dict(warmup_steps=10, total_steps=50)),
                     (None, dict(warmup_steps=0, total_steps=0))):
        args = dict(lr=2e-4, gamma=0.9, steps_per_epoch=7, **kw)
        ref, out = JS.make_schedule(kind, **args), TS.make_schedule(kind,
                                                                    **args)
        for step in (0, 3, 10, 11, 30, 49, 50, 60):
            assert out(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                              abs=1e-12), (kind, step)


def test_scheduled_adam_uses_the_count_before_the_update():
    sched = TS.make_schedule("linear_decay", 1.0, 0.9, 4, 10, 1)
    p = torch.zeros(3)
    opt = TS.make_optimizer("Adam", 1.0, schedule=sched)([("p", p)])
    assert opt.learning_rate() == 0.0          # step 0 of the warm-up
    opt.step([torch.ones(3)])
    assert torch.all(p == 0) and opt.learning_rate() == 0.25


def test_unported_optimizer_raises():
    """Every optimizer of the JAX package is ported (the port's own tests
    in test_torch_port_optimizers.py); an unknown name raises as JAX's
    make_optimizer does; -optim_separate builds the text encoder's group
    (held to optax in test_torch_port_optim_separate.py)."""
    with pytest.raises(KeyError, match="unknown"):
        TS.make_optimizer("Adagrad", 0.1)
    opt = TS.make_optimizer("SGD", 0.1, text_lr=1e-5)(
        [("gen.text_encoder.w", torch.zeros(2)), ("gen.w", torch.zeros(2))])
    assert opt.groups["text"].lr == 1e-5 and opt.groups["rest"].lr == 0.1
    assert TS.translate_optim_kwargs({"betas": (0.5, 0.9), "eps": 1e-6}) == \
        {"b1": 0.5, "b2": 0.9, "eps": 1e-6}
