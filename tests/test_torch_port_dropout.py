"""Dropout (``p > 0``): the port against the JAX package by statistics.

The port cannot reproduce JAX's random draws, so dropout is held the way
``benchmarks/dynamics_parity.py`` holds a trajectory: by what the draws
must share.

* the mask: the kept share of a large tensor within 5 binomial standard
  deviations of ``1 - p``; a kept element is ``x / (1 - p)`` with the
  scale rounded to the input's dtype, bit for bit what ``flax.linen.Dropout``
  keeps (float32 and bfloat16, at the elements both keep);
* eval mode (and ``p = 0`` in training mode) is the identity, so a model
  built with ``p > 0`` computes in eval mode bit for bit what it does with
  ``p = 0``;
* one seed gives one step, two seeds two; the masks come from the step's
  generator (``dropout_rng``), not from torch's global one;
* the loss of one train step from one state, over 16 seeds in each
  package: the two means within ``N_SE`` = 4 standard errors (of their
  difference) for ``Speech2Gesture_G`` (the non-GAN step) and
  ``StyleClassifier_G`` (the classifier step).  These are the
  configurations where the JAX package applies dropout: it passes no
  dropout key to the discriminator or the pose-style encoder, so a GAN or
  a Mix-StAGE generator with ``p > 0`` raises there (flax's
  ``InvalidRngError``), where the port drops in every module in training
  mode (``test_gan_and_style_steps_drop_in_every_module``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import jax_train_state, port_state
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.models.layers import dropout, dropout_rng
from mixstage_tpu_torch.train import StepConfig, StepFactory

P = 0.1
B, T, MEL, FEATS = 2, 64, 32, 96
N_SEEDS, N_SE = 16, 4.0
SIMPLE = dict(model="Speech2Gesture_G", gan=False, criterion="L1Loss",
              num_speakers=2, lr=1e-4, model_kwargs=(("in_channels", 32),),
              p_dropout=P)
CLASSIFIER = dict(model="StyleClassifier_G", gan=False, num_speakers=2,
                  lr=1e-4, p_dropout=P)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(B, T, MEL)).astype(np.float32),),
            "y": rng.normal(size=(B, T, FEATS)).astype(np.float32),
            "style": np.repeat(np.arange(B)[:, None] % 2, T, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_share_and_scale_match_flax(dtype):
    n = 1 << 20
    x = torch.randn(n, generator=torch.Generator().manual_seed(0)).to(dtype)
    with dropout_rng(torch.Generator().manual_seed(1)):
        out = dropout(x, P, training=True)
    kept = out != 0
    share = float(kept.float().mean())
    sigma = np.sqrt(P * (1 - P) / n)
    assert abs(share - (1 - P)) <= 5 * sigma, (share, sigma)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    ref = fnn.Dropout(rate=P, deterministic=False).apply(
        {}, xj, rngs={"dropout": jax.random.key(0)})
    ref = np.asarray(ref.astype(jnp.float32))
    both = kept.numpy() & (ref != 0)
    assert both.mean() > 0.75
    np.testing.assert_array_equal(out.float().numpy()[both], ref[both])
    assert out.dtype == dtype


def test_eval_mode_is_p0_bit_for_bit():
    """A Mix-StAGE generator built with p = 0.1, in eval mode, and one
    with p = 0 (same weights) give the same pose bit for bit; ``dropout``
    in training mode at p = 0 returns its input."""
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_

    kw = dict(in_channels=32, num_clusters=2, num_speakers=2)
    m1 = JointLateClusterSoftStyle4_G(p=P, **kw)
    m0 = JointLateClusterSoftStyle4_G(p=0.0, **kw)
    reset_parameters_(m1, torch.Generator().manual_seed(0),
                      random_bn_stats=True)
    m0.load_state_dict(m1.state_dict())
    b = make_batch(0)
    sw = torch.full((B, T, 2), 0.5)
    args = ([torch.from_numpy(b["x"][0])], torch.from_numpy(b["y"]), sw)
    with torch.no_grad():
        p1 = m1.eval()(*args)["pose"]
        p0 = m0.eval()(*args)["pose"]
        t0 = m0.train()(*args)["pose"]
    assert torch.equal(p1, p0)
    x = torch.randn(8, 4)
    assert dropout(x, 0.0, training=True) is x
    assert not torch.equal(t0, p0)         # training mode: batch stats


def test_seeds_reproduce_and_differ():
    """One ``rng`` seed gives one step bit for bit, another seed another;
    the masks come from the step's own generator (torch's global one is
    left as it was)."""
    factory = StepFactory(StepConfig(**SIMPLE), device="cpu")
    step = factory.make_steps()["train"]
    states = [factory.init(seed=0) for _ in range(3)]
    before = torch.random.get_rng_state()
    runs = []
    for seed, state in zip((3, 3, 4), states):
        _, losses, pose = step(state, make_batch(1), rng=seed)
        runs.append((float(losses["total"]), pose))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][0] != runs[2][0]
    # a torch.Generator as the rng: the same draws from the same state
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a = step(factory.init(seed=0), make_batch(1), rng=g1)[1]["total"]
    b = step(factory.init(seed=0), make_batch(1), rng=g2)[1]["total"]
    assert float(a) == float(b)


def _mean_se(values):
    v = np.asarray(values, np.float64)
    return v.mean(), v.std(ddof=1) / np.sqrt(len(v))


@pytest.mark.parametrize("cfg", [SIMPLE, CLASSIFIER],
                         ids=["Speech2Gesture_G", "StyleClassifier_G"])
def test_loss_over_seeds_matches_jax(cfg):
    """One train step from one state and one batch, 16 dropout seeds in
    each package: the mean losses agree within 4 standard errors; with
    p = 0 the two packages give the same loss (rtol 1e-5)."""
    jf = JaxStepFactory(JaxStepConfig(**cfg), donate=False)
    batch = make_batch(2)
    jstate = jax_train_state(jf, jax.tree.map(jnp.asarray, batch))
    jstep = jf.make_steps()["train"]
    jb = jax.tree.map(jnp.asarray, batch)
    jl = [float(jstep(jstate, jb, jax.random.key(s))[1]["total"])
          for s in range(N_SEEDS)]
    pf = StepFactory(StepConfig(**cfg), device="cpu")
    pstep = pf.make_steps()["train"]
    state0 = jax.tree.map(np.asarray, jstate)
    pl = [float(pstep(port_state(pf, state0), batch, rng=s)[1]["total"])
          for s in range(N_SEEDS)]
    (mj, sj), (mp, sp) = _mean_se(jl), _mean_se(pl)
    assert sj > 0 and sp > 0                      # the seeds do differ
    assert abs(mp - mj) <= N_SE * np.hypot(sj, sp), (mp, mj, sp, sj)
    # without dropout both packages compute one and the same loss
    p0 = {**cfg, "p_dropout": 0.0}
    jf0 = JaxStepFactory(JaxStepConfig(**p0), donate=False)
    pf0 = StepFactory(StepConfig(**p0), device="cpu")
    want = float(jf0.make_steps()["train"](jstate, jb, jax.random.key(0))[1][
        "total"])
    got = float(pf0.make_steps()["train"](port_state(pf0, state0), batch)[1][
        "total"])
    assert got == pytest.approx(want, rel=1e-5)


def test_gan_and_style_steps_drop_in_every_module(monkeypatch):
    """A Mix-StAGE GAN with p > 0: in the G step every ConvNormRelu that
    runs, of the generator, the pose-style encoder and D, drops elements
    (at p = 0.5 every output of 64 elements or more); in the D step D's do
    and the eval-mode generator's do not."""
    from mixstage_tpu_torch.models import layers

    cfg = dict(model="JointLateClusterSoftStyle4_G", gan=True,
               num_clusters=2, num_speakers=2,
               model_kwargs=(("in_channels", 32),), p_dropout=0.5)
    factory = StepFactory(StepConfig(**cfg), device="cpu")
    state = factory.init(seed=0)
    calls, drops = [], []
    for name in ("gen", "psenc", "disc"):
        for m in getattr(state, name).modules():
            if isinstance(m, layers.ConvNormRelu):
                m.register_forward_pre_hook(
                    lambda mod, args, name=name: calls.append(
                        (name, mod.training)))
    orig = layers.dropout

    def counting(x, p, training):
        out = orig(x, p, training)
        # a drop is certain only on many elements (psenc's last conv
        # gives B·1·2 = 4, all kept with probability 1/16): those count
        drops.append(bool((out == 0).any()) or out.numel() < 64)
        return out
    monkeypatch.setattr(layers, "dropout", counting)
    batch = {**make_batch(3), "labels": np.zeros((B, T), np.int64)}
    state, _, _ = factory.make_steps()["g"](state, batch, rng=1)
    g_calls = list(zip(calls, drops))
    calls.clear(), drops.clear()
    factory.make_steps()["d"](state, batch, rng=2)
    d_calls = list(zip(calls, drops))
    assert {name for (name, _), _ in g_calls} == {"gen", "psenc", "disc"}
    assert all(training and dropped for (_, training), dropped in g_calls), \
        g_calls
    assert any(name == "disc" for (name, _), _ in d_calls)
    for (name, training), dropped in d_calls:
        assert training == (name == "disc"), name
        assert dropped or not training, name
