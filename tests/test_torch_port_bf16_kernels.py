"""The plain versions of K1 and K3 in their bf16 modes against the JAX
package's Pallas kernels at ``dtype=bfloat16`` (interpret mode, as the JAX
package's own tests run them on the CPU).

Tolerance: the bf16 rule (``_torch_port_helpers.bf16_rule``): each bf16
output's drift from the float32 truth (the same function in float32 on the
same bf16-valued inputs) within 10% (+1e-3) of the JAX kernel's drift;
gradients by relative Frobenius drift per leaf.  The JAX side is compiled
with XLA's excess precision off (``jax_nominal``), so that it rounds where
the kernels' source rounds.

* K1: bf16 features, float32 folded weights, against
  ``fused_mixstage_decoder(..., interpret=True)``.  The truth is
  ``folded_decoder_xla`` on the features read as float32 (at bf16 it
  refuses float32 weights: ``lax.conv_general_dilated`` takes one dtype).
  Rounding the weights to bf16 is another function and fails the rule.
* K3: the generator's decoder through ``fused_decoder_train`` (the f32
  parameters cast to bf16 inside the graph) against JAX's
  ``fused_decoder_train(..., interpret=True)``: the logits and the batch
  statistics, then the gradients of the features and of every decoder
  parameter through ``DecoderTrain`` against ``jax.grad`` through JAX's
  custom_vjp (its backward kernel) and through its autodiff twin
  ``decoder_train_xla_twin``.  The conv biases before BatchNorm have
  gradient 0 analytically; they stay below 1e-4 of the largest gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (as_np, bf16_rule, bf16_values, jax_nominal,
                                 small_generators)
from mixstage_tpu.ops.pallas import fused_conv as jfc
from mixstage_tpu.ops.pallas import train_decoder as jtd
from mixstage_tpu.serve import folded_decoder_xla
from mixstage_tpu_torch.ops.cuda import fused_conv as tfc
from mixstage_tpu_torch.ops.cuda import train_decoder as ttd

KEYS = ("x", "w0", "wc", "biases", "w_logits", "b_logits")
# (G, C0, C, L, F): the classifier chain's one group, the mixture decoder's
# several, an odd C0, one chain layer
K1_SHAPES = [(1, 40, 32, 5, 8), (3, 37, 32, 3, 12), (2, 16, 8, 1, 5)]


def _folded(seed, B, T, G, C0, C, L, F):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        x=bf16_values(f32(rng.normal(size=(B, T, C0)))),
        w0=f32(rng.normal(size=(G, 3, C0, C)) / np.sqrt(3 * C0)),
        wc=f32(rng.normal(size=(L, G, 3, C, C)) / np.sqrt(3 * C)),
        biases=f32(rng.normal(size=(G, L + 1, C)) * 0.1),
        w_logits=f32(rng.normal(size=(G, C, F)) / np.sqrt(C)),
        b_logits=f32(rng.normal(size=(G, F)) * 0.1))


@pytest.mark.parametrize("G,C0,C,L,F", K1_SHAPES)
def test_k1_plain_bf16_follows_pallas_interpret(G, C0, C, L, F):
    a = _folded(G + C0, B=2, T=32, G=G, C0=C0, C=C, L=L, F=F)
    w = [jnp.asarray(a[k]) for k in KEYS[1:]]
    truth = np.asarray(folded_decoder_xla(
        jnp.asarray(a["x"]), {**dict(zip(KEYS[1:], w)), "c0": C0}, G))
    q = as_np(jax_nominal(functools.partial(
        jfc.fused_mixstage_decoder, groups=G, batch_tile=2, interpret=True),
        jnp.asarray(a["x"], jnp.bfloat16), *w))
    tw = [torch.from_numpy(a[k]) for k in KEYS[1:]]
    x16 = torch.from_numpy(a["x"]).bfloat16()
    out = tfc.fused_mixstage_decoder(x16, *tw, groups=G)   # CPU: plain
    assert out.dtype == torch.bfloat16 and out.shape == (2, 32, G * F)
    dp, dq, ok = bf16_rule(as_np(out), q, truth)
    assert ok, (dp, dq)
    # two-sided: the float32 decoder (no rounding) fails the rule; rounding
    # the weights to bf16 as well drifts further (at these widths by a
    # third more, inside the rule's 1e-3 floor)
    exact = tfc.fused_mixstage_decoder_plain(x16.float(), *tw, groups=G)
    assert not bf16_rule(as_np(exact), q, truth)[2]
    w16 = [t.bfloat16().float() for t in tw]
    coarse = tfc.fused_mixstage_decoder_plain(x16, *w16, groups=G)
    dc = bf16_rule(as_np(coarse), q, truth)[0]
    assert dc > 1.2 * dq, (dc, dq)


@pytest.fixture(scope="module")
def decoder():
    """The small generator's decoder and bf16-valued features."""
    _, params, _, tg = small_generators(seed=4)
    C0 = tg.decoder0.conv.weight.shape[1]
    x = bf16_values(np.random.default_rng(5).normal(size=(4, 32, C0))
                    .astype(np.float32))
    return params, tg, x


def _jax_decoder(params, G, x):
    """(xr, mu, var) of JAX's fused training decoder on ``x``."""
    xr, stats = jtd.fused_decoder_train(x, params, G, interpret=True)
    return xr, jnp.stack([m for m, _ in stats]), \
        jnp.stack([v for _, v in stats])


def test_k3_forward_plain_bf16_follows_pallas_interpret(decoder):
    params, tg, x = decoder
    G = tg.num_clusters
    run = functools.partial(_jax_decoder, params, G)
    truth = [as_np(v) for v in jax_nominal(run, jnp.asarray(x))]
    q = [as_np(v) for v in jax_nominal(run, jnp.asarray(x, jnp.bfloat16))]
    with torch.no_grad():
        xr, mu, var = ttd.fused_decoder_train(torch.from_numpy(x).bfloat16(),
                                              tg)
    assert xr.dtype == torch.bfloat16 and mu.dtype == torch.float32
    # the port's (G, 4, C) statistics in JAX's per-layer (G·C,) order
    got = [as_np(xr), as_np(mu.transpose(0, 1).reshape(4, -1)),
           as_np(var.transpose(0, 1).reshape(4, -1))]
    for name, p_, q_, r_ in zip(("xr", "mu", "var"), got, q, truth):
        dp, dq, ok = bf16_rule(p_, q_, r_)
        assert ok, (name, dp, dq)


def _port_grads(tg, x, cot):
    """Gradients of sum(xr * cot) through ``fused_decoder_train`` w.r.t.
    the features and the decoder's parameters, by flax leaf name."""
    xt = torch.from_numpy(x).to(cot.dtype).requires_grad_(True)
    named = {f"decoder{i}/{part}/{leaf}": getattr(getattr(m, part), name)
             for i, m in enumerate(tg.decoder_layers())
             for part, leaf, name in (("conv", "kernel", "weight"),
                                      ("conv", "bias", "bias"),
                                      ("norm", "scale", "weight"),
                                      ("norm", "bias", "bias"))}
    named.update({"logits/kernel": tg.logits.weight,
                  "logits/bias": tg.logits.bias})
    xr, _, _ = ttd.fused_decoder_train(xt, tg)
    grads = torch.autograd.grad((xr.float() * cot.float()).sum(),
                                [xt] + list(named.values()))
    out = {"x": as_np(grads[0])}
    for (key, p), g in zip(named.items(), grads[1:]):
        g = g.float()
        if key.endswith("kernel") and g.ndim == 3:   # (out, in, k) → flax
            g = g.permute(2, 1, 0)
        out[key] = g.numpy()
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("reference", ["kernel", "autodiff_twin"])
def test_k3_backward_plain_bf16_follows_jax(decoder, reference):
    params, tg, x = decoder
    G = tg.num_clusters
    dec = {k: v for k, v in params.items()
           if k.startswith("decoder") or k == "logits"}
    F = params["logits"]["bias"].shape[0] // G
    cot = bf16_values(np.random.default_rng(6).normal(
        size=x.shape[:2] + (G * F,)).astype(np.float32))

    if reference == "kernel":
        def loss(xx, p):
            xr = _jax_decoder(p, G, xx)[0]
            return jnp.sum(xr.astype(jnp.float32) * cot)
    else:
        def loss(xx, p):
            k = jtd.extract_train_decoder(p, G)
            C0p, Fp = k["w0"].shape[2], k["wl"].shape[-1]
            xp = jnp.pad(xx, ((0, 0), (0, 0), (0, C0p - xx.shape[-1])))
            args = [xp] + [k[n].astype(xx.dtype) for n in
                           ("w0", "wc", "cb", "gamma", "beta", "wl", "bl")]
            out = jtd.decoder_train_xla_twin(*args)[0][..., :F]
            xr = jnp.transpose(out, (1, 2, 0, 3)).reshape(xx.shape[:2] +
                                                          (G * F,))
            return jnp.sum(xr.astype(jnp.float32) * cot)

    grad = jax.grad(loss, argnums=(0, 1))
    truth = jax_nominal(grad, jnp.asarray(x), dec)
    q = jax_nominal(grad, jnp.asarray(x, jnp.bfloat16), dec)
    truth = {"x": as_np(truth[0]), **_flat(jax.tree.map(as_np, truth[1]))}
    q = {"x": as_np(q[0]), **_flat(jax.tree.map(as_np, q[1]))}
    got = _port_grads(tg, x, torch.from_numpy(cot).bfloat16())
    assert sorted(got) == sorted(truth)
    scale = max(np.abs(v).max() for v in truth.values())
    for key, r_ in truth.items():
        p_, q_ = got[key], q[key].reshape(r_.shape)
        p_ = p_.reshape(r_.shape)
        if key.endswith("conv/bias"):        # 0 analytically
            assert np.abs(p_).max() < 1e-4 * scale, key
            continue
        dp, dq, ok = bf16_rule(p_, q_, r_, frobenius=True)
        assert ok, (key, dp, dq)
