"""K3's plain versions (the CPU path of ``ops/cuda/train_decoder.py``)
against the JAX package's training decoder.

* Forward: the port's ``fused_decoder_train`` on a small generator against
  JAX ``fused_decoder_train(..., interpret=True)`` (the Pallas kernel run as
  the JAX tests run it on the CPU) and against ``decoder_train_reference``:
  outputs and batch (mu, var) at 1e-5.
* Backward: the explicit formulas of ``decoder_train_bwd_plain`` against the
  gradients of JAX's ``decoder_train_xla_twin`` at relative Frobenius error
  ≤ 1e-4 (robust to a rare leaky kink flipped by another sum order); dcb is
  0 analytically under train BN, so it is compared absolutely (< 1e-4).
* ``DecoderTrain``'s backward against torch autograd through the plain
  forward, and the wrappers' argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import small_generators
from mixstage_tpu.ops.pallas import train_decoder as jtd
from mixstage_tpu_torch.ops.cuda import train_decoder as ttd

B, T = 2, 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gens():
    jg, params, stats, tg = small_generators(seed=4)
    C0 = tg.decoder0.conv.weight.shape[1]
    x = np.random.default_rng(5).normal(size=(B, T, C0)).astype(np.float32)
    return params, tg, x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_forward_matches_pallas_interpret_and_reference(gens):
    params, tg, x = gens
    G = tg.num_clusters
    with torch.no_grad():
        xr, mu, var = ttd.fused_decoder_train(torch.from_numpy(x), tg)
    for ref_xr, ref_stats in (
            jtd.fused_decoder_train(jnp.asarray(x), params, G,
                                    interpret=True),
            jtd.decoder_train_reference(jnp.asarray(x), params, G)):
        np.testing.assert_allclose(xr.numpy(), np.asarray(ref_xr), **TOL)
        for layer, (m, v) in enumerate(ref_stats):
            np.testing.assert_allclose(mu[:, layer].reshape(-1).numpy(),
                                       np.asarray(m), **TOL)
            np.testing.assert_allclose(var[:, layer].reshape(-1).numpy(),
                                       np.asarray(v), **TOL)


def _packed(params, G, x):
    """JAX's padded kernel arguments and the port's unpadded ones."""
    p = jtd.extract_train_decoder(params, G)
    C0, F = p["c0"], p["out_feats"]
    C0p = p["w0"].shape[2]
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, C0p - C0)))
    jargs = (xp, p["w0"], p["wc"], p["cb"], p["gamma"], p["beta"], p["wl"],
             p["bl"])
    t = lambda a: torch.from_numpy(np.array(a, order="C"))
    targs = (t(x), t(p["w0"][:, :, :C0]), t(p["wc"]), t(p["cb"]),
             t(p["gamma"]), t(p["beta"]), t(p["wl"][..., :F]),
             t(p["bl"][..., :F]))
    return jargs, targs, C0, F


def test_backward_matches_jax_twin_gradients(gens):
    params, tg, x = gens
    G = tg.num_clusters
    jargs, targs, C0, F = _packed(params, G, x)
    cot = np.random.default_rng(6).normal(
        size=(G, B, T, jargs[6].shape[-1])).astype(np.float32)

    def loss(*a):
        return jnp.sum(jtd.decoder_train_xla_twin(*a)[0] * cot)

    want = jax.grad(loss, argnums=tuple(range(8)))(*jargs)
    out, cs, mu, var = ttd.decoder_train_fwd_plain(*targs)
    x_, w0, wc, cb, gamma, beta, wl, bl = targs
    got = ttd.decoder_train_bwd_plain(
        torch.from_numpy(np.ascontiguousarray(cot[..., :F])), x_, cs, mu,
        var, w0, wc, gamma, beta, wl)
    names = ["dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl"]
    cut = {"dx": lambda a: a[..., :C0], "dw0": lambda a: a[:, :, :C0],
           "dwl": lambda a: a[..., :F], "dbl": lambda a: a[..., :F]}
    for name, w, g in zip(names, want, got):
        w = cut.get(name, lambda a: a)(np.asarray(w))
        if name == "dcb":
            assert np.abs(g.numpy()).max() < 1e-4
            assert np.abs(w).max() < 1e-4
            continue
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) <= 1e-4, (name, _rel(g.numpy(), w))


def test_function_backward_matches_autograd_of_plain_forward(gens):
    _, tg, x = gens
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in ttd.extract_train_decoder(tg).items()}
    keys = ["w0", "wc", "cb", "gamma", "beta", "wl", "bl"]
    xt = torch.from_numpy(x).requires_grad_(True)
    cot = torch.randn(tg.num_clusters, B, T, p["wl"].shape[-1],
                      generator=torch.Generator().manual_seed(7))
    before = (ttd.decoder_train_fwd.launches, ttd.decoder_train_bwd.launches)
    out, mu, var = ttd.DecoderTrain.apply(xt, *(p[k] for k in keys))
    assert not mu.requires_grad and not var.requires_grad
    got = torch.autograd.grad((out * cot).sum(), [xt] + [p[k] for k in keys])
    ref_out = ttd.decoder_train_fwd_plain(xt, *(p[k] for k in keys))[0]
    want = torch.autograd.grad((ref_out * cot).sum(),
                               [xt] + [p[k] for k in keys])
    for name, g, w in zip(["x"] + keys, got, want):
        if name == "cb":
            assert g.abs().max() < 1e-4 and w.abs().max() < 1e-4
            continue
        assert _rel(g.numpy(), w.numpy()) <= 1e-4, name
    # the CPU path runs the plain versions and launches no kernel
    assert (ttd.decoder_train_fwd.launches,
            ttd.decoder_train_bwd.launches) == before


def test_gather_reaches_the_module_parameters(gens):
    _, tg, x = gens
    tg.zero_grad()
    xr, _, _ = ttd.fused_decoder_train(torch.from_numpy(x), tg)
    xr.square().sum().backward()
    for layer in tg.decoder_layers():
        assert layer.conv.weight.grad.abs().sum() > 0
        assert layer.norm.weight.grad.abs().sum() > 0
    assert tg.logits.weight.grad.abs().sum() > 0
    tg.zero_grad()


def test_wrappers_reject_what_the_kernel_cannot_take(gens):
    _, tg, x = gens
    p = {k: v.detach() for k, v in ttd.extract_train_decoder(tg).items()}
    args = [torch.from_numpy(x)] + [p[k] for k in
                                    ["w0", "wc", "cb", "gamma", "beta", "wl",
                                     "bl"]]
    with pytest.raises(TypeError, match="float32"):
        ttd.decoder_train_fwd(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ttd.decoder_train_fwd(args[0].transpose(0, 1).contiguous()
                              .transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ttd.decoder_train_fwd(args[0], args[1], args[2][:2], *args[3:])
