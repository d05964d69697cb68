"""K3's earlier 3xTF32 arithmetic, emulated on the CPU, against JAX.

K3's f32 mode took every GEMM product of the training decoder's forward
and backward on the tensor cores in 3xTF32 (``mma.sync``) before it moved
onto ``wgmma`` with six bf16 products of three-term splits
(``test_torch_port_k3_f32_wgmma.py``), as K1 did before it.  These tests
pin the arithmetic of that route, which stays the yardstick
(``tools/profile_k1.py --k3 --parent`` times its kernel against the
current one): each f32 operand v is split into hi = cvt.rna.tf32.f32(v)
and lo = cvt.rna.tf32.f32(v - hi), a product is
a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 sums, while BatchNorm's
statistics, its backward and the leaky units stay in f32.  Here every
product of the chain goes through ``product`` (``_torch_port_helpers``),
at a small ragged width, and is held against JAX's
``decoder_train_xla_twin`` (float32 on the CPU) and its ``jax.vjp``:

* the forward (out, mu, var) within 1e-5 of max |ref|;
* every gradient within 1e-4 relative Frobenius (dcb, 0 analytically under
  train BN, below 1e-4 of max |dbeta|), the kernel's tolerance on the card.

One TF32 pass alone (what the tensor cores give without the split) misses
those tolerances, which is why the kernel splits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import product
from mixstage_tpu.ops.pallas.train_decoder import decoder_train_xla_twin

EPS, SLOPE, L = 1e-5, 0.2, 4
G, C0, C, F, B, T = 2, 37, 64, 16, 2, 16
FWD_TOL = 1e-5               # max |emulated - ref| / max |ref|
GRAD_TOL = 1e-4              # relative Frobenius error per gradient
NAMES = ("dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl")


def _shift(a, s):
    """(B, T, C) with out[:, t] = a[:, t + s] (s = ±1), zero past the ends."""
    z = torch.zeros_like(a[:, :1])
    return torch.cat([a[:, 1:], z], 1) if s > 0 else \
        torch.cat([z, a[:, :-1]], 1)


def _bn(cf, mu, var, gamma, beta):
    xhat = (cf - mu) * torch.rsqrt(var + EPS)
    pre = xhat * gamma + beta
    return xhat, pre, torch.where(pre >= 0, pre, SLOPE * pre)


def _conv3(h, w, passes):
    """k=3 'same' conv, h (B, T, cin), w (3, cin, cout) -> (B*T, cout)."""
    n = h.shape[0] * h.shape[1]
    taps = (_shift(h, -1), h, _shift(h, 1))
    out = product(taps[0].reshape(n, -1), w[0], passes)
    for k in (1, 2):
        out = out + product(taps[k].reshape(n, -1), w[k], passes)
    return out


def emulated_fwd(a, passes):
    """K3-fwd with every product in ``passes`` TF32 passes: (out (G,B,T,F),
    cs (4,G,B,T,C), mu, var (G,4,C))."""
    x, w0, wc, cb, gamma, beta, wl, bl = a
    outs, cs, mus, vrs = [], [], [], []
    for g in range(G):
        h, cg, mg, vg = x, [], [], []
        for layer in range(L):
            w = w0[g] if layer == 0 else wc[layer - 1, g]
            cf = _conv3(h, w, passes) + cb[g, layer]
            mu = cf.mean(0)
            var = (cf * cf).mean(0) - mu * mu
            h = _bn(cf, mu, var, gamma[g, layer], beta[g, layer])[2]
            h = h.reshape(B, T, C)
            cg.append(cf.reshape(B, T, C))
            mg.append(mu)
            vg.append(var)
        outs.append((product(h.reshape(B * T, C), wl[g], passes)
                     + bl[g]).reshape(B, T, -1))
        cs.append(torch.stack(cg))
        mus.append(torch.stack(mg))
        vrs.append(torch.stack(vg))
    return (torch.stack(outs), torch.stack(cs, 1), torch.stack(mus),
            torch.stack(vrs))


def emulated_bwd(dout, a, cs, mu, var, passes):
    """K3-bwd with every product (dW, d(input), the head's) in ``passes``
    TF32 passes: (dx, dw0, dwc, dcb, dgamma, dbeta, dwl, dbl)."""
    x, w0, wc, _, gamma, beta, wl, _ = a
    n = B * T
    dx = torch.zeros_like(x)
    dw0, dwc = torch.empty_like(w0), torch.empty_like(wc)
    dcb, dg, db = (torch.empty_like(gamma) for _ in range(3))
    dwl, dbl = torch.empty_like(wl), torch.empty(G, 1, F)

    def act(g, layer):
        return _bn(cs[layer, g].reshape(n, C), mu[g, layer], var[g, layer],
                   gamma[g, layer], beta[g, layer])

    for g in range(G):
        do = dout[g].reshape(n, F)
        dwl[g] = product(act(g, L - 1)[2].T, do, passes)
        dbl[g, 0] = do.sum(0)
        dh = product(do, wl[g].T, passes)
        for layer in range(L - 1, -1, -1):
            inv = torch.rsqrt(var[g, layer] + EPS)
            xhat, pre, _ = act(g, layer)
            dpre = torch.where(pre >= 0, dh, SLOPE * dh)
            dg[g, layer] = (dpre * xhat).sum(0)
            db[g, layer] = dpre.sum(0)
            dxhat = dpre * gamma[g, layer]
            dc = inv * (dxhat - dxhat.mean(0)
                        - xhat * (dxhat * xhat).mean(0))
            dcb[g, layer] = dc.sum(0)
            if layer == 0:
                inp, w = x, w0[g]
            else:
                inp = act(g, layer - 1)[2].reshape(B, T, C)
                w = wc[layer - 1, g]
            cin = inp.shape[-1]
            taps = (_shift(inp, -1), inp, _shift(inp, 1))
            dw = torch.stack([product(t.reshape(n, cin).T, dc, passes)
                              for t in taps])
            if layer == 0:
                dw0[g] = dw
            else:
                dwc[layer - 1, g] = dw
            u = [product(dc, w[k].T, passes).reshape(B, T, cin)
                 for k in range(3)]
            dinp = u[1] + _shift(u[0], 1) + _shift(u[2], -1)
            if layer == 0:
                dx += dinp
            else:
                dh = dinp.reshape(n, cin)
    return dx, dw0, dwc, dcb, dg, db, dwl, dbl


@pytest.fixture(scope="module")
def case():
    """Seeded numpy inputs and cotangent, and JAX's forward and gradients."""
    rng = np.random.default_rng(21)

    def draw(*shape, scale, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    a = (draw(B, T, C0, scale=1.0), draw(G, 3, C0, C, scale=(3 * C0) ** -.5),
         draw(L - 1, G, 3, C, C, scale=(3 * C) ** -.5),
         draw(G, L, C, scale=0.1), draw(G, L, C, scale=0.2, shift=1.0),
         draw(G, L, C, scale=0.1), draw(G, C, F, scale=C ** -.5),
         draw(G, 1, F, scale=0.1))
    cot = draw(G, B, T, F, scale=1.0)
    ja = tuple(jnp.asarray(v) for v in a)
    (out, mu, var), vjp = jax.vjp(decoder_train_xla_twin, *ja)
    grads = vjp((jnp.asarray(cot), jnp.zeros_like(mu), jnp.zeros_like(var)))
    ref = dict(out=np.asarray(out), mu=np.asarray(mu), var=np.asarray(var))
    return a, cot, ref, [np.asarray(gr) for gr in grads]


def _fwd_errors(case, passes):
    a, _, ref, _ = case
    out, _, mu, var = emulated_fwd(tuple(map(torch.from_numpy, a)), passes)
    got = dict(out=out, mu=mu, var=var)
    errs = {}
    for k, want in ref.items():
        assert got[k].shape == want.shape, k
        errs[k] = float(np.abs(got[k].numpy() - want).max()
                        / np.abs(want).max())
    return errs


def _grad_errors(case, passes):
    """{name: relative Frobenius error} of the gradients; dcb as |dcb| over
    max |dbeta| (JAX's own dcb is float noise around 0 too)."""
    a, cot, _, want = case
    ta = tuple(map(torch.from_numpy, a))
    _, cs, mu, var = emulated_fwd(ta, passes)
    got = emulated_bwd(torch.from_numpy(cot), ta, cs, mu, var, passes)
    errs = {}
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy().astype(np.float64)
        assert g.shape == w.shape, name
        if name == "dcb":
            errs[name] = float(np.abs(g).max() / np.abs(want[5]).max())
        else:
            w = w.astype(np.float64)
            errs[name] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    return errs


def test_tf32x3_forward_matches_jax_twin(case):
    errs = _fwd_errors(case, passes=3)
    assert max(errs.values()) <= FWD_TOL, errs


@pytest.mark.parametrize("name", NAMES)
def test_tf32x3_gradients_match_jax_vjp(case, name):
    err = _grad_errors(case, passes=3)[name]
    assert err <= GRAD_TOL, (name, err)


def test_single_tf32_pass_misses_the_kernel_tolerance(case):
    """One TF32 product keeps 11 bits of each operand: the forward lands
    far above 1e-5 of max |ref| and the gradients above 1e-4."""
    fwd = _fwd_errors(case, passes=1)
    grads = _grad_errors(case, passes=1)
    assert fwd["out"] > 10 * FWD_TOL, fwd
    worst = max(v for k, v in grads.items() if k != "dcb")
    assert worst > GRAD_TOL, grads
