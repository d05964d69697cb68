"""K3's f32 mode on the CPU: its six-product arithmetic against JAX, the
three-term split, the three-term operand images its descriptors read, and
its shared-memory plan.

K3's f32 mode (``mixstage_tpu_torch/ops/cuda/csrc/train_gemm_bf16.cuh``
with ``kTerms`` 3, driven by ``csrc/train_decoder.cu``) runs every GEMM
pass of the training decoder's forward and backward on the bf16 tensor
cores.  Every operand element is split into three bf16 terms that sum to
it exactly (``split_bf16x3``): x, dout and the weights by ``pack_kernel``,
the activations h and dc by the column passes that write their images.  A
product a·w is taken as the six bf16 products a1w1 + (a1w2 + a2w1) +
(a1w3 + a2w2 + a3w1), small ones first, each exact in float32; each
chunk's products (``KC_CONV`` reduced channels by every tap, or ``KC_DW``
padded rows of a weight gradient) sum into a zeroed float32 partial added
to the float32 accumulator; a weight gradient's padded rows may be split
into ranges whose partials are added in split order, and layer 0's dx is
summed over the groups in group order.

Here, without the card:

* (a) that arithmetic, emulated through every GEMM pass of K3 in the
  kernel's order, at a small ragged width, holds the forward (out, mu,
  var) within 1e-5 of max |ref| of JAX's ``decoder_train_xla_twin`` and
  every gradient of its ``jax.vjp`` within 1e-4 relative Frobenius (dcb,
  0 analytically under train BN, below 1e-4 of max |dbeta|): the card's
  limits;
* (b) one product, a1w1 (both operands rounded to bf16, what the tensor
  cores give without the splits), misses those limits;
* (c) the three-term split is exact on the BN-leaky outputs of a layer,
  and from 1e-30 to 1e4;
* (d) the source's constants (the f32 mode's chunk depths, six products
  in the plan's cost), the mma.sync route gone, the plan's stages fitting
  the shared-memory budget with two stages or more at every tile and
  operand shape, and the three-term images read through each term's
  descriptors at every width of ``K3_SHAPES``
  (``test_torch_port_k3_bf16_wgmma.py``'s image model with ``terms`` 3),
  the activation operands' 5-D tensor copies (all channel groups and
  terms of a chunk in one copy) writing at the kernel's coordinates what
  per-group, per-term copies would.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixstage_tpu.ops.pallas.train_decoder import decoder_train_xla_twin
from mixstage_tpu_torch.ops.cuda import train_decoder as ttd
from mixstage_tpu_torch.ops.cuda.fused_conv import split_bf16x3
from test_torch_port_cuda import K3_SHAPES
from test_torch_port_k3_bf16_wgmma import (KC_F32, TILES, TILES_ALL_TAPS,
                                           bn_leaky, check_passes, geometry,
                                           shift)

CSRC = Path(ttd.__file__).resolve().parent / "csrc"
KC_CONV, KC_DW = KC_F32["conv"], KC_F32["dW"]
SMEM_BUDGET, BAR_BYTES, MAX_STAGES = 232448, 256, 8
L = 4
G, C0, C, F, B, T = 2, 37, 64, 16, 2, 16
FWD_TOL = 1e-5               # max |emulated - ref| / max |ref|
GRAD_TOL = 1e-4              # relative Frobenius error per gradient
NAMES = ("dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl")
# the products (i, j) of a_i w_j the kernel issues, small ones first
SIX = [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
ONE = [(0, 0)]


# ---------------------------------------------------------------------------
# (a), (b): the six-product arithmetic against JAX
# ---------------------------------------------------------------------------

def terms(v):
    """The three bf16 terms of ``v`` as float32 (exact)."""
    return [t.float() for t in split_bf16x3(v)]


def prod(a, w, products):
    """a @ w as one chunk's products: each (i, j) of ``products`` the exact
    float32 product of a's term i and w's term j, summed in that order into
    a zeroed partial."""
    at, wt = terms(a), terms(w)
    part = torch.zeros(a.shape[0], w.shape[1])
    for i, j in products:
        part = part + at[i] @ wt[j]
    return part


def conv_gemm(a, w, sign, products):
    """sum_k shift(a, sign (k - 1)) @ w[k] (one tap: a @ w[0]) as the
    kernel sums it: per chunk of KC_CONV reduced channels, every tap's
    products into a zeroed partial, added in chunk order.  a (B, T, K), w
    (taps, K, N)."""
    taps, K, _ = w.shape
    xs = [shift(a, sign * (k - 1)) if taps == 3 else a for k in range(taps)]
    acc = None
    for c0 in range(0, K, KC_CONV):
        cs = slice(c0, c0 + KC_CONV)
        x = torch.cat([v[..., cs] for v in xs], -1)
        part = prod(x.reshape(-1, x.shape[-1]),
                    torch.cat([w[k, cs] for k in range(taps)], 0), products)
        acc = part if acc is None else acc + part
    return acc


def dw_gemm(a, d, taps, splits, products):
    """dW[k] = shift(a, k - 1)^T @ d over the frames, as the kernel sums
    it: per chunk of KC_DW padded rows into a zeroed partial, the chunks of
    each of ``splits`` ranges in order, then the splits in order."""
    Bn, Tn, J = a.shape
    rows = 1 + Bn * (Tn + 1)
    p = 1 + np.arange(Bn)[:, None] * (Tn + 1) + np.arange(Tn)[None, :]
    chunk = torch.from_numpy((p // KC_DW).reshape(-1))
    nch = -(-rows // KC_DW)
    per = -(-nch // splits)
    outs = []
    for k in range(taps):
        ak = (shift(a, k - 1) if taps == 3 else a).reshape(-1, J)
        dk = d.reshape(-1, d.shape[-1])
        total = None
        for s in range(splits):
            acc = torch.zeros(J, dk.shape[-1])
            for c in range(s * per, min(nch, (s + 1) * per)):
                sel = chunk == c
                acc = acc + prod(ak[sel].T.contiguous(), dk[sel], products)
            total = acc if total is None else total + acc
        outs.append(total)
    return torch.stack(outs)


def emulated_fwd(a, products):
    """K3-fwd's f32 mode with the GEMM's sums: (out, cs, mu, var)."""
    x, w0, wc, cb, gamma, beta, wl, bl = a
    outs, css, mus, vrs = [], [], [], []
    for g in range(w0.shape[0]):
        h, cg, mg, vg = x, [], [], []
        for layer in range(L):
            w = w0[g] if layer == 0 else wc[layer - 1, g]
            cf = conv_gemm(h, w, 1, products) + cb[g, layer]
            mu = cf.mean(0)
            var = (cf * cf).mean(0) - mu * mu
            h = bn_leaky(cf, mu, var, gamma[g, layer], beta[g, layer])[2]
            h = h.reshape(B, T, -1)
            cg.append(cf.reshape(B, T, -1))
            mg.append(mu)
            vg.append(var)
        out = conv_gemm(h, wl[g][None], 1, products) + bl[g]
        outs.append(out.reshape(B, T, -1))
        css.append(torch.stack(cg))
        mus.append(torch.stack(mg))
        vrs.append(torch.stack(vg))
    return (torch.stack(outs), torch.stack(css, 1), torch.stack(mus),
            torch.stack(vrs))


def emulated_bwd(dout, a, cs, mu, var, splits, products):
    """K3-bwd's f32 mode with the GEMM's sums: the head, then each layer's
    BN backward, dW (split-K) and d(input); dx over the groups in order."""
    x, w0, wc, _, gamma, beta, wl, _ = a
    n = B * T
    dx = torch.zeros(x.shape)
    dw0, dwc = torch.empty(w0.shape), torch.empty(wc.shape)
    dcb, dg, db = (torch.empty(gamma.shape) for _ in range(3))
    dwl, dbl = torch.empty(wl.shape), torch.empty(G, 1, F)

    def act(g, layer):
        return bn_leaky(cs[layer, g].reshape(n, C), mu[g, layer],
                        var[g, layer], gamma[g, layer], beta[g, layer])

    for g in range(G):
        do = dout[g]                                        # (B, T, F)
        h3 = act(g, L - 1)[2].reshape(B, T, C)
        dwl[g] = dw_gemm(h3, do, 1, splits, products)[0]
        dbl[g, 0] = do.reshape(n, -1).sum(0)
        dh = conv_gemm(do, wl[g].T[None].contiguous(), -1, products)
        for layer in range(L - 1, -1, -1):
            inv = torch.rsqrt(var[g, layer] + 1e-5)
            xhat, pre, _ = act(g, layer)
            dpre = torch.where(pre >= 0, dh, 0.2 * dh)
            dg[g, layer] = (dpre * xhat).sum(0)
            db[g, layer] = dpre.sum(0)
            dxhat = dpre * gamma[g, layer]
            dc = inv * (dxhat - dxhat.mean(0) - xhat * (dxhat * xhat).mean(0))
            dcb[g, layer] = dc.sum(0)
            dc = dc.reshape(B, T, C)
            if layer == 0:
                inp, w = x, w0[g]
            else:
                inp = act(g, layer - 1)[2].reshape(B, T, C)
                w = wc[layer - 1, g]
            dw = dw_gemm(inp, dc, 3, splits, products)
            if layer == 0:
                dw0[g] = dw
            else:
                dwc[layer - 1, g] = dw
            dinp = conv_gemm(dc, w.transpose(1, 2).contiguous(), -1, products)
            if layer == 0:
                dx += dinp.reshape(x.shape)
            else:
                dh = dinp
    return dx, dw0, dwc, dcb, dg, db, dwl, dbl


@pytest.fixture(scope="module")
def case():
    """Seeded numpy inputs and cotangent, and JAX's forward and gradients."""
    rng = np.random.default_rng(12)

    def draw(*shape, scale, shift_=0.0):
        return (rng.normal(size=shape) * scale + shift_).astype(np.float32)

    a = (draw(B, T, C0, scale=1.0), draw(G, 3, C0, C, scale=(3 * C0) ** -.5),
         draw(L - 1, G, 3, C, C, scale=(3 * C) ** -.5),
         draw(G, L, C, scale=0.1), draw(G, L, C, scale=0.2, shift_=1.0),
         draw(G, L, C, scale=0.1), draw(G, C, F, scale=C ** -.5),
         draw(G, 1, F, scale=0.1))
    cot = draw(G, B, T, F, scale=1.0)
    ja = tuple(jnp.asarray(v) for v in a)
    (out, mu, var), vjp = jax.vjp(decoder_train_xla_twin, *ja)
    grads = vjp((jnp.asarray(cot), jnp.zeros_like(mu), jnp.zeros_like(var)))
    ref = dict(out=np.asarray(out), mu=np.asarray(mu), var=np.asarray(var))
    return a, cot, ref, [np.asarray(gr) for gr in grads]


def fwd_errors(case, products):
    a, _, ref, _ = case
    out, _, mu, var = emulated_fwd(tuple(map(torch.from_numpy, a)), products)
    got = dict(out=out, mu=mu, var=var)
    errs = {}
    for k, want in ref.items():
        assert got[k].shape == want.shape, k
        errs[k] = float(np.abs(got[k].numpy() - want).max()
                        / np.abs(want).max())
    return errs


def grad_errors(case, splits, products):
    """{name: relative Frobenius error}; dcb as |dcb| over max |dbeta|."""
    a, cot, _, want = case
    ta = tuple(map(torch.from_numpy, a))
    _, cs, mu, var = emulated_fwd(ta, products)
    got = emulated_bwd(torch.from_numpy(cot), ta, cs, mu, var, splits,
                       products)
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


def test_six_products_forward_matches_jax_twin(case):
    errs = fwd_errors(case, SIX)
    assert max(errs.values()) <= FWD_TOL, errs


@pytest.mark.parametrize("splits", [1, 2])
def test_six_products_gradients_match_jax_vjp(case, splits):
    errs = grad_errors(case, splits, SIX)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_one_product_misses_the_kernel_tolerance(case):
    """a1w1 alone keeps 8 bits of each operand: the forward lands far above
    1e-5 of max |ref| and the gradients above 1e-4."""
    fwd = fwd_errors(case, ONE)
    grads = grad_errors(case, 1, ONE)
    assert fwd["out"] > 10 * FWD_TOL, fwd
    worst = max(v for k, v in grads.items() if k != "dcb")
    assert worst > GRAD_TOL, grads


# ---------------------------------------------------------------------------
# (c): the split
# ---------------------------------------------------------------------------

def assert_split_exact(v):
    t = split_bf16x3(v)
    assert all(x.dtype == torch.bfloat16 for x in t)
    assert torch.equal(sum(x.double() for x in t), v.double())


def test_split_is_exact_on_bn_leaky_outputs(case):
    a = tuple(map(torch.from_numpy, case[0]))
    _, cs, mu, var = ttd.decoder_train_fwd_plain(*a)
    gamma, beta = a[4], a[5]
    for layer in range(L):
        h = bn_leaky(cs[layer, 0].reshape(B * T, C), mu[0, layer],
                     var[0, layer], gamma[0, layer], beta[0, layer])[2]
        assert (h < 0).any() and (h > 0).any()
        assert_split_exact(h)


def test_split_is_exact_from_1e_30_to_1e4():
    rng = np.random.default_rng(2)
    mag = 10.0 ** rng.uniform(-30, 4, size=200_000)
    assert_split_exact(torch.from_numpy(
        (mag * rng.choice([-1, 1], size=mag.shape)).astype(np.float32)))


# ---------------------------------------------------------------------------
# (d): the source, the plan, the images
# ---------------------------------------------------------------------------

def test_constants_match_the_source():
    src = (CSRC / "train_gemm_bf16.cuh").read_text()
    m = re.search(r"constexpr int kKCConvF32 = (\d+), kKCDWF32 = (\d+);", src)
    assert m and (int(m.group(1)), int(m.group(2))) == (KC_CONV, KC_DW)
    tiles = re.search(r"kTilesAllTaps\[\]\[2\] = \{(.*?)\};", src).group(1)
    assert [tuple(map(int, t)) for t in
            re.findall(r"\{(\d+), (\d+)\}", tiles)] == TILES_ALL_TAPS
    for name, value in (("kSmemBudget", SMEM_BUDGET),
                        ("kBarBytes", BAR_BYTES), ("kMaxStages", MAX_STAGES)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    # the plan's cost counts six bf16 products a multiply-add
    assert "kProducts = kTerms == 1 ? 1 : 6;" in src
    # the f32 mode runs the wgmma GEMM: the mma.sync route is gone
    k3 = (CSRC / "train_decoder.cu").read_text()
    assert "wgmma_pass<k3::kConv, E, kT>" in k3
    for gone in ("gemm_kernel<kMode, BM, BN>", "mma_tf32", "cp_async",
                 "tensor_core.cuh", "pick_tile"):
        assert gone not in k3 and gone not in src, gone
    assert not (CSRC / "tensor_core.cuh").exists()


@pytest.mark.parametrize("mode", ["conv", "convT", "dW"])
def test_stages_fit_the_budget_at_every_tile(mode):
    """Tile<mode, kWM, kN, 3>: every tile's slot of three term images of A
    and of B leaves two stages or more in the budget (dW: its tiles that
    hold every tap's accumulator, three of 64 x kN a warpgroup, within
    three wgmma accumulators' registers)."""
    for wm, kn in (TILES_ALL_TAPS if mode == "dW" else TILES):
        if mode == "dW":
            assert 3 * kn // 2 + 2 * kn // 2 <= 160, kn
        g = geometry(mode, wm, kn, terms=3)
        stages = min((SMEM_BUDGET - BAR_BYTES) // g["Slot"], MAX_STAGES)
        assert stages >= 2, (mode, wm, kn, stages)
        assert BAR_BYTES + stages * g["Slot"] <= SMEM_BUDGET
        # the f32 mode's chunk holds 3x the bytes of a bf16 chunk of the
        # same depth for 6x the products
        one = geometry(mode, wm, kn)
        assert g["Slot"] * one["KC"] >= 2.9 * one["Slot"] * g["KC"]


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_three_term_images_and_descriptors_read_the_operands(shape):
    check_passes(shape, 3)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_variant_edits_apply_to_the_source(mode):
    """``tools/k3_variants.py`` builds one-edit copies of the source: every
    edit of every variant applies exactly once to today's source."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / "k3_variants.py"
    spec = importlib.util.spec_from_file_location("k3_variants", path)
    kv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kv)
    for name in kv.variants(mode):
        texts = kv.variant_sources(name, mode)
        changed = [f for f, t in texts.items() if t != (CSRC / f).read_text()]
        assert bool(changed) == (name != "kernel"), name
