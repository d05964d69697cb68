"""K3's bf16 wgmma GEMM on the CPU: its operand images and matrix
descriptors, and its summation order against JAX.

K3's bf16 mode (``mixstage_tpu_torch/ops/cuda/csrc/train_gemm_bf16.cuh``)
runs every GEMM pass of the training decoder on ``wgmma``.  Frames are kept
in padded rows (p = 1 + b (T + 1) + t, a zero row before each sequence);
every operand lives in global memory as an image [channel / 8][row][8]
(activations) or [tap][chunk][...] (weights), zero-padded, so that a
chunk's operands reach the ring in a few bulk copies; wgmma reads them
K-major or MN-major through no-swizzle descriptors, and a tap is the same
image read one line (16 bytes) further on.  Each chunk's products
(``KC_CONV`` reduced channels by every tap, or ``KC_DW`` padded rows of the
weight gradient) sum into a zeroed f32 partial added to the accumulator;
the weight gradient's padded rows may be split in up to ``MAX_SPLIT_K``
ranges whose partials are added in split order.

Here, without the card:

* the constants above equal the source's;
* a model of the global images (which operand element each line holds,
  zero rows and padded channels included), of the kernel's bulk copies of
  a chunk into the ring, and of its descriptors gives, for every
  warpgroup, tap and 16-deep step, exactly the operand element the GEMM
  needs, by direct indexing, at every width of ``K3_SHAPES`` and in every
  tile the plan may pick; with ``terms`` 3 the same model covers the f32
  mode's three term images of each operand (its own chunk depths, each
  term one image further on in global memory and in the slot), tested in
  ``test_torch_port_k3_f32_wgmma.py``;
* the kernel's summation order emulated in plain PyTorch (exact bf16
  products, f32 chunk partials, split partials in order), forward and
  backward, follows JAX's Pallas K3 at ``dtype=bfloat16`` (interpret mode,
  compiled with ``jax_nominal``) by the bf16 rule, and its forward stays
  within one bf16 ULP of the port's plain version;
* a copy that skips the rounding of the conv's sum before the bias add
  differs from the plain version in more elements than the card tests
  allow (the bf16 rule alone passes it).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import as_np, bf16_rule, bf16_values, jax_nominal
from mixstage_tpu.ops.pallas import train_decoder as jtd
from mixstage_tpu_torch.ops.cuda import train_decoder as ttd
from test_torch_port_cuda import K3_SHAPES

SOURCE = (Path(ttd.__file__).resolve().parent / "csrc"
          / "train_gemm_bf16.cuh")
KC_CONV, KC_DW = 64, 128     # reduction depth of a chunk (kKCConv, kKCDW)
KC_F32 = {"conv": 16, "dW": 32}  # the f32 mode's (kKCConvF32, kKCDWF32)
# the f32 mode's dW tiles, every tap's accumulator a CTA (kTilesAllTaps)
TILES_ALL_TAPS = [(2, 64), (1, 64), (1, 48), (2, 48)]
MAX_SPLIT_K = 4               # the kernel's kMaxSplitK
TILES = [(2, 128), (1, 128), (1, 96), (1, 48)]   # (kWM, kN): kTiles
EPS, SLOPE, L = 1e-5, 0.2, 4
# a decoder whose GEMMs take several chunks: C0 and C off the 32-channel
# chunks, and 1 + B (T + 1) = 83 padded rows, two 64-row chunks of dW
B, T, G, C0, C, F = 2, 40, 2, 40, 48, 12
NAMES = ("dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl")


def test_constants_match_the_source():
    src = SOURCE.read_text()
    m = re.search(r"constexpr int kKCConv = (\d+), kKCDW = (\d+);", src)
    assert m and (int(m.group(1)), int(m.group(2))) == (KC_CONV, KC_DW)
    m = re.search(r"constexpr int kMaxSplitK = (\d+);", src)
    assert m and int(m.group(1)) == MAX_SPLIT_K
    tiles = re.search(r"kTiles\[\]\[2\] = \{(.*?)\};", src).group(1)
    assert [tuple(map(int, t)) for t in
            re.findall(r"\{(\d+), (\d+)\}", tiles)] == TILES
    for name, value in (("kRowAlign", ROW_ALIGN), ("kColAlign", COL_ALIGN)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name


# ---------------------------------------------------------------------------
# the images and descriptors
# ---------------------------------------------------------------------------

ROW_ALIGN, COL_ALIGN = 128, 128      # the source's kRowAlign, kColAlign


def up(n, m):
    return -(-n // m) * m


def frame_of(p, T_, B_):
    """The frame of padded row p, or -1 for a zero row (vectorized)."""
    q = np.asarray(p) - 1
    b, t = np.divmod(np.maximum(q, 0), T_ + 1)
    return np.where((q >= 0) & (t < T_) & (b < B_), b * T_ + t, -1)


def act_image(C_, Bn, Tn):
    """The global activation image of a (frames x C_) matrix, each element
    recorded as its source index frame * C_ + channel, -1 for a zero:
    [channel / 8][image row q = padded row + 1][8]."""
    rows = up(1 + Bn * (Tn + 1), ROW_ALIGN) + 2
    ch = np.arange(up(C_, COL_ALIGN)).reshape(-1, 1, 8)
    f = frame_of(np.arange(rows) - 1, Tn, Bn)[None, :, None]
    return np.where((f >= 0) & (ch < C_), f * C_ + ch, -1), rows


def conv_image(taps, K, N, kc=KC_CONV):
    """kConv weights w (taps, K, N): [tap][chunk][n / 8][kc][8]."""
    nc, ng = -(-K // kc), up(N, COL_ALIGN) // 8
    k = np.arange(taps)[:, None, None, None, None]
    row = (np.arange(nc)[None, :, None, None, None] * kc
           + np.arange(kc)[None, None, None, :, None])
    col = (8 * np.arange(ng)[None, None, :, None, None]
           + np.arange(8)[None, None, None, None, :])
    return np.where((row < K) & (col < N), (k * K + row) * N + col, -1)


def convt_image(taps, J, K, kc=KC_CONV):
    """kConvT weights w (taps, J, K): [tap][chunk][k / 8][J rows][8]."""
    nc, jr = -(-K // kc), up(J, COL_ALIGN)
    k = np.arange(taps)[:, None, None, None, None]
    col = (np.arange(nc)[None, :, None, None, None] * kc
           + 8 * np.arange(kc // 8)[None, None, :, None, None]
           + np.arange(8)[None, None, None, None, :])
    j = np.arange(jr)[None, None, None, :, None]
    return np.where((j < J) & (col < K), (k * J + j) * K + col, -1)


def geometry(mode, wm, kn, terms=1):
    """The kernel's Tile<mode, wm, kn, terms> (bytes)."""
    dw = mode == "dW"
    kc = (KC_DW if dw else KC_CONV) if terms == 1 else \
        KC_F32["dW" if dw else "conv"]
    g = dict(BM=64 * wm, BN=kn * (2 // wm), KC=kc)
    g["ARows"] = g["KC"] + 2 if dw else g["BM"] + 2
    g["AGroups"] = g["BM"] // 8 if dw else g["KC"] // 8
    g["AGroupBytes"] = g["ARows"] * 16
    g["ABytes"] = g["AGroups"] * g["AGroupBytes"]
    g["BRows"] = g["BN"] if mode == "convT" else g["KC"]
    g["BGroups"] = g["KC"] // 8 if mode == "convT" else g["BN"] // 8
    g["BGroupBytes"] = g["BRows"] * 16
    g["BTapBytes"] = g["BGroups"] * g["BGroupBytes"]
    g["BTermBytes"] = (1 if dw else 3) * g["BTapBytes"]
    g["Slot"] = up(terms * (g["ABytes"] + g["BTermBytes"]), 128)
    return g


def copy(slot, dst, image, start, nbytes):
    """A bulk copy of nbytes from element ``start`` of a flat image."""
    n = nbytes // 2
    slot[dst // 2:dst // 2 + n] = image.reshape(-1)[start:start + n]


def read(img, addr, lbo, sbo, mn, k, mn_major):
    """Elements (mn, k) of a no-swizzle wgmma operand at ``addr``."""
    if mn_major:
        off = addr + (mn // 8) * sbo + (k % 8) * 16 + (k // 8) * lbo + \
            (mn % 8) * 2
    else:
        off = addr + (mn // 8) * sbo + (mn % 8) * 16 + (k // 8) * lbo + \
            (k % 8) * 2
    return img[off // 2]


def term_image(img, u, terms):
    """Term u of an image whose elements are source indices: index * terms
    + u (-1 stays a zero)."""
    return np.where(img >= 0, img * terms + u, -1)


def check_tile(mode, wm, kn, Bn, Tn, K, N, taps, m_tile, n_tile, chunk,
               terms=1):
    """One chunk of one CTA tile: the kernel's bulk copies from the global
    images (chunk_copy; with ``terms`` 3, each term's from its own image
    into its place in the slot), then every element its two consumer
    warpgroups read through their descriptors, for every tap, 16-deep step
    and term, against the operand by direct indexing (source indices
    index * terms + term; -1 = zero)."""
    g = geometry(mode, wm, kn, terms)
    m0, n0 = m_tile * g["BM"], n_tile * g["BN"]
    sign = -1 if mode == "convT" else 1
    slot = np.full(g["Slot"] // 2, -2, np.int64)
    c, kc = chunk, g["KC"]
    for u in range(terms):
        abase = u * g["ABytes"]
        bbase = terms * g["ABytes"] + u * g["BTermBytes"]
        if mode == "dW":  # a: frames x K (M: K's channels), d: frames x N
            a_img, rows = act_image(K, Bn, Tn)
            d_img, _ = act_image(N, Bn, Tn)
            a_img, d_img = (term_image(v, u, terms) for v in (a_img, d_img))
            for i in range(g["AGroups"]):
                copy(slot, abase + i * g["AGroupBytes"], a_img,
                     ((m0 // 8 + i) * rows + c * kc) * 8, g["AGroupBytes"])
            for j in range(g["BGroups"]):
                copy(slot, bbase + j * g["BGroupBytes"], d_img,
                     ((n0 // 8 + j) * rows + c * kc + 1) * 8,
                     g["BGroupBytes"])
            continue
        a_img, rows = act_image(K, Bn, Tn)
        a_img = term_image(a_img, u, terms)
        for i in range(g["AGroups"]):
            copy(slot, abase + i * g["AGroupBytes"], a_img,
                 ((c * kc // 8 + i) * rows + m0) * 8, g["AGroupBytes"])
        if mode == "conv":
            w_img = conv_image(taps, K, N, kc)
            wt = term_image(w_img, u, terms)
            for k in range(taps):
                copy(slot, bbase + k * g["BTapBytes"], wt,
                     (((k * w_img.shape[1] + c) * w_img.shape[2] + n0 // 8)
                      * kc) * 8, g["BTapBytes"])
        else:
            w_img = convt_image(taps, N, K, kc)
            wt = term_image(w_img, u, terms)
            for k in range(taps):
                for cg in range(g["BGroups"]):
                    copy(slot, bbase + k * g["BTapBytes"]
                         + cg * g["BGroupBytes"], wt,
                         (((k * w_img.shape[1] + c) * g["BGroups"] + cg)
                          * w_img.shape[3] + n0) * 8, g["BGroupBytes"])
    if terms == 3:
        check_tensor_copies(slot, g, mode, Bn, Tn, K, N, m0, n0, c)
    for u in range(terms):
        check_reads(slot, g, mode, wm, kn, Bn, Tn, K, N, taps, m0, n0, c,
                    sign, u, terms)


def tensor_box(img, coords, box):
    """The box of the f32 mode's 5-D tensor copy (dims {8, rows, channel
    groups, terms, groups}, dimension 0 fastest) of the term images of
    ``img`` (one group) at ``coords``, zero outside, flattened as the copy
    writes it to shared memory."""
    dense = np.stack([term_image(img, u, 3) for u in range(3)])[None]
    out = np.full(tuple(reversed(box)), -1, np.int64)
    lo = list(reversed(coords))
    src = dense[tuple(slice(a, a + b) for a, b in zip(lo, reversed(box)))]
    out[tuple(slice(0, n) for n in src.shape)] = src
    return out.reshape(-1)


def check_tensor_copies(slot, g, mode, Bn, Tn, K, N, m0, n0, c):
    """The f32 mode copies A (and kDW's B) with one tensor copy each, at
    the kernel's coordinates: it writes the slot the per-group, per-term
    bulk copies of the model wrote."""
    kc, na = g["KC"], 3 * g["ABytes"] // 2
    if mode == "dW":
        a_img, _ = act_image(K, Bn, Tn)
        d_img, _ = act_image(N, Bn, Tn)
        got = tensor_box(a_img, (0, c * kc, m0 // 8, 0, 0),
                         (8, kc + 2, g["BM"] // 8, 3, 1))
        assert (got == slot[:na]).all(), ("A", mode)
        got = tensor_box(d_img, (0, c * kc + 1, n0 // 8, 0, 0),
                         (8, kc, g["BN"] // 8, 3, 1))
        assert (got == slot[na:na + 3 * g["BTermBytes"] // 2]).all(), "B"
    else:
        a_img, _ = act_image(K, Bn, Tn)
        got = tensor_box(a_img, (0, m0, c * kc // 8, 0, 0),
                         (8, g["BM"] + 2, kc // 8, 3, 1))
        assert (got == slot[:na]).all(), ("A", mode)


def check_reads(slot, g, mode, wm, kn, Bn, Tn, K, N, taps, m0, n0, c, sign,
                u, terms):
    """The elements both consumer warpgroups read through the descriptors
    of term u (A at u image sizes on, B at terms A images and u B images
    on) against the operand by direct indexing."""
    mn = np.arange(64)[:, None]
    kk16 = np.arange(16)[None, :]
    tb = mode != "convT"                      # B MN-major

    def enc(want):                            # term u of a source index
        return np.where(want >= 0, want * terms + u, -1)

    for wg in range(2):
        wmi, wni = (wg, 0) if wm == 2 else (0, wg)
        for k in range(taps):
            for kk in range(g["KC"] // 16):
                a0 = u * g["ABytes"]
                if mode == "dW":
                    rowoff = k if taps == 3 else 1
                    a = read(slot, a0 + 8 * wmi * g["AGroupBytes"]
                             + (rowoff + 16 * kk) * 16, 128,
                             g["AGroupBytes"], mn, kk16, True)
                    j = m0 + 64 * wmi + mn
                    f = frame_of(c * g["KC"] + 16 * kk + kk16
                                 + (k - 1 if taps == 3 else 0), Tn, Bn)
                    want = np.where((f >= 0) & (j < K), f * K + j, -1)
                    ok = j < K                # rows past M: discarded
                else:
                    shift = sign * (k - 1) if taps == 3 else 0
                    a = read(slot, a0 + (64 * wmi + 1 + shift) * 16
                             + kk * 2 * g["AGroupBytes"],
                             g["AGroupBytes"], 128, mn, kk16, False)
                    f = frame_of(m0 + 64 * wmi + mn + shift, Tn, Bn)
                    cc = c * g["KC"] + 16 * kk + kk16
                    want = np.where((f >= 0) & (cc < K), f * K + cc, -1)
                    ok = np.ones_like(want, bool)
                want = enc(want)
                assert (a == want)[np.broadcast_to(ok, want.shape)].all(), (
                    mode, wg, k, kk, u)
                nn = np.arange(kn)[:, None]
                n = n0 + wni * kn + nn
                base = terms * g["ABytes"] + u * g["BTermBytes"] + (
                    0 if mode == "dW" else k * g["BTapBytes"])
                if tb:
                    bv = read(slot, base + wni * (kn // 8) * g["BGroupBytes"]
                              + 16 * kk * 16, 128, g["BGroupBytes"], nn,
                              kk16, True)
                else:
                    bv = read(slot, base + wni * kn * 16
                              + kk * 2 * g["BGroupBytes"],
                              g["BGroupBytes"], 128, nn, kk16, False)
                cc = c * g["KC"] + 16 * kk + kk16
                if mode == "dW":
                    f = frame_of(cc, Tn, Bn)
                    want = np.where((f >= 0) & (n < N), f * N + n, -1)
                elif mode == "conv":
                    want = np.where((cc < K) & (n < N),
                                    (k * K + cc) * N + n, -1)
                else:
                    want = np.where((cc < K) & (n < N),
                                    (k * N + n) * K + cc, -1)
                want = enc(want)
                ok = np.broadcast_to(n < N, want.shape)  # columns past N
                assert (bv == want)[ok].all(), (mode, wg, k, kk, u, "B")


def check_passes(shape, terms):
    """check_tile for every GEMM pass of K3 at ``shape``, every tile the
    plan may pick, and the first and last (tile, chunk) of each."""
    Bn, Tn, _, c0, c, f = shape
    rows = 1 + Bn * (Tn + 1)
    # (mode, K: reduced width or dW's row channels, N, taps) of every pass
    passes = [("conv", c0, c, 3), ("conv", c, c, 3), ("conv", c, f, 1),
              ("convT", c, c0, 3), ("convT", c, c, 3), ("convT", f, c, 1),
              ("dW", c0, c, 3), ("dW", c, c, 3), ("dW", c, f, 1)]
    for mode, K, N, taps in passes:
        tiles = TILES_ALL_TAPS if mode == "dW" and terms == 3 else TILES
        for wm, kn in tiles:
            g = geometry(mode, wm, kn, terms)
            if up(N, g["BN"]) > up(N, COL_ALIGN):   # the plan skips it
                continue
            if mode == "dW":
                mt, nchunks = -(-K // g["BM"]), -(-rows // g["KC"])
            else:
                mt, nchunks = -(-rows // g["BM"]), -(-K // g["KC"])
            nt = -(-N // g["BN"])
            for m_tile, n_tile, chunk in {(0, 0, 0), (mt - 1, nt - 1,
                                                      nchunks - 1)}:
                check_tile(mode, wm, kn, Bn, Tn, K, N, taps, m_tile, n_tile,
                           chunk, terms)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_images_and_descriptors_read_the_operands(shape):
    check_passes(shape, 1)


# ---------------------------------------------------------------------------
# the kernel's summation order, emulated
# ---------------------------------------------------------------------------

def shift(a, s):
    """(B, T, C): out[:, t] = a[:, t + s], zero past each sequence's end."""
    if s == 0:
        return a
    z = torch.zeros_like(a[:, :1])
    return torch.cat([a[:, 1:], z], 1) if s > 0 else \
        torch.cat([z, a[:, :-1]], 1)


def conv_gemm(a, w, sign):
    """sum_k shift(a, sign (k - 1)) @ w[k] (one tap: a @ w[0]) as the
    kernel sums it: per chunk of KC_CONV reduced channels, every tap's
    exact bf16 products into a zeroed f32 partial, added in chunk order.
    a (B, T, K) and w (taps, K, N) hold bf16 values in float32."""
    taps, K, _ = w.shape
    xs = [shift(a, sign * (k - 1)) if taps == 3 else a for k in range(taps)]
    acc = None
    for c0 in range(0, K, KC_CONV):
        cs = slice(c0, c0 + KC_CONV)
        x = torch.cat([v[..., cs] for v in xs], -1)
        x = x.reshape(-1, x.shape[-1])
        wk = torch.cat([w[k, cs] for k in range(taps)], 0)
        part = x @ wk
        acc = part if acc is None else acc + part
    return acc


def dw_gemm(a, d, taps, splits):
    """dW[k] = shift(a, k - 1)^T @ d over the frames, as the kernel sums it:
    per chunk of KC_DW padded rows into a zeroed partial, the chunks of
    each of ``splits`` ranges in order, then the splits in order.  a (B, T,
    J), d (B, T, N)."""
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
                acc = acc + ak[sel].T @ dk[sel]
            total = acc if total is None else total + acc
        outs.append(total)
    return torch.stack(outs)


def bn_leaky(cf, mu, var, gamma, beta):
    xhat = (cf - mu) * torch.rsqrt(var + EPS)
    pre = xhat * gamma + beta
    return xhat, pre, torch.where(pre >= 0, pre, SLOPE * pre)


def emulated_fwd(a16, round_before_bias=True):
    """K3-fwd's bf16 mode with the wgmma GEMM's sums: (out, cs, mu, var)."""
    x, w0, wc, cb, gamma, beta, wl, bl = (t.float() for t in a16)
    Bn, Tn, _ = x.shape
    outs, css, mus, vrs = [], [], [], []
    for g in range(w0.shape[0]):
        h, cg, mg, vg = x, [], [], []
        for layer in range(L):
            w = w0[g] if layer == 0 else wc[layer - 1, g]
            acc = conv_gemm(h, w, 1)
            if round_before_bias:
                acc = acc.bfloat16().float()
            c = (acc + cb[g, layer]).bfloat16()
            cf = c.float()
            mu = cf.mean(0)
            var = (cf * cf).mean(0) - mu * mu
            h = bn_leaky(cf, mu, var, gamma[g, layer], beta[g, layer])[2]
            h = h.bfloat16().float().reshape(Bn, Tn, -1)
            cg.append(c.reshape(Bn, Tn, -1))
            mg.append(mu)
            vg.append(var)
        out = conv_gemm(h, wl[g][None], 1) + bl[g]
        outs.append(out.bfloat16().reshape(Bn, Tn, -1))
        css.append(torch.stack(cg))
        mus.append(torch.stack(mg))
        vrs.append(torch.stack(vg))
    return (torch.stack(outs), torch.stack(css, 1), torch.stack(mus),
            torch.stack(vrs))


def emulated_bwd(dout16, x16, cs16, mu, var, w0, wc, gamma, beta, wl,
                 splits):
    """K3-bwd's bf16 mode with the wgmma GEMM's sums; all float32."""
    x, cs, w0, wc, gamma, beta, wl = (t.float() for t in (x16, cs16, w0, wc,
                                                         gamma, beta, wl))
    Bn, Tn, _ = x.shape
    Gn, Cn, n = w0.shape[0], w0.shape[-1], Bn * Tn
    dx = torch.zeros(x.shape)
    dw0, dwc = torch.empty(w0.shape), torch.empty(wc.shape)
    dcb, dg, db = (torch.empty(gamma.shape) for _ in range(3))
    dwl, dbl = torch.empty(wl.shape), torch.empty(Gn, 1, wl.shape[-1])

    def act(g, layer):
        return bn_leaky(cs[layer, g].reshape(n, Cn), mu[g, layer],
                        var[g, layer], gamma[g, layer], beta[g, layer])

    for g in range(Gn):
        do = dout16[g].float()                               # (B, T, F)
        h3 = act(g, L - 1)[2].bfloat16().float().reshape(Bn, Tn, Cn)
        dwl[g] = dw_gemm(h3, do, 1, splits)[0]
        dbl[g, 0] = do.reshape(n, -1).sum(0)
        dh = conv_gemm(do, wl[g].T[None], -1)
        for layer in range(L - 1, -1, -1):
            inv = torch.rsqrt(var[g, layer] + EPS)
            xhat, pre, _ = act(g, layer)
            dpre = torch.where(pre >= 0, dh, SLOPE * dh)
            dg[g, layer] = (dpre * xhat).sum(0)
            db[g, layer] = dpre.sum(0)
            dxhat = dpre * gamma[g, layer]
            dc = inv * (dxhat - dxhat.mean(0) - xhat * (dxhat * xhat).mean(0))
            dcb[g, layer] = dc.sum(0)
            dc = dc.bfloat16().float().reshape(Bn, Tn, Cn)
            if layer == 0:
                inp, w = x, w0[g]
            else:
                inp = act(g, layer - 1)[2].bfloat16().float()
                inp, w = inp.reshape(Bn, Tn, Cn), wc[layer - 1, g]
            dw = dw_gemm(inp, dc, 3, splits)
            if layer == 0:
                dw0[g] = dw
            else:
                dwc[layer - 1, g] = dw
            dinp = conv_gemm(dc, w.transpose(1, 2), -1)
            if layer == 0:
                dx += dinp.reshape(x.shape)
            else:
                dh = dinp
    return dx, dw0, dwc, dcb, dg, db, dwl, dbl


@pytest.fixture(scope="module")
def case():
    """bf16-valued inputs, JAX's Pallas K3 at bf16 (forward and backward,
    interpret mode, compiled once each) and the float32 truth."""
    rng = np.random.default_rng(9)

    def draw(*shape, scale, shift_=0.0):
        return bf16_values((rng.normal(size=shape) * scale + shift_)
                           .astype(np.float32))

    a = (draw(B, T, C0, scale=1.0), draw(G, 3, C0, C, scale=(3 * C0) ** -.5),
         draw(L - 1, G, 3, C, C, scale=(3 * C) ** -.5),
         draw(G, L, C, scale=0.1), draw(G, L, C, scale=0.2, shift_=1.0),
         draw(G, L, C, scale=0.1), draw(G, C, F, scale=C ** -.5),
         draw(G, 1, F, scale=0.1))
    dout = draw(G, B, T, F, scale=1.0)
    j16 = [jnp.asarray(v, jnp.bfloat16) for v in a]
    fwd = jax_nominal(lambda *v: jtd._fwd_call(*v, interpret=True), *j16)
    out, cs, mu, var = fwd
    gb = jnp.concatenate([j16[4], j16[5]], axis=1)
    bwd = jax_nominal(lambda *v: jtd._bwd_call(*v, interpret=True),
                      jnp.asarray(dout, jnp.bfloat16), j16[0], cs, mu, var,
                      j16[1], j16[2], gb, j16[6])
    a16 = tuple(torch.from_numpy(v).bfloat16() for v in a)
    a32 = tuple(torch.from_numpy(v) for v in a)
    truth = ttd.decoder_train_fwd_plain(*a32)
    return dict(a16=a16, a32=a32, dout=torch.from_numpy(dout).bfloat16(),
                jax_fwd=[as_np(v) for v in fwd],
                jax_bwd=[as_np(v) for v in bwd], truth=truth)


def _bwd_truth(case):
    x, w0, wc, _, gamma, beta, wl, _ = case["a32"]
    return ttd.decoder_train_bwd_plain(case["dout"].float(), x,
                                       *case["truth"][1:], w0, wc, gamma,
                                       beta, wl)


def test_emulated_forward_follows_pallas_bf16(case):
    got = emulated_fwd(case["a16"])
    for name, p, q, r in zip(("out", "cs", "mu", "var"), got,
                             case["jax_fwd"], case["truth"]):
        dp, dq, ok = bf16_rule(as_np(p), q, as_np(r))
        assert ok, (name, dp, dq)


def test_emulated_forward_within_one_ulp_of_plain(case):
    got = emulated_fwd(case["a16"])
    ref = ttd.decoder_train_fwd_plain(*case["a16"])
    for name, p, q in zip(("out", "cs"), got, ref):
        top = float(q.float().abs().max())
        ulp = 2.0 ** (np.frexp(top)[1] - 8)
        err = float((p.float() - q.float()).abs().max())
        assert err <= ulp, (name, err / ulp)


@pytest.mark.parametrize("splits", [1, 2])
def test_emulated_backward_follows_pallas_bf16(case, splits):
    x, w0, wc, _, gamma, beta, wl, _ = case["a16"]
    _, cs, mu, var = ttd.decoder_train_fwd_plain(*case["a16"])
    got = emulated_bwd(case["dout"], x, cs, mu, var, w0, wc, gamma, beta,
                       wl, splits)
    true = _bwd_truth(case)
    jax_g = case["jax_bwd"]
    for name, p, q, r in zip(NAMES, got, jax_g, true):
        if name == "dcb":              # 0 analytically: float noise
            bound = 1e-4 * float(np.abs(jax_g[5]).max())
            assert float(p.abs().max()) < bound, name
            continue
        dp, dq, ok = bf16_rule(as_np(p), q, as_np(r), frobenius=True)
        assert ok, (name, dp, dq)


def test_skipping_the_rounding_before_the_bias_is_caught(case):
    """A copy that adds the bias to the unrounded f32 sum rounds once where
    K3 rounds twice.  Its drifts stay inside the bf16 rule's 1e-3 floor at
    this size (cs 3.15e-3 against JAX's 3.94e-3), so the card tests also
    hold out and cs to a share of elements differing from the plain
    version (``test_torch_port_cuda.K3_BF16_SHARE``): the kernel's sums
    stay inside the limits, the copy's differ in far more."""
    from test_torch_port_cuda import K3_BF16_SHARE

    ref = ttd.decoder_train_fwd_plain(*case["a16"])
    good = emulated_fwd(case["a16"])
    bad = emulated_fwd(case["a16"], round_before_bias=False)
    for name, p, q, r in zip(("out", "cs"), bad, ref, good):
        share = float((r.float() != q.float()).float().mean())
        assert share <= K3_BF16_SHARE[name], (name, share)
        share = float((p.float() != q.float()).float().mean())
        assert share > K3_BF16_SHARE[name], (name, share)
