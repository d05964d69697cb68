"""K1's f32 mode on the CPU: its six-product arithmetic against JAX, the
three-term split of the features, the activation image its B descriptors
read, and its shared-memory plan.

K1's f32 mode (``mixstage_tpu_torch/ops/cuda/csrc/fused_decoder_wgmma.cu``)
runs on the bf16 tensor cores.  Both operands are split into three bf16
terms that sum to them exactly (``split_bf16x3``): the weights once, by
``pack_decoder_bf16``; the features by the consumer threads, as they stage
the input and as each epilogue writes the next layer.  A product x·w is
taken as the six bf16 products x1w1 + (x1w2 + x2w1) + (x1w3 + x2w2 +
x3w1), small ones first, each exact in float32; the products of each
group of up to ``GROUP_CHUNKS`` 16-channel chunks sum into a zeroed
float32 partial that is added to the float32 accumulator.

Here, without the card:

* (a) that arithmetic, emulated through the folded decoder and the
  classifier chain at the serving widths, stays within 1e-5 of max |ref|
  of JAX's ``folded_decoder_xla``, with 64- and 16-channel partials;
* (b) one product, x1w1 (both operands rounded to bf16, what the tensor
  cores give without the splits), lands above the kernel's 1e-4: the
  mutant the card's limit must catch;
* (c) the three-term split is exact on the leaky outputs of a folded
  layer, and from 1e-30 to 1e4;
* (d) the three-term activation image, read through the B descriptor of
  each tap (one 16-byte row apart) and each term (one image apart), gives
  the operand the conv needs by direct indexing, zero rows outside
  [0, T) and C0 = 266 read as 272 included, at every width the plan picks;
* the source's constants, and its plan: the f32 mode rewrites one
  activation buffer in place and gives the ring the rest (down to 2
  stages), so it takes the card's serving shapes at the bf16 mode's tiles
  and every (C0, L) that the mma.sync kernel before it took at T = 64.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import GROUP_CHUNKS, emulated_decoder, terms
from mixstage_tpu.serve import folded_decoder_xla
from mixstage_tpu_torch.ops.cuda import fused_conv as fc
from mixstage_tpu_torch.ops.cuda.fused_conv import split_bf16x3

SOURCE = Path(fc.__file__).resolve().parent / "csrc" / "fused_decoder_wgmma.cu"
NEG_SLOPE = 0.2
STAGES, MIN_STAGES = 6, 2                   # kStages, kMinStages
WIDTHS = [16, 32, 48, 64, 72]               # kWidths: the wgmma N instances
MAX_TILE, WEIGHT_ROWS, BAR_BYTES = 64, 64, 128
H100 = dict(sms=132, smem=232448)
# name: (G, C0, C, L, F) -- the mixture decoder and the classifier chain
# of the flagship model (C0 = 256 channels + style_dim 10)
CHAINS = {"decoder": (2, 266, 256, 3, 96), "classifier": (1, 266, 256, 5, 8)}
B, T = 2, 16


def up(n, m):
    return -(-n // m) * m


def test_constants_match_the_source():
    src = SOURCE.read_text()
    for name, value in (("kStages", STAGES), ("kMinStages", MIN_STAGES),
                        ("kGroupChunks", GROUP_CHUNKS),
                        ("kMaxTile", MAX_TILE), ("kMaxN", WIDTHS[-1]),
                        ("kBarBytes", BAR_BYTES),
                        ("kWeightRows", WEIGHT_ROWS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    widths = re.search(r"constexpr int kWidths\[\] = \{(.*?)\};", src)
    assert widths.group(1).replace(" ", "") == "16,32,48,64,kMaxN"
    # one buffer rewritten in place in the f32 mode (3 terms), two in bf16
    assert "return terms == 1 ? 2 : 1;" in src
    # the old mma.sync K1 is gone: no TF32 helpers reach this source
    assert "tensor_core.cuh" not in src and "mma_tf32" not in src
    assert not (SOURCE.parent / "fused_decoder.cu").exists()


# ---------------------------------------------------------------------------
# (a), (b): the six-product arithmetic against JAX
# ---------------------------------------------------------------------------

def folded(seed, G, C0, C, L, F_):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        x=f32(rng.normal(size=(B, T, C0))),
        w0=f32(rng.normal(size=(G, 3, C0, C)) / np.sqrt(3 * C0)),
        wc=f32(rng.normal(size=(L, G, 3, C, C)) / np.sqrt(3 * C)),
        biases=f32(rng.normal(size=(G, L + 1, C)) * 0.1),
        w_logits=f32(rng.normal(size=(G, C, F_)) / np.sqrt(C)),
        b_logits=f32(rng.normal(size=(G, F_)) * 0.1))


@pytest.fixture(scope="module")
def chains():
    """{name: (numpy inputs, JAX's f32 reference)}, one JAX run each."""
    out = {}
    for i, (name, (G, C0, C, L, F_)) in enumerate(CHAINS.items()):
        a = folded(40 + i, G, C0, C, L, F_)
        fd = {k: jnp.asarray(v) for k, v in a.items() if k != "x"}
        ref = np.asarray(folded_decoder_xla(jnp.asarray(a["x"]),
                                            {**fd, "c0": C0}, G, NEG_SLOPE))
        out[name] = (a, ref)
    return out


def rel_err(chains, name, **kw):
    a, ref = chains[name]
    out = emulated_decoder({k: torch.from_numpy(v) for k, v in a.items()},
                           CHAINS[name][0], **kw).numpy()
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("group_chunks", [GROUP_CHUNKS, 1])
@pytest.mark.parametrize("name", list(CHAINS))
def test_six_products_match_jax_folded_decoder(chains, name, group_chunks):
    err = rel_err(chains, name, group_chunks=group_chunks)
    assert err <= 1e-5, err


@pytest.mark.parametrize("name", list(CHAINS))
def test_one_product_misses_the_kernel_tolerance(chains, name):
    err = rel_err(chains, name, products=[(0, 0)])
    assert err > 1e-4, err


# ---------------------------------------------------------------------------
# (c): the features' split
# ---------------------------------------------------------------------------

def assert_split_exact(v):
    t = split_bf16x3(v)
    assert all(x.dtype == torch.bfloat16 for x in t)
    assert torch.equal(sum(x.double() for x in t), v.double())


def test_split_is_exact_on_leaky_outputs_of_a_folded_layer():
    a = {k: torch.from_numpy(v) for k, v in folded(3, 1, 266, 256, 1,
                                                   8).items()}
    v = F.conv1d(a["x"].transpose(1, 2), a["w0"][0].permute(2, 1, 0),
                 a["biases"][0, 0], padding=1)
    h = F.leaky_relu(v, NEG_SLOPE).transpose(1, 2).contiguous()
    assert (h < 0).any() and (h > 0).any()
    assert_split_exact(h)


def test_split_is_exact_from_1e_30_to_1e4():
    rng = np.random.default_rng(1)
    mag = 10.0 ** rng.uniform(-30, 4, size=200_000)
    assert_split_exact(torch.from_numpy(
        (mag * rng.choice([-1, 1], size=mag.shape)).astype(np.float32)))


# ---------------------------------------------------------------------------
# the plan, and (d): the activation image and the B descriptors
# ---------------------------------------------------------------------------

def plan(terms_, T_, C0, C, L, F_, tile, smem=H100["smem"]):
    """(N, nrows, kp, stages, group) of a launch in the mode of ``terms_``
    bf16 terms a feature (3: f32, 1: bf16): fused_decoder_wgmma.cu's Plan;
    None when no instance covers the rows or the ring gets under 2 stages
    (the bf16 mode: under its fixed 6)."""
    rows = min(tile + 2 * L, T_)
    n = next((w for w in WIDTHS if rows <= w), None)
    if n is None:
        return None
    nrows = max(tile + 2 * (L + 1), L + 2 + n)
    kp, slot = up(max(C0, C), 16), 96 * up(max(C, F_), 64)
    fixed = BAR_BYTES + (2 if terms_ == 1 else 1) * terms_ * kp * nrows * 2
    if fixed + (STAGES if terms_ == 1 else MIN_STAGES) * slot > smem:
        return None
    stages = min(STAGES, (smem - fixed) // slot)
    return n, nrows, kp, stages, min(max(stages - 2, 1), GROUP_CHUNKS)


def pick_tile(terms_, B_, T_, C0, C, L, F_, G, sms=H100["sms"],
              smem=H100["smem"]):
    """launch_common.cuh::cost_tile with the plan's fit, in 8-row passes."""
    best, best_cost, tile = 0, 0, 8
    while tile <= MAX_TILE:
        if plan(terms_, T_, C0, C, L, F_, tile, smem) and not (
                tile > 8 and tile // 2 >= T_):
            rows = WEIGHT_ROWS + sum(up(tile + 2 * (L + 1 - l) - 2, 8)
                                     for l in range(L + 1))
            cost = -(-(G * B_ * -(-T_ // tile)) // sms) * rows
            if best == 0 or cost < best_cost:
                best, best_cost = tile, cost
        tile *= 2
    return best


def test_plan_at_the_card_shapes():
    """Both modes pick the same tiles at chip_smoke.py's K1 shapes; the f32
    mode's one in-place buffer leaves the ring 4 stages at the decoder's
    64-frame tiles (groups of 2 chunks), 5 or 6 at the classifier's."""
    for (b, t, g, L, F_), tile, f32, bf16 in [
            ((32, 64, 8, 3, 96), 64, (64, 72, 272, 4, 2), (64, 72, 272, 6, 4)),
            ((32, 64, 1, 5, 8), 16, (32, 39, 272, 6, 4), (32, 39, 272, 6, 4)),
            ((1, 64, 8, 3, 96), 8, (16, 21, 272, 6, 4), (16, 21, 272, 6, 4)),
            ((32, 128, 8, 3, 96), 64, (72, 77, 272, 4, 2),
             (72, 77, 272, 6, 4)),
            ((1, 4096, 1, 5, 8), 32, (48, 55, 272, 5, 3),
             (48, 55, 272, 6, 4))]:
        for terms_, want in ((3, f32), (1, bf16)):
            got = pick_tile(terms_, b, t, 266, 256, L, F_, g)
            assert got == tile, (terms_, b, t, L)
            assert plan(terms_, t, 266, 256, L, F_, got) == want, (terms_, b,
                                                                   t, L)


# The widest C0 (at L = 3) and the deepest L (at C0 = 266) that the
# mma.sync kernel before this one took at T = 64 (its tile function on an
# H100: tile + 2L <= 80 rows, two f32 activation buffers and a 2-stage
# ring of 32 f32 rows in 227 KB)
PARENT_WIDEST = [(1, 64, 2, 1280, 256, 3, 96), (1, 64, 1, 266, 256, 32, 8)]


def test_f32_mode_takes_what_the_mma_sync_kernel_took():
    from test_torch_port_cuda import EDGE_SHAPES
    for b, t, g, c0, c, L, F_ in EDGE_SHAPES + PARENT_WIDEST:
        tile = pick_tile(3, b, t, c0, c, L, F_, g)
        assert tile > 0, (c0, L)
        assert plan(3, t, c0, c, L, F_, tile)[3] >= MIN_STAGES
    # the ring shrinks to 2 stages (groups of 1 chunk) at both widest
    for b, t, g, c0, c, L, F_ in PARENT_WIDEST:
        assert plan(3, t, c0, c, L, F_, 8)[3:] == (2, 1), (c0, L)
    # its own limit at L = 3 lies wider: 1440 channels (three term images
    # of 21 rows and a 2-stage ring)
    assert pick_tile(3, 1, 64, 1440, 256, 3, 96, 2) == 8
    assert pick_tile(3, 1, 64, 1441, 256, 3, 96, 2) == 0


def read_b(buf, start, lbo, rows):
    """The (rows, 16) bf16 operand a no-swizzle K-major descriptor at
    element ``start`` (LBO ``lbo`` elements, SBO 128 bytes) reads from
    ``buf`` (bf16 elements): element (i, k) at start + (k / 8) lbo + (i / 8)
    64 + (i % 8) 8 + k % 8.  Every read stays inside ``buf``."""
    i, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    idx = start + (k // 8) * lbo + (i // 8) * 64 + (i % 8) * 8 + k % 8
    assert idx.min() >= 0 and idx.max() < buf.size
    return buf[idx]


@pytest.mark.parametrize("dims", [(266, 256, 96, 3), (266, 256, 8, 5),
                                  (37, 20, 7, 2), (5, 4, 3, 0)], ids=str)
def test_activation_image_and_descriptors_read_the_operands(dims):
    C0, C, F_, L = dims
    rng = np.random.default_rng(sum(dims))
    seen = set()
    for T_, tile in [(200, 8), (200, 16), (200, 32), (200, 64), (5, 8),
                     (20, 8), (30, 32), (40, 64), (64, 64), (70, 64),
                     (3, 64)]:
        p = plan(3, T_, C0, C, L, F_, tile)
        if p is None:
            continue
        n, nrows, kp, _, _ = p
        seen.add(n)
        term = kp * nrows
        halo = L + 1
        for t_first in {-halo, min(tile, max(T_ - tile, 0)) - halo}:
            nr = tile + 2 * halo
            v_lo, v_hi = max(0, -t_first), min(nr, T_ - t_first)
            for l in range(L + 2):
                logits = l == L + 1
                cin, taps = (C0 if l == 0 else C), (1 if logits else 3)
                # the features as the kernel stages them: three bf16 terms
                # of [channel / 8][row][8], zero outside [v_lo, v_hi) and
                # in the channels past cin
                act = np.zeros((nrows, kp), np.float32)
                act[v_lo:v_hi, :cin] = rng.normal(size=(v_hi - v_lo, cin))
                split = [t.numpy() for t in
                         terms(torch.from_numpy(act))]
                buf = np.zeros(3 * term, np.float32)
                r, m = np.meshgrid(np.arange(nrows), np.arange(kp),
                                   indexing="ij")
                for u in range(3):
                    buf[u * term + ((m >> 3) * nrows + r) * 8 + (m & 7)] = \
                        split[u]
                lo = max(halo, v_lo) if logits else max(l + 1, v_lo)
                x = np.zeros((nrows + 2, kp), np.float32)
                x[1:nrows + 1] = act             # x[r + 1] is row r
                for tap in range(taps):
                    for kc in range(-(-cin // 16)):
                        rows = lo - taps // 2 + tap + np.arange(n)
                        got = sum(read_b(buf, u * term
                                         + (lo - taps // 2 + tap) * 8
                                         + 2 * kc * nrows * 8, nrows * 8, n)
                                  .astype(np.float64) for u in range(3))
                        want = x[rows + 1, 16 * kc:16 * kc + 16]
                        assert np.array_equal(got, want), (l, tap, kc)
                        if 16 * kc + 16 > cin:     # C0 = 266 read as 272
                            assert not got[:, cin - 16 * kc:].any()
    # every width the plan picks at these shapes
    assert seen == {w for i, w in enumerate(WIDTHS)
                    if i == 0 or WIDTHS[i - 1] < MAX_TILE + 2 * L}, seen
