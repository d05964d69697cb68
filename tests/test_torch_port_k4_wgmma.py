"""K4's wgmma kernel on the CPU: its operand images and matrix descriptors,
its tile plan, and its sums against JAX.

K4 (``mixstage_tpu_torch/ops/cuda/csrc/decoder_int8.cu``) runs every layer
of the int8 decoder on ``wgmma`` m64nNk32 s8.  Both operands are K-major
without swizzle: a core matrix is 8 rows of 16 bytes (16 int8 along K).
The weights reach shared memory as the images ``quant.pack_image`` packs,
one chunk of 32 input channels of one tap per bulk copy, [2 halves][c_out
padded to 64][16 bytes]; a warpgroup's A is 64 of those lines.  A CTA's
activations are an image [channel / 16][row][16 bytes] of ``nrows`` rows
(zero outside the sequence: the 'same' padding); a tap is the B
descriptor moved by one 16-byte row.  The s32 sums are exact, so one
accumulator set serves a layer; the f32 epilogue rounds op by op.

Here, without the card:

* the constants above equal the source's, and the tile rule picks the
  tiles and widths the source's note names at the card's shapes;
* a model of the images and descriptors gives, for every layer,
  warpgroup, tap and 32-deep step, exactly the operand byte the
  convolution needs, by direct indexing (zero rows, padded input channels
  and padded output channels included), at C0 in {266, 37, 5}, C in
  {256, 20}, F in {96, 7}, L in {0, 3, 9} and every N the plan may pick;
* the kernel emulated from those images, CTA by CTA (int64 products, the
  f32 epilogue op for op), equals the port's plain version and JAX's
  ``decoder_int8_xla`` (the Pallas kernel's twin, same op order) in every
  element, on f32 and bf16 features in both quantization schemes; against
  JAX's Pallas K4 itself (interpret mode, op by op) every element equals
  either that or the same integer sums with the logits' multiply-add
  contracted into an FMA, which XLA's CPU pipeline does inside the
  interpreted kernel (up to 15 f32 ULPs of an element where the sum
  cancels; no requantized activation differs, or the logits would move by
  a whole weight);
* a kernel whose middle tap reads one row late is caught.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixstage_tpu.ops.pallas import quant as jquant
from mixstage_tpu_torch.ops.cuda import quant as tq

SOURCE = Path(tq.__file__).resolve().parent / "csrc" / "decoder_int8.cu"
CHUNK_K, STAGES, GROUP_CHUNKS = 32, 4, 4    # kChunkK, kStages, kGroupChunks
WIDTHS = [16, 24, 32, 48, 64, 80, 128]      # kWidths: the wgmma N instances
MAX_TILE, FIXED_ROWS = 64, 16               # kMaxTile, kFixedRows
BAR_BYTES = 2 * 8 * STAGES
H100 = dict(sms=132, smem=232448)
SLOPE = np.float32(0.2)


def up(n, m):
    return -(-n // m) * m


def test_constants_match_the_source():
    src = SOURCE.read_text()
    for name, value in (("kChunkK", CHUNK_K), ("kStages", STAGES),
                        ("kGroupChunks", GROUP_CHUNKS),
                        ("kMaxTile", MAX_TILE), ("kFixedRows", FIXED_ROWS)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    widths = re.search(r"constexpr int kWidths\[\] = \{(.*?)\};", src)
    assert [int(w) for w in widths.group(1).split(",")] == WIDTHS
    assert tq.CHUNK_K == CHUNK_K
    # the s8 wgmma of every instance exists, and the kernel includes none
    # of the mma.sync helpers
    hdr = (SOURCE.parent / "wgmma.cuh").read_text()
    for n in WIDTHS:
        assert f"m64n{n}k32.s32.s8.s8" in hdr, n
    assert "tensor_core.cuh" not in src and "mixstage::mma_s8" not in src


# ---------------------------------------------------------------------------
# the plan, the images and the descriptors
# ---------------------------------------------------------------------------

def plan(T, C0, C, L, F, tile, smem=H100["smem"]):
    """(N, nrows, kp0, kp1, shared bytes) of a launch: decoder_int8.cu's
    Plan (its ring of STAGES stages, down to 2 where the images need the
    room); N None when no instance covers the rows."""
    rows = min(tile + 2 * L, T)
    n = next((w for w in WIDTHS if rows <= w), None)
    if n is None:
        return None, 0, 0, 0, 0
    nrows = max(tile + 2 * (L + 1), L + 2 + n) | 1
    kp0, kp1 = up(max(C0, C), 32), up(C, 32)
    stage = GROUP_CHUNKS * CHUNK_K * up(max(C, F), 64)
    images = (kp0 + kp1) * nrows
    stages = STAGES
    while stages > 2 and BAR_BYTES + stages * stage + images > smem:
        stages -= 1
    return n, nrows, kp0, kp1, BAR_BYTES + stages * stage + images


def pick_tile(B, T, C0, C, L, F, G, sms=H100["sms"], smem=H100["smem"]):
    best, best_cost = 0, 0
    tile = 8
    while tile <= MAX_TILE:
        n, *_, nbytes = plan(T, C0, C, L, F, tile, smem)
        if not (tile > 8 and tile // 2 >= T) and n and nbytes <= smem:
            ctas = G * B * -(-T // tile)
            cost = -(-ctas // sms) * (FIXED_ROWS + n)
            if best == 0 or cost < best_cost:
                best, best_cost = tile, cost
        tile *= 2
    return best


def test_tile_rule_at_the_card_shapes():
    """The tiles and widths the source's note names (G = 8 decoder), and
    N never more than T."""
    shape = dict(C0=266, C=256, L=3, F=96, G=8)
    for (b, t), (tile, n) in {(32, 64): (64, 64), (1, 64): (8, 16),
                              (3, 50): (16, 24), (32, 128): (64, 80),
                              (1, 4096): (64, 80), (1, 1): (8, 16)}.items():
        got = pick_tile(b, t, **shape)
        assert (got, plan(t, 266, 256, 3, 96, got)[0]) == (tile, n), (b, t)
    # every card-test edge shape gets a tile (tests/test_torch_port_cuda.py),
    # and so do the widths the mma.sync kernel before this one took: C0 up
    # to 5,600 beside C = 256, and a chain of 60 layers (its 128 rows)
    from test_torch_port_cuda import EDGE_SHAPES
    for b, t, g, c0, c, layers, f in EDGE_SHAPES + [
            (1, 64, 1, 5600, 256, 3, 96), (1, 64, 1, 266, 256, 60, 96)]:
        assert pick_tile(b, t, c0, c, layers, f, g) > 0, (c0, layers)
    assert pick_tile(1, 200, 266, 256, 61, 96, 1) == 0    # 130 rows


def act_byte(m, r, nrows):
    """Byte of channel m, row r of an activation image (the source's)."""
    return ((m >> 4) * nrows + r) * 16 + (m & 15)


def read(buf, start, lbo, rows):
    """The (rows, 32) int8 operand a no-swizzle K-major descriptor at byte
    ``start`` (LBO ``lbo``, SBO 128) reads from ``buf``: element (i, k) at
    start + (k / 16) lbo + (i / 8) 128 + (i % 8) 16 + k % 16.  Every read
    stays inside ``buf``."""
    i, k = np.arange(rows)[:, None], np.arange(32)[None, :]
    idx = start + (k // 16) * lbo + (i // 8) * 128 + (i % 8) * 16 + k % 16
    assert idx.min() >= 0 and idx.max() < buf.size
    return buf[idx].astype(np.int64)


def layers(C0, C, L, F):
    """(cin, cout, taps) of layers 0 .. L + 1."""
    return [(C0 if l == 0 else C, F if l == L + 1 else C,
             1 if l == L + 1 else 3) for l in range(L + 2)]


def chunk(img, c, cout):
    """Chunk c of a layer's packed (taps, nk, 2, mp, 16) image as the bytes
    one bulk copy puts in a ring stage."""
    nbytes = CHUNK_K * up(cout, 64)
    flat = img.reshape(-1)
    return flat[c * nbytes:(c + 1) * nbytes]


@pytest.mark.parametrize("dims", [(266, 256, 96, 3), (266, 256, 96, 0),
                                  (37, 20, 7, 3), (5, 20, 96, 0),
                                  (37, 256, 7, 3), (5, 20, 7, 9)], ids=str)
def test_images_and_descriptors_read_the_operands(dims):
    C0, C, F, L = dims
    rng = np.random.default_rng(sum(dims))
    taps_w = [rng.integers(-127, 128, size=(taps, cin, cout), dtype=np.int8)
              for cin, cout, taps in layers(C0, C, L, F)]
    imgs = [tq.pack_image(torch.from_numpy(w)).numpy() for w in taps_w]
    seen = set()
    for T, tile in [(200, 8), (200, 16), (200, 32), (200, 64), (5, 8),
                    (20, 8), (20, 32), (30, 32), (40, 64), (60, 64),
                    (70, 64), (80, 64), (3, 64)]:
        n, nrows, kp0, kp1, _ = plan(T, C0, C, L, F, tile)
        if n is None:
            continue
        seen.add(n)
        halo = L + 1
        # the first tile of a sequence (t_first = -halo: zero rows before
        # it) and, where T allows, an inner one
        for t_first in {-halo, min(tile, max(T - tile, 0)) - halo}:
            nr = tile + 2 * halo
            v_lo, v_hi = max(0, -t_first), min(nr, T - t_first)
            for l, (cin, cout, taps) in enumerate(layers(C0, C, L, F)):
                kp = kp0 if l % 2 == 0 else kp1
                act = rng.integers(-127, 128, size=(nrows, cin),
                                   dtype=np.int8)
                act[:v_lo] = act[v_hi:] = 0
                buf = np.zeros(kp * nrows, np.int8)
                r, m = np.meshgrid(np.arange(nrows), np.arange(cin),
                                   indexing="ij")
                buf[act_byte(m, r, nrows)] = act
                logits = l == L + 1
                lo = max(halo, v_lo) if logits else max(l + 1, v_lo)
                nk, mp = -(-cin // 32), up(cout, 64)
                w = np.zeros((taps, nk * 32, mp), np.int64)
                w[:, :cin, :cout] = taps_w[l]
                x = np.zeros((nrows + 2, nk * 32), np.int64)
                x[1:nrows + 1, :cin] = act        # x[r + 1] is row r
                for tap in range(taps):
                    for kc in range(nk):
                        c = tap * nk + kc
                        bb = read(buf, (lo - taps // 2 + tap) * 16
                                  + 2 * kc * nrows * 16, nrows * 16, n)
                        rows = lo - taps // 2 + tap + np.arange(n)
                        assert np.array_equal(
                            bb, x[rows + 1, 32 * kc:32 * kc + 32]), (l, tap)
                        slot = chunk(imgs[l], c, cout)
                        for wg in range(4):
                            mb = wg if wg * 64 < mp else 0
                            aa = read(slot, mb * 64 * 16, mp * 16, 64)
                            assert np.array_equal(
                                aa, w[tap, 32 * kc:32 * kc + 32,
                                      64 * mb:64 * mb + 64].T), (l, tap, wg)
    # every width the plan may pick: layer 0 has at most 64 + 2L rows
    assert seen == {w for i, w in enumerate(WIDTHS)
                    if i == 0 or WIDTHS[i - 1] < MAX_TILE + 2 * L}, seen


# ---------------------------------------------------------------------------
# the kernel emulated from its images
# ---------------------------------------------------------------------------

def emulate(x, qfd, G, tile, tap_shift=0):
    """K4 on x (B, T, C0) f32 or bf16, CTA by CTA as the kernel runs it:
    the input image, per layer the wgmma sums of every (tap, chunk,
    warpgroup) read through the descriptors from the packed images (int64
    products), the f32 epilogue op for op into the other image, the logits
    to the output.  ``tap_shift`` moves the middle tap's B by that many
    rows (a fault).  Returns (out, logit sums)."""
    B, T, C0 = x.shape
    L, C, F = qfd["wc_i8"].shape[0], qfd["w0_i8"].shape[-1], \
        qfd["wl_i8"].shape[-1]
    q_in = tq.quantize_input(x, qfd["s_in"]).numpy()
    imgs = [tq.pack_image(qfd[k]).numpy()
            for k in ("w0_i8", "wc_i8", "wl_i8")]
    f32 = {k: qfd[k].numpy() for k in ("m0", "mc", "ml", "rq", "biases",
                                       "b_logits")}
    n, nrows, kp0, kp1, _ = plan(T, C0, C, L, F, tile)
    halo = L + 1
    nr = tile + 2 * halo
    out = np.zeros((B, T, G * F), np.float32)
    sums = np.zeros((B, T, G * F), np.int64)
    for g in range(G):
        for b in range(B):
            for bx in range(-(-T // tile)):
                t_first = bx * tile - halo
                v_lo, v_hi = max(0, -t_first), min(nr, T - t_first)
                bufs = [np.zeros(kp0 * nrows, np.int8),
                        np.zeros(kp1 * nrows, np.int8)]
                r, m = np.meshgrid(np.arange(v_lo, v_hi), np.arange(C0),
                                   indexing="ij")
                bufs[0][act_byte(m, r, nrows)] = q_in[b, t_first + r, m]
                for l, (cin, cout, taps) in enumerate(layers(C0, C, L, F)):
                    logits = l == L + 1
                    img = (imgs[0][g] if l == 0 else imgs[2][g] if logits
                           else imgs[1][l - 1, g])
                    lo = max(halo, v_lo) if logits else max(l + 1, v_lo)
                    hi = (min(halo + tile, v_hi) if logits
                          else min(nr - l - 1, v_hi))
                    src, dst = bufs[l % 2], bufs[(l + 1) % 2]
                    nk, mp = -(-cin // 32), up(cout, 64)
                    acc = np.zeros((mp, n), np.int64)
                    for tap in range(taps):
                        shift = tap_shift if tap == 1 else 0
                        for kc in range(nk):
                            bb = read(src, (lo - taps // 2 + tap + shift) * 16
                                      + 2 * kc * nrows * 16, nrows * 16, n)
                            slot = chunk(img, tap * nk + kc, cout)
                            for mb in range(mp // 64):
                                aa = read(slot, mb * 64 * 16, mp * 16, 64)
                                acc[64 * mb:64 * mb + 64] += aa @ bb.T
                    acc = acc[:cout, :hi - lo].T          # (rows, cout)
                    if logits:
                        y = acc.astype(np.float32) * f32["ml"][g]
                        rows = t_first + np.arange(lo, hi)
                        out[b, rows, g * F:(g + 1) * F] = \
                            y + f32["b_logits"][g]
                        sums[b, rows, g * F:(g + 1) * F] = acc
                        continue
                    mult = f32["m0"][g] if l == 0 else f32["mc"][l - 1, g]
                    y = acc.astype(np.float32) * mult + f32["biases"][g, l]
                    y = np.where(y >= 0, y, SLOPE * y)
                    q = np.clip(np.rint(y * f32["rq"][g, l]), -127, 127)
                    r, m = np.meshgrid(np.arange(lo, hi), np.arange(cout),
                                       indexing="ij")
                    dst[act_byte(m, r, nrows)] = q.astype(np.int8)
    return out, sums


B, T, G, C0, C, L, F = 2, 40, 2, 37, 20, 2, 7


@pytest.fixture(scope="module")
def case():
    """Seeded folded weights and f32 features at a small ragged shape."""
    rng = np.random.default_rng(7)

    def draw(*shape, scale):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    fd = dict(w0=draw(G, 3, C0, C, scale=(3 * C0) ** -.5),
              wc=draw(L, G, 3, C, C, scale=(3 * C) ** -.5),
              biases=draw(G, L + 1, C, scale=0.1),
              w_logits=draw(G, C, F, scale=C ** -.5),
              b_logits=draw(G, F, scale=0.1))
    return fd, draw(B, T, C0, scale=1.0)


def jax_pallas(x, qfd):
    """JAX's Pallas K4 in interpret mode, op by op (``jax.disable_jit``, as
    tests/test_torch_port_int8_bf16.py runs it), and its twin
    ``decoder_int8_xla``, on the same features and quantized weights."""
    s_in = qfd["s_in"]
    s_in = tuple(s_in.tolist()) if isinstance(s_in, torch.Tensor) else s_in
    jq = {k: v.numpy() for k, v in qfd.items() if k != "s_in"}
    jq["s_in"] = s_in
    xj = jnp.asarray(x.float().numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    with jax.disable_jit():
        pallas = np.asarray(jquant.fused_mixstage_decoder_int8(
            xj, *(jq[k] for k in ("w0_i8", "wc_i8", "m0", "mc", "rq",
                                  "biases", "wl_i8", "ml", "b_logits")),
            s_in=s_in, groups=G, interpret=True))
        xla = np.asarray(jquant.decoder_int8_xla(xj, jq, G))
    return pallas, xla


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_equals_plain_and_jax(case, dtype, per_channel):
    fd, x32 = case
    x = x32.to(dtype)
    qfd = tq.quantize_folded_decoder(fd, x, per_channel=per_channel)
    plain = tq.decoder_int8_plain(x, qfd, G).numpy()
    pallas, xla = jax_pallas(x, qfd)
    assert np.array_equal(plain, xla)
    for tile in (8, 16, pick_tile(B, T, C0, C, L, F, G)):
        out, sums = emulate(x, qfd, G, tile)
        assert np.array_equal(out, plain), tile
    # JAX's Pallas kernel: the same integer sums, its logits rounded op by
    # op or through one FMA (f64 holds the exact product of an integer
    # below 2^24 and an f32 multiplier)
    ml = np.concatenate([qfd["ml"][g].numpy() for g in range(G)])
    bl = np.concatenate([qfd["b_logits"][g].numpy() for g in range(G)])
    fma = (sums * ml.astype(np.float64) + bl).astype(np.float32)
    ok = (pallas == out) | (pallas == fma)
    print(f"K4 emulated ({dtype}, per_channel={per_channel}) vs JAX's "
          f"Pallas K4: {int((pallas != out).sum())} of {out.size} elements "
          f"differ, all of them its FMA rounding: {bool(ok.all())}")
    assert ok.all()


def test_a_middle_tap_one_row_late_is_caught(case):
    fd, x = case
    qfd = tq.quantize_folded_decoder(fd, x)
    plain = tq.decoder_int8_plain(x, qfd, G).numpy()
    out, _ = emulate(x, qfd, G, 16, tap_shift=1)
    assert (out != plain).mean() > 0.5
