"""The CUDA kernels against their plain PyTorch versions ON THE CARD.

K1 at edge shapes the serving path does not reach (several time tiles with
halos, T not a multiple of the tile, odd widths, no chain layer, one
frame), at every time tile, at the widest C0 and the deepest chain that
its ``mma.sync`` parent took, its time-tile rule, and the serving path.
Tolerance: max |kernel - plain| ≤ 1e-4 · max |plain| (K1's f32 mode: six
bf16 products of three-term splits of both operands, f32 accumulation
order).
K3's forward and backward (``wgmma`` GEMM passes on three-term bf16
splits of both operands, six products a multiply-add) at shapes that cross
its tiles' edges and at widths beyond the main path's, their launch
counters, their repeating bit for bit (also at the main path's shape), the
checks of ``DecoderTrain``, and one fused G step.  K4 (the
int8 decoder) at the same edge shapes in both quantization schemes, equal
to its plain version in every element, its refusal of unpacked weights,
and the int8 serving tier (one K1 and one K4 launch per call); K2 (the
grouped conv chain, the chain mode of K1's kernel) at edge shapes and at
``chip_smoke.py``'s K2 shapes, to 1e-4, on weights packed once equal bit
for bit to weights packed per call, its tile rule and its refusals.  The
built K1, K2, K3 and K4 run on the tensor cores (their SASS holds HGMMA and
IGMMA instructions; K2's no FFMA).  K1's decoder mode equals, in both
modes, the kernel of the version before the chain mode joined it bit for
bit where that source lies in ``build/parent_wgmma/``.

The bf16 modes of K1 and K3 against their plain versions, under the bf16
rule (``bf16_rule`` below): no bf16 output is held element-wise to
another, since two valid bf16 roundings of one computation differ about as
much as either differs from the float32 truth; instead each output's drift
from the truth (the same function in float32 on the same inputs) must match
the plain version's drift to 10% (+1e-3).  K1's bf16 mode (``wgmma`` on
weights split into three bf16 terms) must also stay within one bf16 ULP
of max |plain| with at most a fifth of its elements differing (45% for
chains of more than three hidden layers), at every edge shape and every
time tile its launch takes, and equal the kernel of the version before it
bit for bit where that source lies in ``build/parent/``; its SASS holds
BF16 HGMMA.  Both wrappers
refuse other dtype pairs, and a bf16 serving call and a fused bf16 G
step launch the bf16 modes; the bf16 and int8-bf16 serving calls at full
width launch K1-bf16 on weights packed when the serving function was
built.  K3's bf16 mode (``wgmma`` GEMM passes) also holds out and cs
within one bf16 ULP of max |plain| and to ``K3_BF16_SHARE`` of elements
differing, repeats bit for bit, and its SASS holds BF16 HGMMA.  K4's
bf16-feature mode equals its plain version in every element
(a bf16 feature widens to float32 exactly; the rest is the f32 mode), at
one 64-frame clip and a ragged B=3 T=50 of the flagship widths and at the
edge shapes; K2's bf16 mode follows its plain version under the bf16 rule,
within one bf16 ULP and in at most a fifth of its elements.

These need a CUDA device and skip without one.  This file imports neither
JAX nor the JAX package, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA "
                    "kernels with no CPU mode (their plain versions are "
                    "tested on the CPU)")
    from mixstage_tpu_torch import resolve_device
    return resolve_device("cuda")


def _folded(B, T, G, C0, C, L, F, device, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    return (draw(B, T, C0, scale=1.0), draw(G, 3, C0, C, scale=(3 * C0) ** -.5),
            draw(L, G, 3, C, C, scale=(3 * C) ** -.5),
            draw(G, L + 1, C, scale=0.1), draw(G, C, F, scale=C ** -.5),
            draw(G, F, scale=0.1))


# (B, T, G, C0, C, L, F)
EDGE_SHAPES = [
    (2, 64, 8, 266, 256, 3, 96),     # the decoder, small batch (tile 8)
    (3, 200, 3, 37, 20, 2, 7),       # T not a multiple of any tile
    (1, 1, 2, 5, 4, 1, 3),           # one frame
    (4, 96, 2, 16, 8, 0, 5),         # no chain layer
    (2, 130, 1, 266, 256, 5, 8),     # the classifier chain, ragged T
]


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_kernel_matches_plain_on_card(cuda, shape):
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        fused_mixstage_decoder, fused_mixstage_decoder_plain)

    B, T, G, C0, C, L, F = shape
    a = _folded(B, T, G, C0, C, L, F, cuda)
    before = fused_mixstage_decoder.launches
    out = fused_mixstage_decoder(*a, groups=G)
    ref = fused_mixstage_decoder_plain(*a, groups=G)
    torch.cuda.synchronize()
    assert fused_mixstage_decoder.launches == before + 1
    assert out.shape == (B, T, G * F)
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-4, err


def test_tile_frames_fills_the_card_and_fits_shared_memory(cuda):
    """K1's tile rule in the f32 mode (``launch_common.cuh::cost_tile``) on
    an H100: the tile with the fewest estimated row-passes (weight
    streaming plus 8-row passes over the frames and halo) times waves of
    CTAs, among those whose three-term activation image and a ring of at
    least 2 stages fit shared memory."""
    from mixstage_tpu_torch.ops.cuda.fused_conv import tile_frames

    h100 = dict(sm_count=132, smem_limit=232448)
    # decoder bs32 T=64: 256 CTAs of 64 frames are two waves on 132 SMs;
    # 32-frame tiles would be four waves of CTAs that cost more than half
    assert tile_frames(32, 64, 266, 256, 3, 96, 8, **h100) == 64
    # classifier chain bs32 T=64, one group: 32- and 64-frame tiles leave
    # 68 and 100 SMs idle, 8-frame ones take two waves; 16 frames run 128
    # CTAs in one
    assert tile_frames(32, 64, 266, 256, 5, 8, 1, **h100) == 16
    # one 64-frame clip through the decoder: 64 CTAs of 8 frames, one wave
    assert tile_frames(1, 64, 266, 256, 3, 96, 8, **h100) == 8
    # not even the 8-frame tile fits shared memory
    assert tile_frames(1, 64, 4096, 4096, 3, 8, 1, **h100) == 0


def test_kernels_run_on_tensor_cores(cuda):
    """Every instance of K1's ``decoder_kernel`` holds BF16 HGMMA
    instructions (wgmma) and no HMMA, in its f32 mode (terms 3) as in its
    bf16 mode (terms 1), in the decoder mode as in K2's chain mode, whose
    instances hold no FFMA either (the FFMA chain is gone); every
    instance of K4's ``decoder_int8_kernel`` s8 IGMMA ones (wgmma) and no
    IMMA (mma.sync) or ``__dp4a`` (IDP.4A), and K3's GEMM passes in both
    modes (every instance of ``wgmma_gemm_kernel``, terms 3 and 1) BF16
    HGMMA ones, no HMMA and no FFMA (the ``mma.sync`` route is gone), read
    from their SASS with ``cuobjdump`` (it ships beside ``nvcc``)."""
    import subprocess
    from pathlib import Path

    from mixstage_tpu_torch.ops.cuda import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    assert set(build.SOURCES) == {"fused_decoder_wgmma", "decoder_int8",
                                  "train_decoder"}
    sass = {}
    for name in build.SOURCES:
        build.load_library(name)
        sass[name] = subprocess.run(
            [tool, "-sass", str(build.library_path(name))], check=True,
            capture_output=True, text=True).stdout
    # one section per function, each opened by a "Function : <name>" line;
    # decoder_kernel<N, terms, chain> mangles its terms and its chain flag
    # as "Li3ELb0EE" (f32 decoder), "Li1ELb1EE" (bf16 chain), ...
    k1 = [f for f in sass["fused_decoder_wgmma"].split("Function : ")[1:]
          if "decoder_kernel" in f.splitlines()[0]]
    assert len(k1) == 20, len(k1)
    for terms in ("Li3E", "Li1E"):
        for chain in ("Lb0E", "Lb1E"):
            mode = [f for f in k1 if terms + chain + "E" in f.splitlines()[0]]
            assert len(mode) == 5, (terms, chain, len(mode))  # one per width
            for body in mode:
                hgmma = [ln for ln in body.splitlines() if "HGMMA" in ln]
                assert hgmma and all("BF16" in ln for ln in hgmma), hgmma[:3]
                if chain == "Lb1E":
                    assert "FFMA" not in body, body.splitlines()[0]
    assert " HMMA" not in sass["fused_decoder_wgmma"]
    k4 = [f for f in sass["decoder_int8"].split("Function : ")[1:]
          if "decoder_int8_kernel" in f.splitlines()[0]]
    assert len(k4) == 7, len(k4)          # one per wgmma width N
    for body in k4:
        igmma = [ln for ln in body.splitlines() if "IGMMA" in ln]
        assert igmma and all("S8" in ln for ln in igmma), igmma[:3]
    assert "IMMA" not in sass["decoder_int8"]
    assert "IDP.4A" not in sass["decoder_int8"]
    # one section per function, each opened by a "Function : <name>" line;
    # wgmma_gemm_kernel<mode, kWM, kN, O, terms> mangles its terms last,
    # before its return type: "Li3EEEv" or "Li1EEEv"
    functions = sass["train_decoder"].split("Function : ")[1:]
    assert not [f for f in functions if "gemm_kernel" in f.splitlines()[0]
                and "wgmma_gemm_kernel" not in f.splitlines()[0]]
    assert " HMMA" not in sass["train_decoder"]
    wgmmas = [f for f in functions
              if "wgmma_gemm_kernel" in f.splitlines()[0]]
    for terms in ("Li3EEEv", "Li1EEEv"):
        # 3 operand shapes x 4 tiles a mode
        mode = [f for f in wgmmas if terms in f.splitlines()[0]]
        assert len(mode) == 12, (terms, len(mode))
        for body in mode:
            hgmma = [ln for ln in body.splitlines() if "HGMMA" in ln]
            assert hgmma and all("BF16" in ln for ln in hgmma), hgmma[:3]
            assert "FFMA" not in body, body.splitlines()[0]


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_decoder_kernel_at_every_tile(cuda, shape):
    """K1's f32 mode launched directly at every time tile (the rule picks
    one), each through the kernel instance its rows need and the ring its
    shared memory leaves, held like the wrapper's launch; a packed operand
    of the wrong size is refused."""
    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc

    B, T, G, C0, C, L, F = shape
    x, w0, wc, biases, wl, bl = _folded(B, T, G, C0, C, L, F, cuda)
    lib = fc.bind_decoder(build.load_library("fused_decoder_wgmma"))
    gstride = fc.packed_elems(C0, C, L, F)
    packed = fc.pack_decoder_bf16(dict(w0=w0, wc=wc, w_logits=wl))
    ref = fc.fused_mixstage_decoder_plain(x, w0, wc, biases, wl, bl, G)

    def launch(tile, size=gstride):
        out = torch.empty(B, T, G * F, device=cuda)
        err = lib.mixstage_fused_decoder_f32(
            x.data_ptr(), packed.data_ptr(), biases.data_ptr(),
            bl.data_ptr(), out.data_ptr(), B, T, C0, C, L, F, G, 0.2, tile,
            size, torch.cuda.current_stream().cuda_stream)
        return err, out

    for tile in (8, 16, 32, 64):
        err, out = launch(tile)
        if err:              # the tile's rows are wider than every instance
            assert min(tile + 2 * L, T) > 72, (tile, err)
            continue
        torch.cuda.synchronize()
        rel = float((out - ref).abs().max()) / float(ref.abs().max())
        assert rel <= 1e-4, (tile, rel)
    assert launch(0, gstride + 8)[0] != 0


# (B, T, G, C0, C, L, F): the widest C0 (at L = 3) and the deepest chain
# (at C0 = 266) that K1's mma.sync f32 kernel before the wgmma mode took at
# T = 64 (its tile function on an H100: tools/profile_k1.py --parent); the
# f32 mode takes them with a 2-stage ring
K1_PARENT_WIDEST = [(1, 64, 2, 1280, 256, 3, 96), (1, 64, 1, 266, 256, 32, 8)]


@pytest.mark.parametrize("shape", K1_PARENT_WIDEST, ids=str)
def test_kernel_at_the_parents_widest_on_card(cuda, shape):
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        fused_mixstage_decoder, fused_mixstage_decoder_plain)

    B, T, G, C0, C, L, F = shape
    a = _folded(B, T, G, C0, C, L, F, cuda)
    out = fused_mixstage_decoder(*a, groups=G)
    ref = fused_mixstage_decoder_plain(*a, groups=G)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-4, err


def test_kernel_rejects_what_it_cannot_take(cuda):
    from mixstage_tpu_torch.ops.cuda.fused_conv import fused_mixstage_decoder

    a = _folded(2, 16, 2, 11, 8, 1, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        fused_mixstage_decoder(a[0].double(), *a[1:], groups=2)
    with pytest.raises(ValueError, match="is on"):
        fused_mixstage_decoder(a[0], a[1].cpu(), *a[2:], groups=2)
    wide = _folded(1, 8, 1, 3000, 3000, 1, 4, cuda)   # 288 KB a CTA
    with pytest.raises(RuntimeError, match="none fits shared memory"):
        fused_mixstage_decoder(*wide, groups=1)


def test_serving_path_on_card_within_drift_contract(cuda):
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_
    from mixstage_tpu_torch.ops.cuda.fused_conv import fused_mixstage_decoder
    from mixstage_tpu_torch.serve import build_serving_fn

    model = JointLateClusterSoftStyle4_G(num_clusters=4, num_speakers=3,
                                         in_channels=64)
    reset_parameters_(model, torch.Generator().manual_seed(1),
                      random_bn_stats=True)
    audio = torch.randn(3, 128, 64, generator=torch.Generator().manual_seed(2))
    serve = build_serving_fn(model)
    before = fused_mixstage_decoder.launches
    pose = serve(audio, [0, 1, 2])
    assert fused_mixstage_decoder.launches == before + 2
    ref = build_serving_fn(model, use_kernel=False)(audio, [0, 1, 2])
    rel = float((pose - ref).abs().mean() / ref.abs().mean())
    assert pose.is_cuda and rel <= 0.01, rel


# ---------------------------------------------------------------------------
# K3: the training decoder's forward and backward kernels
# ---------------------------------------------------------------------------

def _train_args(B, T, G, C0, C, F, device, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(device)

    return (draw(B, T, C0, scale=1.0), draw(G, 3, C0, C, scale=(3 * C0) ** -.5),
            draw(3, G, 3, C, C, scale=(3 * C) ** -.5),
            draw(G, 4, C, scale=0.1), draw(G, 4, C, scale=0.2, shift=1.0),
            draw(G, 4, C, scale=0.1), draw(G, C, F, scale=C ** -.5),
            draw(G, 1, F, scale=0.1))


def _rel_fro(a, b):
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


# (B, T, G, C0, C, F): a small decoder, a ragged one (T and every width
# off the 64-wide tiles) that checks the sequence ends, and shapes that
# cross the GEMM tiles' edges: padded rows off every M tile (35, 154, 143,
# 139, 11), C0 and C off a multiple of 8 (a zero-padded channel group in the
# images: C0 = 29 and 266, C = 44 and 20), C over one 128-wide tile (136),
# F below one 8-wide channel group, and T = 1, where both outer taps leave
# the sequence
K3_SHAPES = [(2, 16, 2, 37, 16, 7), (3, 50, 3, 70, 72, 9),
             (2, 70, 3, 29, 44, 12), (3, 45, 2, 266, 136, 96),
             (5, 1, 2, 13, 20, 5)]


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_train_decoder_kernels_match_plain_on_card(cuda, shape):
    """K3-fwd: out, mu, var at max|err| ≤ 1e-4·max|ref|; K3-bwd: every
    gradient at relative Frobenius ≤ 1e-4; dcb is 0 analytically (float
    noise of a sum over B·T rows), so it stays below 1e-4·max|dbeta|, the
    same column sum of terms of the same size."""
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    B, T, G, C0, C, F = shape
    a = _train_args(B, T, G, C0, C, F, cuda)
    before = (td.decoder_train_fwd.launches, td.decoder_train_bwd.launches)
    out, cs, mu, var = td.decoder_train_fwd(*a)
    ref = td.decoder_train_fwd_plain(*a)
    torch.cuda.synchronize()
    for got, want in zip((out, cs, mu, var), ref):
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-4, err
    dout = torch.randn(G, B, T, F, generator=torch.Generator().manual_seed(1)
                       ).to(cuda)
    x, w0, wc, cb, gamma, beta, wl, bl = a
    got = td.decoder_train_bwd(dout, x, cs, mu, var, w0, wc, gamma, beta, wl)
    want = td.decoder_train_bwd_plain(dout, x, cs, mu, var, w0, wc, gamma,
                                      beta, wl)
    torch.cuda.synchronize()
    assert (td.decoder_train_fwd.launches, td.decoder_train_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    names = ["dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name == "dcb":
            bound = 1e-4 * float(want[5].abs().max())
            assert float(g.abs().max()) < bound
            assert float(w.abs().max()) < bound
        else:
            assert _rel_fro(g, w) <= 1e-4, (name, _rel_fro(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_train_decoder_kernels_repeat_bit_for_bit(cuda, dtype):
    """Two launches of K3-fwd and of K3-bwd on the same inputs give the same
    bits: every sum (the GEMMs' MMAs, the split-K partials of dW, the
    column passes' splits, layer 0's dx over the groups) runs in a fixed
    order, without atomics."""
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    B, T, G, C0, C, F = 4, 64, 3, 266, 136, 96
    a = tuple(t.to(dtype) for t in _train_args(B, T, G, C0, C, F, cuda))
    first, second = td.decoder_train_fwd(*a), td.decoder_train_fwd(*a)
    for p, q in zip(first, second):
        assert torch.equal(p, q)
    dout = torch.randn(G, B, T, F, generator=torch.Generator().manual_seed(1)
                       ).to(cuda).to(dtype)
    x, w0, wc, cb, gamma, beta, wl, bl = a
    _, cs, mu, var = first
    args = (dout, x, cs, mu, var, w0, wc, gamma, beta, wl)
    for p, q in zip(td.decoder_train_bwd(*args), td.decoder_train_bwd(*args)):
        assert torch.equal(p, q)


def _check_train_kernels(td, a, seed=1):
    """K3-fwd and K3-bwd on ``a`` against their plain versions: out, cs,
    mu, var at max|err| <= 1e-4 max|ref|, every gradient at relative
    Frobenius <= 1e-4, dcb below 1e-4 max|dbeta|."""
    out = td.decoder_train_fwd(*a)
    ref = td.decoder_train_fwd_plain(*a)
    torch.cuda.synchronize()
    for name, got, want in zip(("out", "cs", "mu", "var"), out, ref):
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-4, (name, err)
    x, w0, wc, cb, gamma, beta, wl, bl = a
    dout = torch.randn(out[0].shape, generator=torch.Generator().manual_seed(
        seed)).to(x.device)
    args = (dout, x, *out[1:], w0, wc, gamma, beta, wl)
    got, want = td.decoder_train_bwd(*args), td.decoder_train_bwd_plain(*args)
    torch.cuda.synchronize()
    names = ["dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl"]
    for name, g, w in zip(names, got, want):
        if name == "dcb":
            assert float(g.abs().max()) < 1e-4 * float(want[5].abs().max())
        else:
            assert _rel_fro(g, w) <= 1e-4, (name, _rel_fro(g, w))


def test_train_decoder_f32_repeats_bit_for_bit_at_the_main_shape(cuda):
    """At the training path's bs32 x 64 shape, where the plan splits the
    weight gradients over the frames, two launches of K3-fwd and two of
    K3-bwd in the f32 mode give the same bits."""
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    B, T, G, C0, C, F = 32, 64, 8, 266, 256, 96
    a = _train_args(B, T, G, C0, C, F, cuda)
    first, second = td.decoder_train_fwd(*a), td.decoder_train_fwd(*a)
    for p, q in zip(first, second):
        assert torch.equal(p, q)
    dout = torch.randn(G, B, T, F, generator=torch.Generator().manual_seed(2)
                       ).to(cuda)
    x, w0, wc, cb, gamma, beta, wl, bl = a
    args = (dout, x, *first[1:], w0, wc, gamma, beta, wl)
    for p, q in zip(td.decoder_train_bwd(*args), td.decoder_train_bwd(*args)):
        assert torch.equal(p, q)


def test_train_decoder_f32_beyond_the_main_widths_on_card(cuda):
    """K3's f32 mode at C0 = 1280 and C = 384 (a small B*T): widths its
    3xTF32 parent took (``bad_dims`` bounds only the frames, C0, C and F),
    held against the plain versions as at every other shape."""
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    _check_train_kernels(td, _train_args(2, 24, 2, 1280, 384, 96, cuda))


def test_train_decoder_f32_at_every_tile_and_split_on_card(cuda):
    """K3's f32 mode with every GEMM pass forced onto each of its four
    tiles (``td.gemm_tiles``) and every weight gradient onto 1 and 3 splits
    of the frames, at the ragged C0 = 266, C = 136 (two N tiles) shape."""
    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    lib = td.bind(build.load_library("train_decoder"))
    a = _train_args(3, 45, 2, 266, 136, 96, cuda)
    try:
        for tile in range(len(td.GEMM_TILES)):
            for splits in (1, 3):
                lib.mixstage_train_decoder_force(tile, splits)
                _check_train_kernels(td, a)
    finally:
        lib.mixstage_train_decoder_force(-1, 0)


def test_decoder_train_function_rejects_bad_inputs(cuda):
    from mixstage_tpu_torch.ops.cuda.train_decoder import DecoderTrain

    a = _train_args(2, 8, 2, 11, 8, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        DecoderTrain.apply(a[0].double(), *a[1:])
    strided = a[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        DecoderTrain.apply(strided, *a[1:])
    with pytest.raises(ValueError, match="is on"):
        DecoderTrain.apply(a[0], a[1].cpu(), *a[2:])


def test_fused_g_step_launches_k3_once_each_on_card(cuda):
    """One G step of a small config with fused_decoder launches K3-fwd and
    K3-bwd exactly once, and its losses match the unfused step's."""
    import numpy as np

    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    common = dict(model="JointLateClusterSoftStyle4_G", gan=True,
                  num_clusters=2, num_speakers=2,
                  model_kwargs=(("in_channels", 64),))
    rng = np.random.default_rng(0)
    batch = {"x": (rng.normal(size=(4, 64, 32)).astype(np.float32),),
             "y": rng.normal(size=(4, 64, 96)).astype(np.float32),
             "labels": rng.integers(0, 2, size=(4, 64)),
             "style": np.repeat(rng.integers(0, 2, size=(4, 1)), 64, 1)}
    totals = []
    for fused in (False, True):
        f = StepFactory(StepConfig(**common, fused_decoder=fused))
        state = f.init(seed=0)
        before = (td.decoder_train_fwd.launches,
                  td.decoder_train_bwd.launches)
        _, losses, _ = f.make_steps()["g"](state, batch)
        torch.cuda.synchronize()
        after = (td.decoder_train_fwd.launches, td.decoder_train_bwd.launches)
        assert after == (before[0] + fused, before[1] + fused)
        totals.append(float(losses["total"]))
    assert abs(totals[1] - totals[0]) <= 1e-4 * abs(totals[0])


# ---------------------------------------------------------------------------
# K4: the int8 decoder; K2: the grouped conv chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_int8_kernel_matches_plain_on_card(cuda, shape, per_channel):
    from mixstage_tpu_torch.ops.cuda import quant as q8

    B, T, G, C0, C, L, F = shape
    x, w0, wc, biases, wl, bl = _folded(B, T, G, C0, C, L, F, cuda)
    fd = dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        fd, x, per_channel=per_channel))
    before = q8.fused_mixstage_decoder_int8.launches
    out = q8.fused_mixstage_decoder_int8(x, qfd, groups=G)
    ref = q8.decoder_int8_plain(x, qfd, G)
    torch.cuda.synchronize()
    assert q8.fused_mixstage_decoder_int8.launches == before + 1
    assert out.shape == (B, T, G * F)
    # exact integer MMA sums and the plain version's f32 epilogue, op by op
    assert int((out != ref).sum()) == 0


# (B, T, G, C0, C, L, F): the widths the mma.sync kernel before the wgmma
# one took, where the ring shrinks to make room for the images: C0 = 7000
# (2 stages) and a chain of 60 layers (3 stages, wgmma width 128)
K4_WIDE_SHAPES = [(1, 64, 2, 7000, 256, 3, 96), (1, 200, 1, 266, 256, 60, 8)]


@pytest.mark.parametrize("shape", K4_WIDE_SHAPES, ids=str)
def test_int8_kernel_at_its_widest_on_card(cuda, shape):
    from mixstage_tpu_torch.ops.cuda import quant as q8

    B, T, G, C0, C, L, F = shape
    x, w0, wc, biases, wl, bl = _folded(B, T, G, C0, C, L, F, cuda)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl), x))
    out = q8.fused_mixstage_decoder_int8(x, qfd, groups=G)
    ref = q8.decoder_int8_plain(x, qfd, G)
    torch.cuda.synchronize()
    assert int((out != ref).sum()) == 0


def test_int8_kernel_needs_packed_weights(cuda):
    from mixstage_tpu_torch.ops.cuda import quant as q8

    x, w0, wc, biases, wl, bl = _folded(2, 16, 2, 11, 8, 1, 4, cuda)
    qfd = q8.quantize_folded_decoder(dict(w0=w0, wc=wc, biases=biases,
                                          w_logits=wl, b_logits=bl), x)
    with pytest.raises(ValueError, match="pack_decoder_int8"):
        q8.fused_mixstage_decoder_int8(x, qfd, groups=2)


# (B, T, G, C, L): edge shapes (T off every tile, C off a 16-channel
# chunk, one frame, no layer) and chip_smoke.py's K2 shapes
CHAIN_SHAPES = [(2, 64, 4, 32, 3), (3, 50, 3, 20, 2), (1, 1, 2, 8, 1),
                (2, 130, 1, 256, 4), (2, 17, 2, 12, 0), (32, 64, 8, 256, 3),
                (4, 64, 4, 128, 3), (3, 50, 8, 256, 3)]


def _chain_args(B, T, G, C, L, device, dtype=torch.float32):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, T, G * C, generator=gen).to(device).to(dtype)
    w = (torch.randn(L, G, 3, C, C, generator=gen) * (3 * C) ** -.5).to(device)
    b = (torch.randn(L, G * C, generator=gen) * 0.1).to(device)
    return x, w, b


@pytest.mark.parametrize("shape", CHAIN_SHAPES, ids=str)
def test_chain_kernel_matches_plain_on_card(cuda, shape):
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        chain_plain, fused_grouped_conv_chain)

    B, T, G, C, L = shape
    x, w, b = _chain_args(B, T, G, C, L, cuda)
    before = fused_grouped_conv_chain.launches
    out = fused_grouped_conv_chain(x, w, b, groups=G)
    ref = chain_plain(x, w, b, groups=G)
    torch.cuda.synchronize()
    assert fused_grouped_conv_chain.launches == before + 1
    if L == 0:                       # a chain of no layers copies x
        assert torch.equal(out, x)
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-4, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_chain_kernel_packed_once_equals_packed_per_call(cuda, dtype):
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        fused_grouped_conv_chain, pack_chain_bf16)

    for B, T, G, C, L in ((32, 64, 8, 256, 3), (3, 50, 3, 20, 2)):
        x, w, b = _chain_args(B, T, G, C, L, cuda, dtype)
        packed = pack_chain_bf16(w)
        out = fused_grouped_conv_chain(x, w, b, groups=G, packed=packed)
        assert torch.equal(out, fused_grouped_conv_chain(x, w, b, groups=G))


def test_chain_tile_rule_and_refusals(cuda):
    """K2's tile rule (``launch_common.cuh::cost_tile`` on the chain's
    plan) on an H100 in both modes, and what the wrapper refuses: a packed
    operand of another chain, C over 256 (one output channel a consumer
    thread's row of four 64-channel warpgroups)."""
    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc

    lib = fc.bind_decoder(build.load_library("fused_decoder_wgmma"))
    h100 = (132, 232448)
    for mode in ("f32", "bf16"):
        tile = getattr(lib, f"mixstage_conv_chain_{mode}_tile")
        # 256 CTAs of 64 frames are two waves on 132 SMs
        assert tile(32, 64, 256, 3, 8, *h100) == 64
        # 16 sequences: 8-frame tiles fill 128 SMs in one wave
        assert tile(4, 64, 128, 3, 4, *h100) == 8
        assert tile(2, 130, 256, 4, 1, *h100) == 8
    x, w, b = _chain_args(2, 16, 2, 32, 2, cuda)
    with pytest.raises(ValueError, match="pack_chain_bf16"):
        fc.fused_grouped_conv_chain(x, w, b, groups=2,
                                    packed=fc.pack_chain_bf16(w[:1]))
    wide = _chain_args(1, 8, 1, 264, 1, cuda)
    with pytest.raises(RuntimeError, match="C=264"):
        fc.fused_grouped_conv_chain(*wide, groups=1)


def test_int8_serving_path_on_card(cuda):
    """One int8 serving call launches K1 (the classifier) once and K4 once;
    the kernel route is within the int8 envelope of the plain route, and the
    tier drifts from f32 serving by (1e-4, 0.10)."""
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_
    from mixstage_tpu_torch.ops.cuda import quant as q8
    from mixstage_tpu_torch.ops.cuda.fused_conv import fused_mixstage_decoder
    from mixstage_tpu_torch.serve import build_serving_fn

    model = JointLateClusterSoftStyle4_G(num_clusters=4, num_speakers=3,
                                         in_channels=64)
    reset_parameters_(model, torch.Generator().manual_seed(1),
                      random_bn_stats=True)
    gen = torch.Generator().manual_seed(2)
    audio = torch.randn(3, 128, 64, generator=gen)
    calib = (torch.randn(4, 64, 64, generator=gen), [0, 1, 2, 0])
    serve = build_serving_fn(model, quantize_int8=True, calib=calib)
    before = (fused_mixstage_decoder.launches,
              q8.fused_mixstage_decoder_int8.launches)
    pose = serve(audio, [0, 1, 2])
    torch.cuda.synchronize()
    assert (fused_mixstage_decoder.launches,
            q8.fused_mixstage_decoder_int8.launches) == (before[0] + 1,
                                                         before[1] + 1)
    ref = build_serving_fn(model, use_kernel=False, quantize_int8=True,
                           calib=calib)(audio, [0, 1, 2])
    err, scale = (pose - ref).abs(), float(ref.abs().mean())
    assert float(err.mean()) <= 1e-3 * scale
    assert float(err.max()) <= 1e-2 * scale
    p32 = build_serving_fn(model)(audio, [0, 1, 2])
    rel = float((pose - p32).abs().mean() / p32.abs().mean())
    assert pose.is_cuda and 1e-4 < rel < 0.10, rel


# ---------------------------------------------------------------------------
# bf16 modes of K1, K3, K4 and K2
# ---------------------------------------------------------------------------

BF16_REL, BF16_ABS = 0.10, 1e-3


def _drift(out, truth, frobenius=False):
    """mean |out - truth| / mean |truth| (relative Frobenius error for a
    gradient)."""
    d = (out.double() - truth.double())
    if frobenius:
        return float(d.norm() / truth.double().norm().clamp_min(1e-30))
    return float(d.abs().mean() / truth.double().abs().mean())


def bf16_rule(p, q, truth, frobenius=False):
    """(drift of the kernel's p, of the plain version's q, whether
    |drift(p) - drift(q)| <= 0.10 * drift(q) + 1e-3)."""
    dp, dq = _drift(p, truth, frobenius), _drift(q, truth, frobenius)
    return dp, dq, abs(dp - dq) <= BF16_REL * dq + BF16_ABS


# K1's and K2's bf16 modes against their plain versions: the same f32 sums
# rounded at the same points, so they differ by at most one bf16 ULP of
# max |out|, and only where two summation orders fall on either side of a
# rounding boundary and the flip spreads through later layers (K2: 5.7% of
# the elements at (2, 130, 1, 256, 4) below, on an H100).  A kernel that
# skips one layer's rounding differs in 40-58% of them.
BF16_ULPS, BF16_SHARE = 1.0, 0.20
# K1's classifier chain (L = 5) rounds seven layers, where the flips of two
# valid summation orders saturate: K1-bf16's parent differed from the plain
# version in 27.9-32.7% of the elements there, this kernel in up to 37.5%;
# rounding the last hidden layer toward zero gives 62-71% and passes the
# bf16 rule (chip_smoke.py's K1_BF16_SHARE_DEEP).
K1_BF16_SHARE_DEEP = 0.45


# K3-fwd's bf16 mode: out and cs within one bf16 ULP of max |plain| and
# in at most these shares of their elements differing from the plain
# version (chip_smoke.py's K3_BF16_SHARE: its mma.sync parent differed in
# up to 7.50% of cs and 50.69% of out, the wgmma kernel in up to 7.51% and
# 48.54%; a copy that skips the rounding before the bias add passes the
# bf16 rule and differs in 59.6% and 80.4%).
K3_BF16_SHARE = {"out": 0.65, "cs": 0.20}


def k1_bf16_share(layers):
    return BF16_SHARE if layers <= 3 else K1_BF16_SHARE_DEEP


def bf16_ulps(p, q):
    """(max |p - q| in bf16 ULPs at the scale of max |q|, the share of
    elements where p and q differ)."""
    p, q = p.float(), q.float()
    top = q.abs().max().reshape(1)
    ulp = float(torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8))
    return float((p - q).abs().max()) / ulp, float((p != q).float().mean())


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_bf16_decoder_kernel_follows_plain_on_card(cuda, shape):
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        fused_mixstage_decoder, fused_mixstage_decoder_plain)

    B, T, G, C0, C, L, F = shape
    x, *w = _folded(B, T, G, C0, C, L, F, cuda)
    x16 = x.bfloat16()
    before = (fused_mixstage_decoder.launches,
              fused_mixstage_decoder.launches_bf16)
    out = fused_mixstage_decoder(x16, *w, groups=G)
    ref = fused_mixstage_decoder_plain(x16, *w, groups=G)
    truth = fused_mixstage_decoder_plain(x16.float(), *w, groups=G)
    torch.cuda.synchronize()
    assert (fused_mixstage_decoder.launches,
            fused_mixstage_decoder.launches_bf16) == (before[0] + 1,
                                                      before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, G * F)
    dp, dq, ok = bf16_rule(out, ref, truth)
    assert ok, (dp, dq)
    ulps, share = bf16_ulps(out, ref)
    assert ulps <= BF16_ULPS and share <= k1_bf16_share(L), (ulps, share)


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_bf16_decoder_kernel_at_every_tile(cuda, shape):
    """K1-bf16 launched directly at every time tile (the rule picks one),
    each through the kernel instance its rows need, held like the wrapper's
    launch; a packed operand of the wrong size is refused."""
    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc

    B, T, G, C0, C, L, F = shape
    x, w0, wc, biases, wl, bl = _folded(B, T, G, C0, C, L, F, cuda)
    x16 = x.bfloat16()
    lib = fc.bind_decoder(build.load_library("fused_decoder_wgmma"))
    gstride = fc.packed_elems(C0, C, L, F)
    packed = fc.pack_decoder_bf16(dict(w0=w0, wc=wc, w_logits=wl))
    ref = fc.fused_mixstage_decoder_plain(x16, w0, wc, biases, wl, bl, G)
    truth = fc.fused_mixstage_decoder_plain(x, w0, wc, biases, wl, bl, G)
    for tile in (8, 16, 32, 64):
        out = torch.empty(B, T, G * F, device=cuda, dtype=torch.bfloat16)
        err = lib.mixstage_fused_decoder_bf16(
            x16.data_ptr(), packed.data_ptr(), biases.data_ptr(),
            bl.data_ptr(), out.data_ptr(), B, T, C0, C, L, F, G, 0.2, tile,
            gstride, torch.cuda.current_stream().cuda_stream)
        if err:              # the tile's rows are wider than every instance
            assert min(tile + 2 * L, T) > 72, (tile, err)
            continue
        torch.cuda.synchronize()
        dp, dq, ok = bf16_rule(out, ref, truth)
        ulps, share = bf16_ulps(out, ref)
        assert ok and ulps <= BF16_ULPS and share <= k1_bf16_share(L), (
            tile, dp, dq, ulps, share)
    out = torch.empty(B, T, G * F, device=cuda, dtype=torch.bfloat16)
    assert lib.mixstage_fused_decoder_bf16(
        x16.data_ptr(), packed.data_ptr(), biases.data_ptr(), bl.data_ptr(),
        out.data_ptr(), B, T, C0, C, L, F, G, 0.2, 0, gstride + 8,
        torch.cuda.current_stream().cuda_stream) != 0


# (B, T, G, C0, C, L, F): the decoder and the classifier chain at bs32 and
# at the server's 4096-frame bucket
K1_SERVING_SHAPES = [(32, 64, 8, 266, 256, 3, 96), (32, 64, 1, 266, 256, 5, 8),
                     (1, 4096, 8, 266, 256, 3, 96),
                     (1, 4096, 1, 266, 256, 5, 8)]
_parents = {}


@pytest.mark.parametrize("shape", K1_SERVING_SHAPES + EDGE_SHAPES, ids=str)
def test_bf16_decoder_kernel_equals_its_parent_bit_for_bit(cuda, shape):
    """K1's bf16 mode equals the bf16 kernel of the version before the f32
    mode joined it (its ``fused_decoder_bf16.cu`` and the headers it
    includes, written into ``build/parent/`` with ``git show
    <commit>:mixstage_tpu_torch/ops/cuda/csrc/<file>``) in every element,
    on the same packed weights."""
    import ctypes
    import subprocess
    from pathlib import Path

    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc

    src = Path(__file__).resolve().parents[1] / "build" / "parent" / \
        "fused_decoder_bf16.cu"
    if not src.exists():
        pytest.skip(f"needs the parent's kernel source at {src}")
    if src not in _parents:
        lib = src.with_name("libparent_fused_decoder_bf16.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
        _parents[src] = ctypes.CDLL(str(lib))
        fn = _parents[src].mixstage_fused_decoder_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, T, G, C0, C, L, F = shape
    x, w0, wc, biases, wl, bl = _folded(B, T, G, C0, C, L, F, cuda)
    x16 = x.bfloat16()
    packed = fc.pack_decoder_bf16(dict(w0=w0, wc=wc, w_logits=wl))
    out = fc.fused_mixstage_decoder(x16, w0, wc, biases, wl, bl, groups=G,
                                    packed=packed)
    ref = torch.empty_like(out)
    assert _parents[src].mixstage_fused_decoder_bf16(
        x16.data_ptr(), packed.data_ptr(), biases.data_ptr(), bl.data_ptr(),
        ref.data_ptr(), B, T, C0, C, L, F, G, 0.2, 0,
        fc.packed_elems(C0, C, L, F),
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
def test_bf16_train_decoder_kernels_follow_plain_on_card(cuda, shape):
    """K3-fwd (out, cs, mu, var) and K3-bwd (every gradient but dcb, by
    relative Frobenius drift) in bf16 mode against their plain versions,
    each against the float32 plain version on the same (bf16-valued)
    inputs, out and cs also within one bf16 ULP and ``K3_BF16_SHARE``;
    dcb is 0 analytically and stays below 1e-4·max|dbeta|."""
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    B, T, G, C0, C, F = shape
    a32 = tuple(t.bfloat16().float() for t in _train_args(B, T, G, C0, C,
                                                          F, cuda))
    a16 = tuple(t.bfloat16() for t in a32)
    before = (td.decoder_train_fwd.launches_bf16,
              td.decoder_train_bwd.launches_bf16)
    fwd = td.decoder_train_fwd(*a16)
    ref = td.decoder_train_fwd_plain(*a16)
    truth = td.decoder_train_fwd_plain(*a32)
    torch.cuda.synchronize()
    for name, p, q, r in zip(("out", "cs", "mu", "var"), fwd, ref, truth):
        assert p.dtype == q.dtype, name
        dp, dq, ok = bf16_rule(p, q, r)
        assert ok, (name, dp, dq)
        if name in K3_BF16_SHARE:
            ulps, share = bf16_ulps(p, q)
            assert ulps <= BF16_ULPS and share <= K3_BF16_SHARE[name], (
                name, ulps, share)
    dout = torch.randn(G, B, T, F, generator=torch.Generator().manual_seed(1)
                       ).to(cuda).bfloat16()
    x, w0, wc, cb, gamma, beta, wl, bl = a16
    args = (dout, x, ref[1], ref[2], ref[3], w0, wc, gamma, beta, wl)
    got = td.decoder_train_bwd(*args)
    want = td.decoder_train_bwd_plain(*args)
    x, w0, wc, cb, gamma, beta, wl, bl = a32
    true = td.decoder_train_bwd_plain(dout.float(), x, *truth[1:], w0, wc,
                                      gamma, beta, wl)
    torch.cuda.synchronize()
    assert (td.decoder_train_fwd.launches_bf16,
            td.decoder_train_bwd.launches_bf16) == (before[0] + 1,
                                                    before[1] + 1)
    names = ["dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl"]
    for name, p, q, r in zip(names, got, want, true):
        assert p.dtype == torch.float32 and p.shape == r.shape, name
        if name == "dcb":
            bound = 1e-4 * float(want[5].abs().max())
            assert float(p.abs().max()) < bound
            assert float(q.abs().max()) < bound
        else:
            dp, dq, ok = bf16_rule(p, q, r, frobenius=True)
            assert ok, (name, dp, dq)


def test_bf16_wrappers_refuse_other_dtype_pairs(cuda):
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.ops.cuda.fused_conv import fused_mixstage_decoder

    x, *w = _folded(2, 16, 2, 11, 8, 1, 4, cuda)
    with pytest.raises(TypeError, match="float32"):     # bf16 weights
        fused_mixstage_decoder(x.bfloat16(), *(t.bfloat16() for t in w),
                               groups=2)
    with pytest.raises(TypeError, match="bfloat16"):    # half features
        fused_mixstage_decoder(x.half(), *w, groups=2)
    a = _train_args(2, 8, 2, 11, 8, 4, cuda)
    with pytest.raises(TypeError, match="bfloat16"):    # mixed modes
        td.decoder_train_fwd(a[0].bfloat16(), *a[1:])
    out, cs, mu, var = td.decoder_train_fwd(*(t.bfloat16() for t in a))
    dout = out.clone()
    x, w0, wc, cb, gamma, beta, wl, bl = (t.bfloat16() for t in a)
    with pytest.raises(TypeError, match="float32"):     # bf16 statistics
        td.decoder_train_bwd(dout, x, cs, mu.bfloat16(), var, w0, wc, gamma,
                             beta, wl)


def test_bf16_serving_and_fused_g_step_on_card(cuda):
    """A bf16 serving call launches K1's bf16 mode twice and drifts ≤ 1%
    from the f32 kernel route; a fused bf16 G step launches K3's bf16 mode
    once each way, with finite losses."""
    import numpy as np

    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    from mixstage_tpu_torch.ops.cuda.fused_conv import fused_mixstage_decoder
    from mixstage_tpu_torch.serve import build_serving_fn
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    kw = dict(num_clusters=4, num_speakers=3, in_channels=64)
    models = {dt: JointLateClusterSoftStyle4_G(**kw, dtype=dt)
              for dt in (torch.float32, torch.bfloat16)}
    for m in models.values():
        reset_parameters_(m, torch.Generator().manual_seed(1),
                          random_bn_stats=True)
    audio = torch.randn(3, 128, 64, generator=torch.Generator().manual_seed(2))
    p32 = build_serving_fn(models[torch.float32])(audio, [0, 1, 2])
    serve16 = build_serving_fn(models[torch.bfloat16])
    before = fused_mixstage_decoder.launches_bf16
    p16 = serve16(audio, [0, 1, 2])
    torch.cuda.synchronize()
    assert fused_mixstage_decoder.launches_bf16 == before + 2
    assert p16.dtype == torch.float32
    rel = float((p16 - p32).abs().mean() / p32.abs().mean())
    assert rel <= 0.01, rel

    rng = np.random.default_rng(0)
    batch = {"x": (rng.normal(size=(4, 64, 32)).astype(np.float32),),
             "y": rng.normal(size=(4, 64, 96)).astype(np.float32),
             "labels": rng.integers(0, 2, size=(4, 64)),
             "style": np.repeat(rng.integers(0, 2, size=(4, 1)), 64, 1)}
    f = StepFactory(StepConfig(model="JointLateClusterSoftStyle4_G", gan=True,
                               num_clusters=2, num_speakers=2,
                               model_kwargs=(("in_channels", 64),),
                               fused_decoder=True, dtype=torch.bfloat16))
    before = (td.decoder_train_fwd.launches_bf16,
              td.decoder_train_bwd.launches_bf16)
    _, losses, pose = f.make_steps()["g"](f.init(seed=0), batch)
    torch.cuda.synchronize()
    assert (td.decoder_train_fwd.launches_bf16,
            td.decoder_train_bwd.launches_bf16) == (before[0] + 1,
                                                    before[1] + 1)
    assert pose.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
               for v in losses.values())


def test_bf16_serving_launches_k1_on_weights_packed_at_build(cuda,
                                                             monkeypatch):
    """At the flagship widths (bs32 x 64), the bf16 serving call launches
    K1-bf16 twice and the int8 call on the bf16 model once, each on weights
    packed when the serving function was built: no call packs them, and an
    op-by-op call launches no more kernels than before the split moved to
    build time (378 and 380, torch.profiler on an H100).  A replay of the
    call's CUDA graph runs the same kernels, and the copies into its two
    static inputs and out of its static output."""
    from torch.profiler import ProfilerActivity, profile

    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
    from mixstage_tpu_torch.models.layers import reset_parameters_
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc
    from mixstage_tpu_torch.serve import build_serving_fn

    model = JointLateClusterSoftStyle4_G(
        num_clusters=8, num_speakers=8, in_channels=256, style_dim=10,
        out_feats=96, dtype=torch.bfloat16)
    reset_parameters_(model, torch.Generator().manual_seed(1),
                      random_bn_stats=True)
    gen = torch.Generator().manual_seed(2)
    audio = torch.randn(32, 64, 128, generator=gen).to(cuda)
    styles = torch.randint(0, 8, (32,), generator=gen).to(cuda)
    calib = (torch.randn(32, 64, 128, generator=gen), torch.arange(32) % 8)
    fns = {"bf16": (build_serving_fn(model), 2, 378),
           "int8-bf16": (build_serving_fn(model, quantize_int8=True,
                                          calib=calib), 1, 380)}
    packs = []
    pack = fc.pack_decoder_bf16
    monkeypatch.setattr(fc, "pack_decoder_bf16",
                        lambda fd: packs.append(fd) or pack(fd))
    for name, (fn, k1, most) in fns.items():
        for _ in range(3):      # cuDNN picks its algorithms; then a replay
            fn(audio, styles)
        torch.cuda.synchronize()
        before = fc.fused_mixstage_decoder.launches_bf16
        launches = []
        for call in (fn.graphs.body, fn):       # op by op, a replay
            with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                    torch.inference_mode():
                call(audio, styles)
                torch.cuda.synchronize()
            launches.append(sum(
                1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA))
        assert fc.fused_mixstage_decoder.launches_bf16 == before + 2 * k1, \
            name
        assert 0 < launches[0] <= most, (name, launches)
        assert launches[1] == launches[0] + 3, (name, launches)
    assert not packs


# (B, T, G, C0, C, L, F): one clip and a ragged batch at the flagship widths
K4_BF16_SHAPES = [(1, 64, 8, 266, 256, 3, 96), (3, 50, 8, 266, 256, 3, 96)]


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
@pytest.mark.parametrize("shape", K4_BF16_SHAPES + EDGE_SHAPES, ids=str)
def test_int8_kernel_bf16_features_match_plain_on_card(cuda, shape,
                                                       per_channel):
    from mixstage_tpu_torch.ops.cuda import quant as q8

    B, T, G, C0, C, L, F = shape
    x, w0, wc, biases, wl, bl = _folded(B, T, G, C0, C, L, F, cuda)
    x16 = x.bfloat16()
    fd = dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        fd, x16, per_channel=per_channel))
    before = (q8.fused_mixstage_decoder_int8.launches,
              q8.fused_mixstage_decoder_int8.launches_bf16)
    out = q8.fused_mixstage_decoder_int8(x16, qfd, groups=G)
    ref = q8.decoder_int8_plain(x16, qfd, G)
    torch.cuda.synchronize()
    assert (q8.fused_mixstage_decoder_int8.launches,
            q8.fused_mixstage_decoder_int8.launches_bf16) == (before[0] + 1,
                                                              before[1] + 1)
    assert out.dtype == torch.float32 and out.shape == (B, T, G * F)
    assert int((out != ref).sum()) == 0
    # the exact widening: the f32 mode on the widened features agrees
    assert torch.equal(out, q8.fused_mixstage_decoder_int8(x16.float(), qfd,
                                                           groups=G))


@pytest.mark.parametrize("shape", CHAIN_SHAPES, ids=str)
def test_chain_kernel_bf16_follows_plain_on_card(cuda, shape):
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        chain_plain, fused_grouped_conv_chain)

    B, T, G, C, L = shape
    x, w, b = _chain_args(B, T, G, C, L, cuda, torch.bfloat16)
    before = (fused_grouped_conv_chain.launches,
              fused_grouped_conv_chain.launches_bf16)
    out = fused_grouped_conv_chain(x, w, b, groups=G)
    ref = chain_plain(x, w, b, groups=G)
    truth = chain_plain(x.float(), w, b, groups=G)
    torch.cuda.synchronize()
    assert (fused_grouped_conv_chain.launches,
            fused_grouped_conv_chain.launches_bf16) == (before[0] + 1,
                                                        before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    if L == 0:                       # a chain of no layers copies x
        assert torch.equal(out, x)
        return
    dp, dq, ok = bf16_rule(out, ref, truth)
    assert ok, (dp, dq)
    ulps, share = bf16_ulps(out, ref)
    assert ulps <= BF16_ULPS and share <= BF16_SHARE, (ulps, share)


_parents_wgmma = {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", K1_SERVING_SHAPES + EDGE_SHAPES, ids=str)
def test_decoder_mode_equals_its_parent_bit_for_bit(cuda, shape, dtype):
    """K1's decoder mode, in both modes, equals the kernel of the version
    before K2's chain mode joined it (its ``fused_decoder_wgmma.cu`` and
    the headers it includes, written into ``build/parent_wgmma/`` with
    ``git show <commit>:mixstage_tpu_torch/ops/cuda/csrc/<file>``) in every
    element, on the same packed weights."""
    import ctypes
    import subprocess
    from pathlib import Path

    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc

    src = Path(__file__).resolve().parents[1] / "build" / "parent_wgmma" / \
        "fused_decoder_wgmma.cu"
    if not src.exists():
        pytest.skip(f"needs the parent's kernel source at {src}")
    if src not in _parents_wgmma:
        lib = src.with_name("libparent_fused_decoder_wgmma.so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
        _parents_wgmma[src] = ctypes.CDLL(str(lib))
        for mode in ("f32", "bf16"):
            fn = getattr(_parents_wgmma[src], f"mixstage_fused_decoder_{mode}")
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    B, T, G, C0, C, L, F = shape
    x, w0, wc, biases, wl, bl = _folded(B, T, G, C0, C, L, F, cuda)
    x = x.to(dtype)
    packed = fc.pack_decoder_bf16(dict(w0=w0, wc=wc, w_logits=wl))
    out = fc.fused_mixstage_decoder(x, w0, wc, biases, wl, bl, groups=G,
                                    packed=packed)
    ref = torch.empty_like(out)
    mode = "bf16" if dtype == torch.bfloat16 else "f32"
    assert getattr(_parents_wgmma[src], f"mixstage_fused_decoder_{mode}")(
        x.data_ptr(), packed.data_ptr(), biases.data_ptr(), bl.data_ptr(),
        ref.data_ptr(), B, T, C0, C, L, F, G, 0.2, 0,
        fc.packed_elems(C0, C, L, F),
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
