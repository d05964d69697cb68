"""The CUDA kernels against their plain PyTorch versions ON THE CARD.

K1 at edge shapes the serving path does not reach (several time tiles with
halos, T not a multiple of the tile, odd widths, no chain layer, one
frame), its time-tile rule, and the serving path.  Tolerance: max |kernel -
plain| ≤ 1e-4 · max |plain| (3xTF32 products, f32 accumulation order).
K3's forward and backward (3xTF32 GEMM passes) at shapes that cross its
tiles' edges, their launch counters, their repeating bit for bit, the
checks of ``DecoderTrain``, and one fused G step.  K4 (the
int8 decoder) at the same edge shapes in both quantization schemes, equal
to its plain version in every element, its refusal of unpacked weights,
and the int8 serving tier (one K1 and one K4 launch per call); K2 (the
grouped conv chain) at edge shapes, to 1e-4.  The built K1, K3 and K4 run
on the tensor cores (their SASS holds HMMA and IMMA instructions).

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
    """K1's tile rule (``launch_common.cuh::cost_tile``) on an H100: the
    tile with the fewest estimated row-passes (weight staging plus 16-row
    MMA tiles over the frames and halo) times waves of CTAs."""
    from mixstage_tpu_torch.ops.cuda.fused_conv import tile_frames

    h100 = dict(sm_count=132, smem_limit=232448)
    # decoder bs32 T=64: 256 CTAs of 64 frames are two waves on 132 SMs;
    # 32-frame tiles would be four waves of CTAs that cost more than half
    assert tile_frames(32, 64, 266, 256, 3, 96, 8, **h100) == 64
    # classifier chain bs32 T=64, one group: 32-frame tiles leave 68 SMs
    # idle (64 frames and 12 halo rows overflow shared memory), 8-frame
    # ones take two waves; 16 frames run 128 CTAs in one
    assert tile_frames(32, 64, 266, 256, 5, 8, 1, **h100) == 16
    # one 64-frame clip through the decoder: 64 CTAs of 8 frames, one wave
    assert tile_frames(1, 64, 266, 256, 3, 96, 8, **h100) == 8
    # not even the 8-frame tile fits shared memory
    assert tile_frames(1, 64, 4096, 4096, 3, 8, 1, **h100) == 0


def test_kernels_run_on_tensor_cores(cuda):
    """The built K1 holds tf32 HMMA instructions, K4 s8 IMMA ones and no
    ``__dp4a`` (IDP.4A), and K3's GEMM passes (every instance of its
    ``gemm_kernel``) tf32 HMMA ones and no FFMA, read from their SASS with
    ``cuobjdump`` (it ships beside ``nvcc``)."""
    import subprocess
    from pathlib import Path

    from mixstage_tpu_torch.ops.cuda import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = {}
    for name in ("fused_decoder", "decoder_int8", "train_decoder"):
        build.load_library(name)
        sass[name] = subprocess.run(
            [tool, "-sass", str(build.library_path(name))], check=True,
            capture_output=True, text=True).stdout
    hmma = [ln for ln in sass["fused_decoder"].splitlines() if "HMMA" in ln]
    assert hmma and all("TF32" in ln for ln in hmma), hmma[:3]
    assert "IMMA" in sass["decoder_int8"]
    assert "IDP.4A" not in sass["decoder_int8"]
    # one section per function, each opened by a "Function : <name>" line
    gemms = [f for f in sass["train_decoder"].split("Function : ")[1:]
             if "gemm_kernel" in f.splitlines()[0]]
    assert len(gemms) == 9, len(gemms)      # 3 operand shapes x 3 tiles
    for body in gemms:
        hmma = [ln for ln in body.splitlines() if "HMMA" in ln]
        assert hmma and all("TF32" in ln for ln in hmma), hmma[:3]
        assert "FFMA" not in body, body.splitlines()[0]


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
# cross the GEMM tiles' edges: B*T off every M tile (150, 140, 135), C0 and
# C off a multiple of 8 (4-byte copies for C0 = 29 and 266, a zero-padded
# tap width for C = 44 and 20), C over one 128-wide tile (136), F below one
# 32-wide warp block, and T = 1, where both outer taps leave the sequence
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


def test_train_decoder_kernels_repeat_bit_for_bit(cuda):
    """Two launches of K3-fwd and of K3-bwd on the same inputs give the same
    bits: every sum (the GEMMs' MMAs, the column passes' splits, layer 0's
    dx over the groups) runs in a fixed order, without atomics."""
    from mixstage_tpu_torch.ops.cuda import train_decoder as td

    B, T, G, C0, C, F = 4, 64, 3, 266, 136, 96
    a = _train_args(B, T, G, C0, C, F, cuda)
    first, second = td.decoder_train_fwd(*a), td.decoder_train_fwd(*a)
    for p, q in zip(first, second):
        assert torch.equal(p, q)
    dout = torch.randn(G, B, T, F, generator=torch.Generator().manual_seed(1)
                       ).to(cuda)
    x, w0, wc, cb, gamma, beta, wl, bl = a
    _, cs, mu, var = first
    args = (dout, x, cs, mu, var, w0, wc, gamma, beta, wl)
    for p, q in zip(td.decoder_train_bwd(*args), td.decoder_train_bwd(*args)):
        assert torch.equal(p, q)


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


def test_int8_kernel_needs_packed_weights(cuda):
    from mixstage_tpu_torch.ops.cuda import quant as q8

    x, w0, wc, biases, wl, bl = _folded(2, 16, 2, 11, 8, 1, 4, cuda)
    qfd = q8.quantize_folded_decoder(dict(w0=w0, wc=wc, biases=biases,
                                          w_logits=wl, b_logits=bl), x)
    with pytest.raises(ValueError, match="pack_decoder_int8"):
        q8.fused_mixstage_decoder_int8(x, qfd, groups=2)


# (B, T, G, C, L)
CHAIN_SHAPES = [(2, 64, 4, 32, 3), (3, 50, 3, 20, 2), (1, 1, 2, 8, 1),
                (2, 130, 1, 256, 4), (2, 17, 2, 12, 0)]


@pytest.mark.parametrize("shape", CHAIN_SHAPES, ids=str)
def test_chain_kernel_matches_plain_on_card(cuda, shape):
    from mixstage_tpu_torch.ops.cuda.fused_conv import (
        chain_plain, fused_grouped_conv_chain)

    B, T, G, C, L = shape
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, T, G * C, generator=gen).to(cuda)
    w = (torch.randn(L, G, 3, C, C, generator=gen) * (3 * C) ** -.5).to(cuda)
    b = (torch.randn(L, G * C, generator=gen) * 0.1).to(cuda)
    before = fused_grouped_conv_chain.launches
    out = fused_grouped_conv_chain(x, w, b, groups=G)
    ref = chain_plain(x, w, b, groups=G)
    torch.cuda.synchronize()
    assert fused_grouped_conv_chain.launches == before + 1
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-4, err


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
