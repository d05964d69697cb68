"""The CUDA kernels against their plain PyTorch versions ON THE CARD.

K1 at edge shapes the serving path does not reach (several time tiles with
halos, T not a multiple of the tile, odd widths, no chain layer, one
frame), its time-tile rule, and the serving path.  Tolerance: max |kernel -
plain| ≤ 1e-4 · max |plain| (f32 accumulation order only).  K3's forward
and backward at a small and a ragged shape, their launch counters, the
checks of ``DecoderTrain``, and one fused G step.

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
    from mixstage_tpu_torch.ops.cuda.fused_conv import tile_frames

    h100 = dict(sm_count=132, smem_limit=232448)
    # decoder bs32 T=64: 8*32 = 256 CTAs already fill 132 SMs at tile 64
    assert tile_frames(32, 64, 266, 256, 3, 8, **h100) == 64
    # classifier chain bs32 T=64, one group: halve until the SMs fill
    assert tile_frames(32, 64, 266, 256, 5, 1, **h100) == 16
    # one 64-frame clip through the decoder: 8 CTAs, down to the 8-frame tile
    assert tile_frames(1, 64, 266, 256, 3, 8, **h100) == 8
    # not even the 8-frame tile fits shared memory
    assert tile_frames(1, 64, 4096, 4096, 3, 1, **h100) == 0


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


# (B, T, G, C0, C, F): a small decoder, and a ragged one (T and every width
# off the 64-wide tiles) that checks the sequence ends
K3_SHAPES = [(2, 16, 2, 37, 16, 7), (3, 50, 3, 70, 72, 9)]


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
