"""K1's CUDA kernel against its plain PyTorch version ON THE CARD, at edge
shapes the serving path does not reach (several time tiles with halos, T
not a multiple of the tile, odd widths, no chain layer, one frame), its
time-tile rule, and the serving path.  Tolerance: max |kernel - plain| ≤ 1e-4 ·
max |plain| (f32 accumulation order only).

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
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU "
                    "mode (its plain version is tested on the CPU)")
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
