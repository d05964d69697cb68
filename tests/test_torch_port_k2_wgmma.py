"""K2 on the CPU: the chain mode of K1's ``wgmma`` kernel, its arithmetic
in both modes against JAX, its packed weights, and its shared-memory plan.

K2 (the grouped conv chain) runs as ``decoder_kernel<N, KX, true>`` of
``mixstage_tpu_torch/ops/cuda/csrc/fused_decoder_wgmma.cu``: K1 without
layer 0 and the logits.  Each group reads its own C channels of x
(B, T, G·C), the halo is L frames, and the last layer's epilogue stores
to out.  Its f32 mode splits features and weights into three bf16 terms
and takes a product as six bf16 products, small ones first; its bf16 mode
takes a bf16 feature times a weight as three exact products and rounds
each layer's output to bf16.  Each group of up to ``GROUP_CHUNKS``
16-channel chunks sums into a zeroed float32 partial.

Here, without the card:

* (a) the f32 mode's sums, emulated through the chain, stay within 1e-5
  of max |ref| of JAX's Pallas ``fused_grouped_conv_chain(...,
  interpret=True)`` and of ``chain_reference``, with 64- and 16-channel
  partials;
* (b) one product, x1w1 (both operands rounded to bf16), lands above the
  kernel's 1e-4: the mutant the card's limit must catch;
* (c) the bf16 mode's three products, each layer rounded to bf16, meet
  the bf16 rule against JAX's bf16 Pallas chain in interpret mode
  (compiled with ``xla_allow_excess_precision`` off);
* (d) ``pack_chain_bf16`` is, element for element, the chain layers'
  part of ``pack_decoder_bf16``'s image for the same weights;
* (e) the source's chain mode and its plan: a tile fits H100 shared memory
  in both modes at every ``chip_smoke.py`` K2 shape.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (GROUP_CHUNKS, SIX, as_np, bf16_rule,
                                 emulated_layer, jax_nominal)
from mixstage_tpu.ops.pallas.fused_conv import (chain_reference,
                                                fused_grouped_conv_chain)
from mixstage_tpu_torch.ops.cuda import build
from mixstage_tpu_torch.ops.cuda import fused_conv as fc
from test_torch_port_k1_f32_wgmma import (MIN_STAGES, STAGES, pick_tile,
                                          plan)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(fc.__file__).resolve().parent / "csrc" / "fused_decoder_wgmma.cu"
NEG_SLOPE = 0.2
THREE = [(0, 2), (0, 1), (0, 0)]         # the bf16 mode: x w3, x w2, x w1
# (B, T, G, C, L): small, and ragged (T and C off every tile and chunk)
SHAPES = [(2, 20, 2, 32, 2), (3, 13, 3, 20, 3)]


def chain_inputs(shape, seed=0):
    B, T, G, C, L = shape
    rng = np.random.default_rng(seed + sum(shape))
    return (rng.normal(size=(B, T, G * C)).astype(np.float32),
            (rng.normal(size=(L, G, 3, C, C)) * (3 * C) ** -0.5)
            .astype(np.float32),
            (rng.normal(size=(L, G * C)) * 0.1).astype(np.float32))


def emulated_chain(x, w, b, products, group_chunks, dtype=torch.float32):
    """The chain mode's sums: per group and layer ``emulated_layer``, the
    f32 bias and leaky, and the output rounded to ``dtype``."""
    L, G, _, C, _ = w.shape
    outs = []
    for g in range(G):
        h = x[..., g * C:(g + 1) * C].float()
        for layer in range(L):
            v = emulated_layer(h, w[layer, g], b[layer, g * C:(g + 1) * C],
                               products, group_chunks)
            h = torch.where(v >= 0, v, NEG_SLOPE * v).to(dtype).float()
        outs.append(h)
    return torch.cat(outs, dim=-1).to(dtype)


@pytest.fixture(scope="module")
def refs():
    """{shape: (inputs, JAX's Pallas chain in interpret mode, its
    chain_reference)}, float32."""
    out = {}
    for shape in SHAPES:
        a = chain_inputs(shape)
        j = [jnp.asarray(v) for v in a]
        out[shape] = (a, np.asarray(fused_grouped_conv_chain(
            *j, shape[2], interpret=True)), np.asarray(chain_reference(
                *j, shape[2])))
    return out


def rel_err(refs, shape, **kw):
    a, pallas, xla = refs[shape]
    out = emulated_chain(*(torch.from_numpy(v) for v in a), **kw).numpy()
    assert out.shape == pallas.shape == xla.shape
    return max(float(np.abs(out - r).max() / np.abs(r).max())
               for r in (pallas, xla))


@pytest.mark.parametrize("group_chunks", [GROUP_CHUNKS, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_six_products_match_jax_chain(refs, shape, group_chunks):
    err = rel_err(refs, shape, products=SIX, group_chunks=group_chunks)
    assert err <= 1e-5, err


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_one_product_misses_the_kernel_tolerance(refs, shape):
    err = rel_err(refs, shape, products=[(0, 0)], group_chunks=GROUP_CHUNKS)
    assert err > 1e-4, err


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_mode_follows_jax_bf16_chain(shape):
    x, w, b = chain_inputs(shape, seed=7)
    G = shape[2]
    x16 = torch.from_numpy(x).bfloat16()
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    q = jax_nominal(lambda x_, w_, b_: fused_grouped_conv_chain(
        x_, w_, b_, G, interpret=True),
        jnp.asarray(as_np(x16)).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b))
    assert q.dtype == jnp.bfloat16
    out = emulated_chain(x16, wt, bt, THREE, GROUP_CHUNKS, torch.bfloat16)
    truth = fc.chain_plain(x16.float(), wt, bt, groups=G)
    dp, dq, ok = bf16_rule(as_np(out), as_np(q), as_np(truth))
    print(f"K2-bf16 emulated {shape}: drift from f32 {dp:.4e}, JAX {dq:.4e}")
    assert ok, (dp, dq)
    assert dp > 0                           # it does round
    # three products of a one-term feature are the f32 mode's six with
    # the feature's lower terms zero
    assert torch.equal(out, emulated_chain(x16, wt, bt, SIX, GROUP_CHUNKS,
                                           torch.bfloat16))


@pytest.mark.parametrize("C,L", [(32, 2), (20, 3), (256, 1), (8, 0)])
def test_chain_image_is_the_decoders_chain_layers(C, L):
    rng = np.random.default_rng(C + L)
    G, C0, F_ = 2, 37, 7
    w0, wc, wl = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((G, 3, C0, C), (L, G, 3, C, C), (G, C, F_)))
    dec = fc.pack_decoder_bf16(dict(w0=w0, wc=wc, w_logits=wl))
    chain = fc.pack_chain_bf16(wc)
    n = fc.chain_packed_elems(C, L)
    assert chain.dtype == torch.bfloat16 and chain.is_contiguous()
    assert tuple(chain.shape) == (G, n)
    start = 3 * -(-C0 // 16) * 48 * (-(-C // 64) * 64)      # layer 0's
    assert torch.equal(chain, dec[:, start:start + n])
    assert dec.shape[1] == fc.packed_elems(C0, C, L, F_)


def k2_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.K2_SHAPES


def test_source_has_the_chain_mode():
    src = SOURCE.read_text()
    assert "template <int N, int KX, bool kChain>" in src
    assert re.search(r"k3_layers\(bool chain, int L\) \{\s*return chain \? "
                     r"L : L \+ 1;", src)
    assert re.search(r"last_layer\(bool chain, int L\) \{\s*return chain "
                     r"\? L - 1 : L \+ 1;", src)
    for mode in ("f32", "bf16"):
        assert f"int mixstage_conv_chain_{mode}(" in src
        assert f"int mixstage_conv_chain_{mode}_tile(" in src
    # the FFMA chain is gone, and nothing builds it
    assert not (SOURCE.parent / "conv_chain.cu").exists()
    assert "conv_chain" not in build.SOURCES


def test_chain_plan_fits_h100_at_every_k2_shape():
    """The chain of L layers is the plan of a decoder of L - 1 chain layers
    with C0 = F = C (halo L): both modes take a tile at every K2 shape of
    chip_smoke.py, the four-layer (2, 130, 1, 256, 4) included, with the
    bf16 mode's fixed ring of 6 stages and at least 2 in the f32 mode."""
    shapes = k2_shapes()
    assert (2, 130, 1, 256, 4) in shapes.values()
    for b, t, g, c, layers in shapes.values():
        for terms_ in (3, 1):
            tile = pick_tile(terms_, b, t, c, c, layers - 1, c, g)
            assert tile > 0, (terms_, b, t, g, c, layers)
            p = plan(terms_, t, c, c, layers - 1, c, tile)
            assert p[3] == STAGES if terms_ == 1 else p[3] >= MIN_STAGES
    # the main shape: 64-frame tiles (256 CTAs in two waves) on the N = 64
    # instance; a three-term image of 70 rows leaves the f32 mode's ring 5
    # stages (groups of 3 chunks)
    for terms_, want in ((3, (64, 70, 256, 5, 3)), (1, (64, 70, 256, 6, 4))):
        assert pick_tile(terms_, 32, 64, 256, 256, 2, 256, 8) == 64
        assert plan(terms_, 64, 256, 256, 2, 256, 64) == want
