"""The port's int8 decoder (mixstage_tpu_torch/ops/cuda/quant.py, K4's
module) and grouped conv chain (K2, ops/cuda/fused_conv.py) against the JAX
package on the CPU.

* Calibration, from the same folded weights and features, against JAX
  ``quantize_folded_decoder`` in both schemes: ``w0_i8``, ``m0`` and
  ``s_in`` bit for bit (they depend on max |·| only); ``wc_i8`` and
  ``wl_i8`` within 1 LSB, differing in at most ``MAX_LSB_FLIPS`` entries
  (measured: 1 of 73,728 per channel, 0 per tensor); ``mc``, ``ml`` and
  ``rq`` at about twice their measured relative gap (the calibration pass
  sums in another order than XLA's einsum).
* ``decoder_int8_plain`` against ``decoder_int8_xla`` on JAX's own quantized
  dict, carried across by ``quantized_decoder_from_jax``: the envelope of
  tests/test_pallas.py:110-115 (mean |diff| / mean |ref| < 1e-3, max < 1%);
  the count of differing elements is printed (measured 0).
* The kernel operands: the packed int8 words and the wrappers' CPU routes.
* ``chain_plain`` against ``chain_reference`` at tests/test_pallas.py:34's
  shape (rtol 1e-4, atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import MEL, SMALL, T, small_generators
from mixstage_tpu_torch.interop.weights import quantized_decoder_from_jax
from mixstage_tpu_torch.ops.cuda import quant as tq
from mixstage_tpu_torch.ops.cuda.fused_conv import (chain_plain,
                                                    fused_grouped_conv_chain)

MAX_LSB_FLIPS = 3
# relative gap of the calibrated f32 vectors, about twice the measured one
# (per channel: mc 8.7e-7, ml 9.4e-7, rq 6.3e-6; per tensor: ≤ 6e-7)
VECTOR_TOL = {True: {"mc": 2e-6, "ml": 2e-6, "rq": 1.3e-5},
              False: {"mc": 1.2e-6, "ml": 1.2e-6, "rq": 1.2e-6}}


@pytest.fixture(scope="module")
def folded():
    """JAX's folded decoder (numpy, C0 padded to 128 lanes), the port's copy
    of it (padding stripped), and calibration features in both layouts."""
    from mixstage_tpu import serve as jserve

    _, params, stats, port = small_generators(seed=3)
    G = SMALL["num_clusters"]
    jfd = jserve.extract_folded_decoder(params, stats, G, 96)
    c0 = int(jfd.pop("c0"))
    jfd.pop("out_feats")
    jfd = {k: np.asarray(v) for k, v in jfd.items()}
    tfd = {k: torch.from_numpy(v.copy()) for k, v in jfd.items()}
    tfd["w0"] = tfd["w0"][:, :, :c0].contiguous()
    audio = np.random.default_rng(5).normal(size=(4, T, MEL)) \
        .astype(np.float32)
    sw = torch.eye(2)[[0, 1, 1, 0]][:, None, :].expand(4, T, 2)
    with torch.no_grad():
        feats = port.features([torch.from_numpy(audio)], None, sw).numpy()
    fpad = np.pad(feats, ((0, 0), (0, 0), (0, jfd["w0"].shape[2] - c0)))
    return jfd, tfd, c0, feats, fpad


@pytest.fixture(scope="module")
def jax_quantized(folded):
    from mixstage_tpu.ops.pallas.quant import quantize_folded_decoder

    jfd, _, _, _, fpad = folded
    out = {}
    for per_channel in (True, False):
        q = quantize_folded_decoder(dict(jfd), jnp.asarray(fpad),
                                    per_channel=per_channel)
        out[per_channel] = {k: v if k == "s_in" else np.asarray(v)
                            for k, v in q.items()}
    return out


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
def test_calibration_matches_jax(folded, jax_quantized, per_channel):
    _, tfd, c0, feats, _ = folded
    ref = quantized_decoder_from_jax(jax_quantized[per_channel], c0)
    got = tq.quantize_folded_decoder(tfd, torch.from_numpy(feats),
                                     per_channel=per_channel)
    assert torch.equal(got["w0_i8"], ref["w0_i8"])
    assert torch.equal(got["m0"], ref["m0"])
    if per_channel:
        assert got["s_in"].shape == (c0,)
        assert torch.equal(got["s_in"], ref["s_in"])
    else:
        assert isinstance(got["s_in"], float) and got["s_in"] == ref["s_in"]
    for key in ("wc_i8", "wl_i8"):
        diff = (got[key].int() - ref[key].int()).abs()
        assert int(diff.max()) <= 1, key
        assert int((diff > 0).sum()) <= MAX_LSB_FLIPS, key
    for key, tol in VECTOR_TOL[per_channel].items():
        rel = ((got[key] - ref[key]).abs() / ref[key].abs()).max()
        assert float(rel) <= tol, (key, float(rel))
    for key in ("biases", "b_logits"):
        assert torch.equal(got[key], ref[key])


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
def test_decoder_int8_plain_matches_jax(folded, jax_quantized, per_channel):
    from mixstage_tpu.ops.pallas.quant import decoder_int8_xla

    _, _, c0, feats, fpad = folded
    jq = jax_quantized[per_channel]
    ref = np.asarray(decoder_int8_xla(jnp.asarray(fpad), jq,
                                      SMALL["num_clusters"]))
    qfd = quantized_decoder_from_jax(jq, c0)
    out = tq.decoder_int8_plain(torch.from_numpy(feats), qfd,
                                SMALL["num_clusters"]).numpy()
    assert out.shape == ref.shape
    scale = float(np.abs(ref).mean())
    err = np.abs(out - ref)
    print(f"decoder_int8_plain vs decoder_int8_xla: {int((err > 0).sum())} "
          f"of {err.size} elements differ")
    assert err.mean() / scale < 1e-3
    assert err.max() / scale < 0.01
    # the wrapper's CPU route is the plain version, on the packed dict too
    wrapped = tq.fused_mixstage_decoder_int8(
        torch.from_numpy(feats), tq.pack_decoder_int8(qfd),
        SMALL["num_clusters"])
    assert np.array_equal(wrapped.numpy(), out)


def test_pack_words_layout():
    """Word i of an output channel holds input channels 4i..4i+3 in bytes
    0..3 (little-endian), zero-padded past cin."""
    w = torch.randint(-127, 128, (2, 3, 7, 5), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0))
    p = tq.pack_words(w)
    assert p.dtype == torch.int32 and p.shape == (2, 3, 2, 5)
    b = p.numpy().astype("<i4").view(np.int8).reshape(2, 3, 2, 5, 4)
    unpacked = b.transpose(0, 1, 2, 4, 3).reshape(2, 3, 8, 5)
    assert np.array_equal(unpacked[:, :, :7], w.numpy())
    assert not unpacked[:, :, 7].any()
    packed = tq.pack_decoder_int8({"w0_i8": w, "wc_i8": w[None],
                                   "wl_i8": w[0, 0], "m0": torch.ones(1),
                                   "s_in": 0.5})
    assert torch.equal(packed["s_vec"], torch.full((7,), 0.5))


def test_int8_wrapper_rejects_what_it_cannot_take(folded):
    _, tfd, _, feats, _ = folded
    qfd = tq.quantize_folded_decoder(tfd, torch.from_numpy(feats))
    x = torch.from_numpy(feats)
    with pytest.raises(TypeError, match="float32"):
        tq.fused_mixstage_decoder_int8(x.double(), qfd, 2)
    with pytest.raises(ValueError, match="w0_i8 has shape"):
        tq.fused_mixstage_decoder_int8(x[..., :-1], qfd, 2)
    with pytest.raises(ValueError, match="expected"):
        tq.fused_mixstage_decoder_int8(x, qfd, 3)


def test_chain_plain_matches_chain_reference():
    from mixstage_tpu.ops.pallas.fused_conv import chain_reference

    rng = np.random.default_rng(1)
    B, T_, G, C, L = 4, 64, 4, 128, 3
    x = rng.normal(size=(B, T_, G * C)).astype(np.float32)
    w = (rng.normal(size=(L, G, 3, C, C)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(L, G * C)) * 0.1).astype(np.float32)
    ref = np.asarray(chain_reference(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), G))
    args = [torch.from_numpy(a) for a in (x, w, b)]
    out = chain_plain(*args, groups=G)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    # the wrapper's CPU route is the plain version
    assert torch.equal(fused_grouped_conv_chain(*args, groups=G), out)
    with pytest.raises(ValueError, match="do not fit"):
        fused_grouped_conv_chain(*args, groups=2)
