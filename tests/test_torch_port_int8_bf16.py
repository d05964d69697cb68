"""K4's bf16-feature mode and K2's bf16 mode: the port's plain versions
(``ops/cuda/quant.py``, ``ops/cuda/fused_conv.py``) against the JAX
package's functions on the same bfloat16 inputs, on the CPU.

* Calibration on the bf16 features of a bf16 model: the port's
  ``quantize_folded_decoder`` against JAX's on the same features, in both
  schemes, under the assertions of
  ``test_torch_port_quant.py::test_calibration_matches_jax`` (the same
  constants): ``w0_i8``, ``m0`` and ``s_in`` bit for bit, ``wc_i8`` and
  ``wl_i8`` within 1 LSB in at most ``MAX_LSB_FLIPS`` entries, the
  calibrated vectors within ``VECTOR_TOL``.  Both promote the bf16
  features to float32 exactly.
* ``decoder_int8_plain`` on bf16 features against JAX's Pallas kernel
  ``fused_mixstage_decoder_int8(..., interpret=True)`` on the same
  features, with JAX's quantized weights: the int8 envelope of
  ``test_decoder_int8_plain_matches_jax`` (mean |diff| / mean |ref| <
  1e-3, max < 1e-2); the count of differing elements is printed.  The
  kernel runs op by op (``jax.disable_jit``), so ``quantize_input``
  divides as its source says: compiled, XLA turns ``x / s_in`` (a
  constant) into a multiply by 1/s_in, and bf16 features, 8 significant
  bits over a scale that is itself a bf16 maximum / 127, land on the
  rounding ties that the multiply breaks the other way (per channel:
  8.8e-4 mean, 3.8e-2 max of mean |ref|, against JAX's own
  ``decoder_int8_xla`` alike).  Against ``decoder_int8_xla`` run op by op
  the port differs in no element.  The bf16 feature is promoted exactly,
  so the quantized input equals JAX's.
* ``chain_plain``'s bf16 mode against JAX's Pallas
  ``fused_grouped_conv_chain(..., interpret=True)`` on bf16 ``x`` (float32
  weights): the bf16 rule (``_torch_port_helpers.bf16_rule``), the truth
  the float32 chain on the same bf16-valued input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (SMALL, T, MEL, as_np, bf16_rule,
                                 small_generators)
from mixstage_tpu_torch.interop import load_flax_state
from mixstage_tpu_torch.interop.weights import quantized_decoder_from_jax
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.ops.cuda import quant as tq
from mixstage_tpu_torch.ops.cuda.fused_conv import (chain_plain,
                                                    fused_grouped_conv_chain)
from test_torch_port_quant import MAX_LSB_FLIPS, VECTOR_TOL

G = SMALL["num_clusters"]


@pytest.fixture(scope="module")
def folded16():
    """JAX's folded decoder (numpy, C0 padded to 128 lanes), the port's copy
    (padding stripped), and the bf16 features of the bf16 model on a
    calibration batch: as a torch bf16 tensor and, padded, as a JAX bf16
    array."""
    from mixstage_tpu import serve as jserve

    _, params, stats, _ = small_generators(seed=5)
    port16 = JointLateClusterSoftStyle4_G(**SMALL, dtype=torch.bfloat16)
    load_flax_state(port16, params, stats)
    jfd = jserve.extract_folded_decoder(params, stats, G, 96)
    c0 = int(jfd.pop("c0"))
    jfd.pop("out_feats")
    jfd = {k: np.asarray(v) for k, v in jfd.items()}
    tfd = {k: torch.from_numpy(v.copy()) for k, v in jfd.items()}
    tfd["w0"] = tfd["w0"][:, :, :c0].contiguous()
    audio = torch.from_numpy(np.random.default_rng(12).normal(
        size=(4, T, MEL)).astype(np.float32)).bfloat16()
    sw = torch.eye(2, dtype=torch.bfloat16)[[0, 1, 1, 0]][:, None, :] \
        .expand(4, T, 2)
    with torch.no_grad():
        feats = port16.eval().features([audio], None, sw)
    assert feats.dtype == torch.bfloat16
    fpad = jnp.pad(jnp.asarray(as_np(feats)).astype(jnp.bfloat16),
                   ((0, 0), (0, 0), (0, jfd["w0"].shape[2] - c0)))
    return jfd, tfd, c0, feats, fpad


@pytest.fixture(scope="module")
def jax_quantized16(folded16):
    from mixstage_tpu.ops.pallas.quant import quantize_folded_decoder

    jfd, _, _, _, fpad = folded16
    out = {}
    for per_channel in (True, False):
        q = quantize_folded_decoder(dict(jfd), fpad, per_channel=per_channel)
        out[per_channel] = {k: v if k == "s_in" else np.asarray(v)
                            for k, v in q.items()}
    return out


@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_tensor"])
def test_calibration_on_bf16_features_matches_jax(folded16, jax_quantized16,
                                                  per_channel):
    _, tfd, c0, feats, _ = folded16
    ref = quantized_decoder_from_jax(jax_quantized16[per_channel], c0)
    got = tq.quantize_folded_decoder(tfd, feats, per_channel=per_channel)
    assert torch.equal(got["w0_i8"], ref["w0_i8"])
    assert torch.equal(got["m0"], ref["m0"])
    if per_channel:
        # JAX: np.asarray(bf16 max) promoted to f32, max(·, 1e-8), / 127
        want = np.maximum(as_np(feats.abs().amax(dim=(0, 1))), 1e-8) \
            .astype(np.float32) / np.float32(127.0)
        assert got["s_in"].dtype == torch.float32
        assert np.array_equal(got["s_in"].numpy(), want)
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
def test_decoder_int8_plain_on_bf16_matches_jax_kernel(folded16,
                                                       jax_quantized16,
                                                       per_channel):
    import jax

    from mixstage_tpu.ops.pallas.quant import (decoder_int8_xla,
                                               fused_mixstage_decoder_int8)

    _, _, c0, feats, fpad = folded16
    jq = jax_quantized16[per_channel]
    with jax.disable_jit():          # each op rounds as the source says
        ref = np.asarray(fused_mixstage_decoder_int8(
            fpad, jq["w0_i8"], jq["wc_i8"], jq["m0"], jq["mc"], jq["rq"],
            jq["biases"], jq["wl_i8"], jq["ml"], jq["b_logits"],
            s_in=jq["s_in"], groups=G, interpret=True))
    ref_xla = np.asarray(decoder_int8_xla(fpad, jq, G))
    qfd = quantized_decoder_from_jax(jq, c0)
    # the quantized input is JAX's, exactly
    want_q = np.asarray(jnp.clip(jnp.round(
        fpad / jnp.asarray(np.asarray(jq["s_in"], np.float32))), -127, 127)
        .astype(jnp.int8))[..., :c0]
    assert np.array_equal(tq.quantize_input(feats, qfd["s_in"]).numpy(),
                          want_q)
    out = tq.decoder_int8_plain(feats, qfd, G)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    scale = float(np.abs(ref).mean())
    err = np.abs(out.numpy() - ref)
    print(f"decoder_int8_plain (bf16 x) vs fused_mixstage_decoder_int8 "
          f"(interpret, bf16 x): {int((err > 0).sum())} of {err.size} "
          f"elements differ")
    assert err.mean() / scale < 1e-3
    assert err.max() / scale < 0.01
    assert np.array_equal(out.numpy(), ref_xla)
    # the wrapper's CPU route is the plain version, on the packed dict too
    wrapped = tq.fused_mixstage_decoder_int8(feats, tq.pack_decoder_int8(qfd),
                                             G)
    assert torch.equal(wrapped, out)


def test_int8_wrapper_takes_bf16_and_rejects_half(folded16):
    _, tfd, _, feats, _ = folded16
    qfd = tq.quantize_folded_decoder(tfd, feats)
    out = tq.fused_mixstage_decoder_int8(feats, qfd, G)
    assert out.dtype == torch.float32
    # the bf16 value promoted exactly: the f32 copy gives the same logits
    assert torch.equal(out, tq.fused_mixstage_decoder_int8(feats.float(),
                                                           qfd, G))
    with pytest.raises(TypeError, match="bfloat16"):
        tq.fused_mixstage_decoder_int8(feats.half(), qfd, G)


# (B, T, G, C, L): tests/test_pallas.py:34's chain, and a ragged one
CHAIN_SHAPES = [(4, 64, 4, 128, 3), (3, 50, 3, 20, 2)]


@pytest.mark.parametrize("shape", CHAIN_SHAPES, ids=str)
def test_chain_plain_bf16_follows_jax_kernel(shape):
    from mixstage_tpu.ops.pallas.fused_conv import fused_grouped_conv_chain \
        as jax_chain

    B_, T_, G_, C_, L_ = shape
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B_, T_, G_ * C_)).astype(np.float32)
    w = (rng.normal(size=(L_, G_, 3, C_, C_)) * (3 * C_) ** -0.5) \
        .astype(np.float32)
    b = (rng.normal(size=(L_, G_ * C_)) * 0.1).astype(np.float32)
    x16 = torch.from_numpy(x).bfloat16()
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    q = jax_chain(jnp.asarray(as_np(x16)).astype(jnp.bfloat16),
                  jnp.asarray(w), jnp.asarray(b), G_, interpret=True)
    assert q.dtype == jnp.bfloat16
    out = chain_plain(x16, wt, bt, groups=G_)
    assert out.dtype == torch.bfloat16 and out.shape == x16.shape
    truth = chain_plain(x16.float(), wt, bt, groups=G_)
    dp, dq, ok = bf16_rule(as_np(out), as_np(q), as_np(truth))
    print(f"chain bf16 {shape}: drift from f32 port {dp:.4e}, JAX {dq:.4e}")
    assert ok, (dp, dq)
    assert dp > 0                           # it does round
    # the wrapper's CPU route is the plain version
    assert torch.equal(fused_grouped_conv_chain(x16, wt, bt, groups=G_), out)
    with pytest.raises(TypeError, match="float32"):       # bf16 weights
        fused_grouped_conv_chain(x16, wt.bfloat16(), bt, groups=G_)
