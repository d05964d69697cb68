"""The port's serving path (mixstage_tpu_torch/serve.py) against the JAX
one, same weights: the folded weights, and the served pose vs JAX
``build_serving_fn(use_pallas=False)`` at rtol=atol=1e-4, with (B,) ids and
(B, S) soft rows; the K1-routed path (its CPU plain version here) and the
plain path vs the port's unfolded eval forward within the BN-fold contract
(rtol=atol=5e-3, as tests/test_pallas.py holds the JAX path); the kernel
route packs K1's weights once, when the serving function is built."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (B, MEL, SMALL, T, jax_serving_factory,
                                 small_generators, style_rows)
from mixstage_tpu_torch import serve as tserve


@pytest.fixture(scope="module")
def setup():
    jg, params, stats, port = small_generators(seed=2)
    audio = np.random.default_rng(9).normal(size=(B, T, MEL)) \
        .astype(np.float32)
    return jg, params, stats, port, audio


def test_folded_weights_match_jax(setup):
    from mixstage_tpu import serve as jserve

    _, params, stats, port, _ = setup
    G = SMALL["num_clusters"]
    jd = jserve.extract_folded_decoder(params, stats, G, 96)
    jc = jserve.extract_folded_classify(params, stats)
    td = tserve.extract_folded_decoder(port)
    tc = tserve.extract_folded_classify(port)
    for jf, tf, c0 in ((jd, td, jd["c0"]), (jc, tc, jc["c0"])):
        for key in ("w0", "wc", "biases", "w_logits", "b_logits"):
            ref = np.asarray(jf[key])
            if key == "w0":                 # JAX pads C0 to 128 lanes
                ref = ref[:, :, :c0]
            np.testing.assert_allclose(tf[key].numpy(), ref, rtol=1e-6,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("style", ["ids", "soft"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_serving_matches_jax_serving(setup, style, use_kernel):
    from mixstage_tpu.serve import build_serving_fn as jax_build

    jg, params, stats, port, audio = setup
    sty = (np.array([0, 1], np.int32) if style == "ids"
           else style_rows("soft", seed=6))
    ref = np.asarray(jax_build(*jax_serving_factory(jg, params, stats),
                               use_pallas=False)(jnp.asarray(audio), sty))
    fn = tserve.build_serving_fn(port, device="cpu", use_kernel=use_kernel)
    assert fn.use_kernel is use_kernel
    out = fn(audio, sty).numpy()
    assert out.shape == (B, T, 96)
    # the K1 route folds BN into the classifier too: JAX's plain path does
    # not, so hold that route to the fold contract instead
    tol = 5e-3 if use_kernel else 1e-4
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serving_within_fold_contract_of_eval_forward(setup, use_kernel):
    _, _, _, port, audio = setup
    sty = style_rows("soft", seed=7)
    with torch.no_grad():
        ref = port([torch.from_numpy(audio)], None,
                   torch.from_numpy(sty)[:, None, :].expand(B, T, 2))["pose"]
    out = tserve.build_serving_fn(port, device="cpu",
                                  use_kernel=use_kernel)(audio, sty)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-3,
                               atol=5e-3)


def test_build_serving_fn_without_a_device_needs_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device, so device=None is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_serving_fn(setup[3])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_kernel_route_packs_k1_weights_once(setup, int8, monkeypatch):
    """On the kernel route ``build_serving_fn`` packs K1's weights (split
    in three bf16 terms, ``pack_decoder_bf16``) once, when the function is
    built: the classifier's, and the decoder's unless K4 runs it (int8);
    no call packs them again.  On the CPU the wrappers run their plain
    versions, so the packed weights leave the pose unchanged: it equals a
    serving function built without them bit for bit."""
    from mixstage_tpu_torch.ops.cuda import fused_conv as fc

    _, _, _, port, audio = setup
    sty = style_rows("soft", seed=8)
    calib = (audio, np.array([0, 1], np.int32)) if int8 else None
    packs = []
    pack = fc.pack_decoder_bf16

    def counting(fd):
        packs.append(fd)
        return pack(fd)

    monkeypatch.setattr(tserve, "pack_decoder_bf16", counting)
    fn = tserve.build_serving_fn(port, device="cpu", use_kernel=True,
                                 quantize_int8=int8, calib=calib)
    assert [fd["w0"].shape[0] for fd in packs] == \
        [1] + ([] if int8 else [SMALL["num_clusters"]])
    monkeypatch.setattr(fc, "pack_decoder_bf16", counting)
    out = fn(audio, sty)
    fn(audio, sty)
    assert len(packs) == (1 if int8 else 2)       # none per call
    monkeypatch.setattr(tserve, "pack_decoder_bf16", lambda fd: None)
    ref = tserve.build_serving_fn(port, device="cpu", use_kernel=True,
                                  quantize_int8=int8, calib=calib)(audio, sty)
    assert torch.equal(out, ref)
