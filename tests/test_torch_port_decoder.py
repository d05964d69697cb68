"""K1's plain version (mixstage_tpu_torch/ops/cuda/fused_conv.py) against
JAX ``folded_decoder_xla`` and the Pallas ``fused_mixstage_decoder`` in
interpret mode, on random folded weights, at rtol=atol=1e-4 (summation
order only); plus the wrapper's CPU dispatch, its argument checks and
``fold_bn_into_conv``.  The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixstage_tpu.ops.pallas import fused_conv as jfc
from mixstage_tpu.serve import folded_decoder_xla
from mixstage_tpu_torch.ops.cuda import fused_conv as tfc


def random_folded(seed, B, T, G, C0, C, L, F):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        x=f32(rng.normal(size=(B, T, C0))),
        w0=f32(rng.normal(size=(G, 3, C0, C)) / np.sqrt(3 * C0)),
        wc=f32(rng.normal(size=(L, G, 3, C, C)) / np.sqrt(3 * C)),
        biases=f32(rng.normal(size=(G, L + 1, C)) * 0.1),
        w_logits=f32(rng.normal(size=(G, C, F)) / np.sqrt(C)),
        b_logits=f32(rng.normal(size=(G, F)) * 0.1))


KEYS = ("x", "w0", "wc", "biases", "w_logits", "b_logits")
# (G, C0, C, L, F): one group as the classifier chain runs it, several
# groups as the mixture decoder does, an odd C0, one chain layer
SHAPES = [(1, 40, 32, 5, 8), (3, 37, 32, 3, 12), (2, 16, 8, 1, 5)]


@pytest.mark.parametrize("G,C0,C,L,F", SHAPES)
def test_plain_decoder_matches_jax_xla_and_pallas_interpret(G, C0, C, L, F):
    a = random_folded(G + C0, B=2, T=32, G=G, C0=C0, C=C, L=L, F=F)
    ref_xla = np.asarray(folded_decoder_xla(
        jnp.asarray(a["x"]), {**{k: jnp.asarray(a[k]) for k in KEYS[1:]},
                              "c0": C0}, G))
    ref_pallas = np.asarray(jfc.fused_mixstage_decoder(
        *(jnp.asarray(a[k]) for k in KEYS), groups=G, batch_tile=2,
        interpret=True))
    out = tfc.fused_mixstage_decoder_plain(
        *(torch.from_numpy(a[k]) for k in KEYS), groups=G).numpy()
    assert out.shape == (2, 32, G * F)
    np.testing.assert_allclose(out, ref_xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref_pallas, rtol=1e-4, atol=1e-4)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    a = {k: torch.from_numpy(v) for k, v in
         random_folded(0, B=2, T=16, G=2, C0=11, C=8, L=2, F=4).items()}
    before = tfc.fused_mixstage_decoder.launches
    out = tfc.fused_mixstage_decoder(*(a[k] for k in KEYS), groups=2)
    plain = tfc.fused_mixstage_decoder_plain(*(a[k] for k in KEYS), groups=2)
    assert torch.equal(out, plain)
    assert tfc.fused_mixstage_decoder.launches == before


def test_wrapper_rejects_bad_arguments():
    a = {k: torch.from_numpy(v) for k, v in
         random_folded(0, B=2, T=16, G=2, C0=11, C=8, L=2, F=4).items()}
    args = [a[k] for k in KEYS]
    with pytest.raises(TypeError, match="float32"):
        tfc.fused_mixstage_decoder(args[0].double(), *args[1:], groups=2)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.fused_mixstage_decoder(args[0].transpose(0, 1), *args[1:],
                                   groups=2)
    with pytest.raises(ValueError, match="w0 has shape"):
        tfc.fused_mixstage_decoder(*args, groups=3)


def test_fold_bn_into_conv_matches_jax():
    rng = np.random.default_rng(3)
    k = rng.normal(size=(3, 8, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    scale = (rng.normal(size=(16,)) + 2).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    mean = rng.normal(size=(16,)).astype(np.float32)
    var = (rng.random(16) + 0.5).astype(np.float32)
    for conv_bias in (b, None):
        jk, jb = jfc.fold_bn_into_conv(
            jnp.asarray(k), None if conv_bias is None else jnp.asarray(b),
            *(jnp.asarray(v) for v in (scale, bias, mean, var)))
        tk, tb = tfc.fold_bn_into_conv(
            torch.from_numpy(k),
            None if conv_bias is None else torch.from_numpy(b),
            *(torch.from_numpy(v) for v in (scale, bias, mean, var)))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-6)
    assert jax.default_backend() == "cpu"
