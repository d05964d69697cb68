"""K1's 3xTF32 arithmetic, emulated on the CPU, against JAX.

K1 (``mixstage_tpu_torch/ops/cuda/csrc/fused_decoder.cu``) multiplies on
the tensor cores in TF32: each f32 operand v is split into
hi = cvt.rna.tf32.f32(v) and lo = cvt.rna.tf32.f32(v - hi), and a product
is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with f32 sums.  Here
``cvt.rna.tf32.f32`` is emulated on the f32 bit pattern (its low 13 bits
rounded off, half away from zero), the three products of TF32 values are
exact in f32, and the sums are f32 matmuls.  The folded decoder run so at
the serving widths stays within 1e-5 of max |ref| of JAX's
``folded_decoder_xla`` (float32 on the CPU); one TF32 product alone (what
the tensor cores give without the split) lands above the kernel's 1e-4
tolerance, which is why the kernel splits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixstage_tpu.serve import folded_decoder_xla

NEG_SLOPE = 0.2
# name: (G, C0, C, L, F) -- the mixture decoder and the classifier chain
# of the flagship model (C0 = 256 channels + style_dim 10)
CHAINS = {"decoder": (2, 266, 256, 3, 96), "classifier": (1, 266, 256, 5, 8)}
B, T = 2, 16


def tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, to nearest, ties
    away from zero (on the magnitude's bits; finite inputs)."""
    bits = v.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(v):
    hi = tf32(v)
    return hi, tf32(v - hi)


def product(a, b, passes: int):
    """a @ b as the tensor cores take it: 3 passes (3xTF32) or 1 (TF32)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def conv3(h, w, passes):
    """k=3 'same' conv with zero ends: h (B, T, cin), w (3, cin, cout)."""
    zero = h.new_zeros(h.shape[0], 1, h.shape[2])
    taps = (torch.cat([zero, h[:, :-1]], 1), h, torch.cat([h[:, 1:], zero], 1))
    out = product(taps[0], w[0], passes)
    for k in (1, 2):
        out = out + product(taps[k], w[k], passes)
    return out


def emulated_decoder(a, groups, passes):
    outs = []
    for g in range(groups):
        h = conv3(a["x"], a["w0"][g], passes) + a["biases"][g, 0]
        h = torch.where(h >= 0, h, NEG_SLOPE * h)
        for layer in range(a["wc"].shape[0]):
            h = conv3(h, a["wc"][layer, g], passes) + a["biases"][g, layer + 1]
            h = torch.where(h >= 0, h, NEG_SLOPE * h)
        outs.append(product(h, a["w_logits"][g], passes) + a["b_logits"][g])
    return torch.cat(outs, dim=-1)


def folded(seed, G, C0, C, L, F):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        x=f32(rng.normal(size=(B, T, C0))),
        w0=f32(rng.normal(size=(G, 3, C0, C)) / np.sqrt(3 * C0)),
        wc=f32(rng.normal(size=(L, G, 3, C, C)) / np.sqrt(3 * C)),
        biases=f32(rng.normal(size=(G, L + 1, C)) * 0.1),
        w_logits=f32(rng.normal(size=(G, C, F)) / np.sqrt(C)),
        b_logits=f32(rng.normal(size=(G, F)) * 0.1))


@pytest.fixture(scope="module")
def chains():
    """{name: (numpy inputs, JAX's f32 reference)}, one JAX run each."""
    out = {}
    for i, (name, (G, C0, C, L, F)) in enumerate(CHAINS.items()):
        a = folded(10 + i, G, C0, C, L, F)
        fd = {k: jnp.asarray(v) for k, v in a.items() if k != "x"}
        ref = np.asarray(folded_decoder_xla(jnp.asarray(a["x"]),
                                            {**fd, "c0": C0}, G, NEG_SLOPE))
        out[name] = (a, ref)
    return out


def rel_err(chains, name, passes):
    a, ref = chains[name]
    out = emulated_decoder({k: torch.from_numpy(v) for k, v in a.items()},
                           CHAINS[name][0], passes).numpy()
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_tf32_rounding_and_split():
    """Ties round away from zero, the result has 10 mantissa bits, and
    hi + lo carries v to about 2^-21 of |v|."""
    one = 1.0
    half_ulp = 2.0 ** -11                 # a tie between two tf32 values
    v = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp / 2,
                      3.0, 0.0], dtype=torch.float32)
    got = tf32(v)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         3.0, 0.0])
    assert torch.equal(got, want)
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    assert int((tf32(w).view(torch.int32) & 0x1FFF).abs().sum()) == 0
    hi, lo = split(w)
    rel = ((hi.double() + lo.double() - w.double()).abs()
           / w.double().abs()).max()
    assert float(rel) <= 2.0 ** -21


@pytest.mark.parametrize("name", list(CHAINS))
def test_tf32x3_emulation_matches_jax_folded_decoder(chains, name):
    err = rel_err(chains, name, passes=3)
    assert err <= 1e-5, err


@pytest.mark.parametrize("name", list(CHAINS))
def test_single_tf32_pass_misses_the_kernel_tolerance(chains, name):
    err = rel_err(chains, name, passes=1)
    assert err > 1e-4, err
