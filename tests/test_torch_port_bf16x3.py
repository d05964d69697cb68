"""K1's bf16 kernel arithmetic on the CPU: the three-term weight split, the
packed image the kernel streams, and the kernel's sums emulated against
JAX.

K1's bf16 mode (``mixstage_tpu_torch/ops/cuda/csrc/fused_decoder_wgmma.cu``)
multiplies bf16 features by float32 weights on the bf16 tensor cores: each
weight w is split once (``split_bf16x3``) into w1 = bf16(w), w2 = bf16(w -
w1), w3 = w - w1 - w2, three bfloat16 values that sum to w exactly, so a
feature times w is exactly the sum of three bf16 products, each exact in
float32.  ``pack_decoder_bf16`` lays the terms out chunk by chunk in the
image ``wgmma`` reads: per layer, tap and 16 input channels, [3 terms][2
halves of 8 channels][output channels padded to 64][8 channels].

Here: the split is exact on a trained-shape folded decoder and classifier
(``tiny_exp``'s) and on weights from 1e-30 to 1e4; the packed image
unpacks to the terms at every width of the card tests' edge shapes, with
zeros in the padding; and the kernel's arithmetic — exact float32 products
of the bf16 features with each term, the terms of each group of
``GROUP_CHUNKS`` 16-channel chunks summed into a zeroed float32 partial
that is added to the float32 accumulator, bias and leaky in float32, each
layer rounded to bf16 — follows JAX's Pallas K1 at ``dtype=bfloat16``
(interpret mode) by the bf16 rule and stays within one bf16 ULP of max
|plain| of ``fused_mixstage_decoder_plain``, at the serving widths.  With
one term (the weights rounded to bf16, what the tensor cores would give
without the split) the same emulation fails the bf16 rule: why the kernel
splits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_helpers import as_np, bf16_rule, bf16_values, jax_nominal
from mixstage_tpu.ops.pallas import fused_conv as jfc
from mixstage_tpu.serve import (extract_folded_classify,
                                extract_folded_decoder, folded_decoder_xla)
from mixstage_tpu_torch.ops.cuda.fused_conv import (
    fused_mixstage_decoder_plain, pack_decoder_bf16, packed_elems,
    split_bf16x3)
from test_torch_port_cuda import EDGE_SHAPES

KEYS = ("w0", "wc", "biases", "w_logits", "b_logits")
NEG_SLOPE = 0.2
GROUP_CHUNKS = 4          # 16-channel chunks per zeroed partial (the kernel's)
# name: (G, C0, C, L, F) -- the mixture decoder and the classifier chain at
# the flagship model's serving widths
CHAINS = {"decoder": (8, 266, 256, 3, 96), "classifier": (1, 266, 256, 5, 8)}
B, T = 2, 16


def exact_sum(terms):
    return sum(t.double() for t in terms)


def assert_split_exact(w):
    terms = split_bf16x3(w)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    assert torch.equal(exact_sum(terms), w.double())
    # and the float32 sum, big terms first, lands on w bit for bit
    w1, w2, w3 = (t.float() for t in terms)
    assert torch.equal(((w1 + w2) + w3).view(torch.int32),
                       w.view(torch.int32))


def test_split_is_exact_on_folded_weights(tiny_exp):
    _, state, _, _ = tiny_exp
    params, stats = state.g_params["gen"], state.g_state["gen"]
    for fd in (extract_folded_decoder(params, stats, 2, 96),
               extract_folded_classify(params, stats)):
        for key in ("w0", "wc", "w_logits"):
            w = torch.from_numpy(np.array(fd[key], np.float32))
            assert w.abs().max() > 0, key
            assert_split_exact(w)


def test_split_is_exact_from_1e_30_to_1e4():
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-30, 4, size=200_000)
    w = torch.from_numpy((mag * rng.choice([-1, 1], size=mag.shape))
                         .astype(np.float32))
    assert_split_exact(w)


def unpack(packed_g, C0, C, L, F_):
    """One group's packed image → [(3, taps, cin, cout) terms] per layer,
    asserting zeros in the K and output-channel padding."""
    out, off = [], 0
    for taps, cin, cout in [(3, C0, C)] + [(3, C, C)] * L + [(1, C, F_)]:
        nk, mp = -(-cin // 16), -(-cout // 64) * 64
        n = taps * nk * 48 * mp
        terms = (packed_g[off:off + n].reshape(taps, nk, 3, 2, mp, 8)
                 .permute(2, 0, 1, 3, 5, 4).reshape(3, taps, 16 * nk, mp))
        off += n
        assert not terms[:, :, cin:].any() and not terms[..., cout:].any()
        out.append(terms[:, :, :cin, :cout])
    assert off == packed_g.numel()
    return out


def random_folded(seed, G, C0, C, L, F_):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return dict(
        w0=f32(rng.normal(size=(G, 3, C0, C)) / np.sqrt(3 * C0)),
        wc=f32(rng.normal(size=(L, G, 3, C, C)) / np.sqrt(3 * C)),
        biases=f32(rng.normal(size=(G, L + 1, C)) * 0.1),
        w_logits=f32(rng.normal(size=(G, C, F_)) / np.sqrt(C)),
        b_logits=f32(rng.normal(size=(G, F_)) * 0.1))


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
def test_packed_image_unpacks_to_the_terms(shape):
    _, _, G, C0, C, L, F_ = shape
    fd = random_folded(sum(shape), G, C0, C, L, F_)
    packed = pack_decoder_bf16(fd)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (G, packed_elems(C0, C, L, F_))
    for g in range(G):
        layers = [fd["w0"][g]] + [fd["wc"][i, g] for i in range(L)] + \
            [fd["w_logits"][g][None]]
        for w, terms in zip(layers, unpack(packed[g], C0, C, L, F_)):
            for got, want in zip(terms, split_bf16x3(w)):
                assert torch.equal(got, want)
            assert torch.equal(exact_sum(terms), w.double())


def emulated_layer(h, terms, bias):
    """One layer as the kernel sums it: h (B, T, cin) bf16-valued float32,
    terms [(taps, cin, cout)] bf16, the small terms first.  The K of the
    layer runs tap by tap, 16 channels a chunk; each group of GROUP_CHUNKS
    chunks sums into a zeroed float32 partial added to the accumulator."""
    taps, cin, cout = terms[0].shape
    nk = -(-cin // 16)
    hp = F.pad(h, (0, 16 * nk - cin))
    if taps == 3:            # rows t-1, t, t+1 with zeros past each end
        zero = hp.new_zeros(hp.shape[0], 1, hp.shape[2])
        shifted = (torch.cat([zero, hp[:, :-1]], 1), hp,
                   torch.cat([hp[:, 1:], zero], 1))
    else:
        shifted = (hp,)
    xk = torch.cat(shifted, dim=-1).reshape(-1, taps * 16 * nk)
    wk = [F.pad(t.float(), (0, 0, 0, 16 * nk - cin)).reshape(-1, cout)
          for t in terms]
    acc = torch.zeros(xk.shape[0], cout)
    for k0 in range(0, taps * nk, GROUP_CHUNKS):
        ks = slice(16 * k0, 16 * min(k0 + GROUP_CHUNKS, taps * nk))
        part = torch.zeros_like(acc)
        for w in reversed(wk):
            part = part + xk[:, ks] @ w[ks]
        acc = acc + part
    return (acc + bias).reshape(h.shape[0], h.shape[1], cout)


def emulated_decoder(x16, fd, G, L, n_terms):
    """The bf16 kernel's arithmetic on bf16 features ``x16``, from the
    packed image (``n_terms`` = 1: the weights rounded to bf16 instead)."""
    C0, C, F_ = x16.shape[-1], fd["w0"].shape[-1], fd["w_logits"].shape[-1]
    packed = pack_decoder_bf16(fd)
    outs = []
    for g in range(G):
        layers = unpack(packed[g], C0, C, L, F_)
        if n_terms == 1:
            layers = [t[:1] for t in layers]
        h = x16.float()
        for layer in range(L + 1):
            v = emulated_layer(h, layers[layer], fd["biases"][g, layer])
            h = torch.where(v >= 0, v, NEG_SLOPE * v).bfloat16().float()
        outs.append(emulated_layer(h, layers[L + 1], fd["b_logits"][g]))
    return torch.cat(outs, -1).bfloat16()


@pytest.fixture(scope="module")
def chains():
    """{name: (bf16 features, folded weights, JAX's Pallas K1 at bf16, the
    float32 truth, the port's plain bf16 version)}."""
    out = {}
    for i, (name, (G, C0, C, L, F_)) in enumerate(CHAINS.items()):
        fd = random_folded(20 + i, G, C0, C, L, F_)
        x = bf16_values(np.random.default_rng(30 + i).normal(
            size=(B, T, C0)).astype(np.float32))
        w = [jnp.asarray(fd[k].numpy()) for k in KEYS]
        truth = np.asarray(folded_decoder_xla(
            jnp.asarray(x), {**dict(zip(KEYS, w)), "c0": C0}, G, NEG_SLOPE))
        q = as_np(jax_nominal(functools.partial(
            jfc.fused_mixstage_decoder, groups=G, batch_tile=B,
            interpret=True), jnp.asarray(x, jnp.bfloat16), *w))
        x16 = torch.from_numpy(x).bfloat16()
        plain = fused_mixstage_decoder_plain(x16, *(fd[k] for k in KEYS),
                                             groups=G)
        out[name] = (x16, fd, q, truth, plain)
    return out


def bf16_ulp(top: float) -> float:
    """One bf16 ULP at the scale of ``top``."""
    return 2.0 ** (np.frexp(top)[1] - 8)


@pytest.mark.parametrize("name", list(CHAINS))
def test_three_term_emulation_follows_pallas_bf16(chains, name):
    x16, fd, q, truth, plain = chains[name]
    G, _, _, L, F_ = CHAINS[name]
    out = emulated_decoder(x16, fd, G, L, n_terms=3)
    assert out.shape == (B, T, G * F_)
    dp, dq, ok = bf16_rule(as_np(out), q, truth)
    assert ok, (dp, dq)
    ref = plain.float()
    err = float((out.float() - ref).abs().max())
    assert err <= bf16_ulp(float(ref.abs().max())), err


@pytest.mark.parametrize("name", list(CHAINS))
def test_one_term_emulation_fails_the_bf16_rule(chains, name):
    x16, fd, q, truth, _ = chains[name]
    G, _, _, L, _ = CHAINS[name]
    out = emulated_decoder(x16, fd, G, L, n_terms=1)
    dp, dq, ok = bf16_rule(as_np(out), q, truth)
    assert not ok, (dp, dq)
