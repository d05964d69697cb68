"""The layers no model of the port builds, against the flax modules
carrying the same weights (``interop/weights.py``'s layout rule, no new
rule needed): ``AudioEncoder1D``, ``LatentEncoder``, ``PoseDecoder`` (the
per-group style re-injection), ``StyleDecoder``, the encoders' ``groups``
argument, ``EmbLin``'s ``'emb'`` mode and ``curriculum_value``
(``mixstage_tpu/models/layers.py:271-428``, ``:636-741``).

Each layer runs in eval mode and in train mode (batch statistics, the
running statistics updated).  Tolerances, max |port - JAX| / max |JAX|
over the output (and the updated running statistics): float64 ≤ 1e-9
(largest measured 5.1e-15), float32 ≤ 1e-4 as ``test_torch_port_layers.py``
holds the other layers (largest measured 4.6e-6, the summation order of
ATen's and XLA's convolutions).  The ``'emb'`` rows and the curriculum are
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_variables
from mixstage_tpu.models import layers as jl
from mixstage_tpu_torch.interop import load_flax_state, to_flax_state
from mixstage_tpu_torch.models import layers as tl

TOL = {np.float32: 1e-4, np.float64: 1e-9}
# name: (flax module of a dtype, port module of a dtype, input shape)
CASES = {
    "audio_encoder_1d": (
        lambda d: jl.AudioEncoder1D(input_channels=12, dtype=d,
                                    param_dtype=d),
        lambda d: tl.AudioEncoder1D(12, dtype=d), (2, 16, 12)),
    "audio_encoder_1d_groups": (
        lambda d: jl.AudioEncoder1D(input_channels=6, groups=2, dtype=d,
                                    param_dtype=d),
        lambda d: tl.AudioEncoder1D(6, dtype=d, groups=2), (2, 16, 12)),
    "latent_encoder": (
        lambda d: jl.LatentEncoder(10, 16, 3, dtype=d, param_dtype=d),
        lambda d: tl.LatentEncoder(10, 16, 3, dtype=d), (2, 16, 10)),
    "pose_decoder": (
        lambda d: jl.PoseDecoder(16, 3, 4, 5, dtype=d, param_dtype=d),
        lambda d: tl.PoseDecoder(16, 3, 4, 5, dtype=d), (2, 16, 4 * 19)),
    "style_decoder": (
        lambda d: jl.StyleDecoder(16, 3, 5, dtype=d, param_dtype=d),
        lambda d: tl.StyleDecoder(16, 3, 5, dtype=d), (2, 16, 48)),
    "pose_encoder_groups": (
        lambda d: jl.PoseEncoder(input_channels=6, groups=2, dtype=d,
                                 param_dtype=d),
        lambda d: tl.PoseEncoder(6, dtype=d, groups=2), (2, 16, 12)),
    "pose_style_encoder_groups": (
        lambda d: jl.PoseStyleEncoder(input_channels=6, num_speakers=3,
                                      groups=2, dtype=d, param_dtype=d),
        lambda d: tl.PoseStyleEncoder(6, 3, dtype=d, groups=2), (2, 64, 12)),
    "text_encoder_groups": (
        lambda d: jl.TextEncoder1D(input_channels=5, groups=3, dtype=d,
                                   param_dtype=d),
        lambda d: tl.TextEncoder1D(5, dtype=d, groups=3), (2, 16, 15)),
    "audio_encoder_groups": (
        lambda d: jl.AudioEncoder(input_channels=1, groups=2, dtype=d,
                                  param_dtype=d),
        lambda d: tl.AudioEncoder(input_channels=1, groups=2, dtype=d),
        (2, 32, 32, 2)),
}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _run(name, dtype, train):
    jmod_of, tmod_of, shape = CASES[name]
    jmod, tmod = jmod_of(jnp.dtype(dtype)), tmod_of(TORCH[dtype])
    if dtype == np.float64:
        tmod.double()
    x = np.random.default_rng(7).normal(size=shape).astype(dtype)
    params, stats = flax_variables(jmod, jnp.asarray(x), seed=5,
                                   dtype=dtype, train=False)
    load_flax_state(tmod, params, stats)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, new = jmod.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        new_stats = new["batch_stats"]
    else:
        ref = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod.train(train)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x)).numpy()
    gaps = [_rel(out, ref)]
    assert out.dtype == dtype
    if train:
        _, got_stats = to_flax_state(tmod)
        want = dict(_flat(new_stats))
        got = dict(_flat(got_stats))
        assert sorted(got) == sorted(want)
        gaps += [_rel(got[k], want[k]) for k in want]
    return max(gaps)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax_f64(name, train):
    with jax.enable_x64(True):
        assert _run(name, np.float64, train) <= TOL[np.float64]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax_f32(name, train):
    assert _run(name, np.float32, train) <= TOL[np.float32]


def test_pose_decoder_reinjects_each_groups_style():
    """The style channels of group g reach only group g's later layers:
    changing group 1's style leaves groups 0, 2 and 3 as they were."""
    torch.manual_seed(0)
    dec = tl.PoseDecoder(16, 3, 4, 5).eval()
    x = torch.randn(2, 16, 4, 19)
    y0 = dec(x.reshape(2, 16, -1)).reshape(2, 16, 4, 5)
    x[:, :, 1, -3:] += 1.0
    y1 = dec(x.reshape(2, 16, -1)).reshape(2, 16, 4, 5)
    changed = (y0 != y1).any(dim=(0, 1, 3))
    assert changed.tolist() == [False, True, False, False]


def test_emblin_emb_mode_matches_flax():
    jm, tm = jl.EmbLin(7, 6), tl.EmbLin(7, 6)
    idx = np.random.default_rng(3).integers(0, 7, size=(2, 16))
    params, _ = flax_variables(jm, jnp.asarray(idx), mode="emb", seed=2)
    load_flax_state(tm, params, {})
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(idx),
                               mode="emb"))
    got = tm(torch.from_numpy(idx), mode="emb").detach().numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="mode"):
        tm(torch.from_numpy(idx), mode="onehot")


@pytest.mark.parametrize("num_iters", [0, 1, 7, 1000])
def test_curriculum_value_matches_jax(num_iters):
    for step in (0, 1, 3, 6, 7, 20, 999, 1000, 5000):
        for start, end in ((0.0, 1.0), (0.1, 0.9), (1.0, 0.25)):
            want = np.asarray(jl.curriculum_value(step, start, end,
                                                  num_iters))
            got = tl.curriculum_value(step, start, end, num_iters)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
            want_a = np.asarray(jl.curriculum_value(
                jnp.asarray(step, jnp.int32), start, end, num_iters))
            got_a = tl.curriculum_value(torch.tensor(step), start, end,
                                        num_iters)
            np.testing.assert_array_equal(got_a.numpy(), want_a)
