"""The port's layers at the bfloat16 compute dtype against the flax modules
at ``dtype=bfloat16`` carrying the same float32 weights.

Each case runs three times on the same bf16-valued input: the flax module
at float32 (the truth R), the flax module at bfloat16 (Q, compiled with
XLA's excess precision off so that it rounds where flax's source rounds,
``_torch_port_helpers.jax_nominal``) and the port's module at bfloat16
(P).  Tolerance: the bf16 rule (``_torch_port_helpers.bf16_rule``),
|drift(P) - drift(Q)| <= 0.10 drift(Q) + 1e-3, with drift = mean |O - R| /
mean |R|, in eval mode and in training mode (BatchNorm on batch
statistics).  The generator and the discriminator are held to it as
wholes in eval mode; in training mode a whole generator amplifies each
rounding through its train-mode BatchNorms (the UNet's bottleneck
normalises over B·2 rows) and two valid roundings drift apart by more
than 10% at this size, so there each layer is held on its own.  The rule is
two-sided: the port's float32 layer (no rounding) fails it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (FEATS, MODALITIES, SMALL, T, as_np,
                                 bf16_rule, bf16_values, flax_variables,
                                 jax_nominal)
from mixstage_tpu.models import layers as jl
from mixstage_tpu.models.mix_stage import \
    JointLateClusterSoftStyle4_G as JaxG
from mixstage_tpu.models.speech2gesture import Speech2Gesture_D as JaxD
from mixstage_tpu_torch.interop import load_flax_state
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G, \
    Speech2Gesture_D
from mixstage_tpu_torch.models import layers as tl

BF = dict(dtype=jnp.bfloat16)
TB = dict(dtype=torch.bfloat16)

# name: (flax class, port class, constructor kwargs (flax, port), input
# shape, call kwargs); both are built at float32 and at bfloat16
CASES = {
    "batch_norm": (lambda **k: __import__("flax.linen", fromlist=["x"])
                   .BatchNorm(momentum=0.9, epsilon=1e-5, **k),
                   tl.BatchNorm, ({}, {"num_features": 24}), (2, 32, 24),
                   {}),
    "cnr_1d": (jl.ConvNormRelu, tl.ConvNormRelu,
               (dict(in_channels=16, out_channels=24, type="1d",
                     leaky=True),) * 2, (2, 32, 16), {}),
    "cnr_2d": (jl.ConvNormRelu, tl.ConvNormRelu,
               (dict(in_channels=3, out_channels=8, type="2d",
                     leaky=True),) * 2, (2, 16, 12, 3), {}),
    "cnr_grouped_relu": (jl.ConvNormRelu, tl.ConvNormRelu,
                         (dict(in_channels=10, out_channels=12,
                               groups=3),) * 2, (2, 32, 30), {}),
    "cnr_downsample_1d": (jl.ConvNormRelu, tl.ConvNormRelu,
                          (dict(in_channels=8, out_channels=8,
                                downsample=True, leaky=True),) * 2,
                          (2, 32, 8), {}),
    "unet1d": (jl.UNet1D, tl.UNet1D,
               (dict(input_channels=16, output_channels=16),) * 2,
               (2, 64, 16), {}),
    "audio_encoder": (jl.AudioEncoder, tl.AudioEncoder, ({}, {}),
                      (2, 64, 32), {"time_steps": 64}),
    "audio_encoder_resize_down": (jl.AudioEncoder, tl.AudioEncoder,
                                  ({}, {}), (2, 64, 32), {"time_steps": 5}),
    "pose_encoder": (jl.PoseEncoder, tl.PoseEncoder,
                     (dict(input_channels=12),) * 2, (2, 32, 12), {}),
    "pose_style_encoder": (jl.PoseStyleEncoder, tl.PoseStyleEncoder,
                           (dict(input_channels=12, num_speakers=3),) * 2,
                           (8, 128, 12), {}),
    "cluster_classify": (jl.ClusterClassify, tl.ClusterClassify,
                         (dict(num_clusters=3, input_channels=20),) * 2,
                         (2, 32, 20), {}),
    "grouped_pointwise": (jl.GroupedPointwiseConv, tl.GroupedPointwiseConv,
                          (dict(features=12, groups=3),
                           dict(in_channels=24, features=12, groups=3)),
                          (2, 32, 24), {}),
    "emb_lin": (jl.EmbLin, tl.EmbLin,
                (dict(num_embeddings=4, embedding_dim=6),) * 2, (2, 8, 4),
                {}),
}
NO_TRAIN_FLAG = ("grouped_pointwise", "emb_lin")


def _flax_call(mod, params, stats, x, update, **kwargs):
    """The flax module applied with its rounding points kept; with
    ``update`` (training mode) the updated running statistics are
    dropped."""
    variables = {"params": params, "batch_stats": stats}

    def fn(x):
        if update:
            return mod.apply(variables, x, mutable=["batch_stats"],
                             **kwargs)[0]
        return mod.apply(variables, x, **kwargs)

    return jax_nominal(fn, x)


def _mode_kwargs(name, train, kwargs):
    """The flax call's keywords for the mode."""
    if name in NO_TRAIN_FLAG:
        return dict(kwargs)
    if name == "batch_norm":
        return dict(kwargs, use_running_average=not train)
    return dict(kwargs, train=train)


# every case in eval mode, and in training mode those with a BatchNorm
MODES = [(name, train) for name in sorted(CASES) for train in (False, True)
         if not (train and name in NO_TRAIN_FLAG)]


@pytest.mark.parametrize("name,train", MODES,
                         ids=[f"{n}-{'train' if t else 'eval'}"
                              for n, t in MODES])
def test_layer_follows_flax_bf16(name, train):
    flax_cls, port_cls, (fkw, pkw), shape, kwargs = CASES[name]
    x = bf16_values(np.random.default_rng(7).normal(size=shape)
                    .astype(np.float32))
    jkw = _mode_kwargs(name, train, kwargs)
    j32, j16 = flax_cls(**fkw), flax_cls(**fkw, **BF)
    params, stats = flax_variables(j32, jnp.asarray(x), seed=5,
                                   **_mode_kwargs(name, False, kwargs))
    r = as_np(_flax_call(j32, params, stats, jnp.asarray(x), train, **jkw))
    q = as_np(_flax_call(j16, params, stats, jnp.asarray(x, jnp.bfloat16),
                         train, **jkw))
    p16, p32 = port_cls(**pkw, **TB), port_cls(**pkw)
    for m in (p16, p32):
        load_flax_state(m, params, stats)
        m.train(train)
    with torch.no_grad():
        out = p16(torch.from_numpy(x).bfloat16(), **kwargs)
        out32 = p32(torch.from_numpy(x), **kwargs)
    assert out.dtype == torch.bfloat16 and out.shape == r.shape
    dp, dq, ok = bf16_rule(as_np(out), q, r)
    assert ok, (name, dp, dq)
    # two-sided: the float32 layer is too accurate to pass
    assert not bf16_rule(as_np(out32), q, r)[2], name


@pytest.mark.parametrize("out_size", [16, 4, 7])
def test_resize_bilinear_time_follows_jax_bf16(out_size):
    x = bf16_values(np.random.default_rng(8).normal(size=(2, 7, 5, 3))
                    .astype(np.float32))
    r = np.asarray(jl.resize_bilinear_time(jnp.asarray(x), out_size))
    q = as_np(jax_nominal(lambda v: jl.resize_bilinear_time(v, out_size),
                          jnp.asarray(x, jnp.bfloat16)))
    out = tl.resize_bilinear_time(torch.from_numpy(x).bfloat16(), out_size)
    assert out.dtype == torch.bfloat16
    dp, dq, ok = bf16_rule(as_np(out), q, r)
    assert ok, (dp, dq)


def _generators():
    jg = JaxG(**SMALL)
    B = 4
    params, stats = flax_variables(
        jg, [jnp.zeros((B, T, 32))], jnp.zeros((B, T, FEATS)),
        jnp.zeros((B, T, SMALL["num_speakers"])),
        input_modalities=list(MODALITIES), use_pose_input=False,
        train=False, seed=11)
    return B, jg, JaxG(**SMALL, **BF), params, stats


def test_generator_eval_follows_flax_bf16():
    """The whole generator in eval mode: pose, cluster scores and the
    mixture weights (flax's softmax steps, each rounded)."""
    B, jg, jg16, params, stats = _generators()
    rng = np.random.default_rng(12)
    audio = bf16_values(rng.normal(size=(B, T, 32)).astype(np.float32))
    w = rng.uniform(size=(B, SMALL["num_speakers"]))
    sw = bf16_values(np.repeat((w / w.sum(1, keepdims=True))[:, None], T, 1)
                     .astype(np.float32))
    kw = dict(input_modalities=list(MODALITIES), use_pose_input=False,
              train=False)
    out = {}
    for name, mod, dt in (("r", jg, jnp.float32), ("q", jg16, jnp.bfloat16)):
        out[name] = jax_nominal(
            lambda a, w: mod.apply({"params": params, "batch_stats": stats},
                                   [a], jnp.zeros((B, T, FEATS), dt), w,
                                   **kw),
            jnp.asarray(audio, dt), jnp.asarray(sw, dt))
    tg = JointLateClusterSoftStyle4_G(**SMALL, **TB)
    load_flax_state(tg, params, stats)
    with torch.no_grad():
        p = tg.eval()([torch.from_numpy(audio).bfloat16()], None,
                      torch.from_numpy(sw).bfloat16())
    for key in ("pose", "labels_score", "labels_cap_soft"):
        assert p[key].dtype == torch.bfloat16, key
        dp, dq, ok = bf16_rule(as_np(p[key]), as_np(out["q"][key]),
                               as_np(out["r"][key]))
        assert ok, (key, dp, dq)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_follows_flax_bf16(train):
    y = bf16_values(np.random.default_rng(13).normal(size=(4, 64, 12))
                    .astype(np.float32))
    j32, j16 = JaxD(in_channels=12), JaxD(in_channels=12, **BF)
    params, stats = flax_variables(j32, jnp.asarray(y), train=False, seed=14)
    r, q = (as_np(_flax_call(m, params, stats, jnp.asarray(y, dt), train,
                             train=train)[0])
            for m, dt in ((j32, jnp.float32), (j16, jnp.bfloat16)))
    td = Speech2Gesture_D(in_channels=12, **TB)
    load_flax_state(td, params, stats)
    with torch.no_grad():
        p = td.train(train)(torch.from_numpy(y).bfloat16())[0]
    assert p.dtype == torch.bfloat16
    dp, dq, ok = bf16_rule(as_np(p), q, r)
    assert ok, (dp, dq)
