"""Shared set-up of the PyTorch port's parity tests.

Small Mix-StAGE configurations whose flax variable trees are drawn with
numpy from a seed: ``jax.eval_shape`` gives the tree of the JAX module
without running flax's (slow, op-by-op) init, and every leaf is then drawn
at a realistic scale — including RANDOM BatchNorm running statistics, so BN
folding is far from a no-op.  The same numpy arrays load into the port
through ``mixstage_tpu_torch.interop.load_flax_state``.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)    # the suite runs several workers side by side

# the small flagship configuration of the port tests
SMALL = dict(num_clusters=2, num_speakers=2, in_channels=64)
B, T, MEL, FEATS = 2, 64, 32, 96
MODALITIES = ("audio/log_mel_512",)


def _draw(rng, leaf: str, shape):
    if leaf == "kernel":
        return rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
    if leaf == "scale":
        return rng.uniform(0.5, 1.5, size=shape)
    if leaf == "var":
        return rng.uniform(0.5, 2.0, size=shape)
    if leaf == "mean":
        return rng.normal(0.0, 0.2, size=shape)
    if leaf == "embedding":
        return rng.normal(size=shape)
    return rng.normal(0.0, 0.1, size=shape)       # biases


def random_tree(shapes, rng):
    return {k: random_tree(v, rng) if hasattr(v, "items")
            else _draw(rng, k, v.shape).astype(np.float32)
            for k, v in shapes.items()}


def flax_variables(module, *args, seed: int = 0, **kwargs):
    """(params, batch_stats) numpy trees for ``module.init(*args)``."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        *args, **kwargs))
    rng = np.random.default_rng(seed)
    return (random_tree(shapes["params"], rng),
            random_tree(shapes.get("batch_stats", {}), rng))


def jax_apply(module, params, stats, *args, **kwargs):
    out = module.apply({"params": params, "batch_stats": stats}, *args,
                       **kwargs)
    return jax.tree.map(np.asarray, out)


def small_generators(seed: int = 0, mel: int = MEL):
    """The small JointLateClusterSoftStyle4_G in both packages, carrying the
    same random weights: (jax_module, params, stats, port_module)."""
    from mixstage_tpu.models.mix_stage import \
        JointLateClusterSoftStyle4_G as JaxG
    from mixstage_tpu_torch.interop import load_flax_state
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G

    jg = JaxG(**SMALL)
    params, stats = flax_variables(
        jg, [jnp.zeros((B, T, mel))], jnp.zeros((B, T, FEATS)),
        jnp.zeros((B, T, SMALL["num_speakers"])),
        input_modalities=list(MODALITIES), use_pose_input=False,
        train=False, seed=seed)
    tg = JointLateClusterSoftStyle4_G(**SMALL)
    load_flax_state(tg, params, stats)
    return jg, params, stats, tg.eval()


def jax_serving_factory(jg, params, stats):
    """The (factory, state) pair JAX ``build_serving_fn`` reads: ``cfg``,
    ``gen`` and the generator's param / batch-stat trees."""
    from mixstage_tpu.train.steps import StepConfig

    cfg = StepConfig(model="JointLateClusterSoftStyle4_G",
                     num_clusters=SMALL["num_clusters"],
                     num_speakers=SMALL["num_speakers"],
                     input_modalities=MODALITIES)
    factory = types.SimpleNamespace(cfg=cfg, gen=jg)
    state = types.SimpleNamespace(g_params={"gen": params},
                                  g_state={"gen": stats})
    return factory, state


def style_rows(kind: str, seed: int = 0):
    """(B, S) style weights: one-hot hard ids or random soft mixtures."""
    rng = np.random.default_rng(seed)
    S = SMALL["num_speakers"]
    if kind == "hard":
        return np.eye(S, dtype=np.float32)[rng.integers(0, S, size=B)]
    w = rng.uniform(size=(B, S)).astype(np.float32)
    return w / w.sum(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# 3xTF32: the tensor-core arithmetic of K1 and K3, emulated on the CPU
# ---------------------------------------------------------------------------

def tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, to nearest, ties
    away from zero (on the magnitude's bits; finite inputs)."""
    bits = v.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(v):
    """The 3xTF32 split: v = hi + lo, both TF32 values."""
    hi = tf32(v)
    return hi, tf32(v - hi)


def product(a, b, passes: int):
    """a @ b as the tensor cores take it: 3 passes (3xTF32: the small terms
    first, f32 sums; each product of two TF32 values is exact in f32) or 1
    (plain TF32)."""
    (ah, al), (bh, bl) = split(a), split(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh

