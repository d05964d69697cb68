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


def random_tree(shapes, rng, dtype=np.float32):
    return {k: random_tree(v, rng, dtype) if hasattr(v, "items")
            else _draw(rng, k, v.shape).astype(dtype)
            for k, v in shapes.items()}


def flax_variables(module, *args, seed: int = 0, dtype=np.float32,
                   **kwargs):
    """(params, batch_stats) numpy trees for ``module.init(*args)``, in
    ``dtype`` (np.float64 for the JAX package's float64 modules: the same
    draws, not rounded to float32)."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        *args, **kwargs))
    rng = np.random.default_rng(seed)
    return (random_tree(shapes["params"], rng, dtype),
            random_tree(shapes.get("batch_stats", {}), rng, dtype))


def jax_train_state(f, batch, seed: int = 1, dtype=np.float32):
    """A JAX ``TrainState`` for the JAX ``StepFactory`` ``f`` of any model
    family (style generator + psenc, classifier, simple generator; D when
    it has one), its trees drawn by ``flax_variables`` from ``seed`` and
    the optimizer states initialised by ``f``'s transformations."""
    from mixstage_tpu.train.state import TrainState

    cfg = f.cfg
    x, y = list(batch["x"]), batch["y"]
    Bn, Tn = y.shape[:2]
    if cfg.has_style:
        gp, gs = flax_variables(
            f.gen, x, y, jnp.zeros((Bn, Tn, cfg.num_speakers)),
            input_modalities=list(cfg.input_modalities),
            use_pose_input=False, train=False, seed=seed, dtype=dtype)
        pp, ps = flax_variables(f.psenc, y, train=False, seed=seed + 1,
                                dtype=dtype)
        g_params, g_state = {"gen": gp, "psenc": pp}, {"gen": gs,
                                                       "psenc": ps}
    elif cfg.is_classifier:
        gp, gs = flax_variables(f.gen, y, None, train=False, seed=seed,
                                dtype=dtype)
        g_params, g_state = {"gen": gp}, {"gen": gs}
    else:
        gp, gs = flax_variables(f.gen, f._fuse_inputs(x), y, train=False,
                                seed=seed, dtype=dtype)
        g_params, g_state = {"gen": gp}, {"gen": gs}
    kw = {}
    if f.disc is not None:
        dp, ds = flax_variables(f.disc, f._d_input(y, x), train=False,
                                seed=seed + 2, dtype=dtype)
        kw = dict(d_params=dp, d_state=ds, d_opt_state=f.d_tx.init(dp))
    return TrainState(g_params=g_params, g_state=g_state,
                      g_opt_state=f.g_tx.init(g_params), **kw)


def port_state(factory, jstate):
    """The port's state carrying a JAX ``TrainState`` (the weight bridge's
    ``load_jax_train_state``)."""
    from mixstage_tpu_torch.interop.weights import load_jax_train_state

    return load_jax_train_state(factory, jstate)


def flat_tree(tree, prefix=""):
    """A nested tree as {"a/b/leaf": float64 array}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(jnp.asarray(v).astype(jnp.float32)
                                         if str(getattr(v, "dtype", "")) ==
                                         "bfloat16" else v, np.float64)
    return out


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



# ---------------------------------------------------------------------------
# K1's and K2's wgmma arithmetic (csrc/fused_decoder_wgmma.cu), emulated on
# the CPU
# ---------------------------------------------------------------------------

GROUP_CHUNKS = 4          # kGroupChunks: 16-channel chunks per partial, most
# the products x_i w_j of the f32 mode, small ones first (the bf16 mode's
# features are one term: its products are those with i = 0)
SIX = [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]


def terms(v):
    """The three bf16 terms of ``v`` as float32 (exact)."""
    from mixstage_tpu_torch.ops.cuda.fused_conv import split_bf16x3
    return [t.float() for t in split_bf16x3(v)]


def emulated_layer(h, w, bias, products, group_chunks):
    """One layer as the kernel sums it: h (B, T, cin) float32, w (taps,
    cin, cout) float32.  Both split in three bf16 terms; per 16-channel
    chunk (tap by tap) the products x_i w_j of ``products`` (pairs (i, j),
    small ones first), exact in float32, summed by float32 matmuls; each
    group of ``group_chunks`` chunks into a zeroed partial added to the
    accumulator."""
    import torch.nn.functional as F

    taps, cin, cout = w.shape
    nk = -(-cin // 16)
    hp = F.pad(h, (0, 16 * nk - cin))
    if taps == 3:            # rows t-1, t, t+1 with zeros past each end
        zero = hp.new_zeros(hp.shape[0], 1, hp.shape[2])
        shifted = (torch.cat([zero, hp[:, :-1]], 1), hp,
                   torch.cat([hp[:, 1:], zero], 1))
    else:
        shifted = (hp,)
    xk = terms(torch.cat(shifted, dim=-1).reshape(-1, taps * 16 * nk))
    wk = [F.pad(t, (0, 0, 0, 16 * nk - cin)).reshape(-1, cout)
          for t in terms(w)]
    acc = torch.zeros(xk[0].shape[0], cout)
    for k0 in range(0, taps * nk, group_chunks):
        part = torch.zeros_like(acc)
        for c in range(k0, min(k0 + group_chunks, taps * nk)):
            ks = slice(16 * c, 16 * c + 16)
            for i, j in products:
                part = part + xk[i][:, ks] @ wk[j][ks]
        acc = acc + part
    return (acc + bias).reshape(h.shape[0], h.shape[1], cout)


def emulated_decoder(a, groups, products=SIX, group_chunks=GROUP_CHUNKS,
                     negative_slope=0.2):
    """K1's f32 mode on the folded decoder ``a`` (torch tensors: x, w0, wc,
    biases, w_logits, b_logits)."""
    outs = []
    for g in range(groups):
        h = a["x"]
        for layer in range(a["wc"].shape[0] + 1):
            w = a["w0"][g] if layer == 0 else a["wc"][layer - 1, g]
            v = emulated_layer(h, w, a["biases"][g, layer], products,
                               group_chunks)
            h = torch.where(v >= 0, v, negative_slope * v)
        outs.append(emulated_layer(h, a["w_logits"][g][None],
                                   a["b_logits"][g], products, group_chunks))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# the bf16 rule: how a bf16 output is held to a reference bf16 output
# ---------------------------------------------------------------------------

# Two valid bf16 roundings of one computation differ about as much as either
# differs from the float32 truth, so no bf16 output is held element-wise to
# another.  The port's bf16 output P and the reference's Q each drift from
# the truth R (the same function in float32 on the same inputs and
# weights): |drift(P) - drift(Q)| <= 0.10 * drift(Q) + 1e-3.  The rule is
# two-sided: it fails a port that rounds too little as well as too much.
BF16_REL, BF16_ABS = 0.10, 1e-3


def drift(out, truth, frobenius: bool = False) -> float:
    """mean |out - truth| / mean |truth|, or the relative Frobenius error
    (for gradients), in float64."""
    out = np.asarray(out, np.float64)
    truth = np.asarray(truth, np.float64)
    if frobenius:
        return float(np.linalg.norm(out - truth)
                     / max(np.linalg.norm(truth), 1e-30))
    return float(np.abs(out - truth).mean() / np.abs(truth).mean())


def bf16_rule(p, q, truth, frobenius: bool = False):
    """(drift(p), drift(q), whether p meets the bf16 rule against q)."""
    dp, dq = drift(p, truth, frobenius), drift(q, truth, frobenius)
    return dp, dq, abs(dp - dq) <= BF16_REL * dq + BF16_ABS


def as_np(t) -> np.ndarray:
    """A torch or JAX array (bf16 included) as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def bf16_values(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bfloat16 and back: inputs both dtypes read alike."""
    return as_np(torch.from_numpy(np.ascontiguousarray(a)).bfloat16())


def jax_nominal(fn, *args):
    """``fn(*args)`` compiled with XLA's excess precision off, so every bf16
    operation rounds where the JAX source rounds (flax's rounding points).
    XLA's default on the CPU keeps float32 between the bf16 operations it
    fuses: a compiler-dependent function that rounds less (a bf16 eval
    forward of the small generator drifts 0.0050 from float32 with it, 0.0057
    without; the port, eager, 0.0057)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# ---------------------------------------------------------------------------
# A Disentangle generator in both packages (``tests/test_disentangle.py``'s)
# ---------------------------------------------------------------------------

from flax import linen as _nn                                  # noqa: E402

from mixstage_tpu.models import registry as jreg               # noqa: E402
from mixstage_tpu.models.mix_stage import \
    JointLateClusterSoftStyle4_G as JaxG                       # noqa: E402
from mixstage_tpu_torch.models import \
    JointLateClusterSoftStyle4_G                               # noqa: E402
from mixstage_tpu_torch.models.registry import \
    DISENTANGLE_INTERNAL_LOSSES as INTERNAL                    # noqa: E402


class JaxDisentangle(JaxG):
    """``tests/test_disentangle.py``'s generator."""

    style_losses: tuple = ()

    def __call__(self, x_list, y, style_weights, input_modalities,
                 use_pose_input=False, time_steps=None, train=True):
        out = super().__call__(x_list, y, style_weights, input_modalities,
                               use_pose_input=use_pose_input,
                               time_steps=time_steps, train=train)
        w = dict(self.style_losses)
        pose, score = out["pose"], out["labels_score"]
        losses = {}
        for i, name in enumerate(jreg.DISENTANGLE_INTERNAL_LOSSES):
            if name == "H":
                p = _nn.softmax(score, axis=-1)
                losses["H"] = -(p * jnp.log(p + 1e-8)).sum(-1).mean()
            else:
                losses[name] = w.get(name, 1.0) * \
                    jnp.abs(pose).mean() * (i + 1) / 100.0
        out["internal_losses"] = losses
        return out


class PortDisentangle(JointLateClusterSoftStyle4_G):
    """The same generator in the port."""

    def __init__(self, style_losses=(), **kw):
        super().__init__(**kw)
        self.style_losses = dict(style_losses)

    def forward(self, x_list, y, style_weights,
                input_modalities=("audio/log_mel_512",),
                use_pose_input=False, time_steps=None):
        out = super().forward(x_list, y, style_weights, input_modalities,
                              use_pose_input, time_steps)
        pose, score = out["pose"], out["labels_score"]
        losses = {}
        for i, name in enumerate(INTERNAL):
            if name == "H":
                p = torch.softmax(score, dim=-1)
                losses["H"] = -(p * torch.log(p + 1e-8)).sum(-1).mean()
            else:
                losses[name] = self.style_losses.get(name, 1.0) * \
                    pose.abs().mean() * (i + 1) / 100.0
        out["internal_losses"] = losses
        return out


def record_steps(trainer, log):
    """Wrap a trainer's steps: log (kind, use_pose_input, batch without x,
    scalar losses) per call."""
    def scalars(losses):
        return {k: float(np.asarray(v.float() if torch.is_tensor(v) else v))
                for k, v in losses.items() if np.ndim(v) == 0}

    for kind in ("g", "d", "eval"):
        fn = trainer.steps[kind]

        def wrapped(state, batch, *a, _fn=fn, _kind=kind, **kw):
            out = _fn(state, batch, *a, **kw)
            losses = out[0] if _kind == "eval" else out[1]
            log.append((_kind, kw.get("use_pose_input", False),
                        {k: np.asarray(v) for k, v in batch.items()
                         if k != "x"}, scalars(losses)))
            return out
        trainer.steps[kind] = wrapped
