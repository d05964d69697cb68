"""Loss registry and GAN loss helpers.

Counterpart of ``mixstage_tpu/train/losses.py``: the four criteria with
their construction kwargs, the per-sample weighted mean, cross-entropy,
pose velocity, the GAN λ ramp and the weighted GAN's adaptive D/G coin.
Criteria return elementwise losses; reduction is structural in the step
functions.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F


def mse(y_cap, y):
    return (y_cap - y) ** 2


def l1(y_cap, y):
    return (y_cap - y).abs()


def smooth_l1(y_cap, y, beta: float = 1.0):
    d = (y_cap - y).abs()
    return torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta)


def huber(y_cap, y, delta: float = 1.0):
    """torch ``nn.HuberLoss`` semantics: quadratic below ``delta``, then
    ``delta·(|d| - delta/2)``."""
    d = (y_cap - y).abs()
    return torch.where(d < delta, 0.5 * d ** 2, delta * (d - 0.5 * delta))


CRITERIA: Dict[str, Callable] = {
    "MSELoss": mse,
    "L1Loss": l1,
    "SmoothL1Loss": smooth_l1,
    "HuberLoss": huber,
}


def get_criterion(name: str, **kwargs) -> Callable:
    """Criterion lookup with torch-style construction kwargs (e.g.
    ``beta=0.5`` for SmoothL1Loss); ``reduction`` is dropped."""
    if name not in CRITERIA:
        raise KeyError(f"loss {name!r} not in registry; known: "
                       f"{sorted(CRITERIA)}")
    kwargs.pop("reduction", None)
    fn = CRITERIA[name]
    return partial(fn, **kwargs) if kwargs else fn


def sample_wise_weight_mean(loss, w):
    """Per-sample weighted mean: ``w`` (B,) broadcast over trailing dims."""
    w = w.reshape((w.shape[0],) + (1,) * (loss.ndim - 1))
    return (w * loss).mean()


def log_softmax(x, dim: int = -1):
    """``jax.nn.log_softmax``: at float32 ``F.log_softmax``; below it JAX's
    steps (shift by the max, exp, sum, log, subtract), each rounded to
    ``x.dtype``."""
    if x.dtype == torch.float32:
        return F.log_softmax(x, dim=dim)
    shifted = x - x.amax(dim=dim, keepdim=True).detach()
    return shifted - torch.exp(shifted).sum(dim=dim, keepdim=True).log()


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy with integer labels.  A label outside
    [0, classes) picks NaN, as ``jnp.take_along_axis`` fills an
    out-of-bounds gather (``-pos`` tags past ``num_clusters``), so the loss
    is NaN where the JAX package's is."""
    logp = log_softmax(logits, dim=-1)
    idx = labels.long()
    inside = (idx >= 0) & (idx < logp.shape[-1])
    picked = logp.gather(-1, idx.clamp(0, logp.shape[-1] - 1)[..., None])
    picked = torch.where(inside, picked[..., 0], float("nan"))
    return -picked.mean()


def velocity(x):
    """Pose → velocity with a zero first frame."""
    v = x[..., 1:, :] - x[..., :-1, :]
    return torch.cat([torch.zeros_like(x[..., 0:1, :]), v], dim=-2)


def lambda_schedule(step: int, init_lambda: float, max_lambda: float = 2.0,
                    max_interval: int = 300,
                    dtype: torch.dtype = torch.float32) -> float:
    """GAN loss-weight ramp: linear from ``init_lambda`` to ``max_lambda``
    over ``max_interval`` steps, then held.  ``step`` is a host counter, so
    the ramp is a host float, evaluated in float32 as the JAX package does
    on device (in ``dtype=torch.float64`` for its x64 mode, where JAX's
    ``step / max_interval`` is float64)."""
    frac = torch.tensor(step, dtype=dtype) / max_interval
    frac = frac.clamp(0.0, 1.0)
    return float(init_lambda + (max_lambda - init_lambda) * frac)


def adaptive_d_prob(d_prob: float, W, dg_iter_ratio: float = 1.0,
                    ema: float = 0.9, lo: float = 0.05,
                    hi: float = 0.95) -> float:
    """The D/G coin probability adapted from the weighted GAN's sample
    weights (``-update_D_prob_flag``, ``losses.py:96-118``): W = 1/p_real,
    so a high mean W says the discriminator is unconvinced by real samples
    and should train more often.  The effective iteration ratio becomes
    ``r·mean(W)``, the target probability ``r'/(r'+1)``, blended into the
    old one by an EMA and clipped to [lo, hi].  Host float math."""
    w_mean = float(np.mean(np.asarray(W, np.float64)))
    if not np.isfinite(w_mean) or w_mean <= 0:
        return d_prob
    r_eff = dg_iter_ratio * w_mean
    target = r_eff / (r_eff + 1.0)
    return float(np.clip(ema * d_prob + (1.0 - ema) * target, lo, hi))
