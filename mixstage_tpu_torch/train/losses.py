"""Loss registry and GAN loss helpers.

Counterpart of ``mixstage_tpu/train/losses.py``: the four criteria with
their construction kwargs, the per-sample weighted mean, cross-entropy,
pose velocity and the GAN λ ramp.  Criteria return elementwise losses;
reduction is structural in the step functions.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

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


def cross_entropy(logits, labels):
    """Mean softmax cross-entropy with integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def velocity(x):
    """Pose → velocity with a zero first frame."""
    v = x[..., 1:, :] - x[..., :-1, :]
    return torch.cat([torch.zeros_like(x[..., 0:1, :]), v], dim=-2)


def lambda_schedule(step: int, init_lambda: float, max_lambda: float = 2.0,
                    max_interval: int = 300) -> float:
    """GAN loss-weight ramp: linear from ``init_lambda`` to ``max_lambda``
    over ``max_interval`` steps, then held.  ``step`` is a host counter, so
    the ramp is a host float (evaluated in float32, as the JAX package
    does on device)."""
    frac = torch.tensor(step, dtype=torch.float32) / max_interval
    frac = frac.clamp(0.0, 1.0)
    return float(init_lambda + (max_lambda - init_lambda) * frac)
