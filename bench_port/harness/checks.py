"""The comparisons that decide ``correct``, and the precision switch of the
reference and of its control.

Training is compared leaf by leaf by the gap between two norms: the
program's norm of a leaf's quantity against the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger
(some gradients are all but zero).  Leaves whose reference gradient is
under a thousandth of the median parameter's (of its optimizer) are
left out: a conv bias in front of a train-mode BatchNorm has a gradient of
rounding alone, and Adam turns rounding into a full-size step.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Optional, Tuple

import torch

NEGLIGIBLE = 1e-3


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 convolutions and matmuls in full float32 (``tf32=False``,
    the configurations' precision), or in TF32 (the control)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.backends.cuda.matmul.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def rel_fro(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def moving_leaves(ref_grads: Dict[str, torch.Tensor],
                  groups: Iterable[Tuple[str, ...]]) -> set:
    """Names of the parameters whose reference gradient is at least a
    thousandth of its group's median (a group: the leaves of one
    optimizer, by their name prefixes)."""
    keep = set()
    for g in groups:
        norms = {k: float(v.double().norm()) for k, v in ref_grads.items()
                 if k.startswith(g)}
        med = _median(list(norms.values()))
        keep |= {k for k, n in norms.items() if n >= NEGLIGIBLE * med and
                 n > 0}
    return keep


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: Iterable[str]) -> Tuple[float, Optional[str]]:
    """The worst leaf's | ‖prog‖ − ‖ref‖ | / max(‖ref‖, median ‖ref‖)
    over ``names``, and its name."""
    names = sorted(names)
    rn = {k: float(ref[k].double().norm()) for k in names}
    pn = {k: float(prog[k].double().norm()) for k in names}
    med = _median(list(rn.values()))
    worst, at = 0.0, None
    for k in names:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]
            ) -> Tuple[bool, Dict[str, dict]]:
    """correct when every number is finite and at most its limit; the
    numbers beside their limits."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]["limit"]
        ok &= math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
