"""Train state, optimizer and learning-rate schedules.

Counterpart of ``mixstage_tpu/train/state.py``.  The JAX package threads a
pytree of parameters through pure step functions; here the state holds the
modules themselves (the G side: ``gen`` + ``psenc``; the D side: ``disc``),
their optimizers and the four host counters, and the steps update it in
place.

The optimizer is optax's ``chain(clip_by_global_norm(1.0), adam(lr))``
ported rule for rule, on PyTorch's multi-tensor (``_foreach``) ops:

* the clip (max norm 1) sees the global norm over ALL of the optimizer's
  leaves and scales by ``1 / norm`` only when ``norm ≥ 1``, with no
  ``+1e-6`` (so ``torch.nn.utils.clip_grad_norm_`` is not used);
* Adam keeps optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) and
  its order of operations: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² +
  b2·nu``, ``u = mu_hat / (sqrt(nu_hat) + eps)``, bias
  corrections ``1 - b^count`` in float32;
* the learning rate is the schedule at the count BEFORE the update.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


def _f32(v) -> float:
    """``v`` rounded to float32 (the JAX package computes these scalars on
    device in float32)."""
    return float(torch.tensor(v, dtype=torch.float32))


class ClippedAdam:
    """Global-norm clip at ``MAX_NORM`` then Adam, over a fixed list of named
    parameters.

    ``step(grads)`` updates the parameters, ``mu``, ``nu`` and ``count`` in
    place.  ``mu`` / ``nu`` are lists aligned with ``names``."""

    MAX_NORM = 1.0          # the reference clips G and D to 1 (both steps)

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 lr: float = 1e-4, schedule: Optional[Schedule] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr, self.schedule = lr, schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self) -> float:
        """The rate of the next update (schedule at the current count)."""
        return self.schedule(self.count) if self.schedule else self.lr

    @torch.no_grad()
    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax ``clip_by_global_norm(1.0)``: ``g / norm`` when ``norm ≥
        1``, else ``g`` unchanged (optax's ``· max_norm`` is ``· 1``, exact),
        with no host sync.  The per-leaf norms come from one multi-tensor
        launch."""
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        return torch._foreach_div(grads, norm.clamp_min(self.MAX_NORM))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        grads = self.clip(grads)
        rate = self.learning_rate()
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        self.count += 1
        c = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c)
        nu_hat = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, nu_hat)
        torch._foreach_mul_(upd, -_f32(rate))
        torch._foreach_add_(self.params, upd)


def translate_optim_kwargs(kwargs: dict) -> dict:
    """torch optimizer kwargs → optax names: ``betas=(b1, b2)`` → b1/b2."""
    out = dict(kwargs)
    if "betas" in out:
        b1, b2 = out.pop("betas")
        out.update(b1=b1, b2=b2)
    return out


def make_optimizer(name: str, lr: float, schedule: Optional[Schedule] = None,
                   **kwargs) -> Callable[[Sequence[Tuple[str, torch.Tensor]]],
                                         ClippedAdam]:
    """A constructor ``named_params → optimizer`` (``state.py:57-87``) with
    the clip every caller of the JAX package asks for.  Adam only: the other
    optimizers of the JAX package are not ported."""
    if name != "Adam":
        raise NotImplementedError(
            f"optimizer {name!r}: the port has Adam only (the others wait "
            f"for a later slice, ROADMAP queue 1)")
    return partial(ClippedAdam, lr=lr, schedule=schedule, **kwargs)


def make_schedule(kind: Optional[str], lr: float, gamma: float,
                  warmup_steps: int, total_steps: int,
                  steps_per_epoch: int) -> Schedule:
    """Learning-rate schedules (``state.py:90-113``), evaluated in float32:
    ``'linear_decay'`` (linear warm-up, then linear decay per step), else
    the per-epoch exponential ``lr · gamma^floor(step / steps_per_epoch)``.
    """
    f32 = partial(torch.tensor, dtype=torch.float32)
    if kind == "linear_decay":
        def sched(step: int) -> float:
            s = f32(step)
            warm = s / max(warmup_steps, 1)
            decay = torch.clamp_min(
                (total_steps - s) / max(total_steps - warmup_steps, 1), 0.0)
            return float(lr * torch.where(s < warmup_steps, warm, decay))
        return sched

    def sched(step: int) -> float:
        epoch = torch.floor(f32(step) / max(steps_per_epoch, 1))
        return float(lr * f32(gamma) ** epoch)
    return sched


@dataclasses.dataclass
class TrainState:
    """The G side (``gen`` and the pose-style encoder ``psenc``), the D side
    (``disc``), their optimizers and the counters."""

    gen: nn.Module
    psenc: nn.Module
    disc: nn.Module
    g_opt: ClippedAdam
    d_opt: ClippedAdam
    step: int = 0
    g_step: int = 0
    lambda_step: int = 0
    curriculum_step: int = 0


def g_named_parameters(gen: nn.Module, psenc: nn.Module
                       ) -> List[Tuple[str, torch.Tensor]]:
    """G's leaves as the G optimizer sees them: ``gen.*`` then ``psenc.*``
    (one global norm over both, as ``g_tx`` clips)."""
    return [("gen." + n, p) for n, p in gen.named_parameters()] + \
        [("psenc." + n, p) for n, p in psenc.named_parameters()]
