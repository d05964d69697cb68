"""Train state, optimizers and learning-rate schedules.

Counterpart of ``mixstage_tpu/train/state.py``.  The JAX package threads a
pytree of parameters through pure step functions; here the state holds the
modules themselves (the G side: ``gen`` and, for the style models,
``psenc``; the D side: ``disc`` when the config trains a GAN), their
optimizers and the four host counters, and the steps update it in place.

Each optimizer is optax's ``chain(clip_by_global_norm(1.0), <optimizer>)``
ported rule for rule, on PyTorch's multi-tensor (``_foreach``) ops (optax
semantics, not ``torch.optim``'s):

* the clip (max norm 1) sees the global norm over ALL of the optimizer's
  leaves and scales by ``1 / norm`` only when ``norm ≥ 1``, with no
  ``+1e-6`` (so ``torch.nn.utils.clip_grad_norm_`` is not used);
* ``Adam`` (``optax.adam``): b1 0.9, b2 0.999, eps 1e-8, eps_root 0, in
  optax's order: ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``,
  ``u = mu_hat / (sqrt(nu_hat) + eps)``, bias corrections ``1 - b^count``
  (float32; float64 for float64 parameters).  ``mu_dtype`` (the
  ``optim_mu_dtype`` flag) stores ``mu`` in that dtype: the update is
  computed from the float32 ``mu``, which is then cast, as
  ``scale_by_adam(mu_dtype=...)`` does;
* ``AdamW`` (``optax.adamw``): Adam's update plus ``weight_decay · param``
  (default 1e-4, no mask), then scaled by ``-lr``;
* ``SGD`` (``optax.sgd``): no state without ``momentum`` (the default);
  with it the trace ``t = g + momentum·t`` (``nesterov``: ``g +
  momentum·t``) is the update;
* ``RMSprop`` (``optax.rmsprop``): ``nu = (1-decay)·g² + decay·nu`` from
  ``initial_scale`` 0, decay 0.9, the update ``g · rsqrt(nu + eps)`` (eps
  1e-8 inside the root; ``torch.optim.RMSprop``'s α 0.99 and ``g /
  (sqrt(v) + eps)`` compute something else), scaled by ``-lr``, then the
  optional momentum trace; ``centered`` subtracts the squared running
  mean ``mu`` of the gradients, ``bias_correction`` divides the moments
  by ``1 - decay^count``;
* the learning rate is the schedule at the count BEFORE the update;
* an update has a host half and a device half: ``advance`` moves the
  count and computes each step-dependent scalar (the rate, the bias
  corrections) on the host as before, in float32 arithmetic (float64 for
  float64 parameters), and puts it into a 0-d device tensor kept for the
  optimizer's life (``scalars``); ``update`` (the clip, then ``apply``)
  reads those tensors through the tensor-scalar ``_foreach`` overloads, so
  a CUDA graph that captured it reads each step's values.  A float32 value
  in a float32 tensor gives the same products and quotients as the
  host float; ``step`` is both halves;
* ``text_lr`` (the ``-optim_separate`` flag) is optax's ``multi_transform``
  behind the one clip (``SeparateTextOptimizer``): every parameter under a
  module named ``text_encoder`` runs the same rule at the constant
  ``text_lr``, the rest at the learning rate or the schedule, each group
  with its own moments and count.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


def _f32(v) -> float:
    """``v`` rounded to float32 (the JAX package computes these scalars on
    device in float32)."""
    return float(torch.tensor(v, dtype=torch.float32))


def _dtype(name) -> Optional[torch.dtype]:
    """``None``, a torch dtype or its name ("bfloat16") → a torch dtype."""
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _scalar_in(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``."""
    return float(torch.tensor(v, dtype=dtype))


class ClippedOptimizer:
    """Global-norm clip at ``MAX_NORM``, then one optax update rule, over a
    fixed list of named parameters.

    ``step(grads)`` updates the parameters, the rule's state tensors (the
    lists named by ``SLOTS``, aligned with ``names``) and ``count`` in
    place: ``advance()`` (host), then ``update(grads)`` (device).  A
    subclass gives ``SLOTS``, ``_direction(grads)`` (the update before the
    learning rate scales it) and, where its rule has step-dependent
    scalars, ``_advance()``."""

    MAX_NORM = 1.0          # the reference clips G and D to 1 (both steps)
    SLOTS: Tuple[str, ...] = ()
    # (mask over params, model group) once the mixture decoder's experts
    # are split over ranks (parallel/mesh.py::shard_state_mixture)
    expert_norm = None

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 lr: float = 1e-4, schedule: Optional[Schedule] = None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr, self.schedule = lr, schedule
        self.count = 0
        # float64 parameters (the parity mode) take float64 scalars, as
        # optax does under x64; otherwise the float32 ones of the JAX
        # package's device computation
        self.f64 = any(p.dtype == torch.float64 for p in self.params)
        # the step scalars' device tensors by name, made at first use
        self.scalars: Dict[str, torch.Tensor] = {}

    def slots(self) -> Dict[str, List[torch.Tensor]]:
        """The rule's state tensors by optax field name (``mu``, ``nu``,
        ``trace``)."""
        return {s: getattr(self, s) for s in self.SLOTS}

    def learning_rate(self) -> float:
        """The rate of the next update (schedule at the current count)."""
        return self.schedule(self.count) if self.schedule else self.lr

    def _scalar(self, v) -> float:
        return float(v) if self.f64 else _f32(v)

    def device_tensors(self) -> List[torch.Tensor]:
        """Every tensor an update reads or writes besides the gradients:
        the parameters, the rule's state and the step scalars."""
        return self.params + [t for ts in self.slots().values()
                              for t in ts] + list(self.scalars.values())

    def _put(self, name: str, value: float) -> None:
        """``value`` into the step scalar ``name``: a 0-d float32 (float64)
        tensor on the parameters' device, made at first use."""
        slot = self.scalars.get(name)
        if slot is None:
            slot = self.scalars[name] = torch.zeros(
                (), dtype=torch.float64 if self.f64 else torch.float32,
                device=self.params[0].device)
        slot.fill_(value)

    def advance(self) -> None:
        """The host half of one update: the rate at the count before it,
        the count, then the rule's own scalars (``_advance``), each put
        into its step scalar."""
        rate = self.learning_rate()
        self.count += 1
        self._put("neg_rate", -self._scalar(rate))
        self._advance()

    def _advance(self) -> None:
        """The rule's step-dependent scalars (Adam's bias corrections)."""

    def _direction(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One whole update: ``advance``, then ``update``."""
        self.advance()
        self.update(grads)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """The device half of one update, after ``advance``: the clip, then
        ``apply``; it reads no host value that changes from step to step."""
        self.apply(clip_by_global_norm(_checked(grads, self.params),
                                       self.MAX_NORM, self.expert_norm))

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor]) -> None:
        """One update from already clipped gradients, with the step
        scalars of the last ``advance``."""
        upd = self._direction(grads)
        torch._foreach_mul_(upd, self.scalars["neg_rate"])
        self._after_rate(upd)
        torch._foreach_add_(self.params, upd)

    def _after_rate(self, upd: List[torch.Tensor]) -> None:
        """A transformation after the learning rate (RMSprop's momentum)."""


def _checked(grads, params) -> List[torch.Tensor]:
    grads = list(grads)
    if len(grads) != len(params):
        raise ValueError(f"{len(grads)} gradients for {len(params)} "
                         f"parameters")
    return grads


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        expert_norm=None) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm(max_norm)`` at ``max_norm`` 1: ``g /
    norm`` when ``norm ≥ 1``, else ``g`` unchanged (optax's ``· max_norm``
    is ``· 1``, exact), with no host sync.  The per-leaf norms come from
    one multi-tensor launch.  ``expert_norm`` (mask, model group): the
    masked leaves hold this rank's share of the experts, so their squares
    are summed over the model group, and every rank clips by the norm of
    the whole parameter set."""
    sq = torch.stack(torch._foreach_norm(grads)).square()
    if expert_norm is None:
        norm = sq.sum().sqrt()
    else:
        from mixstage_tpu_torch.parallel.mesh import all_reduce_

        mask = torch.tensor(expert_norm[0], device=sq.device)
        norm = (sq[~mask].sum() +
                all_reduce_(sq[mask].sum(), expert_norm[1])).sqrt()
    return torch._foreach_div(grads, norm.clamp_min(max_norm))


class ClippedAdam(ClippedOptimizer):
    """``optax.adam`` (``mu_dtype``: the first moment's storage dtype)."""

    SLOTS = ("mu", "nu")

    def __init__(self, named_params, lr: float = 1e-4,
                 schedule: Optional[Schedule] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mu_dtype=None):
        super().__init__(named_params, lr, schedule)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = _dtype(mu_dtype)
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _bias_correction(self, b: float) -> float:
        if self.f64:
            return 1.0 - b ** self.count
        c = torch.tensor(float(self.count), dtype=torch.float32)
        return float(1.0 - torch.tensor(b, dtype=torch.float32) ** c)

    def _advance(self):
        self._put("bc1", self._bias_correction(self.b1))
        self._put("bc2", self._bias_correction(self.b2))

    def _direction(self, grads):
        b1, b2 = self.b1, self.b2
        if self.mu_dtype is None:
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
            mu = self.mu
        else:
            # optax's update_moment on a bf16 mu: b1 (a weak-typed scalar)
            # becomes a bf16 constant, b1·mu rounds to bf16, the sum takes
            # the gradients' dtype; the update uses that sum, mu stores it
            # cast
            b1_mu = _scalar_in(b1, self.mu_dtype)
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(self.mu, b1_mu))
            torch._foreach_copy_(self.mu, mu)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        nu_hat = torch._foreach_div(self.nu, self.scalars["bc2"])
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        upd = torch._foreach_div(mu, self.scalars["bc1"])
        torch._foreach_div_(upd, nu_hat)
        return upd


class ClippedAdamW(ClippedAdam):
    """``optax.adamw``: Adam's update plus ``weight_decay · param``."""

    def __init__(self, named_params, lr: float = 1e-4,
                 schedule: Optional[Schedule] = None,
                 weight_decay: float = 1e-4, **adam):
        super().__init__(named_params, lr, schedule, **adam)
        self.weight_decay = weight_decay

    def _direction(self, grads):
        upd = super()._direction(grads)
        torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                    self.weight_decay))
        return upd


def _trace(trace: List[torch.Tensor], upd: List[torch.Tensor],
           momentum: float, nesterov: bool) -> List[torch.Tensor]:
    """optax ``trace``: ``t ← g + momentum·t`` in place; the update is
    ``t`` (``nesterov``: ``g + momentum·t``)."""
    torch._foreach_mul_(trace, momentum)
    torch._foreach_add_(trace, upd)
    if nesterov:
        return torch._foreach_add(upd, torch._foreach_mul(trace, momentum))
    return [t.clone() for t in trace]


class ClippedSGD(ClippedOptimizer):
    """``optax.sgd``: the gradient, or its momentum trace."""

    def __init__(self, named_params, lr: float = 1e-4,
                 schedule: Optional[Schedule] = None,
                 momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(named_params, lr, schedule)
        self.momentum, self.nesterov = momentum, nesterov
        if momentum is not None:
            self.SLOTS = ("trace",)
            self.trace = [torch.zeros_like(p) for p in self.params]

    def _direction(self, grads):
        if self.momentum is None:
            return grads
        return _trace(self.trace, grads, self.momentum, self.nesterov)


class ClippedRMSprop(ClippedOptimizer):
    """``optax.rmsprop`` (optax 0.2.6): ``scale_by_rms`` or, ``centered``,
    ``scale_by_stddev``, then the learning rate, then the optional
    momentum trace.  ``nu = (1-decay)·g² + decay·nu`` from
    ``initial_scale``; centered, also ``mu = (1-decay)·g + decay·mu`` from
    0 and the denominator ``nu - mu²``; ``bias_correction`` divides
    ``nu`` (and ``mu``) by ``1 - decay^count`` (float32, as optax's
    ``bias_correction``) before the root.  The update is ``g · rsqrt(den
    + eps)`` (``eps_in_sqrt``, the default) or ``g / (sqrt(den) +
    eps)``."""

    def __init__(self, named_params, lr: float = 1e-4,
                 schedule: Optional[Schedule] = None, decay: float = 0.9,
                 eps: float = 1e-8, initial_scale: float = 0.0,
                 eps_in_sqrt: bool = True, centered: bool = False,
                 momentum: Optional[float] = None, nesterov: bool = False,
                 bias_correction: bool = False):
        super().__init__(named_params, lr, schedule)
        self.decay, self.eps, self.eps_in_sqrt = decay, eps, eps_in_sqrt
        self.centered, self.bias_correction = centered, bias_correction
        self.momentum, self.nesterov = momentum, nesterov
        self.SLOTS = (("mu",) if centered else ()) + ("nu",) + \
            (("trace",) if momentum is not None else ())
        self.nu = [torch.full_like(p, initial_scale) for p in self.params]
        if centered:
            self.mu = [torch.zeros_like(p) for p in self.params]
        if momentum is not None:
            self.trace = [torch.zeros_like(p) for p in self.params]

    _bias_correction = ClippedAdam._bias_correction

    def _advance(self):
        if self.bias_correction:
            self._put("bc", self._bias_correction(self.decay))

    def _direction(self, grads):
        d = self.decay
        torch._foreach_mul_(self.nu, d)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - d))
        den = self.nu
        if self.centered:
            torch._foreach_mul_(self.mu, d)
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - d))
        bc = self.scalars.get("bc")
        if self.bias_correction:
            den = torch._foreach_div(self.nu, bc)
        if self.centered:
            mu = (torch._foreach_div(self.mu, bc) if self.bias_correction
                  else self.mu)
            den = torch._foreach_sub(den, torch._foreach_mul(mu, mu))
        if self.eps_in_sqrt:
            scale = torch._foreach_add(den, self.eps)
            torch._foreach_rsqrt_(scale)
        else:
            scale = torch._foreach_sqrt(den)
            torch._foreach_add_(scale, self.eps)
            torch._foreach_reciprocal_(scale)
        return torch._foreach_mul(scale, grads)

    def _after_rate(self, upd):
        if self.momentum is not None:
            new = _trace(self.trace, upd, self.momentum, self.nesterov)
            for dst, src in zip(upd, new):
                dst.copy_(src)


OPTIMIZERS = {"Adam": ClippedAdam, "AdamW": ClippedAdamW,
              "SGD": ClippedSGD, "RMSprop": ClippedRMSprop}

TEXT_MODULE = "text_encoder"


def is_text_leaf(name: str) -> bool:
    """A parameter under a module named ``text_encoder`` at any depth
    (``state.py:72-78``'s label function)."""
    return TEXT_MODULE in name.split(".")[:-1]


class SeparateTextOptimizer:
    """``chain(clip_by_global_norm(1), multi_transform({"text":
    rule(text_lr), "rest": rule(lr or schedule)}))`` (``state.py:71-87``).

    One global-norm clip over every leaf, then each group's rule on its own
    leaves (``groups``: two ``ClippedOptimizer`` objects, each with its moments
    and count; the text group at the constant ``text_lr``).  ``names``,
    ``params`` and ``slots()`` span both groups in the parameters' order,
    so checkpoints see one optimizer; ``count`` reads the rest group's and
    sets both."""

    MAX_NORM = ClippedOptimizer.MAX_NORM
    GROUPS = ("text", "rest")
    expert_norm = None

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 rule, lr: float, schedule: Optional[Schedule],
                 text_lr: float):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.index = {g: [i for i, n in enumerate(self.names)
                          if is_text_leaf(n) == (g == "text")]
                      for g in self.GROUPS}
        rates = {"text": dict(lr=text_lr, schedule=None),
                 "rest": dict(lr=lr, schedule=schedule)}
        self.groups = {g: rule([named[i] for i in self.index[g]], **rates[g])
                       for g in self.GROUPS}
        self.SLOTS = self.groups["rest"].SLOTS

    @property
    def count(self) -> int:
        return self.groups["rest"].count

    @count.setter
    def count(self, value: int) -> None:
        for opt in self.groups.values():
            opt.count = int(value)

    def learning_rate(self) -> float:
        return self.groups["rest"].learning_rate()

    def slots(self) -> Dict[str, List[torch.Tensor]]:
        out = {}
        for slot in self.SLOTS:
            tensors = [None] * len(self.names)
            for g, opt in self.groups.items():
                for i, t in zip(self.index[g], getattr(opt, slot)):
                    tensors[i] = t
            out[slot] = tensors
        return out

    def device_tensors(self) -> List[torch.Tensor]:
        return [t for opt in self.groups.values()
                for t in opt.device_tensors()]

    def advance(self) -> None:
        for opt in self.groups.values():
            if opt.params:
                opt.advance()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.advance()
        self.update(grads)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        grads = clip_by_global_norm(_checked(grads, self.params),
                                    self.MAX_NORM, self.expert_norm)
        for g, opt in self.groups.items():
            if opt.params:
                opt.apply([grads[i] for i in self.index[g]])


def translate_optim_kwargs(kwargs: dict) -> dict:
    """torch optimizer kwargs → optax names: ``betas=(b1, b2)`` → b1/b2."""
    out = dict(kwargs)
    if "betas" in out:
        b1, b2 = out.pop("betas")
        out.update(b1=b1, b2=b2)
    return out


def make_optimizer(name: str, lr: float, schedule: Optional[Schedule] = None,
                   text_lr: Optional[float] = None, **kwargs
                   ) -> Callable[[Sequence[Tuple[str, torch.Tensor]]],
                                 ClippedOptimizer]:
    """A constructor ``named_params → optimizer`` (``state.py:57-87``) with
    the clip every caller of the JAX package asks for; with ``text_lr`` a
    ``SeparateTextOptimizer``.  ``kwargs`` are the optax optimizer's (``translate_optim_kwargs``); an unknown one raises
    ``TypeError`` when the optimizer is built, as optax raises."""
    if name not in OPTIMIZERS:
        raise KeyError(f"optimizer {name!r} unknown; known: "
                       f"{sorted(OPTIMIZERS)}")
    if text_lr is not None:
        return partial(SeparateTextOptimizer,
                       rule=partial(OPTIMIZERS[name], **kwargs), lr=lr,
                       schedule=schedule, text_lr=text_lr)
    return partial(OPTIMIZERS[name], lr=lr, schedule=schedule, **kwargs)


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
    """The G side (``gen`` and, for the style models, the pose-style
    encoder ``psenc``), the D side (``disc``, None without a GAN), their
    optimizers and the counters."""

    gen: nn.Module
    psenc: Optional[nn.Module]
    disc: Optional[nn.Module]
    g_opt: ClippedOptimizer
    d_opt: Optional[ClippedOptimizer]
    step: int = 0
    g_step: int = 0
    lambda_step: int = 0
    curriculum_step: int = 0


def g_named_parameters(gen: nn.Module, psenc: Optional[nn.Module]
                       ) -> List[Tuple[str, torch.Tensor]]:
    """G's leaves as the G optimizer sees them: ``gen.*`` then ``psenc.*``
    (one global norm over both, as ``g_tx`` clips)."""
    out = [("gen." + n, p) for n, p in gen.named_parameters()]
    if psenc is not None:
        out += [("psenc." + n, p) for n, p in psenc.named_parameters()]
    return out


def tree_size(tree) -> int:
    """The number of elements of every array in ``tree`` (nested dicts,
    lists and tuples of tensors or arrays; a module's parameters)."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(tree_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size(v) for v in tree)
    if tree is None:
        return 0
    return int(tree.numel()) if torch.is_tensor(tree) else int(
        getattr(tree, "size", 1))
