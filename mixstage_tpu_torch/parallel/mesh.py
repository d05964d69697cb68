"""The port's device layouts: data parallelism and the 2-D data × expert
layout (counterpart of ``mixstage_tpu/parallel/mesh.py``).

JAX places one program on a ``Mesh`` and GSPMD inserts the collectives;
here every rank is a process (``parallel/multihost.py``) and a ``Layout``
names the groups the collectives run over:

* ``dp × mp`` ranks, rank ``r = d · mp + m`` (JAX's ``reshape(dp, mp)`` of
  the device list): the DATA group of ``r`` holds the ranks with its ``m``
  (the ranks that split the batch), its MODEL group the ranks with its
  ``d`` (the ranks that split the mixture decoder's experts);
* ``shard_batch`` gives each rank its rows of the global batch, which every
  rank reads from the same seeded loader, so the data order equals the
  single-process run; a batch whose size does not divide ``dp`` is
  replicated, as JAX replicates it (``mesh.py:60-73``);
* the steps run under ``batch_stats(layout, sharded)``: BatchNorm
  (``models/layers.py``) and K3 (``ops/cuda/train_decoder.py``) take their
  statistics over the data group's global batch, so a data-parallel step
  computes the single-device step on the whole batch (JAX gets that from
  GSPMD; per-replica BatchNorm, as ``DistributedDataParallel`` gives it,
  is another model);
* ``all_reduce_grads`` averages gradients over the data group before the
  optimizer's clip; ``shard_state_mixture`` splits the mixture decoder's
  experts over the model group.

A world of one needs no process group: every function is then the
identity, so the single-card paths are unchanged.

Collectives go through ``all_reduce_``, ``broadcast_`` and ``all_gather``
on the tensors' own device: gloo (two ranks sharing one card) runs each of
them on CUDA tensors itself, copying through the host inside
(``chip_smoke.py`` phase 24 checks it on the card).
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

_STATS_GROUP = contextvars.ContextVar("batch_stats_group", default=None)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``t`` reduced over ``group`` in place; returns ``t``."""
    dist.all_reduce(t, op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` overwritten in place by the global rank ``src``'s."""
    dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated on dim 0 in rank order (every rank
    gives the same shape)."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, t, group=group)
    return torch.cat(outs)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group in the forward; the gradient, summed over the group,
    in the backward (each rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    """The identity in the forward; the gradient summed over the group in
    the backward (the input feeds every rank's share of one sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group in the forward; the identity in the backward (the
    sum feeds one loss that every rank of the group holds)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Autograd-aware sum of ``x`` over ``group`` (BatchNorm's sums)."""
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


class Layout:
    """``dp × mp`` ranks over the process group (module docstring).  At a
    world of one: ``dp = mp = 1`` and no group."""

    def __init__(self, dp: int = 1, mp: int = 1):
        world = dist.get_world_size() if dist.is_initialized() else 1
        if dp < 1 or mp < 1 or dp * mp != world:
            raise ValueError(
                f"a {dp} x {mp} layout needs a world of {dp * mp} ranks, "
                f"this process group has {world}: launch with torchrun "
                f"--nproc_per_node {dp * mp} (or multihost.setup)")
        self.dp, self.mp, self.world = dp, mp, world
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.data_rank, self.model_rank = divmod(self.rank, mp)
        self.data_group = self.model_group = None
        if world > 1:
            # new_group is collective: every rank builds every group, in
            # the same order
            for m in range(mp):
                g = dist.new_group([d * mp + m for d in range(dp)])
                if m == self.model_rank:
                    self.data_group = g
            for d in range(dp):
                g = dist.new_group([d * mp + m for m in range(mp)])
                if d == self.data_rank:
                    self.model_group = g

    def __repr__(self):
        return (f"Layout(dp={self.dp}, mp={self.mp}, rank={self.rank}, "
                f"data_rank={self.data_rank}, model_rank={self.model_rank})")

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files."""
        return self.rank == 0

    def divides(self, batch_size: int) -> bool:
        """Whether a batch of ``batch_size`` rows is split (else
        replicated) over the data group."""
        return self.dp > 1 and batch_size % self.dp == 0

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()


def any_rank(flag: bool, layout: Optional[Layout]) -> bool:
    """Whether ``flag`` is set on any rank (a host flag, e.g. a signal
    seen by some ranks before the others)."""
    if layout is None or layout.world == 1:
        return bool(flag)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([int(bool(flag))], device=dev)
    return bool(all_reduce_(t, None, dist.ReduceOp.MAX).item())


def make_mesh(num_devices: int = 0) -> Layout:
    """The 1-D data-parallel layout over ``num_devices`` ranks (0: the
    whole world).  A count other than the world's raises ``ValueError``:
    the ranks are processes, started by ``torchrun --nproc_per_node N``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = int(num_devices) if num_devices and num_devices > 0 else world
    return Layout(dp=n, mp=1)


def make_mesh_2d(dp: int, mp: int) -> Layout:
    """The 2-D layout: the batch split over ``dp``, the mixture decoder's
    experts over ``mp`` (``shard_state_mixture``)."""
    return Layout(dp=dp, mp=mp)


def _shard_leaf(v, layout: Layout, axis: int):
    if isinstance(v, dict):
        return {k: _shard_leaf(u, layout, axis) for k, u in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_shard_leaf(u, layout, axis) for u in v)
    if not (isinstance(v, np.ndarray) or torch.is_tensor(v)):
        return v
    if v.ndim <= axis or not layout.divides(v.shape[axis]):
        return v
    n = v.shape[axis] // layout.dp
    index = [slice(None)] * v.ndim
    index[axis] = slice(layout.data_rank * n, (layout.data_rank + 1) * n)
    return v[tuple(index)]


def shard_batch(batch, layout: Optional[Layout], leading_axis: int = 0):
    """This rank's rows of the global ``batch`` (a dict / tuple tree of
    numpy arrays or tensors): each array whose ``leading_axis`` divides
    the data extent is sliced to the rank's contiguous block; the others
    (a ragged last batch, batch-1 sampling) are kept whole, replicated."""
    if layout is None or layout.dp == 1:
        return batch
    return _shard_leaf(batch, layout, leading_axis)


@contextlib.contextmanager
def batch_stats(layout: Optional[Layout], sharded: bool):
    """Inside, BatchNorm and K3 take their statistics over the data group
    of ``layout`` when ``sharded`` (else over the local rows, which then
    are the whole batch)."""
    group = layout.data_group if layout is not None and sharded and \
        layout.dp > 1 else None
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


def batch_stats_group():
    """The group BatchNorm's statistics are summed over (None: local)."""
    return _STATS_GROUP.get()


def stats_exchange(group):
    """K3's exchange over ``group``: sums a (G, 2, C) float32 buffer of
    per-channel sums in place, returns the global row count (the shards
    are equal, ``shard_batch``); None without a group."""
    if group is None:
        return None
    size = dist.get_world_size(group)

    def exchange(stats: torch.Tensor, rows: int) -> int:
        all_reduce_(stats, group)
        return rows * size

    return exchange


# ---------------------------------------------------------------------------
# state: replication, gradients, the losses
# ---------------------------------------------------------------------------


def _state_tensors(state) -> List[torch.Tensor]:
    """Every parameter, buffer and optimizer slot of a ``TrainState`` (or
    the parameters and buffers of a module), in a fixed order."""
    if isinstance(state, nn.Module):
        return list(state.parameters()) + list(state.buffers())
    out = []
    for name in ("gen", "psenc", "disc"):
        m = getattr(state, name, None)
        if m is not None:
            out += list(m.parameters()) + list(m.buffers())
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name, None)
        if opt is not None:
            for tensors in opt.slots().values():
                out += [t for t in tensors if t is not None]
    return out


@torch.no_grad()
def replicate_state(state, layout: Optional[Layout]):
    """Every tensor of ``state`` (a ``TrainState`` or a module) broadcast
    from rank 0, the counters too, then checked: a checksum of each tensor
    must agree on every rank.  Returns ``state``."""
    if layout is None or layout.world == 1:
        return state
    tensors = _state_tensors(state)
    for t in tensors:
        broadcast_(t.data, 0)
    counters = ("step", "g_step", "lambda_step", "curriculum_step")
    if not isinstance(state, nn.Module):
        c = torch.tensor([int(getattr(state, k)) for k in counters],
                         dtype=torch.int64)
        broadcast_(c, 0)
        for k, v in zip(counters, c.tolist()):
            setattr(state, k, int(v))
        for opt in (state.g_opt, state.d_opt):
            if opt is not None:
                n = torch.tensor([int(opt.count)], dtype=torch.int64)
                opt.count = int(broadcast_(n, 0).item())
    sums = torch.stack([t.detach().double().sum().cpu() for t in tensors]) \
        if tensors else torch.zeros(1, dtype=torch.float64)
    hi, lo = sums.clone(), -sums
    all_reduce_(hi, None, dist.ReduceOp.MAX)
    all_reduce_(lo, None, dist.ReduceOp.MAX)
    if not torch.equal(hi, -lo):
        raise RuntimeError("replicate_state: the ranks' states differ after "
                           "the broadcast")
    return state


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor], layout: Optional[Layout]
                     ) -> List[torch.Tensor]:
    """The mean of ``grads`` over the data group: one flat buffer per
    (device, dtype), one all-reduce each."""
    grads = list(grads)
    if layout is None or layout.dp == 1:
        return grads
    buckets: Dict[Any, List[int]] = {}
    for i, g in enumerate(grads):
        buckets.setdefault((g.device, g.dtype), []).append(i)
    out = list(grads)
    for idx in buckets.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        all_reduce_(flat, layout.data_group)
        flat /= layout.dp
        at = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[at:at + n].view_as(grads[i])
            at += n
    return out


def mean_over_data(values: Dict[str, torch.Tensor], layout: Layout
                   ) -> Dict[str, torch.Tensor]:
    """Scalar losses → their means over the data group (one all-reduce);
    (B,) vectors gathered in rank order (the global batch's rows)."""
    out = dict(values)
    scalars = [k for k, v in values.items() if v.dim() == 0]
    if scalars:
        stacked = torch.stack([values[k].detach().double()
                               for k in scalars])
        all_reduce_(stacked, layout.data_group)
        stacked /= layout.dp
        for k, v in zip(scalars, stacked):
            out[k] = v.to(values[k].dtype)
    for k, v in values.items():
        if v.dim() > 0:
            out[k] = all_gather(v.detach().contiguous(), layout.data_group)
    return out


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

_DECODER = re.compile(r"decoder\d+")


def is_expert_leaf(name: str) -> bool:
    """A parameter, buffer or optimizer leaf of the mixture decoder (its
    ``decoder{i}`` layers and the generator's grouped ``logits``), by its
    dotted name in the generator."""
    parts = name.split(".")
    return any(_DECODER.fullmatch(p) for p in parts) or \
        (len(parts) >= 2 and parts[-2] == "logits" and
         "classify_cluster" not in parts)


def _take(t: torch.Tensor, start: int, count: int, width: int
          ) -> torch.Tensor:
    """Rows ``[start·width, (start + count)·width)`` of dim 0."""
    return t[start * width:(start + count) * width].clone()


@torch.no_grad()
def shard_state_mixture(state, layout: Layout):
    """Expert parallelism of the Mix-StAGE mixture decoder (JAX
    ``mesh.py:81-126``): rank ``(d, m)`` keeps experts ``[m·G/mp,
    (m+1)·G/mp)`` of the generator's four grouped ``ConvNormRelu`` layers
    and its grouped logits (their parameters, BatchNorm statistics and
    optimizer slots; the parameter objects stay, so the optimizer keeps
    them), and the generator decodes through ``decode_experts``.
    Everything else stays replicated.  ``mp`` must divide the cluster
    count.  The global-norm clip then sums the expert leaves' squares over
    the model group.  Returns ``state``."""
    gen = state.gen
    G, mp = gen.num_clusters, layout.mp
    if mp == 1:
        return state
    if G % mp:
        raise ValueError(f"expert parallelism: the model extent {mp} must "
                         f"divide num_clusters {G} (whole experts per rank)")
    gl = G // mp
    start = layout.model_rank * gl
    sliced = {}
    for layer in gen.decoder_layers():
        conv, norm = layer.conv, layer.norm
        cout = conv.out_channels // G
        for p in (conv.weight, conv.bias, norm.weight, norm.bias,
                  norm.running_mean, norm.running_var):
            sliced[id(p)] = (p, cout)
        conv.in_channels = conv.in_channels // G * gl
        conv.out_channels = cout * gl
        conv.groups = gl
    fo = gen.logits.weight.shape[0] // G
    for p in (gen.logits.weight, gen.logits.bias):
        sliced[id(p)] = (p, fo)
    gen.logits.groups = gl
    slots = {}
    for tensors in state.g_opt.slots().values():
        for p, t in zip(state.g_opt.params, tensors):
            if id(p) in sliced and t is not None:
                slots[id(t)] = (t, sliced[id(p)][1])
    for p, width in sliced.values():
        p.data = _take(p.data, start, gl, width)
    for t, width in slots.values():
        t.data = _take(t.data, start, gl, width)
    gen.expert_parallel = (layout.model_group, start, gl)
    state.g_opt.expert_norm = ([id(p) in sliced for p in state.g_opt.params],
                               layout.model_group)
    return state
