"""CUDA graphs of the train steps, for the k-step function
(``StepFactory.make_scan_train_step``).

On the card a train step is some 1,200-1,900 small kernels, and launching
them one by one from Python takes about four times as long as the card
takes to run them.  So the k-step function, from its second call on, runs
each kind of step (G, D, or the non-GAN step) as a CUDA graph: captured
where that kind first comes in the call, then replayed for every step of
that kind.  The first call runs op by op; it is the warm-up a capture
needs (cuDNN's plans, K3's set-up, the allocator).

A graph holds the step's device half (``StepFactory._body``) and the
packing of its losses into one float32 row.  Before each replay the host
half runs as in an op-by-op step (``StepFactory._begin``: the modes, λ
and the optimizer's step scalars into their device slots), and the
step's batch is copied into the static batch the graphs read; after it
the host counters advance.  The graphs engage only where a replay
computes what the op-by-op step would: on a CUDA device, with no
data-parallel layout (its collectives are not captured) and with nothing
drawn per step (``noise`` and ``p_dropout`` 0: a replay cannot reseed the
step's generators).

The graphs belong to one train state and one batch layout: the state
object, the storage of every parameter, buffer, optimizer moment and step
scalar (``load_state_dict`` copies into them and keeps them; a replaced
tensor does not), and the stacked batch's leaves' shapes and dtypes.  A
call that finds another key drops the graphs and runs op by op; the next
call captures again.

A replay opens the step's span (``train.g_step`` / ``train.d_step``) with
the id ``graph=1`` (an op-by-op step: ``graph=0``); a capture is a
``train.capture`` span.  K3's launch counters (``.launches``,
``.launches_bf16``) count what a capture launched once for each replay.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from mixstage_tpu_torch.train.profiling import span

STEP_SPAN = {"train": "train.g_step", "g": "train.g_step",
             "d": "train.d_step"}


def _launch_counts() -> Dict[Tuple, int]:
    """The launch counters of the kernels a train step runs (K3's)."""
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    return {(fn, c): getattr(fn, c)
            for fn in (td.decoder_train_fwd, td.decoder_train_bwd)
            for c in ("launches", "launches_bf16")}


def _leaves(batch) -> List[Tuple[str, object]]:
    """(name, leaf) of a batch, ``x``'s streams one by one."""
    out = []
    for k, v in batch.items():
        if k == "x":
            out += [(f"x{j}", a) for j, a in enumerate(v)]
        else:
            out.append((k, v))
    return out


class CapturedStep:
    """``fn()``'s device work captured as one CUDA graph: ``replay()``
    runs it again and returns the tensors ``fn`` returned, rewritten."""

    def __init__(self, fn):
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn()
        after = _launch_counts()
        self.launches = {k: after[k] - n for k, n in before.items()
                         if after[k] != n}
        for (fn_, c), n in before.items():      # a capture runs nothing
            setattr(fn_, c, n)

    def replay(self):
        self.graph.replay()
        for (fn, c), n in self.launches.items():
            setattr(fn, c, getattr(fn, c) + n)
        return self.outputs


class StepGraphs:
    """The graphs of one k-step function of ``factory``: ``engage`` at
    each call's start says whether the call replays, ``step`` runs one
    step as a replay (capturing its kind first where needed), ``settle``
    after an op-by-op call records the key the next call must find."""

    def __init__(self, factory, keys):
        self.factory, self.keys = factory, keys
        self.key = None
        self.state = None       # held, so that its id is not reused
        self.graphs: Dict[str, CapturedStep] = {}
        self.batch = None       # the static batch the graphs read

    def _key(self, state, batches):
        tensors = [t for m in (state.gen, state.psenc, state.disc)
                   if m is not None
                   for t in (*m.parameters(), *m.buffers())]
        for opt in (state.g_opt, state.d_opt):
            if opt is not None:
                tensors += opt.device_tensors()
        if self.factory._lambda_slot is not None:
            tensors.append(self.factory._lambda_slot)
        layout = tuple((name, None if v is None else
                        (tuple(v.shape), str(v.dtype)))
                       for name, v in _leaves(batches))
        return id(state), tuple(t.data_ptr() for t in tensors), layout

    def engage(self, state, batches) -> bool:
        """Whether this call replays: the key the last call left, else the
        graphs are dropped and the call runs op by op."""
        if self.key is not None and self._key(state, batches) == self.key:
            return True
        self.graphs, self.batch, self.key, self.state = {}, None, None, None
        return False

    def settle(self, state, batches) -> None:
        self.key, self.state = self._key(state, batches), state

    def step(self, kind: str, state, batch):
        """One step of ``kind`` as a replay: (its loss row, its pose),
        tensors the next replay of the kind rewrites."""
        f = self.factory
        with span(STEP_SPAN[kind], graph=1):
            batch, _ = f._prepare(batch, None)
            f._begin(kind, state)
            if self.batch is None:
                self.batch = {k: None if v is None else
                              ([a.clone() for a in v] if k == "x"
                               else v.clone())
                              for k, v in batch.items()}
            else:
                dst, src = zip(*((d, s) for (_, d), (_, s) in zip(
                    _leaves(self.batch), _leaves(batch)) if d is not None))
                torch._foreach_copy_(list(dst), list(src))
            graph = self.graphs.get(kind)
            if graph is None:
                with span("train.capture", kind=kind):
                    graph = self.graphs[kind] = CapturedStep(
                        lambda: self._device_step(kind, state))
            row, pose = graph.replay()
            f._count(kind, state)
            return row, pose

    def _device_step(self, kind, state):
        f = self.factory
        losses, pose = f._body(kind, state, self.batch, None, False, False)
        return f._row(f._out(losses), self.keys), pose
