"""GAN training through the port's k-step call, closed loop.

Set-up builds one train state from the seed's weights, makes the traffic's
stacked batches on the device, and drives the state through two calls of
the window's own k-step function (``StepFactory.make_scan_train_step``):
the first is the one compared with the reference (the start), the second
warms up.  The window then calls the same function back to back on the
same state over the stacked batches, reading the losses back once a call.
Every call's coins come from one seeded stream (``data.coin_stream``): k
G or D steps at the configuration's ``dg_iter_ratio``, a G and then a D
step first, the rest in a seeded order.  ``train_frames_per_s`` is B × T
frames of every step of the calls completed in the window, over the
window.

Correctness: the plain reference (``reference/steps.py``) runs after the
window, with the program freed, twice.

* The start: the reference follows the first call's first steps from the
  same weights and batches.  While that call runs, the program's state is
  read between its steps (``_Observer``: each optimizer's update is
  wrapped for that call only): each optimizer's first gradient, worked out
  from its first moment after its first update, and every parameter and
  BatchNorm statistic after step 3.  Compared: each of the first three
  steps' total loss (``loss_gap``), the gradient of step 1 (G's) by the
  worst leaf (``grad_gap``), and the change of every leaf over the first
  three steps, G's update and D's, by the worst leaf (``change_gap``).
  D's first gradient comes after G's first update, where Adam has already
  turned rounding into steps of the learning rate; it is read but not
  compared.
* A window call: one call of the window, drawn from the seed among its
  first ``check_calls``, runs unwrapped like every other, with the
  program's whole state (parameters, statistics, both optimizers' moments
  and counts, the counters) copied to host memory just before it and its
  parameters and statistics just after.  The reference resumes from the
  state before and follows the call's k steps: compared are the call's
  first step's total loss (``window_loss_gap``: the state the call found,
  through G's and D's forward) and every leaf's change over the call
  (``window_change_gap``: all k updates).  The later steps' losses are
  read, not compared: over a call Adam turns rounding into steps of the
  learning rate, and they read as much in sound runs as in TF32.  A
  window that closes before that call has run goes on, uncounted, until
  it has.
"""

from __future__ import annotations

import time

import torch

from bench_port.harness import checks, data, program, weights
from bench_port.harness.trace import profiled, reduce, span
from bench_port.reference.steps import ReferenceTrainer


OBSERVED_STEPS = 3


class _Observer:
    """Reads the program's train state between the steps of one k-step
    call: wraps both optimizers' ``apply`` (on the instances, restored by
    ``close``), and after each update notes the step; after an
    optimizer's first update its gradient (Adam's first moment over
    1 - b1), after step ``OBSERVED_STEPS`` every parameter and buffer."""

    def __init__(self, state):
        self.state, self.steps = state, 0
        self.grads, self.leaves = {}, None
        self.opts = [(state.g_opt, ""), (state.d_opt, "disc.")]
        for opt, prefix in self.opts:
            opt.apply = self._wrap(opt, prefix, opt.apply)

    def _wrap(self, opt, prefix, apply):
        def wrapped(grads):
            apply(grads)
            self.steps += 1
            if prefix not in self.grads:
                self.grads[prefix] = {
                    prefix + n: (m.detach().float() / (1.0 - opt.b1)).cpu()
                    for n, m in zip(opt.names, opt.mu)}
            if self.steps == OBSERVED_STEPS:
                self.leaves = program.leaves(self.state)
        return wrapped

    def close(self):
        for opt, _ in self.opts:
            del opt.apply
        return {"grads": {k: v for g in self.grads.values()
                          for k, v in g.items()},
                "leaves": self.leaves}


def _feed(b):
    return {"x": (b["audio"],), "y": b["y"], "labels": b["labels"],
            "style": b["style"]}


class _Snapshot:
    """Copies of the program's state tensors (``program.state_tensors``)
    to host memory, queued on the device's stream so that they read the
    state between two calls without waiting for it."""

    def __init__(self, state, leaves_only=False):
        self.leaves_only = leaves_only
        self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                    pin_memory=v.is_cuda)
                     for k, v in self._source(state).items()}
        self.counters = None

    def _source(self, state):
        src = program.state_tensors(state)
        if self.leaves_only:
            src = {k: v for k, v in src.items() if "_opt." not in k}
        return src

    def take(self, state):
        for k, v in self._source(state).items():
            self.host[k].copy_(v, non_blocking=True)
        self.counters = program.counters(state)


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    k, B, T = tr["steps_per_call"], tr["batch"], tr["frames"]
    if tr["batches"] != k:
        raise ValueError("every call takes the traffic's whole stack of "
                         "batches: batches must equal steps_per_call")
    ReferenceTrainer.follows(cfg)
    factory = program.step_factory(cfg, tr, device)
    state = program.train_state(factory, weights.make(cfg, seed, device))
    feed = _feed(data.train_batches(cfg, tr, seed, device))
    coin_stream = data.coin_stream(cfg, tr, seed)
    scan = factory.make_scan_train_step(k)

    first_coins = next(coin_stream)
    observer = _Observer(state)
    state, losses, _ = scan(state, feed, first_coins)
    first_loss = losses["total"].cpu()
    first = observer.close()
    state, losses, _ = scan(state, feed, next(coin_stream))
    losses["total"].cpu()
    before, after = _Snapshot(state), _Snapshot(state, leaves_only=True)
    n_window = tr["trace_calls"] if trace else tr["check_calls"]
    checked = data.sample(seed, min(tr["check_calls"], n_window), 1)[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_end = time.perf_counter()

    calls, used, window_call = 0, [], {}

    def one_call():
        nonlocal state, calls
        c = next(coin_stream)
        if calls == checked:
            before.take(state)
        with span("scan_step"):
            state, losses, _ = scan(state, feed, c)
        with span("read_losses"):
            total = losses["total"].cpu()
        if calls == checked:
            after.take(state)
            window_call.update(coins=c, losses=total.tolist())
        used.append(c)
        calls += 1

    out = {"setup_end": setup_end, "first_loss": first_loss.tolist(),
           "first": first, "first_coins": first_coins}
    if trace:
        with profiled() as prof:
            t0 = time.perf_counter()
            with span("window"):
                for _ in range(tr["trace_calls"]):
                    one_call()
            window = time.perf_counter() - t0
        reading = reduce(prof)
        n_d = int(sum(c.sum() for c in used))
        reading["counters"] = {"steps": calls * k, "d_steps": n_d,
                               "g_steps": calls * k - n_d, "batch": B,
                               "frames": T}
        out["reading"] = reading
    else:
        t0 = time.perf_counter()
        while True:
            one_call()
            window = time.perf_counter() - t0
            if window >= seconds:
                break
        out["metrics"] = {"train_frames_per_s": calls * k * B * T / window}
    out["attempted"], out["failed"] = calls * k, 0
    out["window_s"] = window
    while calls <= checked:             # uncounted: the window has closed
        one_call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["window_call"] = {**window_call, "index": checked,
                          "before": before.host,
                          "counters": before.counters,
                          "after": after.host}
    del state, scan, factory, feed, losses
    out["check"] = lambda: compare(cfg, tr, seed, device, out)
    return out


def reference_first_call(cfg, tr, seed, device, coins, tf32=False,
                         trainer_cls=ReferenceTrainer):
    """The reference (or a control in the program's place) over the first
    call's first three steps, which take both optimizers' first updates:
    (its trainer, its readings: each step's total loss, each optimizer's
    first gradient, every leaf after step 3)."""
    w = weights.make(cfg, seed, device)
    b = data.train_batches(cfg, tr, seed, device)
    batches = [{key: v[i] for key, v in b.items()}
               for i in range(OBSERVED_STEPS)]
    with checks.precision(tf32):
        ref = trainer_cls(cfg, w, device)
        ref.initial = {k: v.detach().cpu().clone() for k, v in w.items()}
        losses = ref.run(batches, coins[:OBSERVED_STEPS])
        leaves = {k: v.detach().cpu().clone()
                  for k, v in ref.leaves().items()}
    step1 = ("disc.",) if coins[0] else ("gen.", "psenc.")
    return ref, {"losses": losses, "grads": ref.first_grads(),
                 "leaves": leaves, "step1": step1}


def numbers(ref, reading, prog_losses, prog, detail=None) -> dict:
    """loss_gap, grad_gap and change_gap of a program's first call (its
    per-step losses and its observed state) against the reference's
    readings.  ``detail``, a dict, receives each step's gap and the worst
    leaves."""
    ref_g = reading["grads"]
    moving = checks.moving_leaves(ref_g, [("gen.", "psenc."), ("disc.",)])
    steps = [abs(float(p) - r) / abs(r) for p, r in
             zip(prog_losses[:OBSERVED_STEPS],
                 reading["losses"][:OBSERVED_STEPS])]
    grad_gap, grad_at = checks.leaf_gap(
        prog["grads"], ref_g,
        {k for k in moving if k.startswith(reading["step1"])})
    ref_leaves = reading["leaves"]
    buffers = {k for k in ref_leaves if "running_" in k}
    delta_p = {k: prog["leaves"][k] - ref.initial[k]
               for k in moving | buffers}
    delta_r = {k: ref_leaves[k] - ref.initial[k] for k in moving | buffers}
    change_p, p_at = checks.leaf_gap(delta_p, delta_r, moving)
    change_b, b_at = checks.leaf_gap(delta_p, delta_r, buffers)
    if detail is not None:
        detail.update(step_gaps=steps, grad_at=grad_at, param_at=p_at,
                      change_params=change_p, buffer_at=b_at,
                      change_buffers=change_b, moving=len(moving),
                      leaves=len(ref_g))
    return {"loss_gap": max(steps), "grad_gap": grad_gap,
            "change_gap": max(change_p, change_b)}


def reference_window_call(cfg, tr, seed, device, call, tf32=False,
                          trainer_cls=ReferenceTrainer):
    """The reference (or a control in the program's place) resumed from
    the program's state before a window call (``call``: its ``before``
    tensors and ``counters`` and its ``coins``), over the call's k steps:
    (its trainer, each step's total loss, every leaf after the call)."""
    b = data.train_batches(cfg, tr, seed, device)
    coins = call["coins"]
    batches = [{key: v[i] for key, v in b.items()}
               for i in range(len(coins))]
    before = {k: v.to(device) for k, v in call["before"].items()}
    with checks.precision(tf32):
        ref = trainer_cls(cfg, weights.make(cfg, seed, device), device)
        ref.resume(before, call["counters"])
        losses = ref.run(batches, coins)
    return ref, losses, {k: v.detach().cpu().clone()
                         for k, v in ref.leaves().items()}


def window_numbers(ref, ref_losses, ref_after, call, detail=None) -> dict:
    """window_loss_gap and window_change_gap of a program's window call
    (its per-step losses, its state before and after) against the
    reference's readings over the same call."""
    steps = [abs(float(p) - r) / abs(r)
             for p, r in zip(call["losses"], ref_losses)]
    moving = checks.moving_leaves(ref.first_grads(),
                                  [("gen.", "psenc."), ("disc.",)])
    buffers = {k for k in ref_after if "running_" in k}
    start = call["before"]
    delta_p = {k: call["after"][k] - start[k] for k in moving | buffers}
    delta_r = {k: ref_after[k] - start[k] for k in moving | buffers}
    change_p, p_at = checks.leaf_gap(delta_p, delta_r, moving)
    change_b, b_at = checks.leaf_gap(delta_p, delta_r, buffers)
    if detail is not None:
        detail.update(window_step_gaps=steps, window_param_at=p_at,
                      window_change_params=change_p, window_buffer_at=b_at,
                      window_change_buffers=change_b,
                      window_moving=len(moving), window_index=call["index"])
    return {"window_loss_gap": steps[0],
            "window_change_gap": max(change_p, change_b)}


def compare(cfg, tr, seed, device, out, detail=None) -> dict:
    ref, reading = reference_first_call(cfg, tr, seed, device,
                                        out["first_coins"])
    nums = numbers(ref, reading, out["first_loss"], out["first"], detail)
    del ref
    ref, losses, after = reference_window_call(cfg, tr, seed, device,
                                               out["window_call"])
    nums.update(window_numbers(ref, losses, after, out["window_call"],
                               detail))
    return nums
