"""The k-step function's CUDA graphs (``mixstage_tpu_torch/train/graphs.py``)
and the device-scalar step body they capture.

On the CPU:

* the optimizers' step scalars in device slots give, bit for bit, what
  the host floats they replace gave: Adam (float32, bfloat16 ``mu``,
  float64) and centered, bias-corrected RMSprop, clipped, over 20 updates,
  with a learning-rate schedule and without (the reference below is the
  update as it read before the slots, host floats and all);
* the λ slot holds ``lambda_schedule`` at every step, across the ramp's end
  at 300, and the steps read it;
* the k-step function on the CPU runs op by op: every step span has
  ``graph=0``, no capture, each step its forward, backward and update;
* the graphs' key: kept after an in-place ``load_state_dict``, dropped
  when a parameter, buffer, moment or the state is replaced or the
  batch's layout changes.

On the card (``cuda``; they skip without one, and import neither JAX nor
the JAX package):

* two k = 16 calls of the k-step function from one seed, the second replayed, with
  mixed coins, all G after the opening G and D, the Speech2Gesture
  generator (its batches host numpy, as the trainer's) and Mix-StAGE at
  bfloat16 (K3's bf16 mode), under PyTorch's
  deterministic algorithms (``deterministic``): every replay is held to
  the op-by-op step of ``make_steps()`` from the same state (a second
  state put in its place, run twice): the loss row, the pose, every
  parameter, BatchNorm statistic and Adam moment after it, bit for bit
  where the two op-by-op steps agree (everywhere, under those
  algorithms), else no further apart than they are
  (``_close_as_op_by_op``), and the counters.  Whole calls are not
  compared: without those algorithms two op-by-op runs differ, and over
  32 Adam steps their rounding grows to a quarter of the losses.  K3's
  launch counters count a replay as an op-by-op step;
* a capture and replays under ``torch.profiler``: every step span
  ``graph=1``, one ``train.capture`` a kind holding the captured phases;
* graphs kept across an in-place ``load_state_dict``, dropped and
  captured again after a parameter's storage is replaced.
"""

import numpy as np
import pytest
import torch

from mixstage_tpu_torch.train import StepConfig, StepFactory
from mixstage_tpu_torch.train import losses as L
from mixstage_tpu_torch.train import profiling
from mixstage_tpu_torch.train import state as TS
from mixstage_tpu_torch.train.graphs import StepGraphs

STEPS = ("train.g_step", "train.d_step")
PHASES = ("train.forward", "train.backward", "train.update")
SMALL = dict(model="JointLateClusterSoftStyle4_G", gan=True,
             criterion="L1Loss", num_clusters=2, num_speakers=2,
             model_kwargs=(("in_channels", 64),))


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _batches(k, B, T, mel, S, M, seed=0, device=None):
    """k batches stacked: (k, ...) leaves as the k-step function takes them
    (numpy, or tensors on ``device``)."""
    rng = np.random.default_rng(seed)
    b = {"x": (rng.normal(size=(k, B, T, mel)).astype(np.float32),),
         "y": rng.normal(size=(k, B, T, 96)).astype(np.float32),
         "labels": rng.integers(0, M, size=(k, B, T)),
         "style": np.repeat(rng.integers(0, S, size=(k, B, 1)), T, 2)}
    if device is not None:
        b = {key: (tuple(torch.as_tensor(a, device=device) for a in v)
                   if key == "x" else torch.as_tensor(v, device=device))
             for key, v in b.items()}
    return b


def _slice(batches, i):
    return {key: (tuple(a[i] for a in v) if key == "x" else v[i])
            for key, v in batches.items()}


# ---------------------------------------------------------------------------
# the optimizers' step scalars
# ---------------------------------------------------------------------------

def _host_float_update(opt, grads, rate_of):
    """One clipped update as the optimizers computed it before the step
    scalars moved to the device: the rate, the bias corrections and the
    RMSprop correction as host floats (float32 arithmetic; float64 for
    float64 parameters), on copies kept in ``opt`` (a dict)."""
    f64 = opt["params"][0].dtype == torch.float64
    scal = (lambda v: float(v)) if f64 else TS._f32
    grads = TS.clip_by_global_norm(list(grads), 1.0)
    rate = rate_of(opt["count"])
    opt["count"] += 1

    def bias_correction(b):
        if f64:
            return 1.0 - b ** opt["count"]
        c = torch.tensor(float(opt["count"]), dtype=torch.float32)
        return float(1.0 - torch.tensor(b, dtype=torch.float32) ** c)

    if opt["rule"] == "adam":
        b1, b2 = 0.9, 0.999
        if opt["mu_dtype"] is None:
            torch._foreach_mul_(opt["mu"], b1)
            torch._foreach_add_(opt["mu"], torch._foreach_mul(grads, 1 - b1))
            mu = opt["mu"]
        else:
            b1_mu = TS._scalar_in(b1, opt["mu_dtype"])
            mu = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(opt["mu"], b1_mu))
            torch._foreach_copy_(opt["mu"], mu)
        torch._foreach_mul_(opt["nu"], b2)
        torch._foreach_add_(opt["nu"], torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        bc1, bc2 = bias_correction(b1), bias_correction(b2)
        nu_hat = torch._foreach_div(opt["nu"], bc2)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, 1e-8)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, nu_hat)
    else:                       # centered RMSprop with bias correction
        d = 0.9
        torch._foreach_mul_(opt["nu"], d)
        torch._foreach_add_(opt["nu"], torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - d))
        torch._foreach_mul_(opt["mu"], d)
        torch._foreach_add_(opt["mu"], torch._foreach_mul(grads, 1.0 - d))
        bc = bias_correction(d)
        den = torch._foreach_div(opt["nu"], bc)
        mu = torch._foreach_div(opt["mu"], bc)
        den = torch._foreach_sub(den, torch._foreach_mul(mu, mu))
        scale = torch._foreach_add(den, 1e-8)
        torch._foreach_rsqrt_(scale)
        upd = torch._foreach_mul(scale, grads)
    torch._foreach_mul_(upd, -scal(rate))
    torch._foreach_add_(opt["params"], upd)


RULES = {"adam": ("Adam", {}, torch.float32),
         "adam_mu_bf16": ("Adam", {"mu_dtype": "bfloat16"}, torch.float32),
         "adam_f64": ("Adam", {}, torch.float64),
         "rmsprop_centered": ("RMSprop", {"centered": True,
                                          "bias_correction": True},
                              torch.float32)}


@pytest.mark.parametrize("schedule", [None, "linear_decay"],
                         ids=["constant", "schedule"])
@pytest.mark.parametrize("rule", list(RULES))
def test_device_scalars_equal_the_host_floats(rule, schedule):
    name, kw, dt = RULES[rule]
    lr = 3e-3
    sched = None if schedule is None else TS.make_schedule(
        schedule, lr, gamma=0.5, warmup_steps=4, total_steps=20,
        steps_per_epoch=5)
    rng = np.random.default_rng(7)
    shapes = [(7,), (4, 5), (3, 2, 2)]
    init = [torch.as_tensor(rng.normal(size=s), dtype=dt) for s in shapes]
    params = [p.clone() for p in init]
    opt = TS.make_optimizer(name, lr, schedule=sched, **kw)(
        [(f"p{i}", p) for i, p in enumerate(params)])
    mu_dtype = TS._dtype(kw.get("mu_dtype"))
    ref = {"rule": "adam" if name == "Adam" else "rmsprop",
           "params": [p.clone() for p in init], "count": 0,
           "mu_dtype": mu_dtype,
           "mu": [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                  for p in init],
           "nu": [torch.zeros_like(p) for p in init]}
    rate_of = sched or (lambda count: lr)
    for step in range(20):
        # norms from 0.3 to 3: the clip acts on some steps, not others
        scale = 0.3 * 10 ** (step % 3 / 2)
        grads = [torch.as_tensor(rng.normal(size=s) * scale, dtype=dt)
                 for s in shapes]
        opt.step([g.clone() for g in grads])
        _host_float_update(ref, grads, rate_of)
        for got, want in zip(params + opt.mu + opt.nu,
                             ref["params"] + ref["mu"] + ref["nu"]):
            assert torch.equal(got, want), (rule, step)
    assert opt.count == ref["count"] == 20
    slot = opt.scalars["neg_rate"]
    assert slot.shape == () and slot.dtype == dt
    assert float(slot) == -(TS._f32(rate_of(19)) if dt == torch.float32
                            else rate_of(19))


def test_step_is_advance_then_update():
    """``step`` is the host half then the device half; the step scalars
    are made once and refilled in place."""
    p = torch.ones(3)
    opt = TS.make_optimizer("Adam", 1e-2)([("p", p)])
    opt.advance()
    slots = dict(opt.scalars)
    assert set(slots) == {"neg_rate", "bc1", "bc2"} and opt.count == 1
    assert float(slots["bc1"]) == pytest.approx(0.1)
    opt.update([torch.full((3,), 0.5)])
    opt.step([torch.full((3,), 0.5)])
    assert opt.count == 2
    assert all(opt.scalars[k] is v for k, v in slots.items())
    assert float(slots["bc2"]) == opt._bias_correction(0.999) \
        == pytest.approx(1 - 0.999 ** 2, rel=1e-4)
    assert opt.device_tensors()[0] is p


# ---------------------------------------------------------------------------
# λ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_lambda_slot_follows_the_ramp(dtype):
    f = StepFactory(StepConfig(**SMALL, dtype=dtype), device="cpu")
    slot = f._lambda(0, 1.0)
    for step in range(0, 400, 3):
        for init in (1.0, 0.3):
            got = f._lambda(step, init)
            assert got is slot and got.dtype == dtype and got.shape == ()
            assert float(got) == L.lambda_schedule(step, init, dtype=dtype)
    assert float(f._lambda(300, 0.3)) == float(f._lambda(1000, 0.3)) == 2.0


def test_steps_read_the_lambda_slot_across_the_ramps_end():
    """G and D steps from ``lambda_step`` 297 to 302: each step's slot is
    the ramp at that step with its own initial λ."""
    torch.set_num_threads(2)
    f = StepFactory(StepConfig(**SMALL, lambda_gan=0.5, lambda_D=0.25),
                    device="cpu")
    state = f.init(seed=0)
    state.lambda_step = 297
    seen = []
    real = f._lambda

    def spy(step, init):
        slot = real(step, init)
        seen.append((step, init, float(slot)))
        return slot

    f._lambda = spy
    steps = f.make_steps()
    batches = _batches(6, 2, 64, 32, 2, 2, seed=3)
    for i, kind in enumerate("gdgdgd"):
        steps[kind](state, _slice(batches, i))
    assert [s for s, _, _ in seen] == list(range(297, 303))
    for step, init, value in seen:
        assert init == (0.5 if (step - 297) % 2 == 0 else 0.25)
        assert value == L.lambda_schedule(step, init)
    assert seen[-1][2] == seen[-2][2] == 2.0 and state.lambda_step == 303


# ---------------------------------------------------------------------------
# the k-step function on the CPU, and the graphs' key
# ---------------------------------------------------------------------------

def test_k_step_function_on_the_cpu_runs_op_by_op():
    from torch.profiler import ProfilerActivity, profile

    torch.set_num_threads(2)
    f = StepFactory(StepConfig(**SMALL), device="cpu")
    assert not f._graphable()
    state = f.init(seed=0)
    k = 3
    scan = f.make_scan_train_step(k)
    batches = _batches(k, 2, 64, 32, 2, 2, seed=1)
    scan(state, batches, [False, True, False])
    with profile(activities=[ProfilerActivity.CPU]):
        _, losses, poses = scan(state, batches, [False, True, True])
    recs = profiling.records()
    steps = [r for r in recs if r.name in STEPS]
    assert [r.name for r in steps] == ["train.g_step", "train.d_step",
                                       "train.d_step"]
    assert all(r.ids == {"graph": 0} for r in steps)
    assert not [r for r in recs if r.name == "train.capture"]
    for s in steps:
        inside = sorted(r.name for r in recs if r.parent == s.id)
        assert inside == sorted(PHASES)
    assert poses.shape == (k, 2, 64, 96)
    assert losses["total"].shape == (k,) and state.step == 2 * k


def _cpu_state_and_batches(seed=0):
    f = StepFactory(StepConfig(**SMALL), device="cpu")
    return f, f.init(seed=seed), _batches(2, 2, 64, 32, 2, 2)


def _replace_param(f, state, batches):
    p = next(state.gen.parameters())
    p.data = p.data.clone()
    return state, batches


def _replace_buffer(f, state, batches):
    m = next(m for m in state.disc.modules() if hasattr(m, "running_mean"))
    m.running_mean = m.running_mean.clone()
    return state, batches


def _replace_moment(f, state, batches):
    state.d_opt.nu[3] = state.d_opt.nu[3].clone()
    return state, batches


def _load_in_place(f, state, batches):
    other = f.init(seed=5)
    for name in ("gen", "psenc", "disc"):
        getattr(state, name).load_state_dict(
            getattr(other, name).state_dict())
    with torch.no_grad():
        torch._foreach_copy_(state.g_opt.mu, other.g_opt.params)
    state.g_opt.count, state.lambda_step = 40, 250
    return state, batches


KEY_CHANGES = {
    "load_state_dict_in_place": (_load_in_place, True),
    "parameter_replaced": (_replace_param, False),
    "buffer_replaced": (_replace_buffer, False),
    "moment_replaced": (_replace_moment, False),
    "other_state": (lambda f, s, b: (f.init(seed=0), b), False),
    "batch_shape": (lambda f, s, b: (s, _batches(2, 3, 64, 32, 2, 2)),
                    False),
    "batch_dtype": (lambda f, s, b: (s, {**b, "y": b["y"].astype(
        np.float64)}), False),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_graphs_key(change):
    """A call replays only on the key the last call left: the state, the
    storage of its tensors and the batch's layout."""
    f, state, batches = _cpu_state_and_batches()
    graphs = StepGraphs(f, f.union_keys())
    assert not graphs.engage(state, batches)
    f._lambda(0, 1.0)
    state.g_opt.advance()
    state.d_opt.advance()
    graphs.settle(state, batches)
    assert graphs.engage(state, batches)
    graphs.graphs["g"] = "captured"
    edit, kept = KEY_CHANGES[change]
    state2, batches2 = edit(f, state, batches)
    assert graphs.engage(state2, batches2) is kept
    assert bool(graphs.graphs) is kept
    if not kept:                # the next call captures again
        assert not graphs.engage(state2, batches2)
        graphs.settle(state2, batches2)
        assert graphs.engage(state2, batches2)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture the card's "
                    "kernels, and the k-step function runs op by op "
                    "elsewhere (the CPU tests above)")
    from mixstage_tpu_torch import resolve_device
    return resolve_device("cuda")


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms: without them two op-by-op G
    steps from one state differ in the audio encoder's 32 leaves (the
    backward of its bilinear resize adds with atomics; cuDNN's backward
    too, unless told otherwise), by up to 5e-6 of a leaf's largest value,
    and Adam turns that into sign flips of whole updates; with them two
    op-by-op steps agree bit for bit, and a replay is held to them bit for
    bit.  ``warn_only``: an op with no deterministic version warns."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


MIXSTAGE8 = dict(model="JointLateClusterSoftStyle4_G", gan=True,
                 criterion="L1Loss", input_modalities=("audio/log_mel_400",),
                 num_clusters=8, num_speakers=8, lambda_id=0.1, argmax=True,
                 some_grad_flag=True, train_only=True,
                 discriminator="Speech2Gesture_D", fused_decoder=True,
                 model_kwargs=(("in_channels", 256),))
S2G = dict(model="Speech2Gesture_G", gan=True, criterion="L1Loss",
           input_modalities=("audio/log_mel_400",), num_speakers=8,
           discriminator="Speech2Gesture_D",
           model_kwargs=(("in_channels", 256),))
K, B, T, MEL = 16, 8, 64, 64
# how far a replay may read from an op-by-op step where two op-by-op steps
# differ: NOISE times their gap, plus 4 float32 ulps of the tensor's scale
NOISE, ULPS = 4.0, 4


def _coins(order, seed):
    rng = np.random.default_rng(seed)
    if order == "all_g":
        return np.array([False, True] + [False] * (K - 2))
    rest = np.array([True] * (K // 2 - 1) + [False] * (K // 2 - 1))
    return np.concatenate([[False, True], rng.permutation(rest)])


def _k3_launches():
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    return (td.decoder_train_fwd.launches, td.decoder_train_bwd.launches)


def _tensors(state):
    """Every tensor of a train state by name (not copied): the modules'
    parameters and buffers, each optimizer's moments."""
    out = {}
    for name in ("gen", "psenc", "disc"):
        mod = getattr(state, name)
        if mod is not None:
            out.update({f"{name}.{k}": v
                        for k, v in mod.state_dict().items()})
    for tag, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for slot, ts in opt.slots().items():
            out.update({f"{tag}.{slot}.{n}": t
                        for n, t in zip(opt.names, ts)})
    return out


def _counters(state):
    return (state.step, state.g_step, state.lambda_step,
            state.curriculum_step, state.g_opt.count, state.d_opt.count)


def _take(state):
    return {k: v.clone() for k, v in _tensors(state).items()}, \
        _counters(state)


@torch.no_grad()
def _put(state, taken):
    tensors, counters = taken
    for k, v in _tensors(state).items():
        v.copy_(tensors[k])
    (state.step, state.g_step, state.lambda_step, state.curriculum_step,
     state.g_opt.count, state.d_opt.count) = counters


def _close_as_op_by_op(got, b, c, what):
    """``got`` (a replayed step) against ``b`` and ``c`` (two op-by-op
    steps from the same state), tensor by tensor: bit for bit where ``b``
    and ``c`` agree, else within ``NOISE`` times their gap plus ``ULPS``
    ulps.  A stale batch or λ moves the losses by 1e-3 and more, a frozen
    rate or bias correction a parameter by 1e-5 of its scale and more."""
    for key in b:
        if torch.equal(b[key], c[key]):
            assert torch.equal(got[key], b[key]), (what, key)
            continue
        noise = (b[key] - c[key]).abs().max().item()
        ulps = ULPS * torch.finfo(torch.float32).eps * \
            b[key].abs().max().item()
        gap = (got[key] - b[key]).abs().max().item()
        assert gap <= NOISE * noise + ulps, (what, key, gap, noise, ulps)


class Lockstep:
    """Holds every replayed step of the k-step function to the op-by-op step: a
    second train state of another factory of ``cfg`` is put into the
    replayed state's place before each replay and runs the same step
    through ``make_steps()`` twice; the replay's loss row, pose, every
    tensor of its state after and its counters are compared with those
    (``_close_as_op_by_op``).  K3's launches are counted for the replay
    and the first op-by-op step."""

    def __init__(self, monkeypatch, cfg, device):
        f = StepFactory(cfg, device=device)
        self.state, keys, steps = f.init(seed=1), f.union_keys(), \
            f.make_steps()
        self.checked, self.launches = [], []
        real = StepGraphs.step

        def op_by_op(kind, batch, before):
            _put(self.state, before)
            k3 = _k3_launches()
            _, losses, pose = steps[kind](self.state, batch)
            torch.cuda.synchronize()
            return {"row": f._row(losses, keys), "pose": pose.float(),
                    **_take(self.state)[0]}, _k3_diff(k3)

        def step(graphs, kind, state, batch):
            before = _take(state)
            k3 = _k3_launches()
            row, pose = real(graphs, kind, state, batch)
            torch.cuda.synchronize()
            replayed = _k3_diff(k3)
            got = {"row": row.clone(), "pose": pose.float(),
                   **_take(state)[0]}
            (b, k3_b), (c, _) = (op_by_op(kind, batch, before)
                                 for _ in range(2))
            assert _counters(state) == _counters(self.state)
            _close_as_op_by_op(got, b, c, (kind, len(self.checked)))
            self.checked.append(kind)
            self.launches.append((replayed, k3_b))
            return row, pose

        monkeypatch.setattr(StepGraphs, "step", step)


def _k3_diff(before):
    return tuple(b - a for a, b in zip(before, _k3_launches()))


def _engage_spy(monkeypatch):
    seen = []
    real = StepGraphs.engage

    def spy(self, state, batches):
        replay = real(self, state, batches)
        seen.append((self, replay))
        return replay

    monkeypatch.setattr(StepGraphs, "engage", spy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("model, order", [
    ("mixstage8", "mixed"), ("mixstage8", "all_g"), ("s2g", "mixed"),
    ("mixstage8_bf16", "mixed")])
def test_replayed_calls_equal_op_by_op_steps(cuda, deterministic,
                                             monkeypatch, model, order):
    """Two k = 16 calls of the k-step function from one seed, the second replayed,
    each replay held to the op-by-op step from the same state."""
    cfg = StepConfig(**(S2G if model == "s2g" else MIXSTAGE8),
                     dtype=torch.bfloat16 if model.endswith("bf16")
                     else torch.float32)
    f = StepFactory(cfg, device=cuda)
    assert f._graphable()
    # the benchmark's device tensors for Mix-StAGE, the trainer's numpy
    # stacks for S2G
    batches = _batches(K, B, T, MEL, 8, 8, seed=11,
                       device=None if model == "s2g" else cuda)
    seen = _engage_spy(monkeypatch)
    lock = Lockstep(monkeypatch, cfg, cuda)
    state = f.init(seed=0)
    scan = f.make_scan_train_step(K)
    k3 = _k3_launches()
    scan(state, batches, _coins(order, 1))
    torch.cuda.synchronize()
    coins = _coins(order, 2)
    n_g = int((~_coins(order, 1)).sum())
    k3_first = (0, 0) if model == "s2g" else (n_g, n_g)
    assert _k3_diff(k3) == k3_first and not lock.checked
    _, losses, poses = scan(state, batches, coins)
    assert [r for _, r in seen] == [False, True]
    assert sorted(seen[-1][0].graphs) == ["d", "g"]
    assert lock.checked == ["d" if c else "g" for c in coins]
    for kind, (replayed, op_by_op) in zip(lock.checked, lock.launches):
        assert replayed == op_by_op == \
            ((1, 1) if kind == "g" and model != "s2g" else (0, 0))
    assert losses["total"].shape == (K,) and poses.shape == (K, B, T, 96)
    assert losses["total"].dtype == torch.float32 and poses.dtype == cfg.dtype
    n_d = int(_coins(order, 1).sum() + coins.sum())
    assert _counters(state)[:4] == (2 * K, 2 * K - n_d, 2 * K, 2 * K - n_d)


@pytest.mark.cuda
def test_capture_and_replays_under_the_profiler(cuda):
    from torch.profiler import ProfilerActivity, profile

    f = StepFactory(StepConfig(**S2G), device=cuda)
    state = f.init(seed=0)
    batches = _batches(K, B, T, MEL, 8, 8, seed=4, device=cuda)
    scan = f.make_scan_train_step(K)
    scan(state, batches, _coins("mixed", 1))
    for call, coins in enumerate((_coins("mixed", 2), _coins("mixed", 3))):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            scan(state, batches, coins)
            torch.cuda.synchronize()
        recs = profiling.records()
        steps = [r for r in recs if r.name in STEPS]
        share = 100.0 * sum(r.ids["graph"] == 1 for r in steps) / len(steps)
        captures = [r for r in recs if r.name == "train.capture"]
        kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                      for e in prof.events())
        print(f"call {call + 2}: {len(steps)} steps, {share}% replayed, "
              f"{len(captures)} captures, {kernels} device events")
        assert len(steps) == K and share == 100.0
        assert kernels > 0
        if call == 0:
            assert sorted(r.ids["kind"] for r in captures) == ["d", "g"]
            by_id = {r.id: r for r in recs}
            for r in recs:
                if r.name in PHASES:        # captured, never replayed
                    while r.parent is not None and r.name != \
                            "train.capture":
                        r = by_id[r.parent]
                    assert r.name == "train.capture"
        else:
            assert not captures
            assert not [r for r in recs if r.name in PHASES]


@pytest.mark.cuda
def test_graphs_kept_after_load_and_recaptured_after_a_replaced_tensor(
        cuda, deterministic, monkeypatch):
    """Five calls: op by op; captured; replayed after an in-place
    ``load_state_dict``; op by op after a parameter's storage is replaced;
    captured again.  Every replay is held to the op-by-op step."""
    cfg = StepConfig(**MIXSTAGE8)
    f = StepFactory(cfg, device=cuda)
    batches = _batches(K, B, T, MEL, 8, 8, seed=6, device=cuda)
    seen = _engage_spy(monkeypatch)
    lock = Lockstep(monkeypatch, cfg, cuda)
    loaded = f.init(seed=9)
    state = f.init(seed=0)
    scan = f.make_scan_train_step(K)
    for n in range(5):
        if n == 2:
            for name in ("gen", "psenc", "disc"):
                getattr(state, name).load_state_dict(
                    getattr(loaded, name).state_dict())
        if n == 3:
            p = next(state.gen.parameters())
            p.data = p.data.clone()
        scan(state, batches, _coins("mixed", n))
    assert [r for _, r in seen] == [False, True, True, False, True]
    assert sorted(seen[-1][0].graphs) == ["d", "g"]
    assert len(lock.checked) == 3 * K
