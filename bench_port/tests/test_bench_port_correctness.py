"""The plain reference against the program on the CPU at a tiny size, the
check failing the faults a cell can have, and (on the card) the control
failing at the cell's own size."""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

from bench_port.loops import serve as serve_loop
from bench_port.loops import train as train_loop
from bench_port.harness import checks, data, program, weights
from bench_port.harness.runner import execute
from bench_port.reference.models import build
from bench_port.reference.steps import ReferenceTrainer
from conftest import SEED


def test_reference_generator_matches_the_program_in_eval(tiny_cell, cpu):
    cfg = tiny_cell("mixstage8.serve.f32.bs32").config
    w = weights.make(cfg, SEED, cpu)
    from mixstage_tpu_torch.models.mix_stage import \
        JointLateClusterSoftStyle4_G
    prog = JointLateClusterSoftStyle4_G(
        in_channels=cfg["in_channels"], out_feats=cfg["out_feats"],
        num_clusters=cfg["num_clusters"], num_speakers=cfg["num_speakers"],
        style_dim=cfg["style_dim"], input_modalities=(cfg["input_modality"],))
    prog.load_state_dict(weights.part(w, "gen"))
    ref = build(cfg)[0]
    ref.load_state_dict(weights.part(w, "gen"))
    audio = torch.randn(3, 64, cfg["mel_bins"])
    sw = torch.nn.functional.one_hot(torch.tensor([0, 1, 1]), 2).float()
    sw = sw[:, None].expand(-1, 64, -1)
    for mode in (False, True):
        prog.train(mode), ref.train(mode)
        p = prog([audio], None, sw, input_modalities=(cfg["input_modality"],))
        r, score = ref(audio, sw)
        assert checks.rel_fro(p["pose"].detach(), r.detach()) < 1e-6
        assert checks.rel_fro(p["labels_score"].detach(),
                              score.detach()) < 1e-6


@pytest.mark.parametrize("cell", ["mixstage8.train.f32.bs32",
                                  "s2g.train.f32.bs32"])
def test_reference_steps_match_the_program(tiny_cell, cpu, cell):
    """Three G/D steps of the program's train state (its k-step call,
    K3's plain versions on the CPU) against the reference's."""
    c = tiny_cell(cell)
    cfg, tr = c.config, {**c.traffic, "steps_per_call": 3, "batches": 3}
    factory = program.step_factory(cfg, tr, cpu)
    state = program.train_state(factory, weights.make(cfg, SEED, cpu))
    b = data.train_batches(cfg, tr, SEED, cpu)
    coins = np.array([False, True, False])
    _, losses, _ = factory.make_scan_train_step(3)(
        state, {"x": (b["audio"],), "y": b["y"], "labels": b["labels"],
                "style": b["style"]}, coins)
    ref = ReferenceTrainer(cfg, weights.make(cfg, SEED, cpu), cpu)
    rl = ref.run([{k: v[i] for k, v in b.items()} for i in range(3)], coins)
    assert np.allclose(losses["total"].numpy(), rl, rtol=1e-5, atol=0)
    prog = program.leaves(state)
    for k, v in ref.leaves().items():
        assert torch.allclose(prog[k], v, rtol=1e-4, atol=3e-4), k


def _fault_run(cell, cpu, monkeypatch, fault):
    fault(monkeypatch)
    return execute(cell, SEED, 0.2, False, cpu, 0.0)


def _state_unchanged(monkeypatch):
    from mixstage_tpu_torch.train.state import ClippedOptimizer

    monkeypatch.setattr(ClippedOptimizer, "apply",
                        lambda self, grads: None)


def _half_batch(monkeypatch):
    from mixstage_tpu_torch.train.steps import StepFactory

    prepare = StepFactory._prepare

    def half(self, batch, rng):
        batch, gen = prepare(self, batch, rng)
        n = batch["y"].shape[0] // 2
        return {k: (None if v is None else
                    [a[:n] for a in v] if k == "x" else v[:n])
                for k, v in batch.items()}, gen

    monkeypatch.setattr(StepFactory, "_prepare", half)


def _d_step_unchanged(monkeypatch):
    """D's steps leave D's parameters as they found them."""
    from mixstage_tpu_torch.train.steps import StepFactory

    d_step = StepFactory._d_step

    def unchanged(self, state, *a, **k):
        saved = {n: v.clone() for n, v in state.disc.state_dict().items()}
        out = d_step(self, state, *a, **k)
        state.disc.load_state_dict(saved)
        return out

    monkeypatch.setattr(StepFactory, "_d_step", unchanged)


def _window_calls_unchanged(monkeypatch):
    """Every call after set-up's two computes its losses but leaves the
    train state as it found it, as a replay that writes nothing back
    would: a fault the comparison of set-up's first call cannot see."""
    from mixstage_tpu_torch.train.steps import StepFactory

    make = StepFactory.make_scan_train_step

    def patched(self, k):
        scan, calls = make(self, k), [0]

        def fn(state, batches, coins, rngs=None):
            calls[0] += 1
            if calls[0] <= 2:
                return scan(state, batches, coins, rngs)
            saved = {n: v.clone()
                     for n, v in program.state_tensors(state).items()}
            out = scan(state, batches, coins, rngs)
            for n, v in program.state_tensors(state).items():
                v.copy_(saved[n])
            return out
        return fn

    monkeypatch.setattr(StepFactory, "make_scan_train_step", patched)


def _answer_altered(monkeypatch):
    from mixstage_tpu_torch import serve

    build_fn = serve.build_serving_fn

    def altered(*a, **k):
        fn = build_fn(*a, **k)

        def call(audio, style):
            return fn(audio, style).roll(1, dims=0)
        return call

    monkeypatch.setattr(serve, "build_serving_fn", altered)


@pytest.mark.parametrize("cell,fault", [
    ("mixstage8.train.f32.bs32", _state_unchanged),
    ("mixstage8.train.f32.bs32", _half_batch),
    ("mixstage8.train.f32.bs32", _d_step_unchanged),
    ("mixstage8.train.f32.bs32", _window_calls_unchanged),
    ("s2g.train.f32.bs32", _state_unchanged),
    ("s2g.train.f32.bs32", _half_batch),
    ("s2g.train.f32.bs32", _d_step_unchanged),
    ("s2g.train.f32.bs32", _window_calls_unchanged),
    ("mixstage8.serve.f32.bs32", _answer_altered),
    ("mixstage8.serve.open.f32", _answer_altered),
])
def test_a_broken_timed_path_is_not_correct(tiny_cell, cpu, monkeypatch,
                                            cell, fault):
    c = tiny_cell(cell)
    sound = execute(c, SEED, 0.2, False, cpu, 0.0)
    assert sound["correct"], sound["checks"]
    broken = _fault_run(tiny_cell(cell), cpu, monkeypatch, fault)
    assert broken["correct"] is False, broken["checks"]


def test_window_call_is_compared_from_its_own_state(tiny_cell, cpu):
    """The compared call is one of the window's, drawn from the seed, and
    its state before the call is the program's after the calls before."""
    from bench_port.loops import train as loop

    c = tiny_cell("mixstage8.train.f32.bs32")
    out = loop.run(c, SEED, 0.0, False, cpu)
    call = out["window_call"]
    assert call["index"] == data.sample(SEED, c.traffic["check_calls"],
                                        1)[0]
    steps = c.traffic["steps_per_call"]
    assert call["counters"]["step"] == (2 + call["index"]) * steps
    assert len(call["losses"]) == steps and call["coins"][1]
    nums = out["check"]()
    assert nums["window_loss_gap"] < 5e-4, nums


@pytest.mark.parametrize("key,value", [("optim", "SGD"),
                                       ("clip_grad_norm", 0.5),
                                       ("tf32", True)])
def test_a_configuration_key_the_run_cannot_follow_is_refused(
        tiny_cell, cpu, key, value):
    c = tiny_cell("mixstage8.train.f32.bs32")
    c.config = {**c.config, key: value}
    with pytest.raises((ValueError, NotImplementedError)):
        execute(c, SEED, 0.1, False, cpu, 0.0)


def test_serving_builds_the_configuration_s_model(tiny_cell, cpu):
    """The serving function is built from the file's ``model`` by the
    program's registry (an s2g serving cell needs no harness edit)."""
    from mixstage_tpu_torch.models.speech2gesture import Speech2Gesture_G

    from mixstage_tpu_torch import serve

    c = tiny_cell("s2g.train.f32.bs32")
    built = []
    with mock.patch.object(serve, "build_serving_fn",
                           lambda model, **k: built.append(model)):
        program.serving_fn(c.config, weights.make(c.config, SEED, cpu), cpu,
                           {**c.traffic, "frames": 64})
    assert [type(m) for m in built] == [Speech2Gesture_G]
    ref = weights.part(weights.make(c.config, SEED, cpu), "gen")
    for k, v in built[0].state_dict().items():
        assert torch.equal(v, ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [501, 502, 503])
def test_control_fails_the_serving_check(card, seed):
    """The reference in TF32 in the program's place, at the serving cell's
    own size, reads above the limit."""
    from bench_port.harness.spec import Cell, load_manifest

    cell = Cell(load_manifest(), "mixstage8.serve.f32.bs32")
    audio, style = serve_loop.inputs(cell.config, cell.traffic, seed, card)
    ref = serve_loop.reference_poses(cell.config, seed, card, audio, style)
    ctl = serve_loop.reference_poses(cell.config, seed, card, audio, style,
                                       tf32=True)
    err = max(checks.rel_fro(c, r) for c, r in zip(ctl, ref))
    assert err > cell.limits["pose_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mixstage8.train.f32.bs32",
                                  "s2g.train.f32.bs32"])
@pytest.mark.parametrize("seed", [501, 502, 503])
def test_control_fails_the_training_check(card, cell, seed):
    """The reference in TF32 in the program's place over the first call's
    steps, at the cell's own size: some number reads above its limit."""
    from bench_port.harness.spec import Cell, load_manifest

    c = Cell(load_manifest(), cell)
    coins = next(data.coin_stream(c.config, c.traffic, seed))
    ref, reading = train_loop.reference_first_call(
        c.config, c.traffic, seed, card, coins)
    _, ctl = train_loop.reference_first_call(
        c.config, c.traffic, seed, card, coins, tf32=True)
    nums = train_loop.numbers(ref, reading, ctl["losses"], ctl)
    ok, _ = checks.verdict(nums, c.limits)
    assert not ok, nums


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mixstage8.train.f32.bs32",
                                  "s2g.train.f32.bs32"])
@pytest.mark.parametrize("seed", [511, 512, 513])
def test_control_fails_the_window_call_check(card, cell, seed):
    """The reference in TF32 in the program's place over a window call of
    the cell's own size, resumed from the program's state before it: the
    window numbers read above their limits."""
    from bench_port.harness.spec import Cell, load_manifest

    c = Cell(load_manifest(), cell)
    c.traffic = {**c.traffic, "check_calls": 2}
    out = train_loop.run(c, seed, 0.0, False, card)
    call = out["window_call"]
    ref, losses, after = train_loop.reference_window_call(
        c.config, c.traffic, seed, card, call)
    _, closs, cafter = train_loop.reference_window_call(
        c.config, c.traffic, seed, card, call, tf32=True)
    nums = train_loop.window_numbers(
        ref, losses, after, {**call, "losses": closs, "after": cafter})
    assert nums["window_loss_gap"] > c.limits["window_loss_gap"]["limit"], \
        nums
