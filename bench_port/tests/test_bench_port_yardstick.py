"""The yardstick: traffic by seed, operations and bytes by hand, the trace
reduction and the result line's keys."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port.harness import data, work
from bench_port.harness.runner import execute, forbidden_modules
from bench_port.harness.spec import ROOT, Cell, load_manifest
from bench_port.harness.trace import short_name
from conftest import SEED

CFG = Cell(load_manifest(), "mixstage8.train.f32.bs32").config


def test_train_traffic_is_deterministic_by_seed(cpu):
    tr = {"batch": 4, "frames": 8, "batches": 3}
    a = data.train_batches(CFG, tr, SEED, cpu)
    b = data.train_batches(CFG, tr, SEED, cpu)
    c = data.train_batches(CFG, tr, SEED + 1, cpu)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["audio"], c["audio"])
    # every batch holds B / S clips of each speaker
    counts = torch.stack([torch.bincount(s[:, 0], minlength=8)
                          for s in data.train_batches(
                              CFG, {**tr, "batch": 32}, SEED, cpu)["style"]])
    assert (counts == 4).all()


def _coins(seed, calls, ratio=1.0):
    stream = data.coin_stream({"dg_iter_ratio": ratio},
                              {"steps_per_call": 16}, seed)
    return np.stack([next(stream) for _ in range(calls)])


def test_coins_same_work_every_seed():
    a, b = _coins(SEED, 5), _coins(SEED + 1, 5)
    assert np.array_equal(a, _coins(SEED, 5))
    assert not np.array_equal(a, b)
    for c in (a, b):
        # every call a G step and then a D step first, 8 D steps in all
        assert (c.sum(1) == 8).all() and not c[:, 0].any() and c[:, 1].all()
        assert len({row.tobytes() for row in c}) > 1
    assert (_coins(SEED, 3, ratio=3.0).sum(1) == 12).all()


def test_open_loop_schedule_same_gaps_every_seed():
    tr = {"rate": 1000.0, "pool": 64}
    a = data.open_loop_schedule(tr, 2.0, SEED)
    b = data.open_loop_schedule(tr, 2.0, SEED + 1)
    assert len(a["due"]) == len(b["due"]) == 2000
    q = (np.arange(2000) + 0.5) / 2000
    gaps = -np.log1p(-q) / 1000.0
    for s in (a, b):             # every gap one of the rate's quantiles
        d = np.diff(s["due"])
        assert (np.abs(d[:, None] - gaps[None, :]).min(1) < 1e-9).all()
    assert not np.array_equal(a["due"], b["due"])
    assert abs(a["due"][-1] - 2.0) < 0.05 and a["due"][0] == 0.0
    assert np.array_equal(a["clip"], data.open_loop_schedule(
        tr, 2.0, SEED)["clip"])


def test_conv_flops_by_hand():
    # one k=3 conv, 266 → 256 channels, 2048 frames: 2 · 2048 · 256 · 266 · 3
    assert work.conv_flops(2048 * 256, 266, 3) == 2 * 2048 * 256 * 266 * 3
    conv = torch.nn.Conv1d(266, 256, 3, padding=1)
    assert work._count(conv, lambda: conv(torch.zeros(32, 266, 64))) == \
        2 * 32 * 64 * 256 * 266 * 3


def test_k1_work_by_hand():
    dec, cls = work.k1_shapes(CFG, 32, 64)
    n = 32 * 64
    macs = 3 * 266 * 256 + 3 * 3 * 256 * 256 + 256 * 96
    assert dec["flops"] == 2 * n * 8 * macs
    assert dec["bytes"] == 4 * (8 * macs + 8 * (4 * 256 + 96)
                                + n * 266 + n * 8 * 96)
    assert cls["flops"] == 2 * n * (3 * 266 * 256 + 5 * 3 * 256 * 256
                                    + 256 * 8)
    # 31.70 GFLOP of f32 work a bs32 call: compute-bound at 989 TFLOP/s
    total = dec["flops"] + cls["flops"]
    assert abs(total / 1e9 - 31.70) < 0.01
    assert work.bound_s(dec["flops"], dec["bytes"]) == \
        dec["flops"] / work.PEAK_BF16_FLOPS


def test_k3_work_by_hand():
    w = work.k3_shapes(CFG, 32, 64)
    n = 32 * 64
    macs = 3 * 266 * 256 + 3 * 3 * 256 * 256 + 256 * 96
    assert w["flops"] == 3 * 2 * n * 8 * macs        # forward + 2 × it
    params = 8 * macs + 8 * (4 * 3 * 256 + 96)
    assert w["bytes"] == 4 * ((n * 266 + params + 8 * n * 96 + 2 * 8 * 4 * 256)
                              + (8 * n * 96 + 2 * n * 266 + 2 * params))
    assert abs(w["flops"] / 1e9 - 80.48) < 0.01


def test_train_step_flops_structure():
    f = work.forward_flops(CFG, 32, 64)
    steps = work.train_step_flops(CFG, 32, 64)
    assert steps["g"] == 3 * f["gen"] + 5 * f["psenc"] + 2 * f["disc"]
    assert steps["d"] == f["gen"] + 6 * f["disc"]
    # the serving call's generator forward, the mixture included
    dec, cls = work.k1_shapes(CFG, 32, 64)
    assert f["gen"] > dec["flops"] + cls["flops"]


def test_kernel_short_names():
    assert short_name("void (anonymous namespace)::decoder_kernel<24, 3, "
                      "false>(float const*, int)") == \
        "{anon}::decoder_kernel<24, 3, false>"
    assert short_name("void mixstage::k3::wgmma_gemm_kernel<2, 1, 96, "
                      "float, 3>(Params, int)") == \
        "mixstage::k3::wgmma_gemm_kernel<2, 1, 96, float, 3>"


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(tiny_cell, cpu, trace):
    cell = tiny_cell("mixstage8.serve.f32.bs32")
    out = execute(cell, SEED, 0.3, bool(trace), cpu, 0.0)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(out) == want
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        dev |= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    assert set(out["device"]) == dev
    names = {m["name"] for m in (cell.per_layer() if trace
                                 else cell.end_to_end())}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert out["correct"] is True
    assert set(out["checks"]["pose_err"]) == {"value", "limit"}
    assert forbidden_modules() == []


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mixstage_tpu_torch_x", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert forbidden_modules() == ["jaxlib"]


def test_reference_and_yardstick_load_nothing_of_the_program():
    code = ("import sys, bench_port.reference.steps, "
            "bench_port.harness.work, bench_port.harness.data, "
            "bench_port.harness.checks, bench_port.harness.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"mixstage_tpu_torch", "mixstage_tpu", "jax",
                         "jaxlib", "flax", "optax", "orbax"}


def test_run_without_a_card_exits_nonzero_with_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload",
         "mixstage8.serve.f32.bs32", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, text=True, capture_output=True)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A checkout holding only the manifest and the benchmark's folder."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload",
         "mixstage8.serve.f32.bs32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, text=True, capture_output=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
