"""``cli.train -num_devices 2`` on two gloo ranks against the one-process
trainer, on the CPU (synthetic PATS, ``-debug 2``, the fused decoder).

Both runs are child processes (``_torch_port_parallel.py``) on identical
copies of the data.  Every G and D step is logged with its coin, its
batch and its losses: the two ranks see the one-process trainer's
batches and coins exactly, and report its losses at rtol 2e-4 (JAX's
data-parallel tolerance, ``tests/test_parallel.py:31-70``: the sums are
taken in another order); the checkpointed parameters agree at rtol 2e-4
within 2·lr a step (Adam's ±lr·sign(g) where a noise-level gradient
flips), the running statistics also within 1e-4 of their scale.  Only rank 0 writes files (rank 1 opens none for writing), and it
writes the one-process trainer's files.  One process asking for
``-num_devices 2`` raises ``ValueError`` naming the launch.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_parallel import run_ranks
from mixstage_tpu_torch.cli import train as cli_train
from mixstage_tpu_torch.config import config_from_dict, get_args_perm
from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset

LR = 1e-4


def argv(data, save, n):
    return ["-path2data", data, "-speaker", '["oliver", "maher"]',
            "-batch_size", "4", "-num_epochs", "1", "-window_hop", "5",
            "-num_iters", "2", "-debug", "2", "-model",
            "JointLateClusterSoftStyle4_G", "-gan", "1", "-loss", "L1Loss",
            "-num_clusters", "2", "-modelKwargs", '{"in_channels": 64}',
            "-fused_decoder", "1", "-lr", str(LR), "-save_dir", save,
            "-num_devices", str(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")

    def one(world):
        data = str(root / f"data{world}")
        make_synthetic_dataset(data, ["oliver", "maher"], 3)
        save = str(root / f"save{world}")
        log = str(root / f"log{world}_{{rank}}.json")
        run_ranks("trainer", root / f"work{world}", world,
                  {"argv": argv(data, save, world), "log": log})
        logs = [json.loads(Path(log.format(rank=r)).read_text())
                for r in range(world)]
        return data, Path(save), logs

    with ThreadPoolExecutor(2) as ex:
        single, dp = ex.map(one, (1, 2))
    return single, dp


def test_batches_coins_and_losses_match_one_process(runs):
    (_, _, single), (_, _, dp) = runs
    want = single[0]["steps"]
    assert len(want) >= 3 and {s["kind"] for s in want} <= {"g", "d"}
    for logs in dp:
        got = logs["steps"]
        assert [(s["kind"], s["pose_input"], s["batch"]) for s in got] == \
            [(s["kind"], s["pose_input"], s["batch"]) for s in want]
        for a, b in zip(got, want):
            assert a["losses"].keys() == b["losses"].keys()
            for k, v in b["losses"].items():
                np.testing.assert_allclose(a["losses"][k], v, rtol=2e-4,
                                           atol=1e-6, err_msg=k)
    assert dp[0]["steps"] == dp[1]["steps"]       # one global step


def test_checkpoint_matches_one_process(runs):
    (_, save1, single), (_, save2, _) = runs
    a = torch.load(next(save1.glob("*_weights.p")), weights_only=True)
    b = torch.load(next(save2.glob("*_weights.p")), weights_only=True)
    steps = len(single[0]["steps"])
    assert a.keys() == b.keys()
    for module in a:
        assert a[module].keys() == b[module].keys()
        for k, v in a[module].items():
            w = b[module][k]
            # a parameter moves by 2·lr where a noise-level gradient flips;
            # a running mean takes the drift of the conv bias before its
            # BatchNorm (gradient 0 analytically) on top of 1e-4 of scale
            atol = 2 * LR * steps + 1e-6
            if "running_" in k:
                atol += 1e-4 * v.abs().max().item()
            np.testing.assert_allclose(w, v, rtol=2e-4, atol=atol,
                                       err_msg=f"{module}/{k}")


def test_only_rank_0_writes(runs):
    (data1, save1, single), (data2, save2, dp) = runs
    assert dp[1]["written"] == []
    assert dp[0]["written"]

    def rel(paths, data, save):
        out = set()
        for p in paths:
            for base, tag in ((save, "save"), (data, "data")):
                if p.startswith(str(base)):
                    out.add((tag, Path(p).relative_to(base).as_posix()))
        return out

    assert rel(dp[0]["written"], data2, save2) == \
        rel(single[0]["written"], data1, save1)
    files = sorted(p.relative_to(save2).as_posix()
                   for p in save2.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(save1).as_posix()
                           for p in save1.rglob("*") if p.is_file())


def test_one_process_asking_for_two_raises(tmp_path):
    _, perms = get_args_perm(argv(str(tmp_path / "absent"),
                                  str(tmp_path / "save"), 2))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli_train.loop(config_from_dict(perms[0]), 0, device="cpu")
