"""Tiny cells for the benchmark's CPU tests: every cell of the manifest at
a width and batch the CPU runs in seconds (the published depth and
structure kept), on the program's plain routes."""

from __future__ import annotations

import pytest
import torch

from bench_port.harness.spec import ROOT, Cell, load_manifest

TINY_CONFIG = {"in_channels": 32, "style_dim": 4, "out_feats": 12,
               "num_clusters": 2, "num_speakers": 2, "mel_bins": 16}
TINY_TRAFFIC = {
    "train": dict(batch=4, frames=64, batches=4, steps_per_call=4,
                  check_calls=2, trace_calls=1),
    "serve": dict(batch=4, frames=64, batches=3, warm_calls=1,
                  keep_calls=3, trace_calls=2),
    "open_loop": dict(batch=4, frames=64, rate=40, pool=16, warm_calls=1,
                      warm_requests=8, keep_requests=8, trace_seconds=0.5),
}
SEED = 2 ** 33 + 7  # more than 32 bits


def tiny(cell: Cell) -> Cell:
    cell.config = {**cell.config, **{k: v for k, v in TINY_CONFIG.items()
                                     if k in cell.config}}
    cell.traffic = {**cell.traffic,
                    **TINY_TRAFFIC[cell.traffic["loop"]]}
    return cell


@pytest.fixture
def tiny_cell():
    def make(name: str, root=ROOT) -> Cell:
        return tiny(Cell(load_manifest(root), name, root))
    return make


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "size on the chip")
    return torch.device("cuda", 0)
