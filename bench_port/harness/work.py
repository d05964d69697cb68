"""Operations and bytes, from a configuration's shapes, and the card's
peaks: the yardstick of every roofline and MFU metric.

A kernel's bound is the least time an H100 could take for the work the
configuration states (float32), whatever route computes it: its
multiply-adds counted once at the dense bf16 tensor-core peak, or each
input read once and each output written once at the HBM rate, whichever
is longer.  No route can then read above 100%, one with fewer bf16 products
than today's included.  A model's FLOPs are its convolutions' and
matmuls' multiply-adds × 2, counted by running the plain reference on the
``meta`` device.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from bench_port.reference.layers import EmbLin, GroupedPointwiseConv
from bench_port.reference.models import build

# NVIDIA H100 SXM, dense, without sparsity (the data sheet; at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def conv_flops(out_elems: int, cin_per_group: int, taps: int) -> int:
    """2 × every multiply-add of a convolution with ``out_elems`` outputs,
    each summing ``cin_per_group`` channels over ``taps`` positions."""
    return 2 * out_elems * cin_per_group * taps


def k1_work(B, T, G, C0, C, L, F) -> Dict[str, int]:
    """One K1 call: a chain of one (C0 → C) and L (C → C) k=3 convs with
    folded BatchNorm and leaky units, then a 1×1 (C → F) head, per group
    of G, on B·T frames.  Reads x (B, T, C0) and the float32 weights and
    biases once; writes the (B, T, G·F) logits once."""
    n = B * T
    macs = 3 * C0 * C + L * 3 * C * C + C * F
    weights = G * macs + G * ((L + 1) * C + F)
    return {"flops": 2 * n * G * macs,
            "bytes": F32 * (weights + n * C0 + n * G * F)}


def k3_work(B, T, G, C0, C, F) -> Dict[str, int]:
    """K3's forward and backward in one G step: the training decoder's
    four conv + train-mode BatchNorm + leaky layers (one C0 → C, three
    C → C, k = 3) and its 1×1 head, per group of G.  The backward does the
    forward's multiply-adds twice (input and weight gradients).  Bytes:
    forward reads x and the parameters and writes the logits and the batch
    statistics; backward reads the logits' gradient, x and the parameters
    and writes x's and the parameters' gradients; float32, once each."""
    n = B * T
    macs = 3 * C0 * C + 3 * 3 * C * C + C * F
    params = G * macs + G * (4 * 3 * C + F)
    fwd = F32 * (n * C0 + params + G * n * F + 2 * G * 4 * C)
    bwd = F32 * (G * n * F + n * C0 + params + n * C0 + params)
    return {"flops": 3 * 2 * n * G * macs, "bytes": fwd + bwd}


def k1_shapes(cfg: dict, B: int, T: int):
    """K1's two launches of a serving call: the mixture decoder and the
    cluster classifier's chain."""
    C, sd = cfg["in_channels"], cfg["style_dim"]
    return [k1_work(B, T, cfg["num_clusters"], C + sd, C, 3,
                    cfg["out_feats"]),
            k1_work(B, T, 1, C + sd, C, 5, cfg["num_clusters"])]


def k3_shapes(cfg: dict, B: int, T: int):
    C, sd = cfg["in_channels"], cfg["style_dim"]
    return k3_work(B, T, cfg["num_clusters"], C + sd, C, cfg["out_feats"])


def _count(module: nn.Module, fn: Callable[[], object]) -> int:
    """FLOPs of the convolutions and matmuls that ``fn`` runs."""
    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            taps = mod.weight[0, 0].numel()
            total[0] += conv_flops(out.numel(), mod.weight.shape[1], taps)
        elif isinstance(mod, GroupedPointwiseConv):
            total[0] += conv_flops(out.numel(), mod.weight.shape[1], 1)
        elif isinstance(mod, EmbLin):
            total[0] += 2 * out.numel() * mod.embedding.shape[0]

    handles = [m.register_forward_hook(hook) for m in module.modules()]
    try:
        with torch.no_grad():
            fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def forward_flops(cfg: dict, B: int, T: int) -> Dict[str, int]:
    """Forward FLOPs of the generator, the pose-style encoder (0 without
    one) and D at B clips × T frames, the mixture's sum included."""
    with torch.device("meta"):
        gen, psenc, disc = build(cfg)
        audio = torch.zeros(B, T, cfg["mel_bins"])
        pose = torch.zeros(B, T, cfg["out_feats"])
        if psenc is None:
            fg = _count(gen, lambda: gen(audio))
            fp = 0
        else:
            w = torch.zeros(B, T, cfg["num_speakers"])
            fg = _count(gen, lambda: gen(audio, w))
            fg += 2 * B * T * cfg["num_clusters"] * cfg["out_feats"]
            fp = _count(psenc, lambda: psenc(pose))
        fd = _count(disc, lambda: disc(pose))
    return {"gen": fg, "psenc": fp, "disc": fd}


def train_step_flops(cfg: dict, B: int, T: int) -> Dict[str, int]:
    """Model FLOPs of one G step and one D step.  A module whose
    parameters train costs 3 × its forward (forward, input and weight
    gradients); one that only passes gradients on, 2 ×; one run without
    gradients, 1 ×.  G step: G trains (3), the style encoder trains on the
    real pose (3) and passes gradients on the fake (2), D passes them on
    (2).  D step: G forward (1), D trains on the fake and the real (2 ×
    3)."""
    f = forward_flops(cfg, B, T)
    return {"g": 3 * f["gen"] + 5 * f["psenc"] + 2 * f["disc"],
            "d": f["gen"] + 6 * f["disc"]}


def serve_call_flops(cfg: dict, B: int, T: int) -> int:
    """Model FLOPs of one serving call: the generator's forward."""
    return forward_flops(cfg, B, T)["gen"]
