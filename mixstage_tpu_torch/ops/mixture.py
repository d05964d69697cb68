"""Soft mixture-of-generators output selection.

Counterpart of ``mixstage_tpu/ops/mixture.py:18-34``: a tiny batched
contraction, no kernel of its own on either side.
"""

from __future__ import annotations

import torch


def index_select_outputs(x, labels, groups: int):
    """(B, T, groups·F) grouped outputs, (B, T, groups) soft weights →
    (B, T, F) = sum_m labels[..., m] · x_m."""
    B, T, C = x.shape
    x = x.reshape(B, T, groups, C // groups)
    return torch.einsum("btmf,btm->btf", x, labels.reshape(B, T, groups))
