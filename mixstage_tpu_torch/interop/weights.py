"""Weight bridge between the JAX package's flax trees and the port's modules.

The port names its submodules after the flax tree (``audio_encoder.conv0``,
``unet.pre0``, ``classify_cluster.stack.conv0``, ``decoder0`` ...), so a
leaf's torch name is its flax path with one leaf rename, and its torch value
is the flax value with one layout rule:

  params  kernel (k, Cin/G, Cout)         ↔ weight (Cout, Cin/G, k)       conv1d
  params  kernel (kh, kw, Cin/G, Cout)    ↔ weight (Cout, Cin/G, kh, kw)  conv2d
  params  scale / bias                    ↔ BatchNorm weight / bias
  params  bias / embedding                ↔ bias / embedding (copied)
  batch_stats  mean / var                 ↔ running_mean / running_var

These are the inverse of ``mixstage_tpu/interop/torch_import.py::_to_flax``
(``:129-150``).  Both directions are total: a flax leaf with no torch
counterpart, or a torch tensor no flax leaf fills, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from mixstage_tpu_torch.models.layers import BatchNorm

_TO_TORCH = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "embedding"): "embedding",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_BUFFER_TO_FLAX = {"running_mean": "mean", "running_var": "var"}


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if hasattr(value, "items"):             # dicts and FrozenDicts
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _kernel_to_torch(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"conv kernel of rank {arr.ndim}")


def _kernel_to_flax(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    if arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    raise ValueError(f"conv kernel of rank {arr.ndim}")


@torch.no_grad()
def load_flax_state(model: nn.Module, params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters and buffers from a flax ``params`` /
    ``batch_stats`` pair (nested dicts of numpy arrays, e.g. a generator's
    ``state.g_params["gen"]`` and ``state.g_state["gen"]``)."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    filled = set()
    for collection, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _leaves(tree):
            leaf = _TO_TORCH.get((collection, path[-1]))
            name = ".".join(path[:-1] + (leaf,)) if leaf else None
            if name not in targets:
                raise KeyError(f"flax {collection} leaf {'/'.join(path)} has "
                               f"no counterpart in {type(model).__name__}")
            arr = np.asarray(value)
            if path[-1] == "kernel":
                arr = _kernel_to_torch(arr)
            dst = targets[name]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{name}: flax {arr.shape} (torch layout) vs "
                                 f"port {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(name)
    unfilled = sorted(set(targets) - filled)
    if unfilled:
        raise KeyError(f"no flax leaf fills {len(unfilled)} port tensors; "
                       f"first few: {unfilled[:5]}")
    return model


def to_flax_state(model: nn.Module
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``load_flax_state``: ``(params, batch_stats)`` as
    nested dicts of numpy arrays in flax layout."""
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    named = [(n, t, False) for n, t in model.named_parameters()]
    named += [(n, t, True) for n, t in model.named_buffers()]
    for name, tensor, is_buffer in named:
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        arr = tensor.detach().cpu().numpy()
        if is_buffer:
            collection, flax_leaf = "batch_stats", _BUFFER_TO_FLAX[leaf]
        elif leaf == "weight":
            collection = "params"
            if isinstance(owner, BatchNorm):
                flax_leaf = "scale"
            else:
                flax_leaf, arr = "kernel", _kernel_to_flax(arr)
        else:
            collection, flax_leaf = "params", leaf
        node = trees[collection]
        for key in path:
            node = node.setdefault(key, {})
        node[flax_leaf] = np.ascontiguousarray(arr)
    return trees["params"], trees["batch_stats"]
