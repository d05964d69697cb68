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

The same per-leaf rule carries optimizer moments, which are trees shaped
like ``params`` (Adam's ``mu`` / ``nu``): ``flax_params_to_torch`` and
``torch_params_to_flax`` convert any such tree, keyed by torch parameter
name.  Any module whose names follow the flax tree goes through the bridge:
the generator, the pose-style encoder and the discriminator.
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


def _torch_leaf_name(collection: str, path: Tuple[str, ...]):
    leaf = _TO_TORCH.get((collection, path[-1]))
    return ".".join(path[:-1] + (leaf,)) if leaf else None


def flax_params_to_torch(model: nn.Module, tree: Dict[str, Any]
                         ) -> Dict[str, np.ndarray]:
    """A params-shaped flax tree (params, or an optimizer moment of them)
    → ``{torch parameter name: array in torch layout}``; total both ways."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = {}
    for path, value in _leaves(tree):
        name = _torch_leaf_name("params", path)
        if name not in shapes:
            raise KeyError(f"flax params leaf {'/'.join(path)} has no "
                           f"counterpart in {type(model).__name__}")
        arr = np.asarray(value)
        if path[-1] == "kernel":
            arr = _kernel_to_torch(arr)
        if shapes[name] != arr.shape:
            raise ValueError(f"{name}: flax {arr.shape} (torch layout) vs "
                             f"port {shapes[name]}")
        out[name] = np.array(arr, order="C")  # a writable, contiguous copy
    unfilled = sorted(set(shapes) - set(out))
    if unfilled:
        raise KeyError(f"no flax leaf fills {len(unfilled)} port parameters;"
                       f" first few: {unfilled[:5]}")
    return out


def torch_params_to_flax(model: nn.Module, tensors: Dict[str, torch.Tensor]
                         ) -> Dict[str, Any]:
    """The inverse of ``flax_params_to_torch``: ``{torch parameter name:
    tensor}`` (every parameter of ``model``) → a nested flax tree of numpy
    arrays."""
    names = [n for n, _ in model.named_parameters()]
    missing = sorted(set(names) ^ set(tensors))
    if missing:
        raise KeyError(f"tensors and {type(model).__name__}'s parameters "
                       f"differ at {missing[:5]}")
    tree: Dict[str, Any] = {}
    for name in names:
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        arr = tensors[name].detach().cpu().numpy()
        if leaf == "weight":
            if isinstance(owner, BatchNorm):
                leaf = "scale"
            else:
                leaf, arr = "kernel", _kernel_to_flax(arr)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


@torch.no_grad()
def load_flax_state(model: nn.Module, params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters and buffers from a flax ``params`` /
    ``batch_stats`` pair (nested dicts of numpy arrays, e.g. a generator's
    ``state.g_params["gen"]`` and ``state.g_state["gen"]``)."""
    values = flax_params_to_torch(model, params)
    buffers = dict(model.named_buffers())
    for path, value in _leaves(batch_stats):
        name = _torch_leaf_name("batch_stats", path)
        if name not in buffers:
            raise KeyError(f"flax batch_stats leaf {'/'.join(path)} has no "
                           f"counterpart in {type(model).__name__}")
        arr = np.array(value)
        if tuple(buffers[name].shape) != arr.shape:
            raise ValueError(f"{name}: flax {arr.shape} vs port "
                             f"{tuple(buffers[name].shape)}")
        values[name] = arr
    unfilled = sorted(set(buffers) - set(values))
    if unfilled:
        raise KeyError(f"no flax leaf fills {len(unfilled)} port buffers; "
                       f"first few: {unfilled[:5]}")
    targets = dict(model.named_parameters(), **buffers)
    for name, arr in values.items():
        targets[name].copy_(torch.from_numpy(arr))
    return model


def to_flax_state(model: nn.Module
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``load_flax_state``: ``(params, batch_stats)`` as
    nested dicts of numpy arrays in flax layout."""
    params = torch_params_to_flax(model, dict(model.named_parameters()))
    stats: Dict[str, Any] = {}
    for name, tensor in model.named_buffers():
        *path, leaf = name.split(".")
        node = stats
        for key in path:
            node = node.setdefault(key, {})
        node[_BUFFER_TO_FLAX[leaf]] = tensor.detach().cpu().numpy().copy()
    return params, stats


def _adam_state(opt_state):
    """The node of an optax state (nested tuples) that holds Adam's
    ``count`` / ``mu`` / ``nu`` (found by duck typing: the port imports
    no optax)."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for node in opt_state:
            found = _adam_state(node)
            if found is not None:
                return found
    return None


@torch.no_grad()
def load_flax_opt_state(opt, modules: Dict[Any, nn.Module], opt_state
                        ) -> None:
    """Fill an optimizer's Adam moments and count from an optax state.

    ``modules`` maps each top-level key of the params tree to its module
    (``{"gen": gen, "psenc": psenc}`` for G; ``{None: disc}`` when the tree
    is the module's own, as D's is).  Kernels go through the same layout
    rule as the parameters; every moment of ``opt`` must be filled."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in the optax state")
    index = {n: i for i, n in enumerate(opt.names)}
    filled = set()
    for moments, tree in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
        for key, module in modules.items():
            sub = tree if key is None else tree[key]
            for name, arr in flax_params_to_torch(module, sub).items():
                full = name if key is None else f"{key}.{name}"
                if full not in index:
                    raise KeyError(f"moment {full} has no optimizer leaf")
                dst = moments[index[full]]
                dst.copy_(torch.from_numpy(arr).to(dst.device))
                filled.add(full)
    unfilled = sorted(set(opt.names) - filled)
    if unfilled:
        raise KeyError(f"no optax moment fills {unfilled[:5]}")
    opt.count = int(np.asarray(adam.count))


def to_flax_opt_state(opt, modules: Dict[Any, nn.Module]) -> Dict[str, Any]:
    """The inverse of ``load_flax_opt_state``: ``{"count", "mu", "nu"}``
    with ``mu`` / ``nu`` as flax params trees of numpy arrays."""
    out: Dict[str, Any] = {"count": np.int32(opt.count)}
    for field, moments in (("mu", opt.mu), ("nu", opt.nu)):
        by_name = dict(zip(opt.names, moments))
        tree: Dict[str, Any] = {}
        for key, module in modules.items():
            prefix = "" if key is None else f"{key}."
            sub = torch_params_to_flax(module, {
                n: by_name[prefix + n] for n, _ in module.named_parameters()})
            if key is None:
                tree = sub
            else:
                tree[key] = sub
        out[field] = tree
    return out
