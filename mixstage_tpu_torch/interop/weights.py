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

The same per-leaf rule carries optimizer states, which are trees shaped
like ``params`` (Adam's ``mu`` / ``nu``, SGD's ``trace``): ``flax_params_to_torch`` and
``torch_params_to_flax`` convert any such tree, keyed by torch parameter
name.  Any module whose names follow the flax tree goes through the bridge:
the generator, the pose-style encoder and the discriminator.

``load_jax_train_state`` carries a whole JAX ``TrainState`` (params, batch
statistics, both optimizer states, the counters) into the port's trainer
state, and ``jax_train_state_of`` carries it back.  The optimizer states
are optax's: Adam's and AdamW's ``mu`` / ``nu`` (a bfloat16 ``mu`` under
``optim_mu_dtype``), SGD's momentum ``trace``, RMSprop's ``nu``
(``load_flax_opt_state``).  ``-optim_separate``'s optax state,
``PartitionState(inner_states={"text": MaskedState(inner_state=...),
"rest": ...})`` with ``MaskedNode`` at the other group's leaves, carries
into the port's ``SeparateTextOptimizer`` group by group, and back.

``quantized_decoder_from_jax`` carries the int8 serving tier's quantized
decoder (``mixstage_tpu/ops/pallas/quant.py::quantize_folded_decoder``)
into the port's layout, so both packages' int8 decoders can run on the same
int8 weights.
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


def _masked(value) -> bool:
    """optax's ``MaskedNode``: an empty named tuple where a masked
    transformation's state has no leaf."""
    return hasattr(value, "_fields") and not value._fields


def _torch_leaf_name(collection: str, path: Tuple[str, ...]):
    leaf = _TO_TORCH.get((collection, path[-1]))
    return ".".join(path[:-1] + (leaf,)) if leaf else None


def flax_params_to_torch(model: nn.Module, tree: Dict[str, Any],
                         masked: bool = False) -> Dict[str, np.ndarray]:
    """A params-shaped flax tree (params, or an optimizer moment of them)
    → ``{torch parameter name: array in torch layout}``; total both ways.
    ``masked``: the tree is a masked optimizer group's, whose ``MaskedNode``
    leaves are skipped, and only the leaves it holds are returned."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    out = {}
    for path, value in _leaves(tree):
        if masked and _masked(value):
            continue
        name = _torch_leaf_name("params", path)
        if name not in shapes:
            raise KeyError(f"flax params leaf {'/'.join(path)} has no "
                           f"counterpart in {type(model).__name__}")
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":        # JAX's bf16 (ml_dtypes)
            arr = arr.astype(np.float32)
        if path[-1] == "kernel":
            arr = _kernel_to_torch(arr)
        if shapes[name] != arr.shape:
            raise ValueError(f"{name}: flax {arr.shape} (torch layout) vs "
                             f"port {shapes[name]}")
        out[name] = np.array(arr, order="C")  # a writable, contiguous copy
    unfilled = sorted(set(shapes) - set(out))
    if unfilled and not masked:
        raise KeyError(f"no flax leaf fills {len(unfilled)} port parameters;"
                       f" first few: {unfilled[:5]}")
    return out


def torch_params_to_flax(model: nn.Module, tensors: Dict[str, torch.Tensor],
                         masked: bool = False) -> Dict[str, Any]:
    """The inverse of ``flax_params_to_torch``: ``{torch parameter name:
    tensor}`` (every parameter of ``model``; ``masked``: some of them) → a
    nested flax tree of numpy arrays."""
    names = [n for n, _ in model.named_parameters()
             if not masked or n in tensors]
    missing = sorted(set(names) ^ set(tensors))
    if missing:
        raise KeyError(f"tensors and {type(model).__name__}'s parameters "
                       f"differ at {missing[:5]}")
    tree: Dict[str, Any] = {}
    for name in names:
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        arr = tensors[name].detach().cpu()
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
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


def _opt_nodes(opt_state) -> Dict[str, Any]:
    """The fields of an optax state (nested tuples of named tuples) that
    hold trees or the count: ``count`` (Adam's or a schedule's, the first
    found) and each moment or trace (``mu``, ``nu``, ``trace``), found by
    duck typing: the port imports no optax."""
    out: Dict[str, Any] = {}

    def walk(node):
        if hasattr(node, "_fields"):
            for field in node._fields:
                value = getattr(node, field)
                if field == "count":
                    out.setdefault("count", value)
                elif hasattr(value, "items"):
                    if field in out:
                        raise KeyError(f"two optax state nodes hold {field}")
                    out[field] = value
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
    walk(opt_state)
    return out


def _partition(opt_state) -> Dict[str, Any]:
    """The inner states of optax's ``multi_transform``
    (``PartitionState.inner_states``), each group's ``MaskedState``
    unwrapped."""
    found = []

    def walk(node):
        if hasattr(node, "_fields"):
            if "inner_states" in node._fields:
                found.append(node.inner_states)
            for field in node._fields:
                walk(getattr(node, field))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
    walk(opt_state)
    if len(found) != 1:
        raise KeyError(f"{len(found)} partitioned optax states; a "
                       f"SeparateTextOptimizer takes one")
    return {g: getattr(v, "inner_state", v) for g, v in found[0].items()}


@torch.no_grad()
def load_flax_opt_state(opt, modules: Dict[Any, nn.Module], opt_state
                        ) -> None:
    """Fill an optimizer's state tensors (``opt.slots()``: Adam's and
    AdamW's ``mu`` / ``nu``, SGD's momentum ``trace``, RMSprop's ``nu``)
    and its count from an optax state.

    ``modules`` maps each top-level key of the params tree to its module
    (``{"gen": gen, "psenc": psenc}`` for G; ``{None: disc}`` when the tree
    is the module's own, as D's is).  Kernels go through the same layout
    rule as the parameters; every slot of ``opt`` must be filled, and the
    optax state may hold no other.  The count is read where the state
    keeps one (Adam's, a schedule's); SGD and RMSprop at a constant rate
    keep none and leave the port's count as it is.  A
    ``SeparateTextOptimizer`` takes ``multi_transform``'s state, each group
    from its own masked inner state."""
    groups = getattr(opt, "groups", None)
    if groups is not None:
        inner = _partition(opt_state)
        if sorted(inner) != sorted(groups):
            raise KeyError(f"the optax partition holds {sorted(inner)}, the "
                           f"optimizer {sorted(groups)}")
        for g, sub in groups.items():
            _load_opt_nodes(sub, modules, inner[g], masked=True)
        return
    _load_opt_nodes(opt, modules, opt_state)


def _load_opt_nodes(opt, modules, opt_state, masked: bool = False) -> None:
    nodes = _opt_nodes(opt_state)
    slots = opt.slots()
    fields = sorted(k for k in nodes if k != "count")
    if fields != sorted(slots):
        raise KeyError(f"the optax state holds {fields}; "
                       f"{type(opt).__name__} keeps {sorted(slots)}")
    index = {n: i for i, n in enumerate(opt.names)}
    for field, tensors in slots.items():
        filled = set()
        for key, module in modules.items():
            sub = nodes[field] if key is None else nodes[field][key]
            for name, arr in flax_params_to_torch(module, sub,
                                                  masked).items():
                full = name if key is None else f"{key}.{name}"
                if full not in index:
                    raise KeyError(f"{field} {full} has no optimizer leaf")
                dst = tensors[index[full]]
                dst.copy_(torch.from_numpy(arr).to(dst.device))
                filled.add(full)
        unfilled = sorted(set(opt.names) - filled)
        if unfilled:
            raise KeyError(f"no optax {field} fills {unfilled[:5]}")
    if "count" in nodes:
        opt.count = int(np.asarray(nodes["count"]))


def to_flax_opt_state(opt, modules: Dict[Any, nn.Module],
                      masked: bool = False) -> Dict[str, Any]:
    """The inverse of ``load_flax_opt_state``: ``{"count", <slot>: tree}``
    for each of ``opt.slots()``, each a flax params tree of numpy arrays
    (a bfloat16 ``mu`` as float32 arrays of the same values); for a
    ``SeparateTextOptimizer`` ``{"inner_states": {group: that dict}}``,
    each group's trees holding its own leaves only."""
    groups = getattr(opt, "groups", None)
    if groups is not None:
        return {"inner_states": {g: to_flax_opt_state(sub, modules, True)
                                 for g, sub in groups.items()}}
    out: Dict[str, Any] = {"count": np.int32(opt.count)}
    for field, tensors in opt.slots().items():
        by_name = dict(zip(opt.names, tensors))
        tree: Dict[str, Any] = {}
        for key, module in modules.items():
            prefix = "" if key is None else f"{key}."
            sub = torch_params_to_flax(module, {
                n: by_name[prefix + n] for n, _ in module.named_parameters()
                if not masked or prefix + n in by_name}, masked)
            if key is None:
                tree = sub
            else:
                tree[key] = sub
        out[field] = tree
    return out


COUNTERS = ("step", "g_step", "lambda_step", "curriculum_step")


def load_jax_train_state(factory, jstate):
    """A JAX ``TrainState`` (``mixstage_tpu/train/state.py``; any object with
    its field names, leaves numpy-convertible) → the port's ``TrainState``
    built by ``factory`` (a ``StepFactory``) on its device: the params and
    BatchNorm statistics of gen, psenc and D (those the configuration
    has), both optimizers' states and counts, and the four counters."""
    return factory.init_from_flax(
        jstate.g_params, jstate.g_state, jstate.d_params, jstate.d_state,
        jstate.g_opt_state, jstate.d_opt_state,
        counters={k: int(np.asarray(getattr(jstate, k))) for k in COUNTERS})


def _g_modules(state) -> Dict[str, nn.Module]:
    """The G side's modules under their params-tree keys."""
    out = {"gen": state.gen}
    if state.psenc is not None:
        out["psenc"] = state.psenc
    return out


def jax_train_state_of(state) -> Dict[str, Any]:
    """The inverse of ``load_jax_train_state``: the port's ``TrainState``
    as a dict of numpy trees under the JAX ``TrainState``'s field names,
    each optimizer state as ``to_flax_opt_state``'s ``{"count", <slot>:
    tree}``; the D side's fields are None without a discriminator."""
    g_mods = _g_modules(state)
    flax = {k: to_flax_state(m) for k, m in g_mods.items()}
    out = {"g_params": {k: v[0] for k, v in flax.items()},
           "g_state": {k: v[1] for k, v in flax.items()},
           "g_opt_state": to_flax_opt_state(state.g_opt, g_mods),
           "d_params": None, "d_state": None, "d_opt_state": None}
    if state.disc is not None:
        out["d_params"], out["d_state"] = to_flax_state(state.disc)
        out["d_opt_state"] = to_flax_opt_state(state.d_opt,
                                               {None: state.disc})
    out.update({k: np.int32(getattr(state, k)) for k in COUNTERS})
    return out


def quantized_decoder_from_jax(qfd: Dict[str, Any], c0: int
                               ) -> Dict[str, Any]:
    """JAX's quantized decoder dict (numpy leaves, ``w0_i8`` with C0 padded
    to 128 lanes, ``s_in`` a tuple of C0p per-channel scales or a float) →
    the port's (``ops/cuda/quant.py``): tensors, the padding of C0 stripped
    to the true width ``c0``, ``s_in`` a (c0,) tensor or a float."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in qfd.items()
           if k != "s_in"}
    out["w0_i8"] = out["w0_i8"][:, :, :c0].contiguous()
    s_in = qfd["s_in"]
    out["s_in"] = (torch.tensor(s_in[:c0], dtype=torch.float32)
                   if isinstance(s_in, (tuple, list, np.ndarray))
                   else float(s_in))
    return out
