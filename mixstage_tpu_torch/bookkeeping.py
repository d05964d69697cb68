"""Experiment bookkeeping: naming, results, early stopping, checkpoints.

The port's copy of ``mixstage_tpu/bookkeeping.py`` with the same
experiment-file contract (reference README.md:155-170):

  ``PREFIX = exp_<num>_cpk_<name>_speaker_<speaker>_model_<model>[_note_<note>]``
  ``PREFIX_args.args`` (json), ``PREFIX_res.json``, ``PREFIX_weights.p``,
  ``PREFIX_log.log``, ``PREFIX_name.name``.

The checkpoints are ``torch.save`` files and load with
``torch.load(weights_only=True)``, where the JAX package writes flax msgpack
(or an orbax directory):

* ``PREFIX_weights.p``: ``{"gen", "psenc", "disc"}``, each module's state
  dict (parameters and BatchNorm statistics), for the modules the
  configuration has (a non-GAN model has no ``disc``; ``StyleClassifier_G``
  and ``Speech2Gesture_G`` have no ``psenc``);
* ``PREFIX_trainstate.p`` (``-save_optim 1``): the optimizers' states
  (Adam's ``mu`` / ``nu``, SGD's ``trace``, RMSprop's ``nu``) and counts,
  and the state's four counters;
* ``PREFIX_preempt.p``: both of these together, the live state that a
  SIGTERM snapshots (with ``PREFIX_preempt.json``, the loop's metadata).

``-load`` also takes a reference (chahuja/mix-stage) ``PREFIX_weights.p``,
converted on the way (``_load_model``).
"""

from __future__ import annotations

import json
import os
import pickle
import random
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mixstage_tpu_torch.config import Config, config_from_dict

MODULES = ("gen", "psenc", "disc")
COUNTERS = ("step", "g_step", "lambda_step", "curriculum_step")


def modules_of(state) -> List[str]:
    """The names of ``MODULES`` that ``state`` has."""
    return [m for m in MODULES if getattr(state, m) is not None]


def is_port_checkpoint(ckpt) -> bool:
    """Whether a loaded torch file is ``weights_of``'s dict: state dicts
    keyed by some of ``MODULES``, ``gen`` among them."""
    return isinstance(ckpt, dict) and "gen" in ckpt and \
        set(ckpt) <= set(MODULES) and \
        all(isinstance(v, dict) for v in ckpt.values())


def weights_of(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The modules' state dicts (parameters and BN statistics), copied to
    the CPU."""
    return {m: {k: v.detach().cpu().clone()
                for k, v in getattr(state, m).state_dict().items()}
            for m in modules_of(state)}


def _optimizers(state):
    return [(name, getattr(state, name)) for name in ("g_opt", "d_opt")
            if getattr(state, name) is not None]


def optim_of(state) -> Dict[str, Any]:
    """The optimizers' state tensors (``opt.slots()``) and counts, and the
    counters."""
    out: Dict[str, Any] = {
        name: {"names": list(opt.names), "count": int(opt.count),
               **{slot: [t.detach().cpu().clone() for t in tensors]
                  for slot, tensors in opt.slots().items()}}
        for name, opt in _optimizers(state)}
    out["counters"] = {k: int(getattr(state, k)) for k in COUNTERS}
    return out


@torch.no_grad()
def load_weights(state, weights: Dict[str, Dict[str, torch.Tensor]]):
    """Copy ``weights_of``'s dicts into ``state``'s modules, in place; the
    checkpoint must hold exactly the state's modules."""
    if sorted(weights) != sorted(modules_of(state)):
        raise ValueError(f"the checkpoint holds {sorted(weights)}, the "
                         f"model {sorted(modules_of(state))}")
    for m in modules_of(state):
        getattr(state, m).load_state_dict(weights[m])
    return state


@torch.no_grad()
def load_optim(state, full: Dict[str, Any]):
    """Copy ``optim_of``'s state tensors, counts and counters into
    ``state``."""
    for name, opt in _optimizers(state):
        saved = full[name]
        if list(saved["names"]) != list(opt.names):
            raise ValueError(f"{name}: the checkpoint's parameters differ "
                             f"from the model's")
        for slot, tensors in opt.slots().items():
            if slot not in saved:
                raise ValueError(f"{name}: the checkpoint has no {slot} "
                                 f"(another optimizer's state)")
            for dst, src in zip(tensors, saved[slot]):
                dst.copy_(src)
        opt.count = int(saved["count"])
    for k in COUNTERS:
        setattr(state, k, int(full["counters"][k]))
    return state


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_port_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """``weights_of``'s dict from a weights file of the port; anything else
    (a JAX checkpoint, flax msgpack or orbax) raises."""
    try:
        ckpt = _torch_load(path)
    except (pickle.UnpicklingError, RuntimeError, IsADirectoryError):
        ckpt = None                   # not a torch file (msgpack, orbax)
    if not is_port_checkpoint(ckpt):
        raise NotImplementedError(
            f"{path} is not a checkpoint of the port; importing a JAX "
            f"checkpoint (flax msgpack or orbax) comes later (ROADMAP queue "
            f"1 item 7)")
    return ckpt


class Name:
    """Experiment-name builder: callable → PREFIX-path (pycasper Name)."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def __call__(self, suffix: str, ext: str, save_dir: str) -> str:
        os.makedirs(save_dir, exist_ok=True)
        return (Path(save_dir) / f"{self.prefix}_{suffix}.{ext}").as_posix()

    def dir(self, save_dir: str) -> str:
        path = Path(save_dir) / self.prefix
        os.makedirs(path, exist_ok=True)
        return path.as_posix()


def _next_exp_num(save_dir: str) -> int:
    os.makedirs(save_dir, exist_ok=True)
    nums = []
    for f in os.listdir(save_dir):
        if f.startswith("exp_"):
            try:
                nums.append(int(f.split("_")[1]))
            except (IndexError, ValueError):
                pass
    return max(nums) + 1 if nums else 1


class BookKeeper:
    weights_ext = ("weights", "p")

    def __init__(self, args: Config, args_subset: Optional[List[str]] = None,
                 args_dict_update: Optional[Dict[str, Any]] = None,
                 tensorboard: Optional[int] = None, layout=None):
        # under a data-parallel layout (parallel/mesh.py) only rank 0
        # writes files; the others take its experiment number and wait
        # for its checkpoints at a barrier
        self.layout = layout
        self.writer = layout is None or layout.is_main
        args_subset = args_subset or ["exp", "cpk", "speaker", "model", "note"]
        args_dict_update = dict(args_dict_update or {})

        if getattr(args, "ckpt_backend", "msgpack") != "msgpack":
            raise NotImplementedError(
                f"-ckpt_backend {args.ckpt_backend}: the orbax directory is "
                f"the JAX package's; the port writes torch checkpoints "
                f"(PREFIX_weights.p, with -save_optim 1 the optimizer too)")
        self._restored_from_ckpt = False
        if getattr(args, "load", None):
            args = self._restore_args(args, args_dict_update)
        else:
            for k, v in args_dict_update.items():
                setattr(args, k, v)
        self.args = args

        if self.args.exp is None:
            exp = [_next_exp_num(self.args.save_dir) if self.writer else None]
            if layout is not None and layout.world > 1:
                import torch.distributed as dist

                dist.broadcast_object_list(exp, src=0)
            self.args.exp = exp[0]
        parts = []
        for key in args_subset:
            val = getattr(self.args, key, None)
            if val is None:
                continue
            parts.append(f"{key}_{val}")
        self.name = Name("_".join(parts))
        self.save_dir = self.args.save_dir

        self.res: Dict[str, List[float]] = {}
        self.dev_sign = self.args.dev_sign
        self.dev_key = self.args.dev_key
        self.best_dev_score = np.inf * self.dev_sign
        self.stop_count = 0
        self._log_file = None
        # default to args.tb so BookKeeper(cfg) alone honours -tb 1
        self._tb = (getattr(self.args, "tb", 0)
                    if tensorboard is None else tensorboard)

        # persist args + name immediately (reference file contract) — but
        # never rewrite a restored experiment's stored args: that would bake
        # inference-time CLI overrides (window_hop=0, -render N, scratch
        # data paths) into the training record
        if not self._restored_from_ckpt and self.writer:
            self.args.save(self.name("args", "args", self.save_dir))
            with open(self.name("name", "name", self.save_dir), "w") as f:
                f.write(self.name.prefix)

    # ------------------------------------------------------------- restore
    def _restore_args(self, args: Config, args_dict_update: Dict) -> Config:
        """Rebuild args from the checkpoint's ``_args.args`` file, then apply
        updates (reference sample.py:10-15 semantics)."""
        load_path = args.load
        args_file = re.sub(r"_weights\.p$", "_args.args", load_path)
        if os.path.exists(args_file):
            self._restored_from_ckpt = True
            with open(args_file) as f:
                restored = config_from_dict(json.load(f))
            restored.load = load_path
            for k, v in args_dict_update.items():
                setattr(restored, k, v)
            return restored
        for k, v in args_dict_update.items():
            setattr(args, k, v)
        return args

    # ---------------------------------------------------------------- seeds
    def _set_seed(self):
        seed = self.args.seed
        if seed:
            np.random.seed(seed)
            random.seed(seed)
            os.environ["PYTHONHASHSEED"] = str(seed)
            print(f"Deterministic Mode!! Seed set to {seed}")

    # ----------------------------------------------------------------- logs
    def _start_log(self):
        if not self.writer:
            return
        self._log_file = open(self.name("log", "log", self.save_dir), "a")
        self._log_file.write(f"--- start {time.asctime()}\n")
        self._log_file.flush()

    def _stop_log(self):
        if self._log_file:
            self._log_file.write(f"--- stop {time.asctime()}\n")
            self._log_file.close()
            self._log_file = None

    def log(self, msg: str):
        if not self.writer:
            return
        print(msg)
        if self._log_file:
            self._log_file.write(msg + "\n")
            self._log_file.flush()

    # ----------------------------------------------------------- checkpoint
    def _save_model(self, state):
        if not self.args.save_model:
            return
        if self.writer:
            _atomic_save(weights_of(state),
                         self.name(*self.weights_ext, self.save_dir))
            if getattr(self.args, "save_optim", 0):
                self._save_train_state(state)
        if self.layout is not None:
            self.layout.barrier()

    # -- preemption survival: the LIVE state, weights + optimizer + counters,
    # in a file apart from the greedy-saved best weights ------------------
    def _preempt_paths(self):
        return (self.name("preempt", "p", self.save_dir),
                self.name("preempt", "json", self.save_dir))

    def save_preempt(self, state, meta: Dict[str, Any]):
        """Snapshot the LIVE training state (weights + optimizer +
        counters) and the host loop's metadata on a preemption signal.

        Written to a SEPARATE ``PREFIX_preempt.p`` so the greedy-saved best
        model (``PREFIX_weights.p``) is never overwritten by a mid-training
        state; a rerun of the same command consumes and clears it.
        """
        if not self.writer:
            return
        p_state, p_meta = self._preempt_paths()
        with open(p_meta, "w") as f:
            json.dump(meta, f, indent=2)
        _atomic_save({"weights": weights_of(state), "train": optim_of(state)},
                     p_state)

    def load_preempt(self, state):
        """``(state, meta)`` from a preemption snapshot, or ``None``; the
        FULL state (optimizer and counters too, whatever ``-save_optim``
        says: exact resume is the point)."""
        p_state, p_meta = self._preempt_paths()
        if not os.path.exists(p_state):
            return None
        full = _torch_load(p_state)
        meta = {}
        if os.path.exists(p_meta):
            with open(p_meta) as f:
                meta = json.load(f)
        load_weights(state, full["weights"])
        return load_optim(state, full["train"]), meta

    def clear_preempt(self):
        if self.layout is not None:
            self.layout.barrier()       # every rank has read the snapshot
        if not self.writer:
            return
        for path in self._preempt_paths():
            if os.path.exists(path):
                os.remove(path)

    # -- full-state checkpoints (-save_optim 1) ----------------------------
    def _save_train_state(self, state):
        _atomic_save(optim_of(state),
                     self.name("trainstate", "p", self.save_dir))

    def _load_train_state(self, state):
        """Restore optimizer state + counters on top of a weights restore;
        returns the state unchanged when no trainstate file exists."""
        path = self.name("trainstate", "p", self.save_dir)
        if not os.path.exists(path):
            return state
        return load_optim(state, _torch_load(path))

    def _load_model(self, state):
        """Return ``state`` with weights restored from ``args.load`` (or the
        experiment's own weights file).

        Both the port's checkpoints and the reference's (chahuja/mix-stage,
        pycasper ``PREFIX_weights.p``) are torch files: a dict keyed exactly
        by some of ``MODULES`` is the port's own; a flat state dict (keys with or
        without ``G.`` / ``D.``) is the reference's, converted into the
        modules on the way (``interop/torch_import.py``, as the JAX
        package's ``-load`` does, ``bookkeeping.py:385-403``).  Anything
        else, a JAX checkpoint among them, raises."""
        from mixstage_tpu_torch.interop.torch_import import (
            is_reference_state_dict, load_reference_state,
            state_dict_to_numpy)

        path = self.args.load or self.name(*self.weights_ext, self.save_dir)
        try:
            ckpt = _torch_load(path)
        except (pickle.UnpicklingError, RuntimeError,
                IsADirectoryError):                 # not a torch file
            ckpt = None
        if is_port_checkpoint(ckpt):
            return load_weights(state, ckpt)
        if is_reference_state_dict(ckpt):
            state, report = load_reference_state(state,
                                                 state_dict_to_numpy(ckpt))
            print(f"[import] converted {report['n_converted']} tensors from "
                  f"reference torch checkpoint {path} "
                  f"({report['n_skipped']} reference-only keys skipped)")
            if report["surprising_skipped"]:
                print("[import] NOTE unrecognized reference keys skipped: "
                      + ", ".join(report["surprising_skipped"][:8]))
            return state
        raise NotImplementedError(
            f"{path} is neither a checkpoint of the port nor a reference "
            f"(chahuja/mix-stage) state dict; importing a JAX checkpoint "
            f"(flax msgpack or orbax) comes later (ROADMAP queue 1 item 7)")

    def export_experiment(self, state, out_dir: str) -> str:
        """Write this experiment (args + weights) in the port's format into
        ``out_dir``: ``cli.import_torch`` calls it after ``_load_model``
        converted a reference checkpoint.  The written args drop ``load``,
        so the new experiment stands alone.  Returns the weights path."""
        import copy

        args = copy.deepcopy(self.args)
        args.load = None
        args.save_dir = out_dir
        args.save(self.name("args", "args", out_dir))
        with open(self.name("name", "name", out_dir), "w") as f:
            f.write(self.name.prefix)
        path = self.name(*self.weights_ext, out_dir)
        _atomic_save(weights_of(state), path)
        return path

    # ---------------------------------------------------------------- results
    def update_res(self, res_dict: Dict[str, float]):
        for key, val in res_dict.items():
            self.res.setdefault(key, []).append(float(val))

    def _save_res(self):
        if not self.writer:
            return
        with open(self.name("res", "json", self.save_dir), "w") as f:
            json.dump(self.res, f)

    def print_res(self, epoch, key_order, metric_order=(), exp=None, lr=None):
        parts = [f"exp: {exp}", f"epoch: {epoch}"]
        for key in list(key_order):
            if key in self.res and self.res[key]:
                parts.append(f"{key}: {self.res[key][-1]:.6f}")
        for key in metric_order:
            for split in ["train", "dev", "test"]:
                full = f"{split}_{key}"
                if full in self.res and self.res[full]:
                    parts.append(f"{full}: {self.res[full][-1]:.4f}")
        parts.append(f"lr: {lr}")
        self.log("  ".join(str(p) for p in parts))

    def update_tb(self, updates: Dict[str, Any]):
        """Tensorboard scalars (reference trainer.py:533-551); no-op without
        a writer backend."""
        if not self._tb or not self.writer:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tb requested but no backend: warn once, no-op
            if not getattr(self, "_tb_warned", False):
                self._tb_warned = True
                self.log("WARNING: -tb 1 but tensorboard is unavailable; "
                         "scalars will not be written")
            return
        if not hasattr(self, "_writer"):
            self._writer = SummaryWriter(log_dir=self.name.dir(self.save_dir))
        for tag, val, step in updates.get("scalar", []):
            self._writer.add_scalar(tag, float(val), int(step))
        self._writer.flush()

    # ----------------------------------------------------------- early stop
    def stop_training(self, state, epoch) -> bool:
        """Greedy-save + early-stopping policy (pycasper semantics driven by
        dev_key/dev_sign/stop_thresh/eps/greedy_save/overfit/min_epochs —
        reference argsUtils.py:84-97,151-163, invoked trainer.py:564)."""
        key = self.dev_key if self.dev_key in self.res else "dev"
        if key not in self.res or not self.res[key]:
            return False
        score = self.res[key][-1]
        improved = (self.dev_sign * score
                    < self.dev_sign * self.best_dev_score - self.args.eps)
        if self.args.overfit:
            self._save_model(state)
            return False
        if improved:
            self.best_dev_score = score
            self.stop_count = 0
            if self.args.greedy_save:
                self._save_model(state)
        else:
            self.stop_count += 1
        if (self.args.early_stopping and self.stop_count >= self.args.stop_thresh
                and epoch >= self.args.min_epochs):
            self.log(f"early stopping at epoch {epoch} "
                     f"(best {key}: {self.best_dev_score:.6f})")
            return True
        return False


def _atomic_save(obj, path: str) -> None:
    """``torch.save`` to a sibling, then rename: the file at ``path`` is
    always whole."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
