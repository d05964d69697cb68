"""One rank of the port's multi-rank tests (started by
``_torch_port_parallel.run_ranks``; imports the port, never JAX).

    python _torch_port_parallel_child.py MODE WORKDIR RANK WORLD

joins the gloo group of WORLD ranks through ``multihost.setup`` with a
``file://`` store in WORKDIR, reads ``spec.json`` (and ``in.npz``), runs
MODE and writes its results to ``out_<RANK>.npz``.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from mixstage_tpu_torch.parallel import mesh, multihost

torch.set_num_threads(2)


def unflatten(flat, prefix):
    """{"prefix/a/b": array} → the nested dict under ``prefix``."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def state_arrays(state, tag):
    """Every module's state dict, ``{tag}/{module}/{name}`` arrays."""
    out = {}
    for name in ("gen", "psenc", "disc"):
        m = getattr(state, name, None)
        if m is not None:
            for k, v in m.state_dict().items():
                out[f"{tag}/{name}/{k}"] = v.detach().float().numpy()
    return out


def step_config(spec, **over):
    from mixstage_tpu_torch.train import StepConfig

    cfg = dict(spec["cfg"])
    cfg["model_kwargs"] = tuple(tuple(kv) for kv in cfg["model_kwargs"])
    cfg.update(over)
    return StepConfig(**cfg)


def bridged(spec, flat, layout, **over):
    """(factory, the state loaded from the parent's JAX trees)."""
    from mixstage_tpu_torch.train import StepFactory

    f = StepFactory(step_config(spec, **over), device="cpu", layout=layout)
    state = f.init_from_flax(unflatten(flat, "g_params"),
                             unflatten(flat, "g_state"),
                             unflatten(flat, "d_params"),
                             unflatten(flat, "d_state"))
    return f, mesh.replicate_state(state, layout)


def batch_of(flat, prefix):
    return {"x": (flat[f"{prefix}/x"],), "y": flat[f"{prefix}/y"],
            "labels": flat[f"{prefix}/labels"],
            "style": flat[f"{prefix}/style"]}


def out_of(tag, losses, pose):
    out = {f"{tag}/loss/{k}": v.double().numpy() for k, v in losses.items()}
    out[f"{tag}/pose"] = pose.float().numpy()
    return out


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


def collectives(spec, flat, rank, world):
    """The layout's pieces on ``world`` ranks (one data group)."""
    import torch.distributed as dist

    lay = mesh.make_mesh(0)
    out = {"dp": np.array(lay.dp), "data_rank": np.array(lay.data_rank)}
    t = torch.tensor([float(rank + 1)])
    out["all_reduce"] = mesh.all_reduce_(t, lay.data_group).numpy()
    out["all_gather"] = mesh.all_gather(
        torch.full((2, 3), float(rank)), lay.data_group).numpy()
    lay.barrier()
    out["any_rank"] = np.array([mesh.any_rank(rank == world - 1, lay),
                                mesh.any_rank(False, lay)])
    batch = {"y": np.arange(16 * 3).reshape(16, 3),
             "x": (np.arange(16 * 2).reshape(16, 2),),
             "ragged": np.arange(3 * 2).reshape(3, 2)}
    local = mesh.shard_batch(batch, lay)
    out["shard_y"], out["shard_x"] = local["y"], local["x"][0]
    out["shard_ragged"] = local["ragged"]
    out["stacked"] = mesh.shard_batch(
        {"y": np.arange(2 * 8).reshape(2, 8)}, lay, leading_axis=1)["y"]
    out["for_process"] = np.array(multihost.shard_for_process(range(10)))
    # replicate_state: rank 0's values everywhere, the ranks start apart
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    mesh.replicate_state(lin, lay)
    out["replicated"] = lin.weight.detach().numpy()
    grads = mesh.all_reduce_grads([torch.full((2,), float(rank)),
                                   torch.full((3,), 2.0 * rank,
                                              dtype=torch.float64)], lay)
    out["grad_f32"], out["grad_f64"] = (g.numpy() for g in grads)
    means = mesh.mean_over_data({"s": torch.tensor(float(rank)),
                                 "W": torch.full((2,), float(rank))}, lay)
    out["mean_s"], out["gathered_W"] = means["s"].numpy(), means["W"].numpy()
    # a 1 x world layout: one model group over every rank
    lay2 = mesh.make_mesh_2d(1, world)
    out["model_rank"] = np.array(lay2.model_rank)
    out["model_sum"] = mesh.all_reduce_(torch.tensor([1.0]),
                                        lay2.model_group).numpy()
    out["backend"] = np.array(dist.get_backend())
    # BatchNorm in train mode on this rank's rows, its statistics over the
    # data group: output, running statistics and gradients against the
    # same layer on the whole batch
    from mixstage_tpu_torch.models.layers import BatchNorm

    x = torch.as_tensor(np.random.default_rng(0).normal(
        1.0, 2.0, size=(4 * world, 5, 3)).astype(np.float32))
    up = torch.as_tensor(np.random.default_rng(1).normal(
        size=x.shape).astype(np.float32))
    whole, mine = BatchNorm(3), BatchNorm(3)
    for bn in (whole, mine):
        torch.nn.init.uniform_(bn.weight, 0.5, 1.5, torch.Generator()
                               .manual_seed(2))
    xa = x.clone().requires_grad_()
    ya = whole.train()(xa)
    (ya * up).sum().backward()
    rows = slice(4 * rank, 4 * rank + 4)
    xb = x[rows].clone().requires_grad_()
    with mesh.batch_stats(lay, True):
        yb = mine.train()(xb)
    (yb * up[rows]).sum().backward()
    gw = mesh.all_reduce_grads([mine.weight.grad], lay)[0] * lay.dp
    out["bn_out"] = (yb - ya[rows]).abs().max().detach().numpy()
    out["bn_dx"] = (xb.grad - xa.grad[rows]).abs().max().numpy()
    out["bn_dw"] = (gw - whole.weight.grad).abs().max().numpy()
    out["bn_stats"] = max(
        (mine.running_mean - whole.running_mean).abs().max(),
        (mine.running_var - whole.running_var).abs().max()).numpy()
    return out


def steps(spec, flat, rank, world):
    """The data-parallel G and D steps (fused and unfused) from the bridged
    state on the global batch, and a G step on a ragged batch."""
    lay = mesh.make_mesh(world)
    out = {}
    batch = batch_of(flat, "batch")
    for fused in (False, True):
        tag = "fused" if fused else "unfused"
        f, state = bridged(spec, flat, lay, fused_decoder=fused)
        st = f.make_steps()
        state, losses, pose = st["g"](state, batch, 1)
        out.update(out_of(f"{tag}/g", losses, pose))
        out.update(state_arrays(state, f"{tag}/g"))
        f, state = bridged(spec, flat, lay, fused_decoder=fused)
        state, losses, pose = f.make_steps()["d"](state, batch, 2)
        out.update(out_of(f"{tag}/d", losses, pose))
        out.update(state_arrays(state, f"{tag}/d"))
    f, state = bridged(spec, flat, lay)
    state, losses, pose = f.make_steps()["g"](state, batch_of(flat, "ragged"),
                                              1)
    out.update(out_of("ragged/g", losses, pose))
    out.update(state_arrays(state, "ragged/g"))
    for fused in (False, True):         # float64: the gradients to rounding
        tag = "f64_fused" if fused else "f64_unfused"
        f, state = bridged(spec, flat, lay, fused_decoder=fused,
                           dtype=torch.float64)
        state, losses, _ = f.make_steps()["g"](state, batch, 1)
        out[f"{tag}/total"] = losses["total"].numpy()
        for n, m in zip(state.g_opt.names, state.g_opt.slots()["mu"]):
            out[f"{tag}/mu/{n}"] = m.numpy()
    return out


def ep(spec, flat, rank, world):
    """The G step on a dp x ep layout (fused and unfused), and the mixture
    decoder's subgraph: its loss and its gradients on this rank's
    experts."""
    dp, mp = spec["dp"], spec["mp"]
    lay = mesh.make_mesh_2d(dp, mp)
    out = {}
    batch = batch_of(flat, "batch")
    for fused in (False, True):
        tag = "fused" if fused else "unfused"
        f, state = bridged(spec, flat, lay, fused_decoder=fused)
        mesh.shard_state_mixture(state, lay)
        state, losses, pose = f.make_steps()["g"](state, batch, 1)
        out.update(out_of(f"{tag}/g", losses, pose))
        out.update(state_arrays(state, f"{tag}/g"))
    # the decoder subgraph: x, w, y over the data group's rows, the
    # experts over the model group, BN in train mode over the data group
    f, state = bridged(spec, flat, lay)
    mesh.shard_state_mixture(state, lay)
    gen = state.gen.train()
    rows = mesh.shard_batch({k: torch.as_tensor(flat[f"dec/{k}"])
                             for k in ("x", "w", "y")}, lay)
    x, w = (rows[k].clone().requires_grad_() for k in ("x", "w"))
    sharded = lay.divides(flat["dec/x"].shape[0])
    with mesh.batch_stats(lay, sharded):
        pose = gen.mixture(x, w, gen.decode)
        loss = (pose - rows["y"]).abs().mean()
        names = [n for n, _ in gen.named_parameters()
                 if mesh.is_expert_leaf(n)]
        params = [p for n, p in gen.named_parameters()
                  if mesh.is_expert_leaf(n)]
        *grads, dx, dw = torch.autograd.grad(loss, params + [x, w])
    grads = mesh.all_reduce_grads(grads, lay)
    # the inputs' gradients of the global mean loss, this rank's rows
    out["dec/dx"] = (dx / lay.dp).numpy()
    out["dec/dw"] = (dw / lay.dp).numpy()
    loss = mesh.mean_over_data({"l": loss.detach()}, lay)["l"]
    out["dec/loss"] = loss.double().numpy()
    out["dec/start"] = np.array(gen.expert_parallel[1])
    for n, g in zip(names, grads):
        out[f"dec/grad/{n}"] = g.numpy()
    return out


def trainer(spec, flat, rank, world):
    """``cli.train`` on the spec's argv (``-num_devices``), every step's
    kind, coin, batch and losses logged, and the files this rank opened
    for writing."""
    import builtins

    import h5py

    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.config import (_typed_flag_names,
                                           config_from_dict, get_args_perm)
    from mixstage_tpu_torch.train import steps as steps_mod

    written = []
    real_open, real_save, real_h5 = builtins.open, torch.save, h5py.File

    def open_(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+"):
            written.append(str(file))
        return real_open(file, mode, *a, **kw)

    def save_(obj, f, *a, **kw):
        written.append(str(f))
        return real_save(obj, f, *a, **kw)

    def h5_(name, mode="r", *a, **kw):
        if mode != "r":
            written.append(str(name))
        return real_h5(name, mode, *a, **kw)

    log = []
    make_steps = steps_mod.StepFactory.make_steps

    def logged(self):
        fns = make_steps(self)
        for kind in ("g", "d"):
            if kind not in fns:
                continue

            def wrapped(state, batch, *a, _fn=fns[kind], _kind=kind, **kw):
                out = _fn(state, batch, *a, **kw)
                log.append({"kind": _kind,
                            "pose_input": bool(kw.get("use_pose_input")),
                            "batch": {k: hashlib.sha1(np.ascontiguousarray(
                                v).tobytes()).hexdigest()
                                for k, v in batch.items() if k != "x"},
                            "losses": {k: float(v) for k, v in
                                       out[1].items() if v.dim() == 0}})
                return out
            fns[kind] = wrapped
        return fns

    steps_mod.StepFactory.make_steps = logged
    builtins.open, torch.save, h5py.File = open_, save_, h5_
    try:
        argv = spec["argv"]
        _, perms = get_args_perm(argv)
        cfg = config_from_dict(perms[0])
        cfg.typed_flags = _typed_flag_names(argv)
        cli_train.loop(cfg, 0, device="cpu")
    finally:
        builtins.open, torch.save, h5py.File = real_open, real_save, real_h5
    Path(spec["log"].format(rank=rank)).write_text(json.dumps(
        {"steps": log, "written": sorted(set(written))}))
    return {"n_steps": np.array(len(log))}


MODES = {"collectives": collectives, "steps": steps, "ep": ep,
         "trainer": trainer}


def main():
    mode, workdir, rank, world = sys.argv[1], Path(sys.argv[2]), \
        int(sys.argv[3]), int(sys.argv[4])
    multihost.setup(init_method=f"file://{workdir / 'store'}",
                    world_size=world, rank=rank, device_type="cpu",
                    timeout_s=100)
    spec = json.loads((workdir / "spec.json").read_text())
    flat = {}
    if (workdir / "in.npz").exists():
        with np.load(workdir / "in.npz") as z:
            flat = {k: z[k] for k in z.files}
    out = MODES[mode](spec, flat, rank, world)
    np.savez(workdir / f"out_{rank}.npz", **out)
    multihost.teardown()
    print(f"CHILD_OK {mode} {rank}", flush=True)


if __name__ == "__main__":
    main()
