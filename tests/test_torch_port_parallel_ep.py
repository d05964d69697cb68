"""Expert parallelism of the port's mixture decoder, on the CPU: the G step
on a 2 x 2 (data x expert) layout of four gloo ranks against the one-rank
step, and the decoder's subgraph against the replicated truth
(``__graft_entry__.py:207-310``, ``tests/test_parallel.py:84-166``).

Four child processes (no JAX) load one state bridged from JAX's trees
(4 experts), split the experts 2 a rank over the model group
(``shard_state_mixture``) and the B=8 batch 4 rows a rank over the data
group, and run one G step, unfused and fused (K3's plain versions at 2
groups, their statistics exchanged over the data group only).  The
losses agree with the one-rank step within 1e-4 relative, the pose at the
data-parallel limits (rtol 2e-3, atol 2e-4), every rank's parameters (the
replicated ones, and its share of the experts') within 2·lr and its BN
statistics within 1e-4 of scale.  The decoder subgraph (the four grouped
layers in train mode and the grouped logits under a soft attention, L1 to
a target) gives the replicated loss within 1e-4 relative, each rank's
expert gradients within 1e-3 and the gradients of its rows of the
features and the attention (summed over the model group) within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_variables
from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_parallel import flatten, run_ranks
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.parallel.mesh import is_expert_leaf
from mixstage_tpu_torch.train import StepConfig, StepFactory

DP, MP, G = 2, 2, 4
B, T, MEL, FEATS, LR = 8, 64, 32, 96, 1e-4
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=G, num_speakers=2, lr=LR,
           model_kwargs=(("in_channels", 64),))
PARAM_ATOL, STAT_TOL = 2 * LR + 1e-6, 1e-4


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(B, T, MEL)).astype(np.float32),),
            "y": rng.normal(size=(B, T, FEATS)).astype(np.float32),
            "labels": rng.integers(0, G, size=(B, T)).astype(np.int32),
            "style": np.repeat(rng.integers(0, 2, size=(B, 1)), T,
                               1).astype(np.int32)}


def trees():
    """JAX's random trees for the generator, the pose-style encoder and D."""
    f = JaxStepFactory(JaxStepConfig(**CFG), donate=False)
    x, y = [jnp.zeros((2, T, MEL))], jnp.zeros((2, T, FEATS))
    gp, gs = flax_variables(f.gen, x, y, jnp.zeros((2, T, 2)),
                            input_modalities=["audio/log_mel_512"],
                            use_pose_input=False, train=False, seed=1)
    pp, ps = flax_variables(f.psenc, y, train=False, seed=2)
    dp, ds = flax_variables(f.disc, y, train=False, seed=3)
    return {"g_params": {"gen": gp, "psenc": pp},
            "g_state": {"gen": gs, "psenc": ps}, "d_params": dp,
            "d_state": ds}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    t = trees()
    batch = make_batch(0)
    rng = np.random.default_rng(5)
    w = rng.uniform(size=(B, T, G)).astype(np.float32)
    dec = {"dec/x": rng.normal(size=(B, T, 64 + 10)).astype(np.float32),
           "dec/w": w / w.sum(-1, keepdims=True),
           "dec/y": rng.normal(size=(B, T, FEATS)).astype(np.float32)}
    arrays = {**flatten(t), "batch/x": batch["x"][0], "batch/y": batch["y"],
              "batch/labels": batch["labels"],
              "batch/style": batch["style"], **dec}
    cfg = {k: (list(map(list, v)) if k == "model_kwargs" else v)
           for k, v in CFG.items()}
    ranks = run_ranks("ep", tmp_path_factory.mktemp("ep"), DP * MP,
                      {"cfg": cfg, "dp": DP, "mp": MP}, arrays)
    return t, batch, dec, ranks


def one_rank(t, fused=False):
    f = StepFactory(StepConfig(**CFG, fused_decoder=fused), device="cpu")
    state = f.init_from_flax(t["g_params"], t["g_state"], t["d_params"],
                             t["d_state"])
    return f, state


def share(name, v, start):
    """This rank's rows of an expert leaf (the experts are M-major on
    dim 0); a replicated leaf whole."""
    if not is_expert_leaf(name):
        return v
    w = v.shape[0] // G
    return v[start * w:(start + G // MP) * w]


@pytest.mark.parametrize("mode", ["unfused", "fused"])
def test_ep_g_step_matches_one_rank(world, mode):
    t, batch, _, ranks = world
    f, state = one_rank(t, fused=mode == "fused")
    state, losses, pose = f.make_steps()["g"](state, batch, 1)
    want = {f"{n}/{k}": v.detach().numpy()
            for n in ("gen", "psenc", "disc")
            for k, v in getattr(state, n).state_dict().items()}
    tag = f"{mode}/g"
    for rank, out in enumerate(ranks):
        start = (rank % MP) * (G // MP)
        for k, v in losses.items():
            np.testing.assert_allclose(out[f"{tag}/loss/{k}"], v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(out[f"{tag}/pose"], pose.numpy(),
                                   rtol=2e-3, atol=2e-4)
        for k, ref in want.items():
            ref = share(k.split("/", 1)[1], ref, start) \
                if k.startswith("gen/") else ref
            a = out[f"{tag}/{k}"]
            assert a.shape == ref.shape, k
            if "running_" in k:
                assert np.abs(a - ref).max() <= \
                    STAT_TOL * np.abs(ref).max(), k
            else:
                np.testing.assert_allclose(a, ref, rtol=0, atol=PARAM_ATOL,
                                           err_msg=k)


def test_ep_decoder_subgraph_matches_replicated(world):
    """The mixture decoder alone, experts split over the model group and
    rows over the data group: the loss, and each rank's expert gradients
    (averaged over its data group) against one rank holding everything."""
    t, _, dec, ranks = world
    _, state = one_rank(t)
    gen = state.gen.train()
    x, w = (torch.as_tensor(dec[f"dec/{k}"]).requires_grad_()
            for k in ("x", "w"))
    pose = gen.mixture(x, w, gen.decode)
    loss = (pose - torch.as_tensor(dec["dec/y"])).abs().mean()
    named = [(n, p) for n, p in gen.named_parameters() if is_expert_leaf(n)]
    *grads, dx, dw = torch.autograd.grad(loss, [p for _, p in named] +
                                         [x, w])
    for rank, out in enumerate(ranks):
        start = int(out["dec/start"])
        assert start == (rank % MP) * (G // MP)
        np.testing.assert_allclose(out["dec/loss"], float(loss.detach()),
                                   rtol=1e-4)
        # the features' and the attention's gradients: every expert's
        # share summed over the model group (the copies' backward)
        rows = slice((rank // MP) * B // DP, (rank // MP + 1) * B // DP)
        np.testing.assert_allclose(out["dec/dx"], dx[rows].numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out["dec/dw"], dw[rows].numpy(), rtol=0,
                                   atol=1e-5)
        for (n, _), g in zip(named, grads):
            np.testing.assert_allclose(out[f"dec/grad/{n}"],
                                       share(n, g.numpy(), start), rtol=0,
                                       atol=1e-3, err_msg=n)
