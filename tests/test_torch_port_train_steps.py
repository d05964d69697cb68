"""The port's GAN steps against the JAX package's, from the same state.

A small flagship configuration (in_channels 64, 2 clusters, 2 speakers,
B=2, T=64, 32 mel bins) whose flax trees are drawn with numpy; the port
loads them, and its optimizer starts from the same (zero) Adam state.

Tolerances:
* losses at rtol 1e-4;
* BN running statistics of gen, psenc and D: max |diff| ≤ 1e-4 · max |ref|
  per leaf;
* poses at rtol 1e-3 / atol 1e-4, the JAX package's own tolerance for
  the pose of one train step (``tests/test_train_decoder.py:155``);
* parameters at atol 2·lr (+1e-6 of rounding): at count 1 Adam's update is
  ±lr·sign(g), so a flipped noise-level gradient (a conv bias before a
  train BN has gradient 0 analytically) moves a weight by 2·lr, the same
  reasoning as ``tests/test_steps.py:214-216``;
* Adam moments, which carry the gradients: module by module (``gen/unet``,
  ``psenc/stack``, D's ``conv1``, ...), the relative Frobenius error of the
  module's leaves taken together, each comparison held to about twice the
  largest gap measured for it (``MOMENT_TOL``); the conv biases before a
  train BN, 0 analytically, absolutely.

The moments cannot agree to 1e-4.  Float32 rounding flips the sign of a
few leaky-unit inputs that lie within ~1e-6 of 0 (the G step's forward
with ``use_pose_input`` flips one in ``decoder1``, -2.4e-7 in the port and
+2.6e-6 in JAX, and one in ``classify_cluster.stack.conv0``).  A flip moves
the gradient of every module upstream of it by about one element's share
of a few thousand, 1e-3 to 2e-2, and leaves the modules downstream alone:
there ``decoder2``, ``decoder3`` and ``logits`` agree to 6e-5 while
``decoder0``/``decoder1`` differ by 2.8e-3.  In float64 the step is just as
sensitive: moving the batch by 1e-6 (relative) moves the port's per-term
gradients by up to 2e-2.  D's gap is the same effect
(``test_d_step_moment_gap_is_conditioning``).  The tolerances still catch
a wrong loss term: scaling the gradient of any one G loss term by 1.1 (the
GAN term's by 1.05), or dropping id_out's, fails the "g" and
"g_pose_input" cases, each mutant by 6× a tolerance or more in some
module (checked on a mutated copy of ``steps.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import flax_variables
from mixstage_tpu.train.state import TrainState as JaxTrainState
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import to_flax_opt_state, to_flax_state
from mixstage_tpu_torch.train import StepConfig, StepFactory
from mixstage_tpu_torch.train.steps import _unsupported

B, T, MEL, FEATS = 2, 64, 32, 96
LR = 1e-4
CFG = dict(model="JointLateClusterSoftStyle4_G", gan=True,
           criterion="L1Loss", num_clusters=2, num_speakers=2, lr=LR,
           model_kwargs=(("in_channels", 64),))
LOSS_RTOL = 1e-4
STAT_TOL = 1e-4                  # max |diff| / max |ref| per leaf
# module (or "gen" / "psenc" for all of theirs, "*" for the rest) →
# relative Frobenius tolerance of its Adam moments; in brackets the
# largest gaps measured (mu or nu)
MOMENT_TOL = {
    "g": {"*": 2e-3},                       # [8.4e-4 gen/classify_cluster]
    "d": {"conv1": 8e-3, "conv2_0": 8e-3,   # [2.9e-3, 3.7e-3]
          "*": 3e-4},                       # [1.1e-4 conv3]
    "g_pose_input": {"gen/pose_encoder": 4e-2, "gen/unet": 8e-3,
                     "gen/decoder0": 6e-3, "gen/decoder1": 6e-3,
                     "gen/style_emb": 4e-3,  # [1.7e-2, 3.6e-3, 2.9e-3,
                     "*": 6e-4},             #  2.8e-3, 1.6e-3; 2.9e-4]
    # -audio_lowering with every conv relowered: JAX's plan rounds its
    # audio features differently from its native convs, which moves its own
    # G step's mu by as much (2.3e-3 gen/classify_cluster, native vs plan)
    "g_relowered": {"gen/classify_cluster": 5e-3,  # [2.5e-3, 1.7e-3,
                    "gen/style_emb": 4e-3,         #  1.3e-3 audio_encoder
                    "*": 3e-3},                    #  and unet]
    "eval": {"*": 0.0},                     # the moments stay as they were
    "fused": {"*": 6e-4},                   # port vs port [2.7e-4]
    # four steps G, D, G, G at lr 1e-6
    "scan": {"gen": 2.5e-2, "psenc": 6e-3,  # [1.04e-2, 2.7e-3]
             "*": 1e-4},                    # D [4.7e-5]
}
PRE_BN_BIAS_ATOL = 1e-6                     # [4.5e-7]
POSE_TOL = dict(rtol=1e-3, atol=1e-4)
PARAM_ATOL = 2 * LR + 1e-6


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(B, T, MEL)).astype(np.float32),),
            "y": rng.normal(size=(B, T, FEATS)).astype(np.float32),
            "labels": rng.integers(0, 2, size=(B, T)),
            "style": np.repeat(rng.integers(0, 2, size=(B, 1)), T, 1)}


def jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX factory, its jitted steps and an initial state."""
    f = JaxStepFactory(JaxStepConfig(**CFG), donate=False)
    batch = jax_batch(make_batch(0))
    S = CFG["num_speakers"]
    gp, gs = flax_variables(f.gen, list(batch["x"]), batch["y"],
                            jnp.zeros((B, T, S)),
                            input_modalities=["audio/log_mel_512"],
                            use_pose_input=False, train=False, seed=1)
    pp, ps = flax_variables(f.psenc, batch["y"], train=False, seed=2)
    dp, ds = flax_variables(f.disc, batch["y"], train=False, seed=3)
    g_params = {"gen": gp, "psenc": pp}
    state = JaxTrainState(g_params=g_params,
                          g_state={"gen": gs, "psenc": ps},
                          g_opt_state=f.g_tx.init(g_params), d_params=dp,
                          d_state=ds, d_opt_state=f.d_tx.init(dp))
    return f, f.make_steps(), state


def port_state(factory, jstate):
    return factory.init_from_flax(
        jstate.g_params, jstate.g_state, jstate.d_params, jstate.d_state,
        jstate.g_opt_state, jstate.d_opt_state,
        counters={k: int(getattr(jstate, k)) for k in
                  ("step", "g_step", "lambda_step", "curriculum_step")})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _pre_bn_bias(key):
    return key.endswith("conv/bias")


def _module(key):
    """The module a leaf belongs to: ``gen/unet``, ``psenc/stack``, D's
    ``conv2_0``."""
    parts = key.split("/")
    return "/".join(parts[:2]) if parts[0] in ("gen", "psenc") else parts[0]


def moment_gaps(got, want):
    """Relative Frobenius error of each module's moments (its leaves
    concatenated, the conv biases before a train BN apart) and the largest
    absolute error of those biases."""
    num, den, bias = {}, {}, 0.0
    for k, b in want.items():
        a = got[k]
        if _pre_bn_bias(k):
            bias = max(bias, float(np.abs(a - b).max()))
            continue
        m = _module(k)
        num[m] = num.get(m, 0.0) + float(np.sum((a - b) ** 2))
        den[m] = den.get(m, 0.0) + float(np.sum(b ** 2))
    return {m: np.sqrt(num[m]) / max(np.sqrt(den[m]), 1e-30)
            for m in num}, bias


def assert_trees_close(got, want, what, kind, param_atol=PARAM_ATOL,
                       moment_tol=None):
    """Leaf by leaf for "params" (atol) and "stats" (max-normalised); module
    by module for "moments" (``moment_gaps`` against ``moment_tol``)."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    if kind == "moments":
        gaps, bias = moment_gaps(got, want)
        assert bias <= PRE_BN_BIAS_ATOL, (what, "pre-BN conv biases", bias)
        for m, gap in gaps.items():
            tol = moment_tol.get(m, moment_tol.get(m.split("/")[0],
                                                   moment_tol["*"]))
            assert gap <= tol, (what, m, gap, tol)
        return
    for k in want:
        a, b, msg = got[k], want[k], f"{what} {k}"
        if kind == "params":
            np.testing.assert_allclose(a, b, rtol=0, atol=param_atol,
                                       err_msg=msg)
        else:
            assert np.abs(a - b).max() <= STAT_TOL * np.abs(b).max(), msg


def assert_states_close(ps, js, moment_tol, param_atol=PARAM_ATOL):
    """Port state ``ps`` against JAX state ``js``: params, BN statistics,
    Adam moments and the counters."""
    gen_p, gen_s = to_flax_state(ps.gen)
    ps_p, ps_s = to_flax_state(ps.psenc)
    d_p, d_s = to_flax_state(ps.disc)
    assert_trees_close({"gen": gen_p, "psenc": ps_p}, js.g_params, "params",
                       "params", param_atol)
    assert_trees_close(d_p, js.d_params, "D params", "params", param_atol)
    assert_trees_close({"gen": gen_s, "psenc": ps_s}, js.g_state,
                       "G batch stats", "stats")
    assert_trees_close(d_s, js.d_state, "D batch stats", "stats")
    g_opt = to_flax_opt_state(ps.g_opt, {"gen": ps.gen, "psenc": ps.psenc})
    d_opt = to_flax_opt_state(ps.d_opt, {None: ps.disc})
    for got, jopt, what in ((g_opt, js.g_opt_state, "G"),
                            (d_opt, js.d_opt_state, "D")):
        adam = jopt[1][0]
        assert got["count"] == int(adam.count), what
        assert_trees_close(got["mu"], adam.mu, f"{what} Adam mu", "moments",
                           moment_tol=moment_tol)
        assert_trees_close(got["nu"], adam.nu, f"{what} Adam nu", "moments",
                           moment_tol=moment_tol)
    for k in ("step", "g_step", "lambda_step", "curriculum_step"):
        assert getattr(ps, k) == int(getattr(js, k)), k


def assert_losses_close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def factory():
    return StepFactory(StepConfig(**CFG), device="cpu")


@pytest.mark.parametrize("branch,use_pose_input",
                         [("g", False), ("d", False), ("g", True)],
                         ids=["g", "d", "g_pose_input"])
def test_step_matches_jax(jax_side, factory, branch, use_pose_input):
    _, jsteps, jstate = jax_side
    batch = make_batch(1)
    js, jl, jpose = jsteps[branch](jstate, jax_batch(batch),
                                   jax.random.key(1),
                                   use_pose_input=use_pose_input)
    ps = port_state(factory, jstate)
    ps, pl, ppose = factory.make_steps()[branch](
        ps, batch, use_pose_input=use_pose_input)
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), **POSE_TOL)
    assert_states_close(ps, js, MOMENT_TOL[branch + "_pose_input" *
                                           use_pose_input])


@pytest.mark.parametrize("style", ["hard", "soft"])
def test_eval_step_matches_jax(jax_side, factory, style):
    _, jsteps, jstate = jax_side
    batch = make_batch(2)
    if style == "soft":
        w = np.random.default_rng(3).uniform(size=(B, T, 2))
        batch["style_soft"] = (w / w.sum(-1, keepdims=True)).astype(
            np.float32)
    jl, jpose, _ = jsteps["eval"](jstate, jax_batch(batch),
                                  use_pose_input=False, sample_flag=True)
    ps = port_state(factory, jstate)
    pl, ppose, _ = factory.make_steps()["eval"](ps, batch,
                                                sample_flag=True)
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), **POSE_TOL)
    # eval leaves every running statistic alone
    assert_states_close(ps, jstate, MOMENT_TOL["eval"])


def test_fused_g_step_matches_unfused(jax_side, factory):
    _, _, jstate = jax_side
    fused = StepFactory(StepConfig(**CFG, fused_decoder=True), device="cpu")
    batch = make_batch(4)
    s0, l0, p0 = factory.make_steps()["g"](port_state(factory, jstate),
                                           batch)
    s1, l1, p1 = fused.make_steps()["g"](port_state(fused, jstate), batch)
    assert_losses_close(l1, l0)
    np.testing.assert_allclose(p1.numpy(), p0.numpy(), **POSE_TOL)
    want = {"params": to_flax_state(s0.gen)[0],
            "stats": to_flax_state(s0.gen)[1],
            "mu": to_flax_opt_state(s0.g_opt, {"gen": s0.gen})["mu"]}
    got = {"params": to_flax_state(s1.gen)[0],
           "stats": to_flax_state(s1.gen)[1],
           "mu": to_flax_opt_state(s1.g_opt, {"gen": s1.gen})["mu"]}
    assert_trees_close(got["params"], want["params"], "params", "params")
    assert_trees_close(got["stats"], want["stats"], "stats", "stats")
    assert_trees_close(got["mu"], want["mu"], "Adam mu", "moments",
                       moment_tol=MOMENT_TOL["fused"])


def test_scan_driver_matches_per_step_and_jax(jax_side):
    """Four steps (G, D, G, G) in one call equal four per-step calls, and
    follow JAX's scan.  At lr 1e-6: a flipped noise-level gradient moves a
    weight by ±lr per step, and at lr 1e-4 those moves (2·lr each) shift
    the later losses by up to 3e-3; at 1e-6 the trajectories stay within
    the per-step tolerances (params within 2·lr per step taken)."""
    _, _, jstate = jax_side
    lr = 1e-6
    f = JaxStepFactory(JaxStepConfig(**{**CFG, "lr": lr}), donate=False)
    factory = StepFactory(StepConfig(**{**CFG, "lr": lr}), device="cpu")
    k = 4
    coins = np.array([False, True, False, False])        # G, D, G, G
    batches = [make_batch(100 + i) for i in range(k)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *batches)

    scan = factory.make_scan_train_step(k)
    ps, losses, poses = scan(port_state(factory, jstate), stacked, coins)
    assert sorted(losses) == factory.union_keys()
    assert poses.shape == (k, B, T, FEATS)

    seq = port_state(factory, jstate)
    steps = factory.make_steps()
    for i in range(k):
        seq, step_losses, pose = steps["d" if coins[i] else "g"](seq,
                                                                  batches[i])
        for key in losses:
            want = float(step_losses.get(key, torch.zeros(())))
            assert float(losses[key][i]) == want, (i, key)
        assert torch.equal(poses[i], pose)
    for a, b in zip(ps.g_opt.params + ps.d_opt.params,
                    seq.g_opt.params + seq.d_opt.params):
        assert torch.equal(a, b)

    jscan = f.make_scan_train_step(k)
    js, jl, jposes = jscan(jstate, jax_batch(stacked), jnp.asarray(coins),
                           jnp.stack([jax.random.key(i) for i in range(k)]))
    assert_losses_close(losses, jl)
    assert_states_close(ps, js, MOMENT_TOL["scan"],
                        param_atol=2 * lr * k + 1e-6)


def test_factory_runs_on_the_card_by_default():
    cfg = StepConfig(**CFG)
    if torch.cuda.is_available():
        assert StepFactory(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StepFactory(cfg)


# -audio_lowering: every plan the JAX package takes (``tpu`` and ``conv``
# resolve to its native convs, an explicit plan relowers each of the eight
# convs, by s2d where it downsamples and im2col elsewhere) computes the same
# G step from the same parameters; the port runs its native convs for each.
RELOWERED = "im2col,s2d,im2col,s2d,im2col,s2d,im2col,im2col"


@pytest.mark.parametrize("spec", ["tpu", "conv", RELOWERED],
                         ids=["tpu_spec", "conv", "plan"])  # "tpu": -m tpu
def test_audio_lowering_matches_jax(jax_side, spec):
    _, _, jstate = jax_side
    f = JaxStepFactory(JaxStepConfig(**CFG, audio_lowering=spec),
                       donate=False)
    batch = make_batch(1)
    js, jl, jpose = f.make_steps()["g"](jstate, jax_batch(batch),
                                        jax.random.key(1))
    port = StepFactory(StepConfig(**CFG, audio_lowering=spec), device="cpu")
    ps, pl, ppose = port.make_steps()["g"](port_state(port, jstate), batch)
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(ppose.numpy(), np.asarray(jpose), **POSE_TOL)
    assert_states_close(ps, js, MOMENT_TOL["g_relowered" if spec == RELOWERED
                                           else "g"])


@pytest.mark.parametrize("spec", ["s2d,conv", "fft," * 7 + "fft", "gpu"])
def test_bad_audio_lowering_raises_in_both_packages(spec):
    for cfg, factory, kw in ((JaxStepConfig, JaxStepFactory,
                              dict(donate=False)),
                             (StepConfig, StepFactory, dict(device="cpu"))):
        with pytest.raises(ValueError, match="audio_lowering must be"):
            factory(cfg(**CFG, audio_lowering=spec), **kw)


# What the port still refuses (K3 with dropout, an unregistered
# Disentangle generator), and the configurations ported since, each built
# from the JAX package's tree (-audio_lowering and -fused_decoder on a
# model without the mixture decoder, which JAX ignores, among them).  The
# weighted GAN, the joint D, float64, noise, dropout, the non-GAN trainer
# and StyleClassifier_G, refused here before, are held against the JAX
# package in test_torch_port_f64_steps.py, _gan_variants.py, _dropout.py
# and _simple_models.py; text, -optim_separate and the Disentangle losses
# in test_torch_port_text_steps.py, _optim_separate.py, _disentangle.py.
STREAM_WIDTH = {"audio/log_mel_512": MEL, "text/w2v": 300, "text/bert": 768}


@pytest.mark.parametrize("change", [
    dict(input_modalities=("audio/log_mel_512", "text/w2v")),
    dict(input_modalities=("text/bert",)), dict(text_channels=300),
    dict(optim_separate=1e-5),
    dict(model="JointLateClusterSoftStyleDisentangle_G"),
    dict(style_losses=(("id_a", 1.0),)), dict(audio_lowering="tpu"),
    dict(fused_decoder=True, p_dropout=0.1),
    dict(fused_decoder=True, model="Speech2Gesture_G")], ids=str)
def test_unported_configs_raise(change):
    """A refused configuration raises naming its ROADMAP item (an
    unregistered Disentangle generator with the JAX package's message); a
    configuration ported since loads the JAX ``StepFactory``'s whole state
    (params, statistics and the optimizer states, partitioned with
    ``optim_separate``) through the total bridge and takes a finite G
    step."""
    cfg = StepConfig(**{**CFG, **change})
    if "Disentangle" in cfg.model:
        with pytest.raises(NotImplementedError, match="upstream-incomplete"):
            StepFactory(cfg, device="cpu")
        return
    if _unsupported(cfg):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            StepFactory(cfg, device="cpu")
        return
    from _torch_port_helpers import jax_train_state

    rng = np.random.default_rng(5)
    batch = dict(make_batch(6), x=tuple(
        rng.normal(size=(B, T, STREAM_WIDTH[m])).astype(np.float32)
        for m in cfg.input_modalities))
    jf = JaxStepFactory(JaxStepConfig(**{**CFG, **change}), donate=False)
    port = StepFactory(cfg, device="cpu")
    state = port_state(port, jax_train_state(jf, jax_batch(batch)))
    assert hasattr(state.gen, "text_encoder") == any(
        m.startswith("text/") for m in cfg.input_modalities)
    _, losses, _ = port.make_steps()["g"](state, batch)
    assert all(bool(torch.isfinite(v).all()) for v in losses.values())


def test_init_draws_a_full_state(factory):
    state = factory.init(seed=0)
    assert state.gen.decoder0.conv.weight.abs().sum() > 0
    assert len(state.g_opt.params) == \
        len(list(state.gen.parameters())) + len(list(state.psenc.parameters()))
    _, losses, pose = factory.make_steps()["g"](state, make_batch(5))
    assert pose.shape == (B, T, FEATS)
    assert all(torch.isfinite(v).all() for v in losses.values())


def test_d_step_moment_gap_is_conditioning(jax_side, factory):
    """Where the D step's Adam moments differ most (conv1, conv2_0), both
    packages compute D's float32 gradients to within 2e-4 (relative
    Frobenius) of the port's float64 ones on the same fake pose.  What
    separates the two D steps is
    their inputs: the two eval forwards' fake poses differ by < 1e-6, and
    that alone moves D's gradients by more than 1e-4 (leaky kinks in
    conv1, which has no BatchNorm before it)."""
    import copy

    from mixstage_tpu.train import losses as JL
    from mixstage_tpu_torch.interop.weights import flax_params_to_torch
    from mixstage_tpu_torch.train import losses as TL

    f, jsteps, jstate = jax_side
    batch = make_batch(1)
    ps = port_state(factory, jstate)
    _, pose, _ = factory.make_steps()["eval"](ps, batch)
    _, jpose, _ = jsteps["eval"](jstate, jax_batch(batch),
                                 use_pose_input=False)
    jpose = torch.from_numpy(np.asarray(jpose))
    assert float((pose - jpose).abs().max()) < 1e-6

    def port_grads(fake_pose, dtype):
        disc = copy.deepcopy(ps.disc).to(dtype).train()
        fake = disc(TL.velocity(fake_pose.to(dtype)))[0]
        real = disc(TL.velocity(torch.from_numpy(batch["y"]).to(dtype)))[0]
        loss = fake.abs().mean() + (real - 1).abs().mean()
        names = [n for n, _ in disc.named_parameters()]
        return dict(zip(names, torch.autograd.grad(loss, disc.parameters())))

    def jax_loss(dp):
        fake, st = f._apply_disc(dp, jstate.d_state,
                                 JL.velocity(jnp.asarray(pose.numpy())), True)
        real, _ = f._apply_disc(dp, st, JL.velocity(jnp.asarray(batch["y"])),
                                True)
        return jnp.abs(fake).mean() + jnp.abs(real - 1).mean()

    g32, g64 = port_grads(pose, torch.float32), port_grads(pose, torch.float64)
    g64_jpose = port_grads(jpose, torch.float64)
    gj = flax_params_to_torch(ps.disc, jax.tree.map(
        np.asarray, jax.grad(jax_loss)(jstate.d_params)))
    moved = 0.0
    for name in ("conv1.weight", "conv1.bias", "conv2_0.conv.weight",
                 "conv2_0.norm.bias"):
        truth = g64[name].numpy()
        scale = np.linalg.norm(truth)
        port = np.linalg.norm(g32[name].double().numpy() - truth) / scale
        ref = np.linalg.norm(gj[name] - truth) / scale
        assert port <= 2e-4 and ref <= 2e-4, (name, port, ref)
        moved = max(moved, np.linalg.norm(g64_jpose[name].numpy() - truth)
                    / scale)
    assert moved > 1e-4, moved
