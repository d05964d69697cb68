"""The G and D steps with text input, port against the JAX package.

The small flagship configuration of ``test_torch_port_f64_steps.py``
(in_channels 64, 2 clusters, 2 speakers, B=2, T=64) on 128-mel audio
+ ``text/w2v`` (300 channels, fused by ``concat_encoder``), with the plain
D and with the joint D (velocity ⊕ both streams: 96 + 128 + 300
channels: the port sizes it by the streams' names, so the audio has the
PATS width),
and ``Speech2Gesture_G`` on the early-fused streams; one state drawn with
numpy loaded into both packages.

Tolerances:
* float64 (JAX's x64 scoped to the fixture): every loss, parameter,
  BatchNorm statistic and Adam moment within ``TOL`` = 1e-9 of the leaf's
  largest magnitude, the moments of the pre-BN conv biases (0
  analytically) within 1e-12 absolutely — the float64 contract of
  ``test_torch_port_f64_steps.py``; the fused G step (K3's plain version
  in float64) is held to JAX's unfused G step the same way;
* float32: losses at rtol 1e-4, G's Adam moments per module within
  ``MOMENT_TOL`` relative Frobenius (the float32 steps' contract,
  ``test_torch_port_train_steps.py``: leaky units within float noise of 0
  flip between the packages); the port's fused G step against its unfused
  one within 6e-4 (``"fused"`` there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import flat_tree, jax_train_state, port_state
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.interop import weights as W
from mixstage_tpu_torch.train import StepConfig, StepFactory

B, T, MEL, FEATS, W2V = 2, 64, 128, 96, 300
MODS = ("audio/log_mel_512", "text/w2v")
BASE = dict(model="JointLateClusterSoftStyle4_G", gan=True,
            criterion="L1Loss", num_clusters=2, num_speakers=2, lr=1e-4,
            model_kwargs=(("in_channels", 64),), input_modalities=MODS,
            text_channels=W2V)
CONFIGS = {
    "text": BASE,
    "joint": dict(BASE, joint=True),
    "s2g": dict(model="Speech2Gesture_G", gan=True, criterion="L1Loss",
                lr=1e-4, out_feats=FEATS, input_modalities=MODS,
                model_kwargs=(("in_channels", 64),)),
}
# name: (config, branch, batch seed)
RUNS = {"g": ("text", "g", 1), "d": ("text", "d", 1),
        "joint_g": ("joint", "g", 2), "joint_d": ("joint", "d", 2),
        "s2g_g": ("s2g", "g", 3)}
TOL = 1e-9
BIAS_MOMENT_ATOL = 1e-12
LOSS_RTOL = 1e-4
# float32 G step, G's Adam mu and nu per module (relative Frobenius),
# about twice the largest gap measured [in brackets]: the encoders, the
# concat encoder and the UNet lie upstream of the leaky units that flip
MOMENT_TOL = {"jax": 6e-3,        # [2.9e-3 nu, 2.5e-3 mu gen/text_encoder;
#                                    2.7e-3 gen/audio_encoder]
              "fused": 6e-4}      # port fused vs unfused [7.9e-5 psenc]


def make_batch(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {"x": (rng.normal(size=(B, T, MEL)).astype(dtype),
                  rng.normal(size=(B, T, W2V)).astype(dtype)),
            "y": rng.normal(size=(B, T, FEATS)).astype(dtype),
            "labels": rng.integers(0, 2, size=(B, T)),
            "style": np.repeat(rng.integers(0, 2, size=(B, 1)), T, 1)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_f64():
    """Each config's initial state and each run's (losses, pose, state),
    computed by the JAX package under x64, as numpy."""
    out = {}
    with jax.enable_x64(True):
        factories = {k: JaxStepFactory(JaxStepConfig(**c, dtype=jnp.float64),
                                       donate=False)
                     for k, c in CONFIGS.items()}
        steps = {k: f.make_steps() for k, f in factories.items()}
        for k, f in factories.items():
            out[k] = jax_train_state(f, jax.tree.map(jnp.asarray,
                                                     make_batch(0)),
                                     dtype=np.float64)
        for name, (c, branch, seed) in RUNS.items():
            js, jl, jpose = steps[c][branch](
                out[c], jax.tree.map(jnp.asarray, make_batch(seed)),
                jax.random.key(1), use_pose_input=False)
            out[name] = (_np(jl), np.asarray(jpose), _np(js))
        out = {k: _np(v) if k in CONFIGS else v for k, v in out.items()}
    assert not jax.config.jax_enable_x64
    return out


def assert_f64_close(ps, js):
    port = W.jax_train_state_of(ps)
    for field in ("g_params", "g_state", "d_params", "d_state"):
        got, want = flat_tree(port[field]), flat_tree(getattr(js, field))
        assert sorted(got) == sorted(want), field
        for k, b in want.items():
            err = float(np.abs(got[k] - b).max())
            assert err <= TOL * max(float(np.abs(b).max()), 1e-300), \
                (field, k, err)
    for field in ("g_opt_state", "d_opt_state"):
        nodes = W._opt_nodes(getattr(js, field))
        assert port[field]["count"] == int(nodes["count"])
        for slot in ("mu", "nu"):
            got, want = flat_tree(port[field][slot]), flat_tree(nodes[slot])
            for k, b in want.items():
                err = float(np.abs(got[k] - b).max())
                if (k.endswith("conv/bias") and "logits" not in k) or \
                        not np.any(b):
                    # 0 analytically (a pre-BN bias; D's logits bias,
                    # whose real and fake terms cancel): float noise
                    assert err <= BIAS_MOMENT_ATOL, (field, slot, k, err)
                else:
                    assert err <= TOL * max(float(np.abs(b).max()),
                                            1e-300), (field, slot, k, err)


def assert_losses_close(got, want, rtol):
    for k, v in want.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300), \
            (k, a, b)


@pytest.mark.parametrize("name", sorted(RUNS) + ["fused_g"])
def test_text_f64_step_matches_jax(jax_f64, name):
    c, branch, seed = RUNS["g" if name == "fused_g" else name]
    factory = StepFactory(StepConfig(**CONFIGS[c], dtype=torch.float64,
                                     fused_decoder=name == "fused_g"),
                          device="cpu")
    ps = port_state(factory, jax_f64[c])
    if c != "s2g":
        assert ps.gen.text_encoder.stack.conv0.conv.weight.shape[1] == W2V
    if c == "joint":
        assert factory.d_in_channels() == FEATS + MEL + W2V
    ps, pl, ppose = factory.make_steps()[branch](ps, make_batch(seed))
    jl, jpose, js = jax_f64["g" if name == "fused_g" else name]
    assert_losses_close(pl, jl, TOL)
    np.testing.assert_allclose(ppose.numpy(), jpose, rtol=0,
                               atol=TOL * np.abs(jpose).max())
    assert_f64_close(ps, js)


def mu_nu_gaps(got, want):
    """{(slot, module): relative Frobenius gap} of two G optimizer states
    given as ``{"mu": tree, "nu": tree}``, the pre-BN conv biases apart."""
    gaps = {}
    for slot in ("mu", "nu"):
        a, b = flat_tree(got[slot]), flat_tree(want[slot])
        num, den = {}, {}
        for k, v in b.items():
            if k.endswith("conv/bias") and "logits" not in k:
                continue
            m = "/".join(k.split("/")[:2])
            num[m] = num.get(m, 0.0) + float(((a[k] - v) ** 2).sum())
            den[m] = den.get(m, 0.0) + float((v ** 2).sum())
        gaps.update({(slot, m): (num[m] / max(den[m], 1e-60)) ** 0.5
                     for m in num})
    return gaps


@pytest.fixture(scope="module")
def f32_runs():
    """JAX's float32 G step on the text configuration, and the state it
    started from."""
    f = JaxStepFactory(JaxStepConfig(**BASE), donate=False)
    batch = make_batch(4, np.float32)
    state0 = jax_train_state(f, jax.tree.map(jnp.asarray, batch))
    js, jl, _ = f.make_steps()["g"](state0, jax.tree.map(jnp.asarray, batch),
                                    jax.random.key(1), use_pose_input=False)
    return _np(state0), _np(jl), _np(js), batch


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_text_f32_g_step_matches_jax(f32_runs, fused):
    state0, jl, js, batch = f32_runs
    factory = StepFactory(StepConfig(**BASE, fused_decoder=fused),
                          device="cpu")
    ps, pl, _ = factory.make_steps()["g"](port_state(factory, state0), batch)
    assert_losses_close(pl, jl, LOSS_RTOL)
    port = W.jax_train_state_of(ps)["g_opt_state"]
    gaps = mu_nu_gaps(port, W._opt_nodes(js.g_opt_state))
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= MOMENT_TOL["jax"], (worst, gaps[worst])
    assert gaps[("mu", "gen/text_encoder")] <= MOMENT_TOL["jax"]
    if fused:
        plain = StepFactory(StepConfig(**BASE), device="cpu")
        pu, _, _ = plain.make_steps()["g"](port_state(plain, state0), batch)
        gaps = mu_nu_gaps(port, W.jax_train_state_of(pu)["g_opt_state"])
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= MOMENT_TOL["fused"], (worst, gaps[worst])
