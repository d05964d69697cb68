"""The flax ↔ port weight bridge (mixstage_tpu_torch/interop/weights.py):
a flax tree round-trips through the port BITWISE, every leaf is consumed in
both directions, and mismatches raise."""

import numpy as np
import pytest

from _torch_port_helpers import small_generators
from mixstage_tpu_torch.interop import load_flax_state, to_flax_state
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def generators():
    return small_generators(seed=3)


def test_flax_tree_round_trips_bitwise(generators):
    _, params, stats, port = generators
    params2, stats2 = to_flax_state(port)
    for src, back in ((params, params2), (stats, stats2)):
        a, b = _flat(src), _flat(back)
        assert sorted(a) == sorted(b), set(a) ^ set(b)
        for key in a:
            assert b[key].dtype == a[key].dtype, key
            assert b[key].shape == a[key].shape, key
            assert np.array_equal(b[key], a[key]), key


def test_bridge_covers_every_flax_leaf_and_port_tensor(generators):
    _, params, stats, port = generators
    n_flax = len(_flat(params)) + len(_flat(stats))
    n_port = len(list(port.parameters())) + len(list(port.buffers()))
    assert n_flax == n_port
    # a fresh module is filled completely (load raises on any gap)
    load_flax_state(JointLateClusterSoftStyle4_G(num_clusters=2,
                                                 num_speakers=2,
                                                 in_channels=64),
                    params, stats)


def test_bridge_rejects_missing_and_unknown_leaves(generators):
    _, params, stats, _ = generators
    fresh = JointLateClusterSoftStyle4_G(num_clusters=2, num_speakers=2,
                                         in_channels=64)
    short = {k: v for k, v in params.items() if k != "style_emb"}
    with pytest.raises(KeyError, match="no flax leaf fills"):
        load_flax_state(fresh, short, stats)
    extra = dict(params, bogus={"kernel": np.zeros((3, 2, 2), np.float32)})
    with pytest.raises(KeyError, match="bogus"):
        load_flax_state(fresh, extra, stats)
    wrong = dict(params, style_emb={"embedding": np.zeros((3, 10),
                                                          np.float32)})
    with pytest.raises(ValueError, match="style_emb"):
        load_flax_state(fresh, wrong, stats)


def test_train_state_round_trips_bitwise():
    """A whole JAX ``TrainState`` (params, batch statistics, both Adam
    states with random moments and counts, the counters) → the port's
    trainer state → back, bit for bit."""
    import jax
    import jax.numpy as jnp

    from _torch_port_helpers import flax_variables
    from mixstage_tpu.train.state import TrainState as JaxTrainState
    from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
    from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
    from mixstage_tpu_torch.interop import (jax_train_state_of,
                                            load_jax_train_state)
    from mixstage_tpu_torch.train import StepConfig, StepFactory

    cfg = dict(model="JointLateClusterSoftStyle4_G", gan=True,
               criterion="L1Loss", num_clusters=2, num_speakers=2,
               model_kwargs=(("in_channels", 64),))
    jf = JaxStepFactory(JaxStepConfig(**cfg), donate=False)
    B, T = 2, 64
    x, y = jnp.zeros((B, T, 128)), jnp.zeros((B, T, 96))
    gp, gs = flax_variables(jf.gen, [x], y, jnp.zeros((B, T, 2)),
                            input_modalities=["audio/log_mel_512"],
                            use_pose_input=False, train=False, seed=1)
    pp, ps = flax_variables(jf.psenc, y, train=False, seed=2)
    dp, ds = flax_variables(jf.disc, y, train=False, seed=3)
    g_params = {"gen": gp, "psenc": pp}
    rng = np.random.default_rng(4)

    def moments(opt_state, count):
        adam = opt_state[1][0]
        rand = lambda t: jax.tree.map(  # noqa: E731
            lambda v: rng.normal(size=v.shape).astype(np.float32), t)
        return (opt_state[0], (adam._replace(
            count=jnp.int32(count), mu=rand(adam.mu),
            nu=jax.tree.map(np.abs, rand(adam.nu))),) + opt_state[1][1:])

    jstate = JaxTrainState(
        g_params=g_params, g_state={"gen": gs, "psenc": ps},
        g_opt_state=moments(jf.g_tx.init(g_params), 7), d_params=dp,
        d_state=ds, d_opt_state=moments(jf.d_tx.init(dp), 5),
        step=jnp.int32(12), g_step=jnp.int32(7), lambda_step=jnp.int32(12),
        curriculum_step=jnp.int32(6))
    port = load_jax_train_state(StepFactory(StepConfig(**cfg),
                                            device="cpu"), jstate)
    back = jax_train_state_of(port)
    for field in ("g_params", "g_state", "d_params", "d_state"):
        a, b = _flat(getattr(jstate, field)), _flat(back[field])
        assert sorted(a) == sorted(b), field
        for key in a:
            assert np.array_equal(np.asarray(a[key]), b[key]), (field, key)
    for field in ("g_opt_state", "d_opt_state"):
        adam = getattr(jstate, field)[1][0]
        assert int(back[field]["count"]) == int(adam.count) > 0
        for m in ("mu", "nu"):
            a, b = _flat(getattr(adam, m)), _flat(back[field][m])
            assert sorted(a) == sorted(b), (field, m)
            for key in a:
                assert np.array_equal(np.asarray(a[key]), b[key]), \
                    (field, m, key)
    for k in ("step", "g_step", "lambda_step", "curriculum_step"):
        assert int(back[k]) == int(getattr(jstate, k)) == getattr(port, k)
