"""Train-mode layers of the port against the flax modules carrying the same
weights: ``apply(..., train=True, mutable=["batch_stats"])``.  Outputs and
the updated running statistics at rtol=atol=1e-5; the gradients of a random
projection of the output w.r.t. every parameter and the input against
``jax.grad`` at relative Frobenius error ≤ 1e-4 (float32 sums in another
order).  Conv biases that feed a train-mode BatchNorm have gradient 0
analytically, so theirs are compared absolutely (< 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_variables
from mixstage_tpu.models import layers as jl
from mixstage_tpu.models.speech2gesture import Speech2Gesture_D as JaxD
from mixstage_tpu_torch.interop import load_flax_state, to_flax_state
from mixstage_tpu_torch.interop.weights import flax_params_to_torch
from mixstage_tpu_torch.models import Speech2Gesture_D
from mixstage_tpu_torch.models import layers as tl

# name: (flax module, port module, input shape)
CASES = {
    "cnr_1d": (jl.ConvNormRelu(16, 24, type="1d", leaky=True),
               tl.ConvNormRelu(16, 24, type="1d", leaky=True), (2, 32, 16)),
    "cnr_1d_grouped_relu": (jl.ConvNormRelu(10, 12, groups=3),
                            tl.ConvNormRelu(10, 12, groups=3), (2, 32, 30)),
    "cnr_2d_downsample": (
        jl.ConvNormRelu(3, 8, type="2d", leaky=True, downsample=True),
        tl.ConvNormRelu(3, 8, type="2d", leaky=True, downsample=True),
        (2, 16, 12, 3)),
    "pose_style_encoder": (jl.PoseStyleEncoder(input_channels=12,
                                               num_speakers=3),
                           tl.PoseStyleEncoder(input_channels=12,
                                               num_speakers=3), (2, 64, 12)),
    "speech2gesture_d": (JaxD(in_channels=12), Speech2Gesture_D(12),
                         (2, 64, 12)),
}


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_mode_layer_matches_flax(name):
    flax_mod, port_mod, shape = CASES[name]
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    params, stats = flax_variables(flax_mod, jnp.asarray(x), train=False,
                                   seed=3)

    def jax_fwd(p, xx):
        out, mut = flax_mod.apply({"params": p, "batch_stats": stats}, xx,
                                  train=True, mutable=["batch_stats"])
        return _first(out), mut["batch_stats"]

    ref, ref_stats = jax_fwd(params, jnp.asarray(x))
    cot = rng.normal(size=ref.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jax_fwd(p, xx)[0] * cot),
                      argnums=(0, 1))(params, jnp.asarray(x))

    load_flax_state(port_mod, params, stats)
    port_mod.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = _first(port_mod(xt))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    _, new_stats = to_flax_state(port_mod)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(new_stats),
                            jax.tree_util.tree_leaves(ref_stats)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))

    names = [n for n, _ in port_mod.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [xt] + list(port_mod.parameters()))
    assert _rel(grads[0].numpy(), gx) <= 1e-4
    want = flax_params_to_torch(port_mod, jax.tree.map(np.asarray, gp))
    for n, g in zip(names, grads[1:]):
        if n == "conv.bias" or n.endswith(".conv.bias"):
            # a conv bias before a train-mode BN has gradient 0 analytically
            # (the batch mean cancels it): both sides are float noise
            assert np.abs(g.numpy()).max() < 1e-4, n
            assert np.abs(want[n]).max() < 1e-4, n
            continue
        assert _rel(g.numpy(), want[n]) <= 1e-4, n


def test_eval_mode_leaves_running_stats_alone():
    bn = tl.BatchNorm(4)
    bn.running_mean.fill_(0.5)
    bn.eval()(torch.randn(3, 5, 4))
    assert torch.all(bn.running_mean == 0.5)
    bn.train()(torch.randn(3, 5, 4))
    assert not torch.all(bn.running_mean == 0.5)


def test_discriminator_registry():
    from mixstage_tpu_torch.models import get_model_def, infer_discriminator_name

    name = infer_discriminator_name("JointLateClusterSoftStyle4_G")
    assert name == "JointLateClusterSoftStyle4_D"
    assert get_model_def(name) is Speech2Gesture_D
    d = Speech2Gesture_D(in_channels=96)
    score, internal = d.eval()(torch.zeros(2, 64, 96))
    assert score.shape == (2, 12) and internal == []
