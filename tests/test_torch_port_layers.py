"""Each ported layer family against the flax module carrying the same
weights: f32 eval forward at rtol=atol=1e-4 (room for ATen vs XLA-CPU
summation order; the layers are otherwise the same math)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_variables, jax_apply
from mixstage_tpu.models import layers as jl
from mixstage_tpu_torch.interop import load_flax_state
from mixstage_tpu_torch.models import layers as tl

# name: (flax module, port module, input shape, extra call kwargs)
CASES = {
    "cnr_1d": (jl.ConvNormRelu(16, 24, type="1d", leaky=True),
               tl.ConvNormRelu(16, 24, type="1d", leaky=True),
               (2, 32, 16), {}),
    "cnr_2d": (jl.ConvNormRelu(3, 8, type="2d", leaky=True),
               tl.ConvNormRelu(3, 8, type="2d", leaky=True),
               (2, 16, 12, 3), {}),
    "cnr_grouped_relu": (jl.ConvNormRelu(10, 12, groups=3),
                         tl.ConvNormRelu(10, 12, groups=3),
                         (2, 32, 30), {}),
    "cnr_grouped_einsum": (
        jl.ConvNormRelu(10, 12, groups=3, leaky=True, lowering="einsum"),
        tl.ConvNormRelu(10, 12, groups=3, leaky=True, lowering="einsum"),
        (2, 32, 30), {}),
    "cnr_downsample_1d": (jl.ConvNormRelu(8, 8, downsample=True, leaky=True),
                          tl.ConvNormRelu(8, 8, downsample=True, leaky=True),
                          (2, 32, 8), {}),
    "cnr_downsample_2d_s2d": (
        jl.ConvNormRelu(4, 8, type="2d", downsample=True, lowering="s2d"),
        tl.ConvNormRelu(4, 8, type="2d", downsample=True, lowering="s2d"),
        (2, 16, 12, 4), {}),
    "cnr_k3x8": (jl.ConvNormRelu(4, 6, type="2d", leaky=True,
                                 kernel_size=(3, 8), stride=1),
                 tl.ConvNormRelu(4, 6, type="2d", leaky=True,
                                 kernel_size=(3, 8), stride=1),
                 (2, 8, 10, 4), {}),
    "cnr_k3x8_im2col": (jl.ConvNormRelu(4, 6, type="2d", leaky=True,
                                        kernel_size=(3, 8), stride=1,
                                        lowering="im2col"),
                        tl.ConvNormRelu(4, 6, type="2d", leaky=True,
                                        kernel_size=(3, 8), stride=1,
                                        lowering="im2col"),
                        (2, 8, 10, 4), {}),
    "unet1d": (jl.UNet1D(16, 16), tl.UNet1D(16, 16), (2, 64, 16), {}),
    "audio_encoder": (jl.AudioEncoder(), tl.AudioEncoder(), (2, 64, 32),
                      {"time_steps": 64}),
    "audio_encoder_resize_down": (jl.AudioEncoder(), tl.AudioEncoder(),
                                  (2, 64, 32), {"time_steps": 5}),
    "cluster_classify": (jl.ClusterClassify(num_clusters=3,
                                            input_channels=20),
                         tl.ClusterClassify(num_clusters=3,
                                            input_channels=20),
                         (2, 32, 20), {}),
    "grouped_pointwise": (jl.GroupedPointwiseConv(features=12, groups=3),
                          tl.GroupedPointwiseConv(24, 12, groups=3),
                          (2, 16, 24), {}),
    "emb_lin": (jl.EmbLin(4, 6), tl.EmbLin(4, 6), (2, 16, 4), {}),
    "pose_encoder": (jl.PoseEncoder(input_channels=12),
                     tl.PoseEncoder(input_channels=12), (2, 16, 12), {}),
    "text_encoder": (jl.TextEncoder1D(input_channels=20),
                     tl.TextEncoder1D(input_channels=20), (2, 16, 20), {}),
}
NO_TRAIN_FLAG = ("grouped_pointwise", "emb_lin")


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax(name):
    flax_mod, port_mod, shape, kwargs = CASES[name]
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jkw = dict(kwargs) if name in NO_TRAIN_FLAG else dict(kwargs, train=False)
    params, stats = flax_variables(flax_mod, jnp.asarray(x), seed=5, **jkw)
    ref = jax_apply(flax_mod, params, stats, jnp.asarray(x), **jkw)
    load_flax_state(port_mod, params, stats)
    with torch.no_grad():
        out = port_mod(torch.from_numpy(x), **kwargs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("out_size", [16, 4, 7])
def test_resize_bilinear_time_matches_jax(out_size):
    x = np.random.default_rng(8).normal(size=(2, 7, 5, 3)).astype(np.float32)
    ref = np.asarray(jl.resize_bilinear_time(jnp.asarray(x), out_size))
    out = tl.resize_bilinear_time(torch.from_numpy(x), out_size).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_unknown_lowering_and_short_unet_input_raise():
    with pytest.raises(ValueError, match="lowering"):
        tl.ConvNormRelu(4, 4, lowering="winograd")
    with pytest.raises(ValueError, match="divisible"):
        tl.UNet1D(4, 4)(torch.zeros(1, 48, 4))
