"""JointLateClusterSoftStyle4_G eval forward, port vs JAX, same weights:
pose, labels_score and labels_cap_soft at rtol=atol=1e-4, for hard one-hot
and soft style rows and for the curriculum pose input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (B, FEATS, MEL, MODALITIES, T,
                                 small_generators, style_rows)


@pytest.fixture(scope="module")
def generators():
    return small_generators(seed=1)


@pytest.mark.parametrize("style,use_pose_input", [
    ("hard", False), ("soft", False), ("soft", True)])
def test_generator_eval_forward_matches_jax(generators, style,
                                            use_pose_input):
    import jax

    jg, params, stats, port = generators
    rng = np.random.default_rng(2)
    audio = rng.normal(size=(B, T, MEL)).astype(np.float32)
    y = rng.normal(size=(B, T, FEATS)).astype(np.float32)
    sw = np.repeat(style_rows(style, seed=4)[:, None, :], T, axis=1)

    fwd = jax.jit(lambda v, a, y, sw: jg.apply(
        v, [a], y, sw, input_modalities=list(MODALITIES),
        use_pose_input=use_pose_input, train=False))
    ref = jax.tree.map(np.asarray, fwd(
        {"params": params, "batch_stats": stats}, jnp.asarray(audio),
        jnp.asarray(y), jnp.asarray(sw)))
    with torch.no_grad():
        out = port([torch.from_numpy(audio)], torch.from_numpy(y),
                   torch.from_numpy(sw), MODALITIES,
                   use_pose_input=use_pose_input)
    for key in ("pose", "labels_score", "labels_cap_soft"):
        np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_registry_and_text_modality():
    from mixstage_tpu_torch.models import get_model_def
    from mixstage_tpu_torch.models.mix_stage import \
        JointLateClusterSoftStyle4_G

    assert get_model_def("JointLateClusterSoftStyle4_G") is \
        JointLateClusterSoftStyle4_G
    with pytest.raises(KeyError, match="known"):
        get_model_def("NoSuchModel_G")  # Speech2Gesture_G is ported now
    port = JointLateClusterSoftStyle4_G(num_clusters=2, num_speakers=2,
                                        in_channels=64)
    # built for audio (flax's tree of an audio-only generator has no
    # text_encoder) it has no text encoder
    with pytest.raises(ValueError, match="text stream"):
        port.encode_content([torch.zeros(1, 64, 300)], None, ["text/w2v"],
                            False, None)
    # built for text it encodes text (held to JAX in
    # test_torch_port_text_model.py)
    port = JointLateClusterSoftStyle4_G(num_clusters=2, num_speakers=2,
                                        in_channels=64,
                                        input_modalities=["text/w2v"])
    out = port.encode_content([torch.zeros(1, 64, 300)], None,
                              ["text/w2v"], False, None)
    assert tuple(out.shape) == (1, 64, 256)
