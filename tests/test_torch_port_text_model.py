"""The text encoder and the fusion of several content streams, port against
the JAX package, on the same random weights (the weight bridge).

The small flagship generator (in_channels 64, 2 clusters, 2 speakers,
B=2, T=64, 32 mel bins) with a text stream of 300 (``text/w2v``) or 768
(``text/bert``) channels: alone, and with the audio fused by
``concat_encoder``.  Eval forward (pose, cluster scores and their softmax)
and train forward (the same, and every BatchNorm running statistic after
it) at rtol = atol = 1e-4, the tolerance of the audio-only forward
(``test_torch_port_model.py``); ``TextEncoder1D`` alone likewise; the
early fusion of ``Speech2Gesture_G`` over audio and text; and the
parameter trees: the port builds exactly the leaves flax's init creates
for each set of streams, so the audio-only tree (and every audio-only
checkpoint) is as it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import (B, FEATS, MEL, SMALL, T, flax_variables,
                                 jax_apply, style_rows)
from mixstage_tpu.models.layers import TextEncoder1D as JaxText
from mixstage_tpu.models.mix_stage import JointLateClusterSoftStyle4_G as JaxG
from mixstage_tpu.models.speech2gesture import Speech2Gesture_G as JaxS2G
from mixstage_tpu_torch.interop import load_flax_state
from mixstage_tpu_torch.interop.weights import to_flax_state
from mixstage_tpu_torch.models import (JointLateClusterSoftStyle4_G,
                                       Speech2Gesture_G)
from mixstage_tpu_torch.models.layers import TextEncoder1D

TOL = dict(rtol=1e-4, atol=1e-4)
WIDTH = {"text/w2v": 300, "text/bert": 768, "audio/log_mel_512": MEL}
STREAMS = {
    "w2v": ("audio/log_mel_512", "text/w2v"),
    "bert": ("audio/log_mel_512", "text/bert"),
    "bert_alone": ("text/bert",),
    "text_first": ("text/w2v", "audio/log_mel_512"),
}


def inputs(modalities, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, T, WIDTH[m])).astype(np.float32)
          for m in modalities]
    y = rng.normal(size=(B, T, FEATS)).astype(np.float32)
    sw = np.repeat(style_rows("soft", seed=seed)[:, None, :], T, axis=1)
    return xs, y, sw


def text_width(modalities):
    return next((WIDTH[m] for m in modalities if m.startswith("text")),
                None)


@pytest.fixture(scope="module", params=sorted(STREAMS))
def generators(request):
    """(modalities, JAX module, params, stats, port module) on one random
    tree drawn for these streams."""
    mods = STREAMS[request.param]
    jg = JaxG(**SMALL, text_channels=text_width(mods))
    xs, y, sw = inputs(mods)
    params, stats = flax_variables(
        jg, [jnp.asarray(x) for x in xs], jnp.asarray(y), jnp.asarray(sw),
        input_modalities=list(mods), use_pose_input=False, train=False,
        seed=3)
    port = JointLateClusterSoftStyle4_G(**SMALL, input_modalities=mods,
                                        text_channels=text_width(mods))
    load_flax_state(port, params, stats)
    return mods, jg, params, stats, port


def _close(got, want, what):
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_generator_with_text_matches_jax(generators, train):
    mods, jg, params, stats, port = generators
    xs, y, sw = inputs(mods, seed=5)
    kw = dict(input_modalities=list(mods), use_pose_input=False)
    args = ([jnp.asarray(x) for x in xs], jnp.asarray(y), jnp.asarray(sw))
    if train:
        ref, mut = jax_apply(jg, params, stats, *args, train=True,
                             mutable=["batch_stats"], **kw)
    else:
        ref = jax_apply(jg, params, stats, *args, train=False, **kw)
    port.train(train)
    with torch.no_grad():
        out = port([torch.from_numpy(x) for x in xs], torch.from_numpy(y),
                   torch.from_numpy(sw), mods)
    for key in ("pose", "labels_score", "labels_cap_soft"):
        _close(out[key].numpy(), ref[key], key)
    if train:
        _, got = to_flax_state(port)
        flat = jax.tree_util.tree_leaves_with_path(mut["batch_stats"])
        assert len(flat) == len(jax.tree_util.tree_leaves(got))
        for path, want in flat:
            node = got
            for k in path:
                node = node[k.key]
            scale = max(float(np.abs(want).max()), 1e-6)
            assert float(np.abs(node - want).max()) <= 1e-4 * scale, path
        load_flax_state(port, params, stats)     # back to the drawn state


def test_parameter_trees_follow_flax_init(generators):
    """The port's leaves are the flax tree's, for every set of streams:
    ``text_encoder`` only with a text stream (its first conv as wide as
    the stream), ``audio_encoder`` only with an audio one, and the rest
    (``concat_encoder`` too) as the audio-only tree has them."""
    mods, _, params, _, port = generators
    assert ("text_encoder" in params) == any(m.startswith("text")
                                              for m in mods)
    assert ("audio_encoder" in params) == any(m.startswith("audio")
                                               for m in mods)
    width = text_width(mods)
    assert port.text_encoder.stack.conv0.conv.weight.shape[1] == width
    audio_only = JointLateClusterSoftStyle4_G(**SMALL)
    names = {n for n, _ in audio_only.named_parameters()}
    assert not any(n.startswith("text_encoder.") for n in names)
    shared = {n: p.shape for n, p in port.named_parameters()
              if not n.startswith(("text_encoder.", "audio_encoder."))}
    assert shared == {n: p.shape for n, p in audio_only.named_parameters()
                      if not n.startswith("audio_encoder.")}


@pytest.mark.parametrize("width", [300, 768])
@pytest.mark.parametrize("train", [False, True])
def test_text_encoder_matches_jax(width, train):
    jm = JaxText(output_feats=T, input_channels=width)
    x = np.random.default_rng(width).normal(size=(B, T, width)).astype(
        np.float32)
    params, stats = flax_variables(jm, jnp.asarray(x), train=False,
                                   seed=width)
    port = TextEncoder1D(input_channels=width)
    load_flax_state(port, params, stats)
    port.train(train)
    if train:
        ref, mut = jax_apply(jm, params, stats, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        ref = jax_apply(jm, params, stats, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == (B, T, 256)
    _close(out.numpy(), ref, "text encoder")
    if train:
        _, got = to_flax_state(port)
        for i in range(6):
            for k in ("mean", "var"):
                want = mut["batch_stats"]["stack"][f"conv{i}"]["norm"][k]
                have = got["stack"][f"conv{i}"]["norm"][k]
                assert np.abs(have - want).max() <= \
                    1e-4 * max(np.abs(want).max(), 1e-6), (i, k)


def test_speech2gesture_early_fusion_matches_jax():
    """A single-stream generator takes audio and text concatenated on the
    channels (``steps.py:239-243``): its 2-D audio encoder's weights do
    not depend on the width, so the port's module is the audio one."""
    mods = ("audio/log_mel_512", "text/w2v")
    xs, y, _ = inputs(mods, seed=7)
    fused = np.concatenate(xs, axis=-1)
    jm = JaxS2G(time_steps=T, out_feats=FEATS, in_channels=64)
    params, stats = flax_variables(jm, jnp.asarray(fused), jnp.asarray(y),
                                   train=False, seed=8)
    port = Speech2Gesture_G(in_channels=64, out_feats=FEATS).eval()
    load_flax_state(port, params, stats)
    ref, _ = jax_apply(jm, params, stats, jnp.asarray(fused),
                       jnp.asarray(y), train=False)
    with torch.no_grad():
        out, _ = port(torch.from_numpy(fused))
    _close(out.numpy(), ref, "Speech2Gesture_G pose")


def test_streams_of_other_lengths_or_ranks_raise():
    """``repeat_text`` 0 gives word-rate text, which cannot be fused with
    frame-rate audio, and a (B, T) stream (``text/pos``) is no input of
    the text encoder: both raise ``TypeError``, as JAX's concatenation
    does."""
    port = JointLateClusterSoftStyle4_G(
        **SMALL, input_modalities=STREAMS["w2v"], text_channels=300).eval()
    audio = torch.zeros(B, T, MEL)
    with torch.no_grad(), pytest.raises(TypeError, match="lengths"):
        port.encode_content([audio, torch.zeros(B, 5, 300)], None,
                            STREAMS["w2v"], False, None)
    with torch.no_grad(), pytest.raises(TypeError, match="takes"):
        port.encode_content([audio, torch.zeros(B, T)], None,
                            ("audio/log_mel_512", "text/pos"), False, None)
