"""The port's serving artifact (``mixstage_tpu_torch/export.py``) against
the JAX package's (``mixstage_tpu/export.py``), on the CPU.

Both artifacts are written from the same weights (the small flagship
generator, drawn with numpy and carried over by the weight bridge) at
batch 2 × 64 frames × 128 mel bins.  Held:
* the port's ``plain`` program and JAX's ``xla`` one give the same pose
  at rtol = atol = 1e-4 (the port-vs-JAX serving tolerance of
  ``test_torch_port_serve.py``), with hard ids and soft style rows;
* the port's program reproduces its own ``build_serving_fn(use_kernel=
  False)`` within 1e-6 of max |pose| (measured: bit for bit), at float32
  and bfloat16;
* the static-shape, format and platform guards (``tests/test_export.py:
  55-84``); the ``kernel`` variant is the card's and is refused here;
* the ``kernel`` program's K1 is a registered operator that
  ``torch.export`` records and reloads (run here through its body's CPU
  route, the plain version);
* a ``DynamicBatcher`` and a static-batch streaming session over the
  artifact.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import SMALL, jax_serving_factory, small_generators
from mixstage_tpu_torch.export import (ARTIFACT_FORMAT, MANIFEST, WEIGHTS,
                                       export_serving, load_serving)
from mixstage_tpu_torch.serve import build_serving_fn

B, T, MEL = 2, 64, 128
S = SMALL["num_speakers"]
ROUNDTRIP_TOL = 1e-6          # of max |pose|
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    from mixstage_tpu.export import export_serving as jax_export

    jg, params, stats, tg = small_generators(mel=MEL)
    factory, state = jax_serving_factory(jg, params, stats)
    jax_art = tmp_path_factory.mktemp("jax_artifact").as_posix()
    jax_export(factory, state, jax_art, batch=B, frames=T, variants=("xla",))
    art = tmp_path_factory.mktemp("port_artifact").as_posix()
    manifest = export_serving(tg, art, batch=B, frames=T,
                              variants=("plain",), device="cpu")
    return tg, art, manifest, jax_art


def _audio(seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, MEL)) \
        .astype(np.float32)


def _styles(kind):
    if kind == "ids":
        return np.array([0, 1], np.int32)
    w = np.random.default_rng(1).uniform(size=(B, S)).astype(np.float32)
    return w / w.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("style", ["ids", "soft"])
def test_plain_artifact_matches_jax_xla_artifact(arts, style):
    from mixstage_tpu.export import load_serving as jax_load

    _, art, _, jax_art = arts
    audio, sty = _audio(), _styles(style)
    want = np.asarray(jax_load(jax_art)(jnp.asarray(audio), sty))
    got = load_serving(art, device="cpu")(audio, sty)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_TOL, atol=JAX_TOL)


def test_artifact_round_trips_its_serving_fn(arts):
    """Loaded program == live ``build_serving_fn(use_kernel=False)``; soft
    rows pass through; one-hot rows equal hard ids."""
    tg, art, manifest, _ = arts
    assert manifest["format"] == ARTIFACT_FORMAT
    assert manifest["variants"]["plain"]["platforms"] == ["cpu", "cuda"]
    assert (manifest["batch"], manifest["frames"], manifest["mel"]) == \
        (B, T, MEL)
    assert manifest["out_feats"] == 96 and manifest["dtype"] == "float32"
    w = torch.load(os.path.join(art, WEIGHTS), weights_only=True)
    assert sorted(w) == ["fc", "fd", "gen"]
    fn = load_serving(art, device="cpu")
    assert fn.variant == "plain" and fn.static_batch == B and fn.frames == T
    live = build_serving_fn(tg, device="cpu", use_kernel=False)
    audio, ids = _audio(2), _styles("ids")
    ref = live(audio, ids)
    scale = float(ref.abs().max())
    for sty in (ids, np.eye(S, dtype=np.float32)[ids]):
        assert float((fn(audio, sty) - ref).abs().max()) <= \
            ROUNDTRIP_TOL * scale
    soft = _styles("soft")
    mix = fn(audio, soft)
    assert float((mix - live(audio, soft)).abs().max()) <= \
        ROUNDTRIP_TOL * scale
    assert not torch.equal(mix, ref)


def test_bf16_artifact_round_trips(arts, tmp_path):
    """A bfloat16 model exports at its compute dtype; float32 pose."""
    from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G

    tg, _, _, _ = arts
    tg16 = JointLateClusterSoftStyle4_G(**SMALL, dtype=torch.bfloat16)
    tg16.load_state_dict(tg.state_dict())
    man = export_serving(tg16, str(tmp_path), batch=B, frames=T,
                         variants=("xla",), device="cpu")
    assert man["dtype"] == "bfloat16" and list(man["variants"]) == ["plain"]
    audio, ids = _audio(3), _styles("ids")
    ref = build_serving_fn(tg16, device="cpu", use_kernel=False)(audio, ids)
    got = load_serving(str(tmp_path), device="cpu")(audio, ids)
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= \
        ROUNDTRIP_TOL * float(ref.abs().max())


def test_static_shape_and_format_guards(arts, tmp_path):
    _, art, _, _ = arts
    fn = load_serving(art, device="cpu")
    with pytest.raises(ValueError, match="static"):
        fn(np.zeros((B, T + 1, MEL), np.float32), np.zeros((B,), np.int32))
    with pytest.raises(ValueError, match="static"):
        fn(np.zeros((B + 1, T, MEL), np.float32), np.zeros((B,), np.int32))
    for name in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="not in artifact"):
            load_serving(art, prefer=name, device="cpu")
    # a future-format artifact is refused, not misread
    with open(os.path.join(art, MANIFEST)) as f:
        man = json.load(f)
    man["format"] = ARTIFACT_FORMAT + 1
    with open(tmp_path / MANIFEST, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="newer"):
        load_serving(str(tmp_path), device="cpu")


def test_kernel_variant_is_the_cards(arts, tmp_path):
    """``kernel`` is exported and loaded on the card only: asking for it
    on the CPU raises, it is not dropped."""
    tg, art, _, _ = arts
    with pytest.raises(ValueError, match="on the card"):
        export_serving(tg, str(tmp_path / "k"), batch=B, frames=T,
                       variants=("plain", "kernel"), device="cpu")
    with pytest.raises(ValueError, match="unknown serving variant"):
        export_serving(tg, str(tmp_path / "u"), variants=("tpu",),
                       device="cpu")
    # an artifact holding a kernel program: the CPU may not run it
    both = tmp_path / "both"
    shutil.copytree(art, both)
    with open(both / MANIFEST) as f:
        man = json.load(f)
    man["variants"]["kernel"] = {"file": "serving_kernel.pt2",
                                 "platforms": ["cuda"], "use_kernel": True}
    with open(both / MANIFEST, "w") as f:
        json.dump(man, f)
    assert load_serving(str(both), device="cpu").variant == "plain"
    with pytest.raises(ValueError, match="lowered for"):
        load_serving(str(both), prefer="kernel", device="cpu")
    del man["variants"]["plain"]
    with open(both / MANIFEST, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="no variant lowered"):
        load_serving(str(both), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_serving(art)


def test_kernel_program_records_k1_as_an_operator(arts, tmp_path):
    """The kernel route's program calls K1 as the registered operator
    ``mixstage_tpu_torch::fused_mixstage_decoder`` (classifier and
    decoder), which ``torch.export`` records, saves and reloads; on CPU
    tensors the operator's body runs the plain version, so the reloaded
    program equals the kernel route's serving function here."""
    from mixstage_tpu_torch.export import _export

    tg, _, _, _ = arts
    fn = build_serving_fn(tg, device="cpu", use_kernel=True)
    gen, fd, fc, packed = fn.bound_args
    assert sorted(packed) == ["classifier", "decoder"]
    ep = _export(fn.program, (gen, fd, fc, packed,
                              torch.zeros(B, T, MEL), torch.zeros(B, S)))
    ops = [n for n in ep.graph.nodes if n.op == "call_function"
           and "mixstage_tpu_torch" in str(n.target)]
    assert len(ops) == 2, ops
    path = str(tmp_path / "kernel.pt2")
    torch.export.save(ep, path)
    assert os.path.getsize(path) < 4 * 2 ** 20    # no weights inside
    call = torch.export.load(path).module()
    audio, ids = _audio(4), _styles("ids")
    rows = torch.eye(S)[torch.as_tensor(ids).long()]
    ref = fn(audio, ids)
    with torch.inference_mode():
        got = call(gen, fd, fc, packed, torch.as_tensor(audio), rows)
    assert float((got - ref).abs().max()) <= \
        ROUNDTRIP_TOL * float(ref.abs().max())


def test_batcher_over_artifact(arts):
    """The micro-batcher over the loaded artifact: a padded partial batch
    answers as a direct full-batch call; ``input_shape`` pins T."""
    from mixstage_tpu_torch.serving import DynamicBatcher

    _, art, _, _ = arts
    fn = load_serving(art, device="cpu")
    audio, ids = _audio(5), _styles("ids")
    ref = fn(np.repeat(audio[:1], B, axis=0), np.repeat(ids[:1], B))[0]
    batcher = DynamicBatcher(fn, batch_size=B, max_wait_ms=50.0,
                             input_shape=(T, MEL))
    try:
        with pytest.raises(ValueError, match="expected"):
            batcher.submit(np.zeros((T + 1, MEL), np.float32), 0)
        got = batcher.submit(audio[0], int(ids[0])).result(120)
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-6, atol=1e-6)
    finally:
        batcher.close()


def test_static_batch_stream(arts):
    """``session_over_serving_fn`` over the artifact tiles each window to
    the static batch and keeps row 0: it streams as JAX's does over its
    artifact, and as a session over the live serving function."""
    from mixstage_tpu.export import load_serving as jax_load
    from mixstage_tpu.streaming import \
        session_over_serving_fn as jax_session
    from mixstage_tpu_torch.streaming import session_over_serving_fn

    tg, art, _, jax_art = arts
    x = np.random.default_rng(6).normal(size=(150, MEL)).astype(np.float32)

    def run(sess):
        parts = [sess.feed(x[i:i + 40]) for i in range(0, 150, 40)]
        parts.append(sess.finish())
        return np.concatenate([np.asarray(p) for p in parts if len(p)])

    got = run(session_over_serving_fn(load_serving(art, device="cpu"), 1,
                                      hop=32))
    assert got.shape == (150, 96)
    want = run(jax_session(jax_load(jax_art), 1, hop=32))
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
    live = run(session_over_serving_fn(
        build_serving_fn(tg, device="cpu", use_kernel=False), 1, hop=32))
    np.testing.assert_allclose(got, live, rtol=1e-5, atol=1e-5)
