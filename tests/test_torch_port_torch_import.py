"""The port's reference-checkpoint import (``interop/torch_import.py``,
``BookKeeper._load_model``'s reference branch, ``cli.import_torch``)
against the JAX package's converter.

The reference checkpoint is built here, from a numpy seed: the JAX
package's template trees (``StepFactory.init`` at a small width) are walked
with its own ``_rename`` and rule tables, each leaf drawn in float64 at a
realistic scale (``_torch_port_helpers._draw``; the reference trains in
float64) and laid out as torch lays it out (the
inverse of ``_to_flax``), plus reference-only keys the converter must skip.
Nothing is downloaded; no reference source tree is needed.

Held: every converted tensor of the port equals what JAX's
``convert_reference_checkpoint`` followed by the weight bridge gives, bit
for bit (GAN ``G.``/``D.`` and non-GAN layouts); the skip report is
JAX's; the served pose of the imported weights matches JAX's serving
function at rtol = atol = 1e-4 (the port-vs-JAX serving tolerance of
``test_torch_port_serve.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from _torch_port_helpers import SMALL, _draw
from mixstage_tpu.interop import torch_import as jti
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.bookkeeping import BookKeeper, weights_of
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.interop import torch_import as pti
from mixstage_tpu_torch.train.steps import StepConfig, StepFactory

SUB = ["exp", "cpk", "speaker", "model", "note"]
B, T, MEL, FEATS = 2, 64, 128, 96
# reference-only keys: momentum counters and branches the forward never
# uses (expected), and one the converter does not know (surprising)
EXTRA = {"unet.conv1.0.norm.num_batches_tracked": (),
         "style_dec.conv.0.conv.weight": (4, 4, 3),
         "text_encoder.conv.0.conv.weight": (4, 300, 3),
         "mystery.weight": (2, 2)}


def _torch_layout(arr, torch_key, flax_path):
    """The inverse of ``_to_flax``'s layout rule for one leaf."""
    if torch_key.endswith("weight") and arr.ndim == 3 \
            and not torch_key.endswith(("norm.weight", "emb.weight")):
        return arr.transpose(2, 1, 0)
    if torch_key.endswith("weight") and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if torch_key.endswith("weight") and arr.ndim == 2 \
            and flax_path.endswith("kernel"):
        return arr.T
    return arr


def _walk(tree, prefix, rules, rng, out, path=""):
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if hasattr(v, "items"):
            _walk(v, prefix, rules, rng, out, p)
            continue
        key = prefix + jti._rename(p, rules)
        val = _draw(rng, k, np.shape(v))              # float64
        out[key] = torch.from_numpy(np.ascontiguousarray(
            _torch_layout(val, key, p)))


def reference_state_dict(template, gan: bool, seed: int = 0):
    """A reference-layout state dict (float64 tensors) for ``template``."""
    rng = np.random.default_rng(seed)
    g = "G." if gan else ""
    sd = {}
    for part in ("g_params", "g_state"):
        for sub, tree in template[part].items():
            rules = jti._PSENC_RULES if sub == "psenc" else jti._GEN_RULES
            _walk(tree, g, rules, rng, sd)
    if gan:
        for part in ("d_params", "d_state"):
            _walk(template[part], "D.", jti._DISC_RULES, rng, sd)
    for key, shape in EXTRA.items():
        sd[g + key] = torch.from_numpy(rng.normal(size=shape))
    return sd


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_side():
    cfg = JaxStepConfig(model="JointLateClusterSoftStyle4_G", gan=True,
                        criterion="L1Loss", **{k: v for k, v in SMALL.items()
                                               if k != "in_channels"},
                        model_kwargs=(("in_channels",
                                       SMALL["in_channels"]),))
    factory = JaxStepFactory(cfg, donate=False)
    rng = np.random.default_rng(0)
    batch = {"x": (jnp.asarray(rng.normal(size=(B, T, MEL)), jnp.float32),),
             "y": jnp.asarray(rng.normal(size=(B, T, FEATS)), jnp.float32),
             "labels": jnp.zeros((B, T), jnp.int32),
             "style": jnp.zeros((B, T), jnp.int32)}
    state = factory.init(jax.random.key(0), batch)
    template = jax.tree.map(np.asarray, {
        "g_params": state.g_params, "g_state": state.g_state,
        "d_params": state.d_params, "d_state": state.d_state})
    return factory, state, template


def port_factory():
    return StepFactory(StepConfig(
        model="JointLateClusterSoftStyle4_G", gan=True, criterion="L1Loss",
        num_clusters=SMALL["num_clusters"],
        num_speakers=SMALL["num_speakers"],
        model_kwargs=(("in_channels", SMALL["in_channels"]),)),
        device="cpu")


@pytest.mark.parametrize("gan", [True, False], ids=["gan", "non_gan"])
def test_converted_weights_equal_jax_converter_and_bridge(jax_side, gan):
    """Every tensor the port's converter loads equals JAX's converter's
    output carried over by the weight bridge, bit for bit; the skip
    reports agree; a non-GAN checkpoint leaves D as it was."""
    _, _, template = jax_side
    sd = reference_state_dict(template, gan)
    jconv, jrep = jti.convert_reference_checkpoint(_np(sd), template)
    f = port_factory()
    bridged = f.init_from_flax(jconv["g_params"], jconv["g_state"],
                               jconv["d_params"], jconv["d_state"])
    state = f.init(seed=1)
    disc_before = weights_of(state)["disc"]
    state, rep = pti.load_reference_state(state, _np(sd))
    assert rep == jrep
    assert rep["n_converted"] > 100
    assert sorted(rep["surprising_skipped"]) == [
        ("G." if gan else "") + "mystery.weight"]
    got, want = weights_of(state), weights_of(bridged)
    for m in ("gen", "psenc") + (("disc",) if gan else ()):
        assert sorted(got[m]) == sorted(want[m]), m
        for k, v in got[m].items():
            assert v.dtype == torch.float32, (m, k)
            assert torch.equal(v, want[m][k]), (m, k)
    if not gan:
        for k, v in got["disc"].items():
            assert torch.equal(v, disc_before[k]), k


def test_imported_weights_serve_as_jax_does(jax_side):
    """The pose the port serves from the imported weights matches JAX's
    serving function on JAX's import of the same checkpoint."""
    from mixstage_tpu.serve import build_serving_fn as jax_serving
    from mixstage_tpu_torch.serve import build_serving_fn

    factory, jstate, template = jax_side
    sd = reference_state_dict(template, gan=True, seed=3)
    jconv, _ = jti.convert_reference_checkpoint(_np(sd), template)
    jstate = jstate.replace(**{k: jax.tree.map(jnp.asarray, v)
                               for k, v in jconv.items()})
    state, _ = pti.load_reference_state(port_factory().init(seed=2), _np(sd))
    rng = np.random.default_rng(4)
    audio = rng.normal(size=(B, T, MEL)).astype(np.float32)
    styles = np.array([0, 1], np.int32)
    want = np.asarray(jax_serving(factory, jstate, use_pallas=False)(
        jnp.asarray(audio), styles))
    got = build_serving_fn(state.gen, device="cpu", use_kernel=False)(
        audio, styles).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_missing_weight_raises_as_jax(jax_side):
    _, _, template = jax_side
    sd = _np(reference_state_dict(template, gan=True))
    del sd["G.decoder.1.conv.weight"]
    with pytest.raises(ValueError, match="missing weights") as jerr:
        jti.convert_reference_checkpoint(sd, template)
    with pytest.raises(ValueError, match="missing weights") as perr:
        pti.load_reference_state(port_factory().init(seed=1), sd)
    assert str(perr.value) == str(jerr.value)


def test_load_model_tells_port_from_reference(jax_side, tmp_path):
    """``-load``: a dict keyed by the port's modules is the port's own, a
    flat state dict (with or without ``G.``/``D.``) a reference one,
    converted on the way; another torch file raises, naming JAX
    checkpoints, and malformed msgpack raises ``ValueError``."""
    _, _, template = jax_side
    f = port_factory()
    trained = f.init(seed=7)
    paths = {"port": tmp_path / "port_weights.p",
             "ref": tmp_path / "ref_weights.p",
             "nested": tmp_path / "nested_weights.p",
             "msgpack": tmp_path / "jax_weights.p"}
    torch.save(weights_of(trained), paths["port"])
    sd = reference_state_dict(template, gan=True, seed=5)
    torch.save(sd, paths["ref"])
    torch.save({"G": {"w": torch.zeros(1)}}, paths["nested"])
    paths["msgpack"].write_bytes(b"\x84\xa8g_params\x80")

    def load(name):
        book = BookKeeper(config_from_dict(dict(load=str(paths[name]),
                                                save_dir=str(tmp_path))),
                          SUB)
        return book._load_model(f.init(seed=8))

    assert pti.sniff_torch_file(str(paths["port"]))
    assert pti.sniff_torch_file(str(paths["ref"]))
    assert not pti.sniff_torch_file(str(paths["msgpack"]))
    got = weights_of(load("port"))
    for m, sd_m in weights_of(trained).items():
        for k, v in sd_m.items():
            assert torch.equal(got[m][k], v), (m, k)
    want, _ = pti.load_reference_state(f.init(seed=9), _np(sd))
    got = weights_of(load("ref"))
    for m, sd_m in weights_of(want).items():
        for k, v in sd_m.items():
            assert torch.equal(got[m][k], v), (m, k)
    with pytest.raises(NotImplementedError, match="JAX checkpoint"):
        load("nested")
    # the truncated map is not a JAX checkpoint either: malformed msgpack
    with pytest.raises(ValueError, match="malformed flax msgpack"):
        load("msgpack")


def test_cli_import_torch_end_to_end(jax_side, tmp_path):
    """``cli.import_torch``: a reference ``PREFIX_weights.p`` with its
    ``_args.args`` becomes a port experiment whose weights are the
    converted ones and whose args stand alone."""
    from mixstage_tpu_torch.cli import import_torch as cli_import
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset

    _, _, template = jax_side
    data = make_synthetic_dataset(str(tmp_path / "data"),
                                  ["oliver", "maher"], 3)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    prefix = "exp_7_cpk_ref_speaker_['oliver', 'maher']_model_" \
             "JointLateClusterSoftStyle4_G"
    weights = ref_dir / f"{prefix}_weights.p"
    sd = reference_state_dict(template, gan=True, seed=11)
    torch.save(sd, weights)
    with open(ref_dir / f"{prefix}_args.args", "w") as f:
        json.dump(dict(exp=7, cpk="ref", speaker=["oliver", "maher"],
                       model="JointLateClusterSoftStyle4_G", gan=1,
                       loss="L1Loss", num_clusters=SMALL["num_clusters"],
                       modelKwargs={"in_channels": SMALL["in_channels"]},
                       batch_size=4, path2data=data,
                       save_dir=str(ref_dir)), f)
    out = tmp_path / "imported"
    cli_import.loop(config_from_dict(dict(load=str(weights),
                                          path2data=data,
                                          out_dir=str(out))), 0,
                    device="cpu")
    new = out / f"{prefix}_weights.p"
    assert new.exists()
    with open(out / f"{prefix}_args.args") as f:
        args = json.load(f)
    assert args["load"] is None and args["save_dir"] == str(out)
    ckpt = torch.load(new, weights_only=True)
    assert sorted(ckpt) == ["disc", "gen", "psenc"]
    want, _ = pti.load_reference_state(port_factory().init(seed=1), _np(sd))
    for m, sd_m in weights_of(want).items():
        for k, v in sd_m.items():
            assert torch.equal(ckpt[m][k], v), (m, k)
    # the port's own file needs no import
    with pytest.raises(AssertionError, match="no import"):
        cli_import.loop(config_from_dict(dict(load=str(new), path2data=data,
                                              out_dir=str(out))), 0,
                        device="cpu")
    assert os.path.exists(out / f"{prefix}_name.name")
