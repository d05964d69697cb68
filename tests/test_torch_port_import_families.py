"""The reference importer's other model families: every state JAX's
``convert_reference_checkpoint`` fills (``mixstage_tpu/interop/
torch_import.py:168-200``) beyond the Mix-StAGE GAN of
``test_torch_port_torch_import.py``.

For each family a reference state dict is built from the JAX package's
template (its ``StepFactory`` state at a small width) with the JAX rule
tables, drawn from a numpy seed in float64 (the reference's dtype), with
the reference-only keys of ``test_torch_port_torch_import.EXTRA``:

* ``mixstage_nongan``: the Mix-StAGE generator and pose-style encoder
  without a discriminator (unprefixed keys, as non-GAN trainers save);
* ``s2g_gan`` / ``s2g_nongan``: ``Speech2Gesture_G`` with its D (``G.`` /
  ``D.``) and without;
* ``classifier``: ``StyleClassifier_G``.

Held bit for bit: every tensor the port's converter loads equals JAX's
converter followed by the weight bridge; the skip reports are JAX's;
``cli.import_torch`` writes each family's port experiment, holding the
family's modules and nothing else.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixstage_tpu.interop import torch_import as jti
from mixstage_tpu.train.steps import StepConfig as JaxStepConfig
from mixstage_tpu.train.steps import StepFactory as JaxStepFactory
from mixstage_tpu_torch.bookkeeping import weights_of
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.interop import torch_import as pti
from mixstage_tpu_torch.train import StepConfig, StepFactory
from test_torch_port_simple_models import CONFIGS, make_batch
from test_torch_port_torch_import import _np, reference_state_dict

FAMILIES = {  # name: (JAX/port StepConfig kwargs, the port's modules)
    "mixstage_nongan": ("mixstage_nongan", ["gen", "psenc"]),
    "s2g_gan": ("s2g_gan", ["disc", "gen"]),
    "s2g_nongan": ("s2g_nongan", ["gen"]),
    "classifier": ("classifier", ["gen"]),
}
MODELKWARGS = {"mixstage_nongan": {"in_channels": 32},
               "s2g_gan": {"in_channels": 32},
               "s2g_nongan": {"in_channels": 32}, "classifier": {}}


def _cfg(name):
    return dict(CONFIGS[FAMILIES[name][0]], num_speakers=2)


@pytest.fixture(scope="module")
def templates():
    """Each family's JAX template trees."""
    out = {}
    for name in FAMILIES:
        f = JaxStepFactory(JaxStepConfig(**_cfg(name)), donate=False)
        state = f.init(jax.random.key(0),
                       jax.tree.map(jnp.asarray, make_batch(0)))
        out[name] = jax.tree.map(np.asarray, {
            "g_params": state.g_params, "g_state": state.g_state,
            "d_params": state.d_params, "d_state": state.d_state})
    return out


def _port_factory(name):
    return StepFactory(StepConfig(**_cfg(name)), device="cpu")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_converts_as_jax_does(templates, name):
    template = templates[name]
    gan = template["d_params"] is not None
    sd = reference_state_dict(template, gan, seed=sorted(FAMILIES).index(
        name))
    jconv, jrep = jti.convert_reference_checkpoint(_np(sd), template)
    f = _port_factory(name)
    bridged = f.init_from_flax(jconv["g_params"], jconv["g_state"],
                               jconv["d_params"], jconv["d_state"])
    state, rep = pti.load_reference_state(f.init(seed=1), _np(sd))
    assert rep == jrep
    assert rep["n_converted"] > 20
    got, want = weights_of(state), weights_of(bridged)
    assert sorted(got) == FAMILIES[name][1]
    for m in got:
        assert sorted(got[m]) == sorted(want[m]), m
        for k, v in got[m].items():
            assert v.dtype == torch.float32, (m, k)
            assert torch.equal(v, want[m][k]), (m, k)
    # the template the port builds is JAX's, leaf for leaf
    ptemplate = pti.reference_template(state)
    for part in ("g_params", "g_state", "d_params", "d_state"):
        if template[part] is None:
            assert ptemplate[part] is None, part
            continue
        jleaves = jax.tree_util.tree_flatten_with_path(template[part])[0]
        pleaves = jax.tree_util.tree_flatten_with_path(ptemplate[part])[0]
        assert [k for k, _ in pleaves] == [k for k, _ in jleaves], part
        for (_, a), (_, b) in zip(pleaves, jleaves):
            assert a.shape == b.shape


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_cli_import_torch_writes_each_family(templates, name, tmp_path):
    """``cli.import_torch`` of each family's reference checkpoint writes a
    port experiment holding the converted modules."""
    from mixstage_tpu_torch.cli import import_torch as cli_import
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset

    template = templates[name]
    gan = template["d_params"] is not None
    cfg = _cfg(name)
    data = make_synthetic_dataset(str(tmp_path / "data"),
                                  ["oliver", "maher"], 3)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    prefix = f"exp_3_cpk_ref_speaker_['oliver', 'maher']_model_" \
             f"{cfg['model']}"
    weights = ref_dir / f"{prefix}_weights.p"
    sd = reference_state_dict(template, gan, seed=21)
    torch.save(sd, weights)
    args = dict(exp=3, cpk="ref", speaker=["oliver", "maher"],
                model=cfg["model"], gan=int(cfg["gan"]), loss="L1Loss",
                num_clusters=cfg.get("num_clusters", 8),
                modelKwargs=MODELKWARGS[name], batch_size=4,
                path2data=data, save_dir=str(ref_dir))
    with open(ref_dir / f"{prefix}_args.args", "w") as f:
        json.dump(args, f)
    out = tmp_path / "imported"
    cli_import.loop(config_from_dict(dict(load=str(weights), path2data=data,
                                          out_dir=str(out))), 0,
                    device="cpu")
    ckpt = torch.load(out / f"{prefix}_weights.p", weights_only=True)
    assert sorted(ckpt) == FAMILIES[name][1]
    want, _ = pti.load_reference_state(_port_factory(name).init(seed=1),
                                       _np(sd))
    for m, sd_m in weights_of(want).items():
        assert sorted(ckpt[m]) == sorted(sd_m), m
        for k, v in sd_m.items():
            assert torch.equal(ckpt[m][k], v), (m, k)
