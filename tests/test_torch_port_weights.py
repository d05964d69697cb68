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
