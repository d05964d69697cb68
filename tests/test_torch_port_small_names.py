"""The small names of the JAX package the port lacked: ``parallel.py``'s
``get_parallel_list`` and ``get_tensor_items``, ``DummyData``,
``TransformDict`` and the ZNorm self-test, ``tree_size``,
``StepTimer.measure`` / ``reset`` and ``Trainer.get_gt``, each against the
JAX package's on the same inputs (bit for bit: the same host arithmetic).
"""

import importlib
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import flax_variables
from mixstage_tpu.data import dataset as jds
from mixstage_tpu.data import transforms as jtf
from mixstage_tpu.models import layers as jl
from mixstage_tpu.train import profiling as jprof
from mixstage_tpu.train import state as jstate
from mixstage_tpu.train.trainer import Trainer as JaxTrainer
from mixstage_tpu_torch.data import dataset as pds
from mixstage_tpu_torch.data import transforms as ptf
from mixstage_tpu_torch.models import layers as pl
from mixstage_tpu_torch.train import profiling as pprof
from mixstage_tpu_torch.train import state as pstate
from mixstage_tpu_torch.train.trainer import Trainer

# the packages' ``parallel`` names their thread map, not the module
jpar = importlib.import_module("mixstage_tpu.parallel.parallel")
ppar = importlib.import_module("mixstage_tpu_torch.parallel.parallel")


@pytest.mark.parametrize("n", [1, 3, 7, 10, 11])
def test_get_parallel_list_matches_jax(n):
    xs = list(range(10))
    assert list(ppar.get_parallel_list(xs, n)) == \
        list(jpar.get_parallel_list(xs, n))


def test_get_tensor_items_matches_jax():
    assert ppar.get_tensor_items(None) is jpar.get_tensor_items(None)
    x = np.arange(5, dtype=np.float32) / 3
    assert ppar.get_tensor_items(torch.from_numpy(x)) == \
        jpar.get_tensor_items(jnp.asarray(x))
    assert ppar.get_tensor_items(["a", 2]) == jpar.get_tensor_items(["a", 2])


@pytest.mark.parametrize("random", [False, True])
def test_dummy_data_matches_jax(random):
    p = pds.DummyData(["pose", "audio"], length=40, random=random, seed=3)
    j = jds.DummyData(["pose", "audio"], length=40, random=random, seed=3)
    assert len(p) == len(j) == 40
    for i in (0, 17, 39):
        for v in ("pose", "audio"):
            np.testing.assert_array_equal(p[i][v], j[i][v])


def test_transform_dict_matches_jax():
    batch = {"a": np.arange(6.0).reshape(2, 3), "b": np.ones((4,))}
    got = ptf.TransformDict(lambda x, k=1.0: x * 2 + k)(batch, k=0.5)
    want = jtf.TransformDict(lambda x, k=1.0: x * 2 + k)(batch, k=0.5)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert repr(ptf.TransformDict(abs)).startswith("TransformDict(")


def test_znorm_self_test_matches_jax(tmp_path):
    """The self-test's normalised DummyData: mean 0, std 1, and the port's
    ZNorm output equal to the JAX package's on the same data."""
    stats = ptf.znorm_self_test(length=300, savepath=str(tmp_path / "p"))
    for m, s in stats.values():
        assert abs(m) < 1e-6 and abs(s - 1) < 1e-2
    dummy = jds.DummyData(["pose", "audio"], length=300, random=True)
    batch = {v: np.stack([dummy[i][v] for i in range(300)])
             for v in ("pose", "audio")}

    class Loader:
        def iter_all(self, batch_size=32):
            for s in range(0, 300, batch_size):
                yield {k: v[s:s + batch_size] for k, v in batch.items()}
    j = jtf.ZNorm(["pose", "audio"], savepath=str(tmp_path / "j"),
                  key="dummy", data=Loader(), verbose=False)
    p = ptf.ZNorm(["pose", "audio"], savepath=str(tmp_path / "q"),
                  key="dummy", data=Loader(), verbose=False)
    got, want = p(dict(batch)), j(dict(batch))
    for v in ("pose", "audio"):
        np.testing.assert_array_equal(got[v], want[v])


def test_tree_size_matches_jax():
    jm = jl.PoseDecoder(16, 3, 4, 5)
    params, _ = flax_variables(jm, jnp.zeros((2, 8, 4 * 19)), train=False)
    pm = pl.PoseDecoder(16, 3, 4, 5)
    want = jstate.tree_size(params)
    assert pstate.tree_size(pm) == want
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in
               params["pose_logits"].items()}
    assert pstate.tree_size([tensors, None, (np.zeros((2, 3)),)]) == \
        jstate.tree_size([params["pose_logits"], None,
                          (jnp.zeros((2, 3)),)])


def test_step_timer_measure_and_reset_match_jax():
    for mod in (pprof, jprof):
        t = mod.StepTimer("g")
        for _ in range(3):
            with t.measure():
                time.sleep(0.002)
        assert len(t.times) == 3 and min(t.times) >= 0.002
        with pytest.raises(RuntimeError):
            with t.measure():
                raise RuntimeError("the step failed")
        assert len(t.times) == 4            # timed all the same
        summary = t.summary("train_")
        assert sorted(summary) == ["train_g_ms_p50", "train_g_ms_p99",
                                   "train_g_per_sec"]
        t.reset()
        assert t.times == [] and t.summary() == {}


def test_get_gt_matches_jax(tmp_path):
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(str(tmp_path), ["oliver"], 1)
    f = next((tmp_path / "processed" / "oliver").glob("*.h5"))
    stub = types.SimpleNamespace(output_modality="pose/data",
                                 data_shape={"pose/data": (64, 104)})
    got = Trainer.get_gt(stub, f)
    want = JaxTrainer.get_gt(stub, f)
    assert got.shape == want.shape and got.shape[1:] == (2, 52)
    np.testing.assert_array_equal(got, want)
    assert not got[..., 0].any()
