"""The port's serving partitions against the JAX package's, on the CPU.

``build_serving_fn(devices=["cpu"] * n, partition=...)`` (one process
over a list of devices, the counterpart of JAX's forced 8-device CPU mesh)
against JAX's ``build_serving_fn(mesh=make_mesh(n), partition=...)``
(``tests/test_parallel.py:169-283``) and against the one-device port, at
1e-5 max abs:

* batch: the batch split over the devices;
* expert: the folded decoder's groups split (2 and 1 a device), on the
  plain route and on the kernel route (K1's wrapper, its plain version on
  the CPU), the partial mixtures summed on the first device;
* time: one clip of 1024 frames cut into shards at multiples of 32, each
  with a halo of ``time_halo`` frames; a halo too short to cover the
  generator's receptive field misses the whole clip's pose.

The refusals mirror JAX's (``:271-283``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_helpers import flax_variables
from _torch_port_memory import release_memory  # noqa: F401
from mixstage_tpu.models.mix_stage import \
    JointLateClusterSoftStyle4_G as JaxG
from mixstage_tpu.parallel.mesh import make_mesh
from mixstage_tpu.serve import build_serving_fn as jax_build
from mixstage_tpu.train.steps import StepConfig
from mixstage_tpu_torch import serve as port_serve
from mixstage_tpu_torch.interop import load_flax_state
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.serve import build_serving_fn

G, S, MEL, B, TOL = 4, 2, 32, 4, 1e-5
MODEL = dict(num_clusters=G, num_speakers=S, in_channels=64)


@pytest.fixture(scope="module")
def gens():
    """The generator of 4 experts in both packages, the same random
    weights (random BatchNorm statistics too, so the fold is no no-op)."""
    import types

    jg = JaxG(**MODEL)
    params, stats = flax_variables(
        jg, [jnp.zeros((2, 64, MEL))], jnp.zeros((2, 64, 96)),
        jnp.zeros((2, 64, S)), input_modalities=["audio/log_mel_512"],
        use_pose_input=False, train=False, seed=3)
    tg = JointLateClusterSoftStyle4_G(**MODEL)
    load_flax_state(tg, params, stats)
    cfg = StepConfig(model="JointLateClusterSoftStyle4_G", num_clusters=G,
                     num_speakers=S)
    factory = types.SimpleNamespace(cfg=cfg, gen=jg)
    state = types.SimpleNamespace(g_params={"gen": params},
                                  g_state={"gen": stats})
    return factory, state, tg.eval()


def inputs(b, t, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, MEL)).astype(np.float32),
            rng.integers(0, S, size=(b,)).astype(np.int32))


@pytest.mark.parametrize("partition,n,t", [("batch", 2, 64),
                                           ("expert", 2, 64),
                                           ("expert", 4, 64),
                                           ("time", 2, 1024)])
def test_partition_matches_jax_and_one_device(gens, partition, n, t):
    factory, state, tg = gens
    audio, styles = inputs(B if partition != "time" else 1, t)
    want = np.asarray(jax_build(factory, state, use_pallas=False,
                                mesh=make_mesh(n),
                                partition=partition)(audio, styles))
    one = build_serving_fn(tg, device="cpu", use_kernel=False)
    fn = build_serving_fn(tg, devices=["cpu"] * n, partition=partition,
                          use_kernel=False)
    got = fn(audio, styles).numpy()
    assert got.shape == want.shape == audio.shape[:2] + (96,)
    assert fn.partition == partition and len(fn.devices) == n
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, one(audio, styles).numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("partition,n", [("batch", 4), ("expert", 2),
                                         ("expert", 4)])
def test_kernel_route_partitions_match_one_device(gens, partition, n):
    """With the kernel route on (K1's wrapper on the folded, packed
    weights; its plain version on the CPU): batch over 4 devices, and the
    expert split with K1 at 2 and 1 groups a device."""
    _, _, tg = gens
    audio, styles = inputs(B, 64, seed=1)
    one = build_serving_fn(tg, device="cpu", use_kernel=True)
    fn = build_serving_fn(tg, devices=["cpu"] * n, partition=partition,
                          use_kernel=True)
    assert fn.use_kernel
    np.testing.assert_allclose(fn(audio, styles).numpy(),
                               one(audio, styles).numpy(), rtol=0, atol=TOL)


def test_time_halo_covers_the_receptive_field(gens, monkeypatch):
    """The halo is the generator's receptive field read from its modules
    (316 frames here, as at full width: the widths do not move it),
    rounded up to 32; 4 shards of a 1024-frame clip then give the whole
    clip's pose, and a 32-frame halo does not."""
    _, _, tg = gens
    assert port_serve.time_receptive_field(tg) == 316
    assert port_serve.time_halo(tg) == 320
    assert port_serve.time_windows(1024, 4, 320) == [
        (0, 576, 0, 256), (0, 832, 256, 512), (192, 1024, 512, 768),
        (448, 1024, 768, 1024)]
    audio, styles = inputs(1, 1024, seed=2)
    one = build_serving_fn(tg, device="cpu", use_kernel=False)(audio,
                                                                styles)
    fn = build_serving_fn(tg, devices=["cpu"] * 4, partition="time")
    np.testing.assert_allclose(fn(audio, styles).numpy(), one.numpy(),
                               rtol=0, atol=TOL)
    monkeypatch.setattr(port_serve, "time_halo", lambda model: 32)
    short = build_serving_fn(tg, devices=["cpu"] * 4, partition="time")
    assert np.abs(short(audio, styles).numpy() - one.numpy()).max() > 1e-3


def test_partition_refusals_mirror_jax(gens):
    """Unknown partitions, a device count that does not divide the
    experts, the int8 tier on the expert partition, the kernel route on
    the time partition and a batch that does not split raise."""
    _, _, tg = gens
    audio, styles = inputs(B, 64)
    with pytest.raises(ValueError, match="unknown partition"):
        build_serving_fn(tg, devices=["cpu"] * 8, partition="pipeline")
    with pytest.raises(ValueError, match="must divide"):
        build_serving_fn(tg, devices=["cpu"] * 3, partition="expert")
    with pytest.raises(ValueError, match="batch-partitioned only"):
        build_serving_fn(tg, devices=["cpu"] * 2, partition="expert",
                         quantize_int8=True, calib=(audio, styles))
    with pytest.raises(ValueError, match="time partitioning"):
        build_serving_fn(tg, devices=["cpu"] * 2, partition="time",
                         use_kernel=True)
    with pytest.raises(ValueError, match="needs devices"):
        build_serving_fn(tg, device="cpu", partition="expert")
    fn = build_serving_fn(tg, devices=["cpu"] * 4, partition="batch")
    with pytest.raises(ValueError, match="must divide"):
        fn(audio[:3], styles[:3])


def test_int8_batch_partition_matches_one_device(gens):
    """The int8 tier over the batch partition: each device's share through
    ``decoder_int8_plain`` on the weights quantized once."""
    _, _, tg = gens
    audio, styles = inputs(B, 64, seed=4)
    kw = dict(quantize_int8=True, calib=(audio, styles), use_kernel=False)
    one = build_serving_fn(tg, device="cpu", **kw)
    fn = build_serving_fn(tg, devices=["cpu"] * 2, partition="batch", **kw)
    np.testing.assert_allclose(fn(audio, styles).numpy(),
                               one(audio, styles).numpy(), rtol=0, atol=TOL)
