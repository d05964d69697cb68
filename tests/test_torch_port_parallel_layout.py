"""The port's layouts (``parallel/mesh.py``, ``parallel/multihost.py``) and
K3's statistics exchange, on the CPU.

Two gloo ranks (child processes, ``_torch_port_parallel.py``) hold the
layout's pieces against what one process computes: ``shard_batch`` gives
rank r rows ``[r·B/2, (r+1)·B/2)`` and replicates a batch that does not
split (JAX ``tests/test_parallel.py:18-29``), ``replicate_state`` makes
rank 0's values everyone's, the all-reduce, all-gather and barrier
(``tests/test_multihost.py:40-62``), ``shard_for_process``, the gradient
mean and the global losses, and BatchNorm over the data group equal to
BatchNorm on the whole batch.  In one process every piece is the
identity.  K3's plain versions run with an exchange between two ranks
emulated by threads: their outputs on half batches equal the whole batch's.
"""

import threading

import numpy as np
import pytest
import torch

from _torch_port_parallel import run_ranks
from mixstage_tpu_torch.ops.cuda import train_decoder as td
from mixstage_tpu_torch.parallel import mesh, multihost

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("collectives", tmp_path_factory.mktemp("layout"),
                     WORLD, {})


def test_collectives_on_two_ranks(ranks):
    for r, out in enumerate(ranks):
        assert out["dp"] == WORLD and out["data_rank"] == r
        assert str(out["backend"]) == "gloo"
        np.testing.assert_array_equal(out["all_reduce"], [3.0])
        np.testing.assert_array_equal(
            out["all_gather"],
            np.repeat(np.arange(WORLD), 2)[:, None].repeat(3, 1))
        np.testing.assert_array_equal(out["any_rank"], [True, False])
        np.testing.assert_array_equal(out["for_process"],
                                      np.arange(10)[r::WORLD])
        assert out["model_rank"] == r
        np.testing.assert_array_equal(out["model_sum"], [float(WORLD)])


def test_shard_batch_rows_and_ragged_replication(ranks):
    y = np.arange(16 * 3).reshape(16, 3)
    x = np.arange(16 * 2).reshape(16, 2)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["shard_y"], y[8 * r:8 * r + 8])
        np.testing.assert_array_equal(out["shard_x"], x[8 * r:8 * r + 8])
        # 3 rows do not split over 2 ranks: replicated, not dropped
        np.testing.assert_array_equal(out["shard_ragged"],
                                      np.arange(6).reshape(3, 2))
        np.testing.assert_array_equal(
            out["stacked"], np.arange(16).reshape(2, 8)[:, 4 * r:4 * r + 4])


def test_replicate_state_and_gradient_mean(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["replicated"], np.zeros((2, 3)))
        np.testing.assert_array_equal(out["grad_f32"], [0.5, 0.5])
        assert out["grad_f64"].dtype == np.float64
        np.testing.assert_array_equal(out["grad_f64"], [1.0] * 3)
        assert out["mean_s"] == 0.5
        np.testing.assert_array_equal(out["gathered_W"], [0, 0, 1, 1])


def test_batchnorm_takes_the_global_batch(ranks):
    """Output, input and weight gradients and running statistics of
    BatchNorm over the data group equal BatchNorm on the whole batch (the
    cross-rank terms of the gradient included)."""
    for out in ranks:
        assert out["bn_out"] < 1e-5
        assert out["bn_dx"] < 1e-5
        assert out["bn_dw"] < 1e-4
        assert out["bn_stats"] < 1e-6


def test_one_process_is_the_identity():
    """No process group: a world of one, every piece the identity; a layout
    asking for more ranks raises naming the launch."""
    assert multihost.setup() == 1
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.shard_for_process([3, 4]) == [3, 4]
    lay = mesh.make_mesh(0)
    assert (lay.dp, lay.mp, lay.world, lay.is_main) == (1, 1, 1, True)
    batch = {"y": np.zeros((3, 2))}
    assert mesh.shard_batch(batch, lay) is batch
    g = [torch.ones(2)]
    assert mesh.all_reduce_grads(g, lay)[0] is g[0]
    lin = torch.nn.Linear(2, 2)
    assert mesh.replicate_state(lin, lay) is lin
    assert mesh.stats_exchange(None) is None
    with mesh.batch_stats(lay, True):
        assert mesh.batch_stats_group() is None
    for n in (2, 8):
        with pytest.raises(ValueError, match=f"torchrun --nproc_per_node {n}"):
            mesh.make_mesh(n)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        mesh.make_mesh_2d(2, 2)


def _k3_inputs(B=6, T=16, C0=12, C=8, F=6, G=4, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    x = r(B, T, C0)
    w = (r(G, 3, C0, C, scale=0.3), r(3, G, 3, C, C, scale=0.3),
         r(G, 4, C, scale=0.1), 1 + r(G, 4, C, scale=0.1),
         r(G, 4, C, scale=0.1), r(G, C, F, scale=0.3),
         r(G, 1, F, scale=0.1))
    return x, w, r(G, B, T, F)


def _threaded(fn, world):
    """``fn(rank, exchange)`` on ``world`` threads whose exchange sums the
    ranks' buffers, as the data group's all-reduce does."""
    barrier, bufs, res = threading.Barrier(world), {}, {}

    def exchange_of(rank):
        def exchange(stats, rows):
            bufs[rank] = stats.clone()
            barrier.wait()
            total = sum(bufs[i] for i in range(world))
            barrier.wait()
            stats.copy_(total)
            return rows * world
        return exchange

    threads = [threading.Thread(
        target=lambda i=i: res.__setitem__(i, fn(i, exchange_of(i))))
        for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return [res[i] for i in range(world)]


@pytest.mark.parametrize("G", [4, 2, 1])
def test_k3_plain_versions_exchange_over_ranks(G):
    """K3's plain forward and backward on each rank's rows, their
    statistics summed between the layers by the exchange, equal the calls
    on the whole batch: out, cs, dx by rows; mu, var the same; the weight
    gradients summed over the ranks (every G the expert layout gives K3)."""
    x, w, dout = _k3_inputs(G=G)
    out, cs, mu, var = td.decoder_train_fwd(x, *w)
    full = td.decoder_train_bwd(dout, x, cs, mu, var, w[0], w[1], w[3],
                                w[4], w[5])
    rows = [slice(0, 3), slice(3, 6)]

    def rank(i, exchange):
        xs, ds = x[rows[i]].contiguous(), dout[:, rows[i]].contiguous()
        o, c, m, v = td.decoder_train_fwd(xs, *w, exchange=exchange)
        grads = td.decoder_train_bwd(ds, xs, c, m, v, w[0], w[1], w[3],
                                     w[4], w[5], exchange=exchange)
        return o, c, m, v, grads

    res = _threaded(rank, 2)
    torch.testing.assert_close(torch.cat([r[0] for r in res], 1), out,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r[1] for r in res], 2), cs,
                               rtol=1e-5, atol=1e-5)
    for r in res:
        torch.testing.assert_close(r[2], mu, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(r[3], var, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([r[4][0] for r in res]), full[0],
                               rtol=1e-4, atol=1e-5)
    for k in range(1, 8):
        torch.testing.assert_close(res[0][4][k] + res[1][4][k], full[k],
                                   rtol=1e-4, atol=1e-5)
    # without the exchange each rank normalises by its own rows: wrong
    local = td.decoder_train_fwd(x[rows[0]].contiguous(), *w)
    assert (local[2] - mu).abs().max() > 1e-3


def test_k3_launch_count_is_one_per_call_on_the_cpu():
    """The plain route launches nothing: the wrappers count kernel
    launches only."""
    x, w, dout = _k3_inputs()
    before = (td.decoder_train_fwd.launches, td.decoder_train_bwd.launches)
    td.decoder_train_fwd(x, *w, exchange=lambda s, rows: rows)
    assert (td.decoder_train_fwd.launches,
            td.decoder_train_bwd.launches) == before
