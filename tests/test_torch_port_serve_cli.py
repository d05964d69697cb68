"""The port's serving CLIs on the CPU: ``cli.serve`` (``build`` on port
0) in checkpoint mode (f32 and ``-serve_int8 1``, the waveform endpoint
on a ``log_mel_400`` model) and artifact mode (``-export_dir``, after
``cli.export``), ``resolve_partition`` and the partitions ``build``
serves over several devices, and ``Trainer.peek_batches`` with
the pooled int8 calibration windows against the JAX package's.

The experiments are trained here by ``cli.train`` at the sizes of
``test_torch_port_lifecycle.py`` (2 speakers, 2 clusters, ``in_channels``
64, batch 4).  Each pose served over HTTP (JSON, npz, a streaming
session, a waveform) equals the direct serving function called at the
server's batch size with the request tiled as the batcher pads it,
element for element.
"""

import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from mixstage_tpu_torch.cli import export as cli_export
from mixstage_tpu_torch.cli import serve as cli_serve
from mixstage_tpu_torch.cli import train as cli_train
from mixstage_tpu_torch.config import (_typed_flag_names, config_from_dict,
                                       get_args_perm)
from mixstage_tpu_torch.data.synthetic import (append_log_mel_400,
                                               make_synthetic_dataset)
from mixstage_tpu_torch.export import load_serving
from mixstage_tpu_torch.serve import (build_serving_fn,
                                      build_waveform_serving_fn)
from mixstage_tpu_torch.serving import PoseClient
from mixstage_tpu_torch.streaming import session_over_serving_fn
from mixstage_tpu_torch.train.trainer import Trainer

SUB = ["exp", "cpk", "speaker", "model", "note"]
SPEAKERS = '["oliver", "maher"]'
BATCH, FEATS = 4, 96


def args_of(argv):
    """A ``Config`` as ``argparse_n_loop`` hands it to a CLI's loop, with
    the typed flags that survive the checkpoint's args."""
    _, perms = get_args_perm(argv)
    cfg = config_from_dict(perms[0])
    cfg.typed_flags = _typed_flag_names(argv)
    return cfg


def train_argv(data, save, *extra):
    return ["-path2data", data, "-speaker", SPEAKERS, "-batch_size",
            str(BATCH), "-num_epochs", "1", "-window_hop", "5", "-exp", "1",
            "-num_iters", "2", "-debug", "2", "-model",
            "JointLateClusterSoftStyle4_G", "-gan", "1", "-loss", "L1Loss",
            "-num_clusters", "2", "-modelKwargs", '{"in_channels": 64}',
            "-save_dir", save, *extra]


@pytest.fixture(scope="module")
def exps(tmp_path_factory):
    """Two trained experiments (128-mel and 64-mel ``log_mel_400``) and an
    artifact exported from the first."""
    root = tmp_path_factory.mktemp("serve_cli")
    data = str(root / "data")
    make_synthetic_dataset(data, ["oliver", "maher"], 3)
    append_log_mel_400(data, seed=1)
    weights = {}
    for name, extra in (("mel512", ()), ("mel400", (
            "-modalities", '["pose/data", "audio/log_mel_400"]'))):
        save = str(root / name)
        cli_train.loop(args_of(train_argv(data, save, *extra)), 0,
                       device="cpu")
        weights[name] = str(next((root / name).glob("*_weights.p")))
    art = str(root / "artifact")
    cli_export.loop(args_of(["-load", weights["mel512"], "-path2data", data,
                             "-export_dir", art, "-export_variants", "xla"]),
                    0, device="cpu")
    return data, weights, art


def serve(argv):
    server, batchers = cli_serve.build(args_of(["-serve_port", "0", *argv]),
                                       device="cpu")
    client = PoseClient(f"http://127.0.0.1:{server.server_address[1]}",
                        timeout_s=120)
    return server, batchers, client


def stop(server, batchers):
    server.shutdown()
    server.server_close()
    for b in batchers:
        b.close()


def restored(data, weights):
    return Trainer(args_of(["-load", weights, "-path2data", data]), SUB,
                   {"window_hop": 0, "render": 0}, device="cpu")


def tiled(fn, a, sty):
    """``fn`` on one request, run as the batcher runs it: tiled to the
    server's batch."""
    out = fn(np.repeat(a[None], BATCH, axis=0),
             np.repeat(np.asarray(sty)[None], BATCH, axis=0))
    return np.asarray(out[0].cpu() if torch.is_tensor(out) else out[0])


def check_requests(client, fn, mel, frames=(64, 100)):
    """JSON and npz ``/v1/pose`` requests and a 150-frame stream against
    ``fn`` called directly; returns the number of requests."""
    rng = np.random.default_rng(7)
    onehot = np.eye(2, dtype=np.float32)
    soft = np.array([0.3, 0.7], np.float32)
    n = 0
    for kind, t, sty in (("json", frames[0], 1), ("npz", frames[-1], soft)):
        a = rng.normal(size=(t, mel)).astype(np.float32)
        got = (client.pose if kind == "npz" else client.pose_json)(
            a, style=sty)
        bucket = 64 if t <= 64 else 128
        padded = np.concatenate([a, np.repeat(a[-1:], bucket - t, 0)])
        rows = onehot[sty] if np.ndim(sty) == 0 else sty
        np.testing.assert_array_equal(got, tiled(fn, padded, rows)[:t])
        n += 1
    x = rng.normal(size=(150, mel)).astype(np.float32)
    stream = client.stream(style=1, hop=32)
    parts = [stream.feed(x[i:i + 40]) for i in range(0, 150, 40)]
    parts.append(stream.finish())
    got = np.concatenate([p for p in parts if p.size])
    sess = session_over_serving_fn(lambda a, s: tiled(fn, a[0], s[0])[None],
                                   onehot[1], hop=32)
    want = np.concatenate([p for p in (sess.feed(x), sess.finish())
                           if p.size])
    np.testing.assert_array_equal(got, want)
    return n


_CASES = {  # resolve_partition's cases (tests/test_serving.py:1018)
    "default_dp": (None, 8, 32), "dp_ragged": ("batch", 8, 30),
    "time": ("time", 8, 30), "expert": ("expert", 8, 30),
    "one_device": ("time", 1, 32), "empty": ("", 8, 32)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_resolve_partition_matches_jax(case):
    from mixstage_tpu.cli.serve import resolve_partition as jax_resolve

    assert cli_serve.resolve_partition(*_CASES[case]) == \
        jax_resolve(*_CASES[case])


def test_resolve_partition_refuses_typos_and_meshes(exps):
    """A typo raises on any device count; ``build`` serves the layout that
    ``resolve_partition`` resolves over ``-num_devices`` devices (here
    ``["cpu"] * 2``): batch, time and expert across the devices, a batch
    that does not divide them on one; each serving function's pose equals
    the single-device one on the restored model."""
    for n_dev in (1, 8):
        with pytest.raises(ValueError, match="unknown -serve_partition"):
            cli_serve.resolve_partition("exprt", n_dev, 32)
    data, weights, _ = exps
    direct = build_serving_fn(restored(data, weights["mel512"]).state.gen,
                              device="cpu")
    audio = np.random.default_rng(0).normal(size=(BATCH, 64, 128)) \
        .astype(np.float32)
    for partition, n_dev, want in (("batch", 2, "batch"),
                                   ("time", 2, "time"),
                                   ("expert", 2, "expert"),
                                   ("batch", 3, None)):
        server, batchers = cli_serve.build(args_of([
            "-serve_port", "0", "-load", weights["mel512"], "-path2data",
            data, "-serve_partition", partition, "-num_devices",
            str(n_dev)]), device="cpu")
        try:
            fn = batchers[0].serve_fn
            assert fn.partition == (want or "batch")
            assert (fn.devices is None) == (want is None)
            if want is not None:
                assert [d.type for d in fn.devices] == ["cpu"] * n_dev
            styles = np.arange(BATCH) % 2
            np.testing.assert_allclose(fn(audio, styles),
                                       direct(audio, styles), rtol=0,
                                       atol=1e-5)
        finally:
            stop(server, batchers)


def test_peek_batches_and_calibration_match_jax(tmp_path):
    """The same processed batches across train/dev/test, and the same
    pooled calibration windows, as the JAX trainer on one synthetic PATS
    (the JAX trainer writes the ZNorm and k-means caches first; the port
    reads them, as ``test_torch_port_trainer.py`` does)."""
    from mixstage_tpu.cli.serve import _calib_windows as jax_calib
    from mixstage_tpu.config import config_from_dict as jax_cfg
    from mixstage_tpu.train.trainer import Trainer as JaxTrainer

    data = make_synthetic_dataset(str(tmp_path / "data"),
                                  ["oliver", "maher"], 3)
    base = dict(path2data=data, speaker=["oliver", "maher"], batch_size=4,
                window_hop=5, model="JointLateClusterSoftStyle4_G", gan=1,
                loss="L1Loss", num_clusters=2,
                modelKwargs={"in_channels": 64})
    jt = JaxTrainer(jax_cfg(dict(base, save_dir=str(tmp_path / "j"))), SUB,
                    {})
    pt = Trainer(config_from_dict(dict(base, save_dir=str(tmp_path / "p"))),
                 SUB, {}, device="cpu")
    # 40 windows of 8: more than the train split holds, so dev and test
    # are drawn too
    want = jt.peek_batches(40, batch_size=8)
    got = pt.peek_batches(40, batch_size=8)
    assert len(got) == len(want) > len(list(pt.data_train.iter_all(8)))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            for a, b in zip(g[k] if k == "x" else (g[k],),
                            w[k] if k == "x" else (w[k],)):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)
    for k, v in pt._peek_batch().items():
        np.testing.assert_array_equal(v if k != "x" else v[0],
                                      np.asarray(jt._peek_batch()[k] if
                                                 k != "x" else
                                                 jt._peek_batch()[k][0]))
    for n in (1, 3):
        for a, b in zip(cli_serve._calib_windows(pt, n), jax_calib(jt, n)):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_serve_load_over_http(exps, int8):
    """``cli.serve -load`` (f32, and ``-serve_int8 1`` calibrated on three
    pooled windows): HTTP poses equal the direct serving function built
    on the restored model at the server's batch size."""
    data, weights, _ = exps
    extra = ["-serve_int8", "1", "-serve_calib_batches", "3"] if int8 else []
    server, batchers, client = serve(["-load", weights["mel512"],
                                      "-path2data", data, *extra])
    try:
        fn = batchers[0].serve_fn
        assert fn.quantize_int8 == int8 and not fn.use_kernel
        assert len(batchers) == 1            # no waveform endpoint at 128
        tr = restored(data, weights["mel512"])
        kw = ({"quantize_int8": True,
               "calib": cli_serve._calib_windows(tr, 3)} if int8 else {})
        direct = build_serving_fn(tr.state.gen, device="cpu", **kw)
        n = check_requests(client, direct, 128)
        health, stats = client.health(), client.stats()
        assert health == {"ok": True, "backend": "cpu", "batch_size": BATCH}
        assert stats["requests"] >= n
        with pytest.raises(Exception, match="404"):
            client.pose_from_waveform(np.zeros(80000, np.float32))
    finally:
        stop(server, batchers)


def test_serve_waveform_endpoint(exps):
    """A model on ``audio/log_mel_400`` gets ``/v1/pose_from_waveform``:
    its pose equals the direct waveform serving function."""
    data, weights, _ = exps
    server, batchers, client = serve(["-load", weights["mel400"],
                                      "-path2data", data])
    try:
        assert len(batchers) == 2
        tr = restored(data, weights["mel400"])
        wav_fn = build_waveform_serving_fn(tr.state.gen, device="cpu")
        wav = (0.1 * np.random.default_rng(8).normal(
            size=wav_fn.n_samples + 500)).astype(np.float32)
        got = client.pose_from_waveform(wav, style=0)
        np.testing.assert_array_equal(
            got, tiled(wav_fn, wav, np.eye(2, dtype=np.float32)[0]))
        check_requests(client, build_serving_fn(tr.state.gen, device="cpu"),
                       64)
    finally:
        stop(server, batchers)


def test_serve_export_dir_over_http(exps):
    """``cli.export`` → ``cli.serve -export_dir`` with no checkpoint and no
    data: requests of the artifact's frame count equal ``load_serving``'s
    program at its static batch; another length is refused (HTTP 400)."""
    _, _, art = exps
    server, batchers, client = serve(["-export_dir", art])
    try:
        fn = load_serving(art, device="cpu")
        assert fn.variant == "plain" and fn.static_batch == BATCH
        assert batchers[0].input_shape == (64, 128)
        check_requests(client, fn, 128, frames=(64,))
        with pytest.raises(Exception, match="400"):
            client.pose(np.zeros((100, 128), np.float32))
    finally:
        stop(server, batchers)


def test_export_cli_refuses_kernel_without_a_card(exps, tmp_path):
    data, weights, _ = exps
    for variants, err in (("plain,kernel", "on the card"),
                          ("plain,tpu", "unknown serving variant")):
        with pytest.raises(ValueError, match=err):
            cli_export.loop(args_of([
                "-load", weights["mel512"], "-path2data", data,
                "-export_dir", str(tmp_path), "-export_variants",
                variants]), 0, device="cpu")
