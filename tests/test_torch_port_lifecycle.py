"""The port's train → checkpoint → restore → sample lifecycle through its
CLIs, on the CPU: the files an experiment writes, the checkpoint the
sampler restores, a sampled interval against a direct eval step,
``-fused_decoder 1`` against 0, the k-step loop, ``-dtype bfloat16``,
SIGTERM → exit 75 → resume, every flag the port refuses, and the flags
ported since (``Speech2Gesture_G``, float64, noise and dropout, SGD with
momentum and the joint D, a bf16 Adam ``mu``) run end to end.

The CLIs run on the card; here ``cli.train.loop`` / ``cli.sample.loop``
get ``device="cpu"`` from Python.  Sizes as in
``test_torch_port_trainer.py``: 2 speakers, 2 clusters, ``in_channels``
64, batch 4, ``debug`` 2.

``-fused_decoder 1`` against 0 is held to the fused G step's tolerances
(``PERF.md`` §2) carried over the epoch: per-step losses at rtol 1e-4,
params within steps × 2·lr, BN statistics within 1e-4 of scale, and G's
Adam mu per module within 3e-3 relative Frobenius.
"""

import json
import os
import signal
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from _torch_port_memory import release_memory  # noqa: F401
from mixstage_tpu_torch.bookkeeping import BookKeeper, optim_of, weights_of
from mixstage_tpu_torch.cli import sample as cli_sample
from mixstage_tpu_torch.cli import train as cli_train
from mixstage_tpu_torch.config import config_from_dict
from mixstage_tpu_torch.data.dataset import DataLoader
from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset
from mixstage_tpu_torch.train.trainer import Trainer

SUB = ["exp", "cpk", "speaker", "model", "note"]
LR = 1e-4
# the PREFIX_* files of a train → sample run (the verify recipe's list)
PREFIX_FILES = {"args.args", "res.json", "weights.p", "log.log", "name.name",
                "metrics.json", "cummMetrics.json", "histogram.json",
                "style.pkl"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pats_lifecycle"))
    make_synthetic_dataset(path, ["oliver", "maher"], 3)
    return path


def cfg(data, save_dir, **kw):
    d = dict(path2data=data, speaker=["oliver", "maher"], batch_size=4,
             num_epochs=1, window_hop=5, exp=1, num_iters=2, debug=2,
             model="JointLateClusterSoftStyle4_G", gan=1, loss="L1Loss",
             num_clusters=2, modelKwargs={"in_channels": 64}, lr=LR,
             save_dir=str(save_dir))
    d.update(kw)
    return config_from_dict(d)


def _prefix_files(save_dir, prefix):
    return {f[len(prefix) + 1:] for f in os.listdir(save_dir)
            if f.startswith(prefix + "_")}


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """``cli.train``'s loop: train, then sample from the best weights."""
    save = tmp_path_factory.mktemp("save_cli")
    captured = {}
    orig = Trainer.train

    def train_and_keep(self, exp_num):
        orig(self, exp_num)
        captured["trainer"] = self
    Trainer.train = train_and_keep
    try:
        cli_train.loop(cfg(data, save), 0, device="cpu")
    finally:
        Trainer.train = orig
    return save, captured["trainer"]


def test_cli_train_writes_the_experiment_files(trained):
    save, tr = trained
    prefix = tr.book.name.prefix
    assert PREFIX_FILES <= _prefix_files(save, prefix)
    exp_dir = Path(save) / prefix
    for kp in ("keypoints", "keypoints_style"):
        files = sorted((exp_dir / kp).rglob("*.h5"))
        assert len(files) == 6, kp                 # every interval
        with h5py.File(files[0]) as h5:
            assert h5["pose/data"].shape[1:] == (2, 52)
    with open(Path(save) / f"{prefix}_res.json") as f:
        res = json.load(f)
    for key in ("train", "dev", "test", "train_steps_per_sec"):
        assert np.isfinite(res[key]).all(), key


def test_cli_sample_restores_the_checkpoint(trained, data):
    """``cli.sample`` from ``PREFIX_weights.p``: the restored weights are
    the checkpoint's bit for bit, and a sampled interval's keypoints equal
    a direct eval step on the same batch."""
    save, tr = trained
    weights = tr.book.name("weights", "p", str(save))
    ckpt = torch.load(weights, weights_only=True)
    captured = {}
    orig = Trainer.sample

    def sample_and_keep(self, exp_num):
        orig(self, exp_num)
        captured["trainer"] = self
    Trainer.sample = sample_and_keep
    try:
        cli_sample.loop(config_from_dict(dict(load=weights, path2data=data)),
                        0, device="cpu")
    finally:
        Trainer.sample = orig
    st = captured["trainer"]
    assert st.args.window_hop == 0 and st.args.num_clusters == 2
    for m, sd in weights_of(st.state).items():
        for k, v in sd.items():
            assert torch.equal(v, ckpt[m][k]), (m, k)
    md = st.data.datasets["test"].datasets[0]
    batch = next(iter(DataLoader(md, batch_size=len(md))))
    sb, y_, ins = st.get_processed_batch(batch)
    pad = 1 << (len(md) - 1).bit_length()
    flat = {k: (tuple(np.concatenate([v, np.repeat(v[-1:], pad - len(v), 0)])
                      .reshape(1, -1, v.shape[-1]) for v in val)
                if k == "x" else
                np.concatenate([val, np.repeat(val[-1:], pad - len(val), 0)])
                .reshape(1, -1, *val.shape[2:]))
            for k, val in sb.items()}
    _, pose, _ = st.steps["eval"](st.state, flat, sample_flag=True)
    T = y_.shape[1]
    y_cap = pose.numpy().astype(np.float64).reshape(pad, T, -1)[:len(md)]
    st.metrics_reset()
    want = st.calculate_metrics(y_cap, y_, "same", insert=ins,
                                style=sb["style"])
    iid = batch["meta"]["interval_id"][0]
    path = (Path(st.dir_name) / "keypoints" / "test"
            / st.data.getSpeaker(iid) / f"{iid}.h5")
    with h5py.File(path) as h5:
        np.testing.assert_array_equal(h5["pose/data"][()], want)


def _mu_gaps(a, b):
    """G's Adam mu per module (``gen.unet``, ``psenc.stack``, ...): the
    relative Frobenius error of its moments taken together."""
    num, den = {}, {}
    oa, ob = optim_of(a)["g_opt"], optim_of(b)["g_opt"]
    for name, x, y in zip(oa["names"], oa["mu"], ob["mu"]):
        m = ".".join(name.split(".")[:2])
        num[m] = num.get(m, 0.0) + float(((x - y) ** 2).sum())
        den[m] = den.get(m, 0.0) + float((y ** 2).sum())
    return {m: np.sqrt(num[m] / max(den[m], 1e-30)) for m in num}


def test_fused_decoder_matches_unfused(data, tmp_path):
    runs = {}
    for fused in (0, 1):
        tr = Trainer(cfg(data, tmp_path / str(fused), fused_decoder=fused),
                     SUB, {}, device="cpu")
        assert tr.step_cfg.fused_decoder == bool(fused)
        log = []
        for kind in ("g", "d", "eval"):
            fn = tr.steps[kind]

            def rec(*a, _fn=fn, _kind=kind, **kw):
                out = _fn(*a, **kw)
                log.append((_kind, out[0] if _kind == "eval" else out[1]))
                return out
            tr.steps[kind] = rec
        tr.train(1)
        runs[fused] = (tr, log)
    (t0, l0), (t1, l1) = runs[0], runs[1]
    assert [k for k, _ in l0] == [k for k, _ in l1]
    assert "g" in [k for k, _ in l0]
    for (kind, a), (_, b) in zip(l0, l1):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=kind)
    steps = t0.state.step
    w0, w1 = weights_of(t0.state), weights_of(t1.state)
    for m in w0:
        for k, v in w0[m].items():
            if k.endswith(("running_mean", "running_var")):
                scale = float(v.abs().max())
                if k.endswith("running_mean"):
                    scale = max(scale, float(w0[m][k.replace(
                        "running_mean", "running_var")].max().sqrt()))
                assert float((w1[m][k] - v).abs().max()) <= 1e-4 * scale, k
            elif v.is_floating_point():
                assert float((w1[m][k] - v).abs().max()) <= \
                    steps * 2 * LR + 1e-6, (m, k)
    gaps = _mu_gaps(t1.state, t0.state)
    assert max(gaps.values()) <= 3e-3, gaps


def test_k_step_loop_trains(data, tmp_path):
    """``-scan_steps 2`` after the curriculum: the k-step driver takes the
    batches two at a time, its losses finite."""
    tr = Trainer(cfg(data, tmp_path, scan_steps=2, debug=3), SUB, {},
                 device="cpu")
    tr.state.curriculum_step = tr.step_cfg.curriculum_iters
    calls = []
    scan = tr._scan_step
    tr._scan_step = lambda *a: calls.append(1) or scan(*a)
    loss, metrics, _ = tr.train_loop(tr.data_train, "train")
    assert len(calls) == 2 and tr.state.step == 4
    assert np.isfinite(loss) and metrics["train_steps_per_sec"] > 0


def test_bfloat16_passes_through(data, tmp_path):
    tr = Trainer(cfg(data, tmp_path, dtype="bfloat16", debug=1), SUB, {},
                 device="cpu")
    assert tr.step_cfg.dtype == torch.bfloat16
    assert tr.factory.cfg.dtype == torch.bfloat16
    loss, _, _ = tr.train_loop(tr.data_train, "train")
    assert np.isfinite(loss) and tr.state.step == 2


def test_profile_dir_writes_a_chrome_trace(data, tmp_path):
    """``-profile_dir``: the first train epoch under ``torch.profiler``,
    one Chrome trace whose events include the steps' ops."""
    prof = tmp_path / "prof"
    tr = Trainer(cfg(data, tmp_path, debug=1, profile_dir=str(prof)), SUB,
                 {}, device="cpu")
    tr.train_loop(tr.data_train, "train", epoch=0)
    tr.train_loop(tr.data_train, "train", epoch=1)     # not traced
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def test_sigterm_exits_75_and_resumes(data, tmp_path, monkeypatch):
    """A real SIGTERM at the end of epoch 0: ``cli.train`` snapshots the
    live state and exits with 75; the same command resumes at epoch 1 from
    the snapshot, finishes and clears it."""
    c = dict(num_epochs=2, save_optim=1)
    orig = BookKeeper.print_res
    sent = []

    def print_then_term(self, *a, **kw):
        orig(self, *a, **kw)
        if not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
    monkeypatch.setattr(BookKeeper, "print_res", print_then_term)
    with pytest.raises(SystemExit) as e:
        cli_train.loop(cfg(data, tmp_path, **c), 0, device="cpu")
    assert e.value.code == 75
    book = BookKeeper(cfg(data, tmp_path, **c), SUB)
    p_state, p_meta = book._preempt_paths()
    with open(p_meta) as f:
        meta = json.load(f)
    assert os.path.exists(p_state)
    assert meta["epoch_next"] == 1 and meta["step"] == 3
    resumed = []
    orig_resume = Trainer._maybe_resume_preempt

    def resume(self):
        epoch = orig_resume(self)
        resumed.append((epoch, self.state.step))
        return epoch
    monkeypatch.setattr(Trainer, "_maybe_resume_preempt", resume)
    cli_train.loop(cfg(data, tmp_path, **c), 0, device="cpu")
    assert resumed[0] == (1, 3)
    assert not os.path.exists(p_state) and not os.path.exists(p_meta)
    with open(book.name("res", "json", str(tmp_path))) as f:
        assert len(json.load(f)["train"]) >= 1


# The flags the port still refuses, and those refused before that build
# their trainer now.  float64, the other optimizers, dropout, noise, the
# weighted GAN, the joint D, the non-GAN trainer and Speech2Gesture_G run
# in test_torch_port_lifecycle_rest.py and test_torch_port_simple_models.py;
# text, -pos, -filler and -optim_separate are held to the JAX trainer in
# test_torch_port_text_trainer.py, -render's output to the JAX package's in
# test_torch_port_render.py.
REFUSED = {
    "num_devices": dict(num_devices=2),
    "render": dict(render=1),
    "pos": dict(pos=1),
    "disentangle": dict(model="JointLateClusterSoftStyleDisentangle_G"),
    "rmsprop_centered": dict(optim="RMSprop",
                             optimKwargs={"centered": True}),
    "text": dict(modalities=["pose/data", "audio/log_mel_512", "text/w2v"],
                 fs_new=[15, 15, 15]),
    "text_only": dict(modalities=["pose/data", "text/bert"]),
    "filler": dict(filler=1),
    "audio_lowering": dict(audio_lowering="tpu"),
    "optim_separate": dict(optim_separate=1e-5),
    "orbax": dict(ckpt_backend="orbax"),
}


def _text_encoder_width(tr):
    return tr.state.gen.text_encoder.stack.conv0.conv.weight.shape[1]


# what each flag ported since sets up in the trainer it builds
PORTED = {
    # no text/pos stream is loaded: the k-means labels, as in JAX
    "pos": lambda tr: tr.args.pos == 1 and tr.cluster is not None,
    "text": lambda tr: (tr.step_cfg.text_channels == 300
                        and _text_encoder_width(tr) == 300),
    "text_only": lambda tr: (tr.step_cfg.text_channels == 768
                             and _text_encoder_width(tr) == 768
                             and not hasattr(tr.state.gen, "audio_encoder")),
    "filler": lambda tr: tr.data.filler == 1 and tr.data.stopwords is not None,
    "optim_separate": lambda tr: type(tr.state.g_opt).__name__ ==
    "SeparateTextOptimizer" and tr.state.g_opt.groups["text"].lr == 1e-5,
    # the trainer renders after sampling (test_torch_port_render.py)
    "render": lambda tr: tr.args.render == 1 and callable(tr.render_samples),
    # centered, bias-corrected RMSprop (test_torch_port_rmsprop_centered.py)
    "rmsprop_centered": lambda tr: tr.state.g_opt.centered
    and tr.state.g_opt.SLOTS == ("mu", "nu"),
    # orbax directories (test_torch_port_orbax.py)
    "orbax": lambda tr: tr.book._orbax_path().endswith("_weights.orbax"),
    # JAX's native convs (test_torch_port_train_steps.py)
    "audio_lowering": lambda tr: tr.step_cfg.audio_lowering == "tpu",
}


@pytest.fixture(scope="module")
def text_data(tmp_path_factory):
    """The synthetic data with ``text/w2v`` and a seeded ``text/bert``."""
    path = str(tmp_path_factory.mktemp("pats_text"))
    make_synthetic_dataset(path, ["oliver", "maher"], 3, with_text=True)
    rng = np.random.default_rng(0)
    for f in sorted(Path(path, "processed").glob("*/*.h5")):
        with h5py.File(f, "a") as h5:
            h5["text/bert"] = rng.normal(size=(h5["pose/data"].shape[0],
                                               768))
    return path


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_flags_raise(data, text_data, tmp_path, name):
    """A refused flag raises naming its ROADMAP item (an unregistered
    Disentangle generator with the JAX package's message); a flag ported
    since builds its trainer.  ``-num_devices 2`` runs under a process
    group of two ranks: a single process asking for it raises
    ``ValueError`` naming the launch (``torchrun``)."""
    if name == "num_devices":
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            Trainer(cfg(data, tmp_path, **REFUSED[name]), SUB, {},
                    device="cpu")
        return
    if name in PORTED:
        path = text_data if name.startswith("text") else data
        tr = Trainer(cfg(path, tmp_path, **REFUSED[name]), SUB, {},
                     device="cpu")
        assert PORTED[name](tr), name
        return
    with pytest.raises(NotImplementedError) as e:
        Trainer(cfg(data, tmp_path, **REFUSED[name]), SUB, {}, device="cpu")
    if name == "disentangle":
        assert "upstream-incomplete" in str(e.value), str(e.value)
    else:
        assert "ROADMAP queue 1" in str(e.value), str(e.value)


def test_pretrained_classifier_weights_raise(data, tmp_path):
    """``-pretrained_model_weights`` naming a file that exists must be a
    checkpoint of the IS metric's ``StyleClassifier_G``, the port's or the
    JAX package's (``test_torch_port_jax_checkpoint.py``): a file of
    neither format raises ``ValueError``, and so does a directory that is
    not an orbax checkpoint (no ``_METADATA``); a path that does not exist
    is ignored, as the JAX package ignores it."""
    missing = tmp_path / "absent.p"
    tr = Trainer(cfg(data, tmp_path / "a", pretrained_model_weights=str(
        missing)), SUB, {}, device="cpu")
    assert tr.IS is None
    missing.write_bytes(b"x")
    with pytest.raises(ValueError, match="neither a torch file nor"):
        Trainer(cfg(data, tmp_path / "b",
                    pretrained_model_weights=str(missing)), SUB, {},
                device="cpu")
    orbax = tmp_path / "clf_weights.orbax"
    orbax.mkdir()
    with pytest.raises(ValueError, match="_METADATA"):
        Trainer(cfg(data, tmp_path / "c",
                    pretrained_model_weights=str(orbax)), SUB, {},
                device="cpu")


def test_entry_points_run_on_the_card_by_default(data, tmp_path):
    """Without a device the trainer asks for the card, and raises where
    there is none: no quiet fall-back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg(data, tmp_path), SUB, {})


# The model families and flags beyond the flagship GAN, each through
# ``cli.train``'s loop (train, then the sampling pass from the best
# weights): the config the trainer builds, the model family's modules in
# the checkpoint, finite losses in every split.
NEW_FLAGS = {
    "speech2gesture": (dict(model="Speech2Gesture_G", num_clusters=None,
                            modelKwargs={"in_channels": 32}),
                       dict(model="Speech2Gesture_G"), ["disc", "gen"]),
    "float64": (dict(dtype="float64", gan=0),
                dict(dtype=torch.float64, gan=False), ["gen", "psenc"]),
    "noise_dropout": (dict(noise=0.01, modelKwargs={"in_channels": 64,
                                                    "p": 0.1}),
                      dict(noise=0.01, p_dropout=0.1),
                      ["disc", "gen", "psenc"]),
    "sgd_momentum": (dict(optim="SGD", optimKwargs={"momentum": 0.9},
                          joint=1),
                     dict(optim="SGD", joint=True), ["disc", "gen", "psenc"]),
    "adam_mu_bf16": (dict(optim_mu_dtype="bfloat16", fused_decoder=1),
                     dict(optim_mu_dtype="bfloat16", fused_decoder=True),
                     ["disc", "gen", "psenc"]),
}


@pytest.mark.parametrize("name", sorted(NEW_FLAGS))
def test_new_flags_run_end_to_end(data, tmp_path, name):
    flags, want, modules = NEW_FLAGS[name]
    seen = []
    orig = Trainer.train

    def keep(self, exp_num):
        orig(self, exp_num)
        seen.append(self)
    Trainer.train = keep
    try:
        cli_train.loop(cfg(data, tmp_path, **flags), 0, device="cpu")
    finally:
        Trainer.train = orig
    tr = seen[0]
    for k, v in want.items():
        assert getattr(tr.step_cfg, k) == v, k
    weights = torch.load(tr.book.name("weights", "p", str(tmp_path)),
                         weights_only=True)
    assert sorted(weights) == modules
    with open(tr.book.name("res", "json", str(tmp_path))) as f:
        res = json.load(f)
    for key in ("train", "dev", "test"):
        assert np.isfinite(res[key]).all(), (key, res[key])
    assert tr.state.step > 0
