"""The port's data preparation against the JAX package's, on the CPU:
``resample_audio``, ``log_mel_512``, ``log_mel_400`` at any rate and
``silence_vad`` (the energy VAD: webrtcvad is absent); ``Audio.preprocess``
with ``load_waveform`` patched in both packages (no ``soundfile`` here);
the OpenCV-YAML reader of the Berkeley confidence branch against JAX's
PyYAML reader; ``Skeleton2D``'s ``data``, ``normalize`` and ``confidence``
through ``cli.preprocess``; ``cli.delete_keys``.

Every output is compared bit for bit: the same h5 keys, the same arrays.
Raw trees are the synthetic writers' (``with_raw_keypoints``: per-frame
txt matrices and OpenPose YAML dumps) at 2 s intervals.
"""

import shutil
import wave
from pathlib import Path

import h5py
import joblib
import numpy as np
import pytest


from mixstage_tpu.cli import delete_keys as jdel
from mixstage_tpu.cli import preprocess as jpre
from mixstage_tpu.config import argparse_n_loop as jax_loop
from mixstage_tpu.data import audio as ja
from mixstage_tpu.data import skeleton as jsk
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu_torch.cli import delete_keys as pdel
from mixstage_tpu_torch.cli import preprocess as ppre
from mixstage_tpu_torch.data import audio as pa
from mixstage_tpu_torch.data import skeleton as psk

SPEAKERS = ["oliver", "maher"]


def _tone(seed, n, sr):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * (200 + 300 * rng.random()) * t)
            * (t % 0.7 < 0.4) + 0.01 * rng.normal(size=n))


@pytest.mark.parametrize("sr", [16000, 22050, 44100])
def test_dsp_equals_jax(sr):
    y = _tone(sr, int(sr * 1.7), sr)
    np.testing.assert_array_equal(pa.resample_audio(y, sr, 16000),
                                  ja.resample_audio(y, sr, 16000))
    np.testing.assert_array_equal(pa.log_mel_512(y, sr), ja.log_mel_512(y, sr))
    np.testing.assert_array_equal(pa.log_mel_400(y, sr), ja.log_mel_400(y, sr))
    got, want = pa.silence_vad(y, sr), ja.silence_vad(y, sr)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and 0 < got[::2].sum() < len(got) // 2
    np.testing.assert_array_equal(
        pa.mel_filterbank(sr, 2048, 128, 0.0, sr / 2.0, norm="slaney"),
        ja.mel_filterbank(sr, 2048, 128, 0.0, sr / 2.0, norm="slaney"))


def _h5_tree(root: Path):
    """{file: {dataset key: array}} of every h5 file under ``root``."""
    out = {}
    for f in sorted(root.rglob("*.h5")):
        with h5py.File(f) as h5:
            keys = []
            h5.visit(lambda k: keys.append(k)
                     if isinstance(h5[k], h5py.Dataset) else None)
            out[f.relative_to(root).as_posix()] = {k: h5[k][()]
                                                   for k in keys}
    return out


def _assert_same_h5(a: Path, b: Path):
    want, got = _h5_tree(a), _h5_tree(b)
    assert sorted(got) == sorted(want) and want
    for f, keys in want.items():
        assert sorted(got[f]) == sorted(keys), f
        for k, v in keys.items():
            assert got[f][k].dtype == v.dtype, (f, k)
            np.testing.assert_array_equal(got[f][k], v, err_msg=f"{f} {k}")


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A raw tree: keypoint txt and YAML dumps, and an mp3 name per
    interval (its waveform made by ``_fake_waveform``), all but the last
    interval of each speaker (the missing-interval ledger's case)."""
    root = tmp_path_factory.mktemp("raw")
    make_synthetic_dataset(str(root), SPEAKERS, 3, interval_seconds=2.0,
                           with_raw_keypoints=True)
    shutil.rmtree(root / "processed")          # the preprocessing's output
    for sp in SPEAKERS:
        ids = sorted(p.stem for p in (root / sp / "keypoints_simple")
                     .rglob("*.txt"))          # to check the tree exists
        assert ids
        crop = root / "raw" / f"{sp}_cropped"
        crop.mkdir(parents=True)
    for i, iid in enumerate(["100000", "100001", "100003", "100004"]):
        sp = SPEAKERS[i // 2]
        (root / "raw" / f"{sp}_cropped" / f"{sp}vid00_{iid}.mp3").write_bytes(
            b"not decoded here")
    return root


def _fake_waveform(self, filename):
    """The waveform of an mp3 name: 1.3 s at 22.05 kHz seeded by its
    interval id (no decoder on this machine)."""
    iid = int(Path(filename).stem.split("_")[-1])
    return _tone(iid, 28665, 22050), 22050


def _copy(raw, dst):
    shutil.copytree(raw, dst)
    return str(dst)


def test_audio_preprocess_equals_jax(raw, tmp_path, monkeypatch):
    """``Audio.preprocess`` (``cli.preprocess -modalities '["audio"]'``):
    each interval's mp3 through log_mel_512, log_mel_400 and silence into
    its h5 file, the interval without an mp3 into the missing ledger, as
    the JAX package writes them (its joblib fan-out on threads, so the
    patched reader reaches it)."""
    monkeypatch.setattr(ja.Audio, "load_waveform", _fake_waveform)
    monkeypatch.setattr(pa.Audio, "load_waveform", _fake_waveform)
    argv = ["-modalities", '["audio"]', "-speaker", '["oliver", "maher"]',
            "-preprocess_methods", '["log_mel_512", "log_mel_400", "silence"]']
    roots = {}
    for name, loop in (("jax", lambda a: jax_loop(jpre.loop, a)),
                       ("port", ppre.main)):
        path = _copy(raw, tmp_path / name)
        roots[name] = Path(path)
        with joblib.parallel_backend("threading"):
            loop([*argv, "-path2data", path, "-path2outdata", path])
    _assert_same_h5(roots["jax"], roots["port"])
    with h5py.File(roots["port"] / "processed" / "oliver" / "100000.h5") as h5:
        assert h5["audio/log_mel_512"].shape[1] == 128
        assert h5["audio/log_mel_400"].shape[1] == 64
    with h5py.File(roots["port"] / "missing_intervals.h5") as h5:
        assert sorted(x.decode() for x in h5["intervals"][()]) == [
            "100002", "100005"]


def test_load_waveform_needs_soundfile(tmp_path):
    """Without ``soundfile`` (as here) reading raw audio raises, naming
    the package; ``save_intervals`` records the interval as missing."""
    try:
        import soundfile  # noqa: F401
        pytest.skip("soundfile is installed")
    except ImportError:
        pass
    audio = pa.Audio(path2data=str(tmp_path), path2outdata=str(tmp_path))
    with pytest.raises(RuntimeError, match="soundfile"):
        audio.load_waveform(tmp_path / "x.mp3")
    assert audio.save_intervals("7", "oliver",
                                {"7": tmp_path / "x.mp3"}) == "7"


def _opencv_yaml(path, values, per_line=4, fmt="%.16e"):
    toks = [v if isinstance(v, str) else fmt % v for v in values]
    rows = [", ".join(toks[i:i + per_line])
            for i in range(0, len(toks), per_line)]
    path.write_text("%YAML:1.0\n---\npose_0: !!opencv-matrix\n"
                    f"   rows: 1\n   cols: {len(toks)}\n   dt: f\n"
                    "   data: [ " + ",\n       ".join(rows) + " ]\n")
    return str(path)


@pytest.mark.parametrize("case", ["wrapped", "one_line", "ints", "special"])
def test_yaml_reader_equals_pyyaml(tmp_path, case):
    """The port's OpenCV-YAML reader against JAX's (PyYAML after the 3-line
    directive block), on matrices as OpenCV writes them."""
    rng = np.random.default_rng(len(case))
    vals = list(rng.normal(size=75) * 300)
    kw = {}
    if case == "one_line":
        kw = dict(per_line=75, fmt="%.6f")
    elif case == "ints":
        vals = [str(int(v)) for v in vals]
    elif case == "special":
        vals[3], vals[10], vals[11] = ".nan", "-.inf", ".Inf"
    path = _opencv_yaml(tmp_path / "a_pose.yml", vals, **kw)
    got, want = psk.load_yaml_keypoints(path), jsk.load_yaml_keypoints(path)
    assert got.shape == want.shape == (25, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pose_preprocess_equals_jax(raw, tmp_path):
    """``cli.preprocess -modalities '["pose"]'``: ``data`` (the interval's
    txt frames, root-relative), then ``normalize`` (shoulder length 167)
    and ``confidence`` (the OpenPose YAML dumps' confidence column, the
    Berkeley branch), then ``cli.delete_keys`` of ``pose/normalize``; the
    JAX package's h5 files at each stage."""
    roots = {}
    for name, loop in (("jax", lambda a: jax_loop(jpre.loop, a)),
                       ("port", ppre.main)):
        path = _copy(raw, tmp_path / name)
        roots[name] = Path(path)
        for method in ("data", "normalize", "confidence"):
            loop(["-modalities", '["pose"]', "-speaker", '["all"]',
                  "-preprocess_methods", f'["{method}"]', "-path2data", path,
                  "-path2outdata", path])
    _assert_same_h5(roots["jax"], roots["port"])
    with h5py.File(roots["port"] / "processed" / "maher" / "100004.h5") as h5:
        assert h5["pose/data"].shape == (31, 104)
        assert h5["pose/normalize"].shape == (31, 104)
        conf = h5["pose/confidence"][()]
    assert conf.shape == (31, 104) and (conf >= 0).all() and (conf < 1).all()
    for name, loop in (("jax", lambda a: jax_loop(jdel.loop, a)),
                       ("port", pdel.main)):
        loop(["-modalities", '["pose"]', "-speaker", '["maher"]',
              "-preprocess_methods", '["normalize"]', "-path2data",
              str(roots[name]), "-path2outdata", str(roots[name])])
    _assert_same_h5(roots["jax"], roots["port"])
    with h5py.File(roots["port"] / "processed" / "maher" / "100004.h5") as h5:
        assert "pose/normalize" not in h5 and "pose/confidence" in h5
    with h5py.File(roots["port"] / "processed" / "oliver" / "100000.h5") as h5:
        assert "pose/normalize" in h5


def test_text_preprocessing_still_raises(raw, tmp_path):
    """Text preprocessing runs now (``test_torch_port_text_preprocess.py``
    holds it to the JAX package): on this tree, which has no transcripts
    and no ``text/meta``, both CLIs record every interval of the speaker
    missing and write no text stream.  What still raises is reading a
    pytables ``text/meta`` (``test_torch_port_text_data.py``)."""
    roots = {}
    for name, loop in (("jax", lambda a: jax_loop(jpre.loop, a)),
                       ("port", ppre.main)):
        path = _copy(raw, tmp_path / name)
        roots[name] = Path(path)
        for aligned in ("0", "1"):
            loop(["-modalities", '["text"]', "-speaker", '["oliver"]',
                  "-preprocess_methods", '["w2v"]', "-text_aligned",
                  aligned, "-path2data", path, "-path2outdata", path])
    _assert_same_h5(roots["jax"], roots["port"])
    tree = _h5_tree(roots["port"])
    assert not any(k.startswith("text/") for f in tree.values() for k in f)
    assert sorted(m.decode() for m in tree["missing_intervals.h5"][
        "intervals"]) == ["100000", "100001", "100002"]


def test_wav_round_trip_for_the_mux(tmp_path):
    """A wav that the render path's mux reads (``aviwriter.read_wav``)
    holds ``silence_vad``'s input: the port's DSP on it equals JAX's."""
    from mixstage_tpu_torch.animation.aviwriter import read_wav

    pcm = (_tone(3, 16000, 16000) * 20000).astype(np.int16)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    got, sr = read_wav(str(path))
    y = got.astype(np.float64) / 32768.0
    np.testing.assert_array_equal(pa.silence_vad(y, sr),
                                  ja.silence_vad(y, sr))
