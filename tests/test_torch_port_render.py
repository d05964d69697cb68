"""The port's rendering against the JAX package's, on the CPU: the
rasteriser, the GIF encoder, the AVI writer, ``animate`` (native and
matplotlib, captions, the audio mux with and without ffmpeg), the
per-cluster ``frames``, ``save_animation``, ``render_ground_truth``, the
HTML pages, ``cli.render`` and the trainer's ``-render``.

The two packages' rasterisers are the same C++ source.  The port builds it
with the JAX package's ``native/Makefile`` flags and ``-ffp-contract=off``:
GCC otherwise contracts ``a * b + c`` into one FMA where ``-march=native``
has FMA, and the library then rounds a few pixels' coverage differently
from its numpy plain version (``rasterize_plain``), one level in 255 at a
share of ~3e-5 of the pixels.  So:

* the port's library equals its numpy plain version frame for frame, and
  JAX's source built with the port's flags equals it too;
* JAX's library as its Makefile builds it, and JAX's numpy version, stay
  within one level of the port's at no more than ``CONTRACTION_SHARE``
  of the pixels;
* every file comparison with the JAX package (GIF, AVI, PNG, the
  ``cli.render`` tree) runs JAX's code on JAX's source built with the
  port's flags, and asks for the same bytes.

Poses are seeded random walks or the synthetic PATS intervals, clips of at
most 32 frames.
"""

import ctypes
import json
import os
import subprocess
import types
import wave
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest

from mixstage_tpu.animation import animation as janim
from mixstage_tpu.animation import aviwriter as javi
from mixstage_tpu.animation import raster as jr
from mixstage_tpu.cli import render as jrender
from mixstage_tpu.config import argparse_n_loop as jax_loop
from mixstage_tpu.config import config_from_dict as jax_cfg
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu.htmlgrid import snippets as jsnip
from mixstage_tpu.htmlgrid import to_html as jhtml
from mixstage_tpu_torch.animation import animation as panim
from mixstage_tpu_torch.animation import aviwriter as pavi
from mixstage_tpu_torch.animation import raster as pr
from mixstage_tpu_torch.cli import render as prender
from mixstage_tpu_torch.data.common import Table
from mixstage_tpu_torch.data.skeleton import PARENTS
from mixstage_tpu_torch.htmlgrid import snippets as psnip
from mixstage_tpu_torch.htmlgrid import to_html as phtml

CONTRACTION_SHARE = 1e-4      # measured: 2.8e-5 - 3.6e-5 on random walks
FPS = 15


def walk(seed, T=16, scale=25.0):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(size=(T, 2, 52)), 0) * scale
            + rng.normal(size=(1, 2, 52)) * 120)


@pytest.fixture(scope="module")
def same_flags(tmp_path_factory):
    """JAX's rasteriser source built with the port's flags, loaded by
    JAX's own ``raster.get_lib`` for the module's tests."""
    out = tmp_path_factory.mktemp("jax_raster") / "libraster.so"
    subprocess.run(["g++", *pr.CXX_FLAGS, "-o", str(out),
                    str(jr._NATIVE_DIR / "raster.cpp")], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jr, "_LIB_PATH", out)
    mp.setattr(jr, "_lib", None)
    mp.setattr(jr, "_tried", False)
    mp.setenv("MIXSTAGE_RENDER_BACKEND", "native")
    assert jr.get_lib() is not None
    yield
    mp.undo()


@pytest.fixture
def no_ffmpeg(monkeypatch):
    for mod in (janim, panim):
        monkeypatch.setattr(mod, "have_ffmpeg", lambda: False)


@pytest.mark.parametrize("panel, panels", [(128, 1), (160, 1), (480, 2)])
def test_library_equals_its_plain_version(panel, panels):
    ys = [walk(s) for s in range(panels)]
    got = pr.rasterize(ys, PARENTS, panel=panel)
    assert got.shape == (16, panel, panel * panels, 3)
    assert np.array_equal(got, pr.rasterize_plain(ys, PARENTS, panel=panel))
    assert (got < 250).any(-1).mean() > 1e-3          # bones were drawn


@pytest.fixture(scope="module")
def makefile_build(tmp_path_factory):
    """JAX's rasteriser as its Makefile builds it (no -ffp-contract)."""
    out = tmp_path_factory.mktemp("jax_makefile") / "libraster.so"
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared",
                    "-std=c++17", "-pthread", "-o", str(out),
                    str(jr._NATIVE_DIR / "raster.cpp")], check=True)
    return out


def test_library_against_jax_library_and_numpy(same_flags, makefile_build):
    """The same source with the same flags: equal frames.  JAX's numpy
    version and JAX's Makefile build (FMA contraction): within one level,
    at few pixels."""
    ys = [walk(3, T=32), walk(4, T=32)]
    got = pr.rasterize(ys, PARENTS)
    assert np.array_equal(got, jr.rasterize(ys, PARENTS))  # same flags
    stack = np.ascontiguousarray(np.stack(ys), np.float32)
    jnp_frames = jr._rasterize_numpy(
        stack, np.asarray(PARENTS, np.int32), jr.bone_colors(51),
        jr.bone_peak_widths(51), float(jr.MIN_W_PX), 480, 500.0)
    makefile = ctypes.CDLL(str(makefile_build))
    makefile.rasterize_poses.argtypes = pr.get_lib().rasterize_poses.argtypes
    mk = np.empty_like(got)
    makefile.rasterize_poses(
        stack, 2, 32, 52, np.asarray(PARENTS, np.int32),
        np.ascontiguousarray(jr.bone_colors(51)),
        np.ascontiguousarray(jr.bone_peak_widths(51), np.float32),
        ctypes.c_float(jr.MIN_W_PX), 480, ctypes.c_float(500.0), 4, mk)
    for other in (jnp_frames, mk):
        diff = (other != got).any(-1)
        assert np.abs(other.astype(int) - got).max() <= 1
        assert diff.mean() <= CONTRACTION_SHARE, diff.mean()


def palette_frames(frames):
    """``frames`` through the GIF palette (each colour's nearest entry)."""
    pal = pr.gif_palette().astype(np.int64)
    rgb = frames.reshape(-1, 3).astype(np.int64)
    keys = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    colors, inverse = np.unique(keys, return_inverse=True)
    nearest = pal[((np.stack([colors >> 16, (colors >> 8) & 255,
                              colors & 255], -1)[:, None, :] - pal) ** 2)
                  .sum(-1).argmin(-1)]
    return nearest[inverse.reshape(-1)].astype(np.uint8).reshape(
        frames.shape)


def test_gif_bytes_equal_jax(same_flags, tmp_path):
    """The library's GIF encoder (integer code) writes JAX's bytes, in one
    chunk or streamed; the port's reader and PIL decode it alike."""
    frames = pr.rasterize([walk(5, T=24)], PARENTS, panel=200)
    jr.write_gif(frames, str(tmp_path / "j.gif"), FPS)
    pr.write_gif(frames, str(tmp_path / "p.gif"), FPS)
    want = (tmp_path / "j.gif").read_bytes()
    assert (tmp_path / "p.gif").read_bytes() == want
    w = pr.GifWriter(str(tmp_path / "s.gif"), FPS)
    for t0 in range(0, 24, 10):
        w.add(frames[t0:t0 + 10])
    w.close()
    jw = jr.GifWriter(str(tmp_path / "js.gif"), FPS)
    for t0 in range(0, 24, 10):
        jw.add(frames[t0:t0 + 10])
    jw.close()
    assert (tmp_path / "s.gif").read_bytes() == \
        (tmp_path / "js.gif").read_bytes()
    from PIL import Image, ImageSequence

    with Image.open(tmp_path / "p.gif") as im:
        pil = [np.asarray(f.convert("RGB"))
               for f in ImageSequence.Iterator(im)]
    ours = pr.decode_gif(want)
    assert len(ours) == len(pil) == 24
    assert all(np.array_equal(a, b) for a, b in zip(ours, pil))
    assert np.array_equal(np.stack(ours), palette_frames(frames))


def test_avi_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, size=(5, 48, 64, 3)).astype(np.uint8)
    pcm = (rng.normal(size=7001) * 3000).astype(np.int16)
    paths = {}
    for name, mod in (("jax", javi), ("port", pavi)):
        paths[name] = tmp_path / f"{name}.avi"
        w = mod.AviWriter(str(paths[name]), fps=FPS)
        w.add(frames[:3])
        w.add(frames[3:])
        w.set_audio(pcm, 16000)
        w.close()
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    got, want = (pavi.parse_avi(str(paths["port"])),
                 javi.parse_avi(str(paths["jax"])))
    assert got == want and len(got["frames"]) == 5
    assert got["pcm"] == pcm.tobytes()
    # float stereo input, the stdlib WAV reader
    stereo = rng.uniform(-1, 1, size=(400, 2))
    for mod, name in ((javi, "j2"), (pavi, "p2")):
        w = mod.AviWriter(str(tmp_path / f"{name}.avi"), fps=FPS)
        w.add(frames[:1])
        w.set_audio(stereo, 8000)
        w.close()
    assert (tmp_path / "p2.avi").read_bytes() == \
        (tmp_path / "j2.avi").read_bytes()
    wav = _write_wav(tmp_path / "a.wav", pcm, 16000)
    for fn in ("read_wav", "decode_audio"):
        (a, sa), (b, sb) = getattr(pavi, fn)(wav), getattr(javi, fn)(wav)
        assert sa == sb and np.array_equal(a, b)


def _write_wav(path, pcm, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())
    return str(path)


class FakeData:
    def __init__(self, root, speaker="oliver"):
        self.path2data = str(root)
        self.speaker = speaker
        self.modality_classes = {"pose/data": types.SimpleNamespace(
            parents=PARENTS)}

    def getSpeaker(self, interval_id):
        return self.speaker


def _tree(root):
    root = Path(root)
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _words():
    words = ["so", "the", "point", "is", "that", "gestures", "carry",
             "style", "across", "speakers", "and", "time"]
    ends = np.cumsum([2, 2, 3, 1, 2, 4, 3, 2, 3, 4, 1, 3])
    return {"Word": words, "start_frame": ends - 2, "end_frame": ends}


@pytest.mark.parametrize("backend", ["native", "matplotlib"])
def test_animate_writes_jax_files(same_flags, no_ffmpeg, tmp_path,
                                  monkeypatch, backend):
    """``animate`` without ffmpeg and without audio: a silent GIF at the
    JAX package's path with its bytes (prediction beside ground truth,
    and a single panel with captions in the native backend)."""
    monkeypatch.setenv("MIXSTAGE_RENDER_BACKEND", backend)
    ys = [walk(7, T=12), walk(8, T=12)]
    text = _words() if backend == "native" else None
    for name, mod, table in (("jax", janim, pd.DataFrame),
                             ("port", panim, Table)):
        root = tmp_path / name
        mod.animate(ys, "77", PARENTS, str(root), "test", FakeData(root),
                    None, None, None, None, fps=FPS)
        mod.animate([ys[0]], "78", PARENTS, str(root), "dev", FakeData(root),
                    None, None, 3, "style", fps=FPS,
                    text=table(_words()) if text else None)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want) == [
        "render/test/oliver/77.gif", "render_style/dev/oliver/78_003.gif"]
    for k in want:
        assert got[k] == want[k], k


def test_render_backend_names(monkeypatch):
    """``auto`` and ``native`` are the C++ rasteriser; another name raises
    (no quiet fall-back to matplotlib)."""
    for name in ("auto", "native", "matplotlib"):
        monkeypatch.setenv("MIXSTAGE_RENDER_BACKEND", name)
        assert panim.render_backend() == name
    monkeypatch.setenv("MIXSTAGE_RENDER_BACKEND", "pil")
    with pytest.raises(ValueError, match="MIXSTAGE_RENDER_BACKEND"):
        panim.render_backend()


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "raster.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pr, "SOURCE", bad)
    monkeypatch.setattr(pr, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed for .*raster.cpp"):
        pr.build()


def test_captions_equal_jax():
    frames = pr.rasterize([walk(9, T=20)], PARENTS, panel=240)
    want = jr.overlay_captions(frames, pd.DataFrame(_words()))
    got = pr.overlay_captions(frames, Table(_words()))
    assert got.shape == (20, 240 + pr.CAPTION_H, 240, 3)
    assert np.array_equal(got, want)
    split_j = janim.split_text(pd.DataFrame(_words()), max_length=14)
    split_p = panim.split_text(Table(_words()), max_length=14)
    assert [list(s.Word) for s in split_j] == \
        [list(s["Word"]) for s in split_p]


def test_audio_mux_without_ffmpeg_writes_jax_avi(same_flags, no_ffmpeg,
                                                 tmp_path):
    """Decodable interval audio and no ffmpeg: an MJPEG + PCM ``.avi``,
    the video cut to the audio (``-shortest``), the JAX package's bytes."""
    ys = [walk(10, T=24), walk(11, T=24)]
    pcm = (np.random.default_rng(2).normal(size=16000) * 2000).astype(
        np.int16)                                  # 1 s: 15 of 24 frames
    out = {}
    for name, mod in (("jax", janim), ("port", panim)):
        root = tmp_path / name
        raw = root / "raw" / "oliver_cropped"
        raw.mkdir(parents=True)
        _write_wav(raw / "clip_12.wav", pcm, 16000)
        out[name] = mod.animate(ys, "12", PARENTS, str(root / "exp"), "test",
                                FakeData(root), 0, None, None, None, fps=FPS)
    assert out["port"].endswith("render/test/oliver/12.avi")
    a, b = Path(out["jax"]).read_bytes(), Path(out["port"]).read_bytes()
    assert a == b
    assert len(pavi.parse_avi(out["port"])["frames"]) == 15


_STUB = """#!/bin/sh
count=0
case " $* " in
  *" -i - "*) count=$(wc -c | tr -d ' ') ;;
esac
printf '%s|%s\\n' "$count" "$*" >> "$FFMPEG_STUB_LOG"
for last; do :; done
printf 'stub-output' > "$last"
exit 0
"""


def test_ffmpeg_branch_calls_as_jax(same_flags, tmp_path, monkeypatch):
    """With an ``ffmpeg`` on PATH (a stub that logs its calls, as
    ``tests/test_ffmpeg_path.py`` uses): the rawvideo pipe gets every frame
    and the mux the reference's flags, the same calls as the JAX
    package's."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "ffmpeg").write_text(_STUB)
    (bindir / "ffmpeg").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    calls = {}
    for name, mod in (("jax", janim), ("port", panim)):
        root = tmp_path / name
        log = tmp_path / f"{name}.log"
        monkeypatch.setenv("FFMPEG_STUB_LOG", str(log))
        raw = root / "raw" / "oliver_cropped"
        raw.mkdir(parents=True)
        (raw / "audio_123.mp3").write_bytes(b"mp3")
        assert mod.have_ffmpeg()
        out = mod.animate([walk(12, T=6)], "123", PARENTS, str(root), "test",
                          FakeData(root), 0, None, None, None, fps=FPS)
        assert out.endswith("123.mp4") and os.path.exists(out)
        calls[name] = log.read_text().replace(str(root), "ROOT")
    assert calls["port"] == calls["jax"]
    lines = calls["port"].splitlines()
    assert len(lines) == 2 and int(lines[0].split("|")[0]) == 6 * 480 * 480 * 3
    assert " -shortest " in lines[1]


def test_frames_and_save_animation_equal_jax(same_flags, no_ffmpeg,
                                             tmp_path):
    ys = walk(13, T=5)
    for name, mod in (("jax", janim), ("port", panim)):
        root = tmp_path / name
        out = mod.frames(ys, [0, 1, 0, 2, 1], "7", PARENTS,
                         str(root / "frames"), FakeData(root), "style")
        assert out == root / "frames" / "render_style" / "oliver"
        mod.save_animation([walk(14, T=8), walk(15, T=8)], ["1", "2"],
                           str(root / "saved"), "test", FakeData(root))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.endswith(".png")]) == 5
    assert len([k for k in got if k.endswith(".gif")]) == 2
    for k in want:
        assert got[k] == want[k], k


def _grid_tree(root):
    for d, f in (("render", "test/oliver/2.gif"),
                 ("render_oliver_maher", "test/oliver/1.mp4"),
                 ("render_maher_oliver", "test/maher/3.avi"),
                 ("render", "test/maher/4.gif")):
        (root / d / f).parent.mkdir(parents=True, exist_ok=True)
        (root / d / f).touch()


def test_html_pages_equal_jax(tmp_path):
    exp = tmp_path / "exp_3_speaker_['oliver', 'maher']_model"
    _grid_tree(exp)
    for n, o in (("videos", 2), ("videos_subset", 4)):
        a = jhtml.make_html_file(str(exp), o, n + "_j")
        b = phtml.make_html_file(str(exp), o, n)
        assert Path(b).read_text() == Path(a).read_text().replace(
            f"({n}_j)", f"({n})")
    a = jsnip.make_html_report(str(exp), idxs=2, outfile="r_j")
    b = psnip.make_html_report(str(exp), idxs=2, outfile="r_p")
    assert Path(a).read_text() == Path(b).read_text()
    sections = [{"title": "B1", "description": "left vs right",
                 "names": [["1", "model"], ["oliver", "render/x.mp4"],
                           ["maher", "render/y.gif"]], "columns": [0, 1]}]
    a = jsnip.make_supplementary(sections, "Appendix", str(tmp_path / "a"))
    b = psnip.make_supplementary(sections, "Appendix", str(tmp_path / "b"))
    assert Path(a).read_text() == Path(b).read_text()
    assert psnip.get_list_files(str(exp), 0) == \
        jsnip.get_list_files(str(exp), 0)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """Synthetic PATS data and, for each package, a sampled experiment's
    files: ``PREFIX_args.args`` and keypoint trees (the ground truth with
    noise, 24 frames, in ``keypoints`` and a style-transfer
    ``keypoints_oliver_maher`` tree)."""
    root = tmp_path_factory.mktemp("render_cli")
    data = root / "data"
    make_synthetic_dataset(str(data), ["oliver", "maher"], 2)
    df = pd.read_csv(data / "cmu_intervals_df.csv", dtype=str)
    rng = np.random.default_rng(0)
    prefix = "exp_1_cpk_m_speaker_['oliver', 'maher']_model_M"
    for name in ("jax", "port"):
        save = root / name
        save.mkdir()
        jax_cfg(dict(path2data=str(data), speaker=["oliver", "maher"],
                     modalities=["pose/data", "audio/log_mel_512"],
                     fs_new=[15, 15], save_dir=str(save), exp=1, cpk="m",
                     model="M")).save(str(save / f"{prefix}_args.args"))
    for kp, desc in (("keypoints", "test"), ("keypoints", "dev"),
                     ("keypoints_oliver_maher", "test")):
        for _, row in df.iterrows():
            with h5py.File(data / "processed" / row.speaker
                           / f"{row.interval_id}.h5") as h5:
                gt = h5["pose/data"][:24]
            y = gt + rng.normal(size=gt.shape) * 5
            for name in ("jax", "port"):
                path = root / name / prefix / kp / desc / row.speaker
                path.mkdir(parents=True, exist_ok=True)
                with h5py.File(path / f"{row.interval_id}.h5", "w") as h5:
                    h5["pose/data"] = y
    return root, data, prefix


def test_cli_render_writes_jax_tree(same_flags, no_ffmpeg, experiment):
    """``cli.render -load``: prediction beside ground truth under
    ``render*``, the prediction alone under ``render_eval*``, the matrix
    pages; the JAX package's file tree and bytes.  Again with
    ``-clean_render 0``: nothing new is written."""
    root, data, prefix = experiment

    def argv(name, *extra):
        return ["-load", str(root / name / f"{prefix}_weights.p"),
                "-path2data", str(data), "-render", "1", *extra]
    jax_loop(jrender.render, argv("jax"))
    prender.main(argv("port"))
    want, got = (_tree(root / "jax" / prefix), _tree(root / "port" / prefix))
    gifs = sorted(k for k in got if k.endswith(".gif"))
    assert sorted(got) == sorted(want)
    # (2 splits + 1 transfer tree) x 2 speakers, each twice (pair, eval)
    assert len(gifs) == 12
    assert {k.split("/")[0] for k in gifs} == {
        "render", "render_eval", "render_oliver_maher",
        "render_eval_oliver_maher"}
    assert "videos.html" in got and "videos_subset.html" in got
    for k in want:
        assert got[k] == want[k], k
    mtimes = {p: p.stat().st_mtime_ns
              for p in (root / "port" / prefix).rglob("*") if p.is_file()}
    prender.main(argv("port", "-clean_render", "0"))
    after = {p: p.stat().st_mtime_ns
             for p in (root / "port" / prefix).rglob("*") if p.is_file()}
    assert sorted(after) == sorted(mtimes)
    assert all(after[p] == mtimes[p] for p in mtimes
               if p.suffix == ".gif")
    # the args file of the experiment is not rewritten
    args = json.loads((root / "port" / f"{prefix}_args.args").read_text())
    assert args["render"] == 0


def test_make_html_file_loop_equal_jax(experiment):
    """The standalone page CLI (``htmlgrid/to_html.py``'s
    ``make_html_file_loop``): the experiment's args restored from
    ``-load``, its ``videos`` and ``videos_subset`` pages, as JAX's."""
    root, data, prefix = experiment
    pages = {}
    for name, loop in (("jax", lambda a: jax_loop(
            jhtml.make_html_file_loop, a)), ("port", phtml.main)):
        exp = root / name / prefix
        _grid_tree(exp)
        loop(["-load", str(root / name / f"{prefix}_weights.p"),
              "-path2data", str(data)])
        pages[name] = {n: (exp / f"{n}.html").read_text()
                       for n in ("videos", "videos_subset")}
    assert pages["port"] == pages["jax"]
    assert "render_oliver_maher/test/oliver/1.mp4" in \
        pages["port"]["videos"]


def test_render_samples_equal_jax(same_flags, no_ffmpeg, experiment,
                                  tmp_path):
    """The trainer's ``-render`` pass (``render_samples``) on a sampled
    experiment's keypoint trees: the JAX trainer's files."""
    from mixstage_tpu.train.trainer import Trainer as JaxTrainer
    from mixstage_tpu_torch.train.trainer import Trainer

    root, data, prefix = experiment
    import shutil

    for name, cls in (("jax", JaxTrainer), ("port", Trainer)):
        exp = tmp_path / name
        shutil.copytree(root / name / prefix / "keypoints", exp / "keypoints")
        fake = types.SimpleNamespace(
            dir_name=str(exp), data_shape={"pose/data": (64, 104)},
            output_modality="pose/data", parents=PARENTS,
            data=FakeData(data))
        cls.render_samples(fake, max_videos=3)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.endswith(".gif")]) == 3
    for k in want:
        assert got[k] == want[k], k


def test_render_ground_truth_equal_jax(same_flags, no_ffmpeg, experiment,
                                       tmp_path):
    root, data, _ = experiment
    cfg = dict(path2data=str(data), speaker=["oliver", "maher"],
               modalities=["pose/data", "audio/log_mel_512"],
               fs_new=[15, 15], output_modalities=["pose/data"], time=1.6)
    janim.render_ground_truth(jax_cfg(dict(cfg, path2outdata=str(
        tmp_path / "jax"))), 0)
    from mixstage_tpu_torch.config import config_from_dict

    written = panim.render_ground_truth(config_from_dict(dict(
        cfg, path2outdata=str(tmp_path / "port"))), 0)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(written) == len(got) > 0
    for k in want:
        assert got[k] == want[k], k


def test_train_render_writes_videos(tmp_path):
    """``cli.train -render 1`` on the CPU: after the final sampling pass
    the trainer renders the keypoint trees (at most 10 intervals) and
    writes ``videos.html``."""
    from mixstage_tpu_torch.cli import train as cli_train
    from mixstage_tpu_torch.config import config_from_dict
    from mixstage_tpu_torch.data.synthetic import \
        make_synthetic_dataset as port_synthetic

    data = str(tmp_path / "data")
    port_synthetic(data, ["oliver", "maher"], 2)
    save = tmp_path / "save"
    cli_train.loop(config_from_dict(dict(
        path2data=data, speaker=["oliver", "maher"], batch_size=4,
        num_epochs=1, window_hop=5, exp=1, num_iters=2, debug=1,
        model="JointLateClusterSoftStyle4_G", gan=1, loss="L1Loss",
        num_clusters=2, modelKwargs={"in_channels": 32}, lr=1e-4,
        save_dir=str(save), render=1)), 0, device="cpu")
    exp = next(p for p in save.iterdir() if p.is_dir())
    gifs = sorted(exp.rglob("*.gif"))
    kps = sorted(exp.rglob("*.h5"))
    assert len(gifs) == min(10, len(kps)) > 0
    assert (exp / "videos.html").exists()
    frames = pr.decode_gif(gifs[0].read_bytes())
    with h5py.File(sorted((exp / "keypoints").rglob("*.h5"))[0]) as h5:
        T = h5["pose/data"].shape[0]
    assert len(frames) == T and frames[0].shape == (480, 480, 3)
