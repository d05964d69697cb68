"""Skeleton rendering: pose tensors → videos with captions and audio.

The port's copy of ``mixstage_tpu/animation/animation.py``: ``animate``
(one interval's prediction and ground truth side by side), ``save_animation``
(a thread-pool fan-out over intervals), ``render_ground_truth`` and the
per-cluster ``frames`` PNG dumps, after the reference's
(chahuja/mix-stage ``src/animation/animation.py:101-460``).

``MIXSTAGE_RENDER_BACKEND`` picks the backend:

* ``auto`` (the default) and ``native``: the C++ rasteriser
  (``raster.py``); a failed build raises with g++'s log;
* ``matplotlib``: the reference's FuncAnimation over tapered
  LineCollections, imported only when named.

Unlike the JAX package's ``auto``, nothing falls back to matplotlib when
the rasteriser fails.  Where ffmpeg exists a clip is an mp4 (a rawvideo
pipe) muxed with the interval's audio; without it, a clip whose audio
decodes in-process becomes an MJPEG + PCM ``.avi`` (``aviwriter.py``,
PIL), else a silent GIF (the rasteriser's own encoder, no PIL).  Captions
take the ``text/meta`` word table as a ``data/common.py::Table``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

BACKENDS = ("auto", "native", "matplotlib")


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def render_backend() -> str:
    """``MIXSTAGE_RENDER_BACKEND`` ("auto" when unset); another value
    raises."""
    backend = os.environ.get("MIXSTAGE_RENDER_BACKEND", "auto")
    if backend not in BACKENDS:
        raise ValueError(f"MIXSTAGE_RENDER_BACKEND={backend!r}: one of "
                         f"{BACKENDS}")
    return backend


def split_text(text, max_length: int = 27) -> list:
    """Greedily wrap the word table (a ``Table`` with ``Word`` and
    ``end_frame``) into caption lines of at most ``max_length`` monospace
    characters (the reference's 27-character rows, ``animation.py:28-41``):
    a word costs its length plus one for its space, the first word of a
    line its length.  Returns one ``Table`` a line."""
    lengths = [len(str(w)) for w in text["Word"]]
    lines, line_start, used = [], 0, 0
    for i, n in enumerate(lengths):
        if used + n + 1 > max_length:
            lines.append((line_start, i))
            line_start, used = i, n
        else:
            used += n + 1
    if used > 0:
        lines.append((line_start, len(lengths)))
    return [text.rows(slice(s, e)) for s, e in lines]


def get_line_segments(x, y, num_segments: int = 20):
    """The bone from (x0, y0) to (x1, y1) as ``num_segments`` consecutive
    2-point segments, what a tapered LineCollection takes."""
    pts = np.linspace((x[0], y[0]), (x[1], y[1]), num_segments + 1)
    return np.stack([pts[:-1], pts[1:]], axis=1)


def _tapered_widths(min_w, max_w, segs=100):
    def widths(a, b, n, eps_flag=1):
        eps = (b - a) / n
        if eps == 0:
            return np.repeat(a, repeats=int(n))
        return np.arange(a, b + eps * int(eps_flag), eps)

    return np.concatenate([widths(min_w, max_w, segs / 2, eps_flag=0),
                           widths(max_w, min_w, segs / 2, eps_flag=1)])


def animate(ys, interval_id, parents, dir_name, desc, data, start, end, idx,
            subname, text=None, fps: int = 15, bitrate: int = 1000):
    """Render one interval's pose sequence(s) to a video file
    (``render[_<subname>]/<desc>/<speaker>/<interval>[_<idx>].<ext>``
    under ``dir_name``); returns its path.

    ys: (T, 2, joints) array or a list of them (side-by-side panels, e.g.
    [prediction, ground truth]).  ``start`` (seconds) turns on the audio
    mux of the interval's clip; ``text`` is its ``text/meta`` table.
    """
    if not isinstance(ys, list):
        ys = [ys]
    backend = render_backend()
    ext = "mp4" if have_ffmpeg() else "gif"
    render_dir = f"render_{subname}" if subname is not None else "render"
    speaker = data.getSpeaker(interval_id)
    stem = f"{interval_id}" if idx is None else f"{interval_id}_{idx:03d}"
    filename = Path(dir_name) / render_dir / desc / speaker / f"{stem}.{ext}"
    filename_temp = filename.with_name(f"{stem}_temp.{ext}")
    os.makedirs(filename.parent, exist_ok=True)
    if backend == "matplotlib":
        return _animate_matplotlib(ys, filename, filename_temp, parents,
                                   data, interval_id, start, end, text, fps,
                                   bitrate)
    return _animate_native(ys, filename, filename_temp, parents, data,
                           interval_id, start, end, text, fps, bitrate)


def _animate_native(ys, filename, filename_temp, parents, data, interval_id,
                    start, end, text, fps, bitrate):
    """The C++ rasteriser's render: with ffmpeg an mp4 muxed with the
    interval's audio; without, an MJPEG + PCM ``.avi`` where the audio
    decodes in-process, else a silent GIF."""
    from mixstage_tpu_torch.animation import raster

    if start is not None and have_ffmpeg():
        raster.render_to_file(ys, parents, filename_temp.as_posix(),
                              text=text, fps=fps, bitrate=bitrate)
        audio_file = get_audio_file(data, interval_id)
        if audio_file is not None:
            add_audio(start, end, audio_file, filename_temp.as_posix(),
                      filename.as_posix())
        else:
            shutil.move(filename_temp.as_posix(), filename.as_posix())
    else:
        audio = None
        plan = _ffmpeg_free_mux_plan(
            data, interval_id, start, end,
            min(int(y.shape[0]) for y in ys), fps)
        if plan is not None:
            clip, sr, n_keep = plan
            ys = [np.asarray(y)[:n_keep] for y in ys]
            audio = (clip, sr)
            filename = filename.with_suffix(".avi")
        raster.render_to_file(ys, parents, filename.as_posix(), text=text,
                              fps=fps, bitrate=bitrate, audio=audio)
    print(f"{filename} saved")
    return filename.as_posix()


def _animate_matplotlib(ys, filename, filename_temp, parents, data,
                        interval_id, start, end, text, fps, bitrate):
    """The reference's matplotlib render (FuncAnimation over tapered
    LineCollections, monospace word-highlight captions), with the same
    file and audio contract as the native path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter, writers
    from matplotlib.collections import LineCollection

    plt.ioff()
    fig = plt.figure()
    fig.patch.set_alpha(0.0)
    C = len(ys)
    axs = [fig.add_subplot(1, C, c + 1) for c in range(C)]
    num_segments = 100
    lwidths1 = _tapered_widths(1, 3, num_segments)
    lwidths2 = _tapered_widths(1, 1, num_segments)
    colors = [axs[0].plot([], [])[0].get_color() for _ in parents[1:]]

    def get_line_collections():
        lns_list = []
        for i, color in enumerate(colors):
            lw = lwidths1 if i <= 8 else lwidths2
            lns_list.append(LineCollection([], linewidths=lw, alpha=1,
                                           color=color))
        return lns_list

    lns = [get_line_collections() for _ in axs]
    for ax, ln in zip(axs, lns):
        for line in ln:
            ax.add_collection(line)

    text_subs = split_text(text) if text is not None else None
    labels: List = []
    caption_state = {"idx": 0, "end_frame": (text_subs[0]["end_frame"][-1]
                                             if text_subs else 0)}

    def init():
        for ax in axs:
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_xlim(-500, 500)
            ax.set_ylim(-500, 500)
            ax.set_aspect(aspect=1)

    def draw_caption(frame):
        sub = text_subs[caption_state["idx"]]
        if frame >= caption_state["end_frame"] and \
                caption_state["idx"] + 1 < len(text_subs):
            caption_state["idx"] += 1
            sub = text_subs[caption_state["idx"]]
            caption_state["end_frame"] = sub["end_frame"][-1]
        words = [str(w) for w in sub["Word"]]
        ahead = np.flatnonzero(frame < np.asarray(sub["end_frame"],
                                                  np.float64))
        current = int(ahead[0]) if len(ahead) else 0
        for label in labels:
            label.remove()
        labels.clear()
        x0 = 0.0
        for i, word in enumerate(words):
            color = "tab:red" if i == current else "k"
            weight = "bold" if i == current else "normal"
            labels.append(axs[0].text(
                x0 + (len(" ".join(words[:i])) + (1 if i else 0)) / 27, -0.08,
                word, transform=axs[0].transAxes, c=color, fontweight=weight,
                fontfamily="monospace", fontsize=13 if C == 1 else 10))

    def update(frame):
        for i, y in enumerate(ys):
            for joint, parent in enumerate(parents):
                if joint != 0:
                    segments = get_line_segments(
                        x=[y[frame, 0, parent], y[frame, 0, joint]],
                        y=[-y[frame, 1, parent], -y[frame, 1, joint]],
                        num_segments=num_segments)
                    lns[i][joint - 1].set_segments(segments)
        if text_subs is not None:
            draw_caption(frame)

    n_frames = min(y.shape[0] for y in ys)
    anim = FuncAnimation(fig, update, frames=range(n_frames), init_func=init)
    if have_ffmpeg():
        writer = writers["ffmpeg"](fps=fps, metadata={}, bitrate=bitrate)
    else:
        writer = PillowWriter(fps=fps)
    if start is not None and have_ffmpeg():
        anim.save(filename_temp.as_posix(), writer=writer, dpi=400)
        audio_file = get_audio_file(data, interval_id)
        if audio_file is not None:
            add_audio(start, end, audio_file, filename_temp.as_posix(),
                      filename.as_posix())
        else:
            shutil.move(filename_temp.as_posix(), filename.as_posix())
    else:
        plan = None if have_ffmpeg() else _ffmpeg_free_mux_plan(
            data, interval_id, start, end, n_frames, fps)
        if plan is not None:
            # the native path's ffmpeg-free contract: the Pillow GIF's frames
            # remuxed as MJPEG + PCM .avi, 64 frames at a time
            clip, sr, n_keep = plan
            anim.save(filename_temp.as_posix(), writer=writer)
            from mixstage_tpu_torch.animation.aviwriter import AviWriter

            filename = filename.with_suffix(".avi")
            w = AviWriter(filename.as_posix(), fps=fps)
            chunk = []
            for arr in _gif_frames(filename_temp.as_posix(), fps,
                                   limit=n_keep):
                chunk.append(arr)
                if len(chunk) == 64:
                    w.add(np.stack(chunk))
                    chunk = []
            if chunk:
                w.add(np.stack(chunk))
            w.set_audio(clip, sr)
            w.close()
            filename_temp.unlink()
        else:
            anim.save(filename.as_posix(), writer=writer)
    print(f"{filename} saved")
    plt.close("all")
    return filename.as_posix()


def _ffmpeg_free_mux_plan(data, interval_id, start, end, n_frames, fps):
    """``(pcm_clip, sample_rate, n_video_frames_to_keep)`` when the
    interval's audio decodes in-process and overlaps ``[start, stop)``,
    else None (a silent render): the reference mux's ``-ss start`` /
    ``-shortest`` (``animation.py:251-271``), the clip starting at
    ``start`` and the shorter track cutting the other."""
    if start is None:
        return None
    audio_file = get_audio_file(data, interval_id)
    if audio_file is None:
        return None
    from mixstage_tpu_torch.animation.aviwriter import decode_audio

    decoded = decode_audio(audio_file)
    if decoded is None:
        return None
    pcm, sr = decoded
    dur = n_frames / fps
    stop = min(float(end) if end is not None else start + dur, start + dur)
    clip = pcm[int(start * sr):int(stop * sr)]
    if not clip.size:
        return None
    n_keep = min(int(round(dur * fps)),
                 int(round(clip.size / sr * fps)))
    if n_keep <= 0:
        return None
    return clip, sr, n_keep


def _gif_frames(path: str, fps: int, limit=None):
    """A Pillow GIF's frames as constant-rate RGB arrays (at most
    ``limit``): PIL merges equal consecutive frames into one longer
    frame, so each is repeated ``round(duration * fps)`` times."""
    from PIL import Image, ImageSequence

    n = 0
    with Image.open(path) as im:
        for frame in ImageSequence.Iterator(im):
            rgba = frame.convert("RGBA")
            bg = Image.new("RGBA", rgba.size, (255, 255, 255, 255))
            arr = np.asarray(Image.alpha_composite(bg, rgba).convert("RGB"))
            repeats = max(1, int(round(
                frame.info.get("duration", 1000 / fps) / 1000 * fps)))
            for _ in range(repeats):
                if limit is not None and n >= limit:
                    return
                yield arr
                n += 1


def in_modalities(modality: str, input_modalities) -> bool:
    """True when e.g. 'text' appears in a modality key like 'text/bert'."""
    return any(modality in key for key in input_modalities)


def get_audio_file(data, interval_id) -> Optional[str]:
    """The interval's raw audio clip under ``raw/<speaker>_cropped``: mp3
    (the reference dataset's) or wav; when both exist, mp3 with ffmpeg and
    wav without (the standard library decodes wav, not mp3)."""
    speaker = data.getSpeaker(interval_id)
    parent = Path(data.path2data) / "raw" / f"{speaker}_cropped"
    if not parent.exists():
        return None
    found = {}
    for f in parent.iterdir():
        if f.suffix in (".mp3", ".wav") and \
                f.stem.split("_")[-1] == str(interval_id):
            found[f.suffix] = f.as_posix()
    order = (".mp3", ".wav") if have_ffmpeg() else (".wav", ".mp3")
    return next((found[s] for s in order if s in found), None)


def add_audio(start, end, audio_file, filename_temp, filename):
    """Mux the interval's audio into the rendered video with ffmpeg (the
    reference's command, ``animation.py:251-271``)."""
    if not have_ffmpeg():
        warnings.warn("ffmpeg unavailable; skipping audio mux")
        shutil.move(filename_temp, filename)
        return
    command = ["ffmpeg", "-y", "-ss", str(start), "-i", audio_file,
               "-i", filename_temp, "-map", "0:a", "-map", "1:v",
               "-c:v", "copy", "-shortest", filename]
    subprocess.run(command, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL, check=False)
    os.remove(filename_temp)


def save_animation(y, interval_ids, dir_name, desc, data, start=None,
                   end=None, idx=None, subname=None, text=None,
                   output_modalities="pose/data", mask=()):
    """``animate`` over intervals on a thread pool (``parallel/
    parallel.py``)."""
    from mixstage_tpu_torch.parallel.parallel import parallel

    parents = data.modality_classes[output_modalities].parents
    n = len(interval_ids)

    def listify(v):
        return v if isinstance(v, list) else [v] * n

    return parallel(animate, -1, y, list(interval_ids), [parents] * n,
                    listify(dir_name), listify(desc), [data] * n,
                    listify(start), listify(end), listify(idx),
                    listify(subname), listify(text))


def frames(ys, clusters, interval_id, parents, dir_name, data, subname,
           filename=None):
    """Per-cluster still frames: frame ``i`` of the interval goes to
    ``render[_<subname>]/<speaker>/<clusters[i]>/frame_<i>.png`` (PIL), so
    each mixture cluster's poses can be browsed side by side.  Returns the
    speaker directory."""
    from PIL import Image

    from mixstage_tpu_torch.animation import raster

    if not isinstance(ys, list):
        ys = [ys]
    render_dir = f"render_{subname}" if subname is not None else "render"
    if filename is None:
        filename = (Path(dir_name) / render_dir / data.getSpeaker(interval_id)
                    / "{}" / "frame_{}.png")
    imgs = raster.rasterize(ys, parents)
    for i in range(imgs.shape[0]):
        path = Path(str(filename).format(clusters[i], i))
        os.makedirs(path.parent, exist_ok=True)
        Image.fromarray(imgs[i]).save(path.as_posix())
    return Path(str(filename)).parent.parent


def render_ground_truth(args, exp_num):
    """Render the first ground-truth interval of each split and speaker
    file under ``<path2outdata>/<speaker>`` (the reference's
    renderGroundTruth, ``animation.py:345-415``), captioned when a text
    modality is in play, with the interval's audio from second 0."""
    from mixstage_tpu_torch.data.dataset import Data, DataLoader

    data = Data(args.path2data, args.speaker, args.modalities, args.fs_new,
                time=args.time, split=args.split, batch_size=args.batch_size,
                shuffle=bool(args.shuffle))
    output_modality = args.output_modalities[0]
    feats_shape = data.shape[output_modality][-1] // 2
    dir_name = (Path(args.path2outdata) / f"{args.speaker}").as_posix()
    os.makedirs(dir_name, exist_ok=True)
    written = []
    for desc in ["train", "dev", "test"]:
        for minidata in data.datasets[desc].datasets:
            text = None
            if in_modalities("text", getattr(args, "input_modalities", None)
                             or args.modalities):
                from mixstage_tpu_torch.data.text import read_text_meta

                text = read_text_meta(minidata.path2h5)
            loader = DataLoader(minidata, batch_size=len(minidata) or 1,
                                shuffle=False)
            for batch in loader:
                y = np.asarray(batch[output_modality])
                y = y.reshape(-1, 2, feats_shape)
                y[..., 0] = 0
                interval_id = batch["meta"]["interval_id"][0]
                written.append(animate(
                    y, interval_id,
                    data.modality_classes[output_modality].parents,
                    dir_name, desc, data, 0, None, None, "gt", text))
                break
    return written
