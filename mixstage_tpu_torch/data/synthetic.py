"""Synthetic PATS-like dataset fixture (the port's copy of
``mixstage_tpu/data/synthetic.py``).

Writes a miniature dataset with the exact on-disk contract of preprocessed
PATS: a ``cmu_intervals_df.csv`` master table and per-interval h5 files
holding ``pose/data`` (15 fps, 104 feats), ``audio/log_mel_512`` (89
rows/s, 128 mels) and optionally ``text/w2v`` (15 fps, 300 dims), so the
full Data/ZNorm/KMeans/trainer stack runs unchanged.  The same seed gives
the same arrays and the same CSV bytes as the JAX package's writer (which
writes its CSVs with pandas; here the standard ``csv`` module does).
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from mixstage_tpu_torch.data.hdf5 import HDF5

POSE_FS = 15
AUDIO_FS = 89          # log_mel_512 rows/sec (audio.py fs_map)
POSE_FEATS = 104       # 52 joints x 2
MEL_FEATS = 128
W2V_FEATS = 300


def _smooth_pose(rng: np.ndarray, num_frames: int, speaker_id: int,
                 style_scale: float = 1.0) -> np.ndarray:
    """Smooth, speaker-dependent random pose walk (root-relative layout)."""
    base = rng.normal(size=(num_frames, POSE_FEATS)) * 2.0
    # low-pass with a running mean for plausible velocities
    kernel = np.ones(9) / 9.0
    smooth = np.apply_along_axis(
        lambda c: np.convolve(c, kernel, mode="same"), 0, np.cumsum(base, 0))
    # speaker-specific posture offset + amplitude ("style")
    offset = (speaker_id + 1) * 3.0
    out = smooth * style_scale + offset
    out[:, 0] = 0.0           # root x stays 0 (root-relative encoding)
    out[:, POSE_FEATS // 2] = 0.0  # root y
    return out


_WORDS = ["the", "gesture", "speaks", "louder", "than", "words", "and",
          "style", "matters", "unbelievable", "punctuation"]


def _fmt_td(seconds: float) -> str:
    """Seconds → '0 days H:MM:SS.ffffff' (the master-CSV time format the
    reference parses via ``pd.to_timedelta(... .str.split().str[1])``)."""
    h = int(seconds // 3600)
    m = int(seconds % 3600 // 60)
    s = seconds % 60
    return f"0 days {h}:{m:02d}:{s:09.6f}"


def _write_csv(path, rows) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)`` for rows of str,
    int and float cells: the header from the first row, newline line ends,
    minimal quoting."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(rows[0]))
        for row in rows:
            writer.writerow([repr(v) if isinstance(v, float) else v
                             for v in row.values()])


def make_synthetic_dataset(path2data: str, speakers: Optional[List[str]] = None,
                           num_intervals_per_speaker: int = 3,
                           interval_seconds: float = 25.0,
                           with_text: bool = False,
                           with_raw_transcripts: bool = False,
                           with_raw_keypoints: bool = False,
                           with_raw_audio: bool = False,
                           seed: int = 11212) -> str:
    """Write a synthetic dataset under ``path2data``; returns the path.

    ``with_raw_transcripts`` also writes the *raw* PATS layout consumed by
    the not-aligned text path (reference text.py:142-237): one video per
    speaker whose intervals run back-to-back, with a word-timing CSV at
    ``raw/<speaker>/<video>_transcripts/<video>.csv``.

    ``with_raw_audio`` writes per-interval audio crops at
    ``raw/<speaker>_cropped/<video>_<interval_id>.wav`` (the layout
    ``get_audio_file`` globs — reference animation.py:274-283 ships mp3;
    WAV here so the ffmpeg-free mux can decode it in-process): a tone whose
    pitch tracks the interval's pose energy.

    ``with_raw_keypoints`` writes the raw trees the skeleton preprocessing
    consumes (reference skeleton.py:29-48,180-245): per-frame ``(2, 52)``
    txt matrices under ``<speaker>/keypoints_simple/<video>/`` named with
    the frame's video timestamp, plus OpenPose-style
    ``keypoints_all/<video>/*_{pose,hand_left,hand_right}.yml`` dumps
    (3-line OpenCV %YAML header + a ``data:`` list) for the Berkeley
    confidence branch.
    """
    if speakers is None:
        speakers = ["oliver", "maher"]
    rng = np.random.default_rng(seed)
    rows = []
    os.makedirs(path2data, exist_ok=True)
    interval_counter = 100000
    for si, speaker in enumerate(speakers):
        video_id = f"{speaker}vid00"
        transcript_rows = []
        for k in range(num_intervals_per_speaker):
            interval_id = str(interval_counter)
            interval_counter += 1
            video_start = k * interval_seconds
            if with_raw_transcripts:
                # one word every ~0.5 s across the interval (video time)
                t = video_start
                while t < video_start + interval_seconds - 0.25:
                    transcript_rows.append(
                        {"Word": _WORDS[int(rng.integers(len(_WORDS)))],
                         "Start": round(t, 3),
                         "End": round(t + 0.45, 3)})
                    t += 0.5
            num_pose = int(interval_seconds * POSE_FS)
            num_audio = int(interval_seconds * AUDIO_FS)
            pose = _smooth_pose(rng, num_pose, si,
                                style_scale=1.0 + 0.5 * si)
            # audio correlated with pose energy so the model has signal
            energy = np.abs(np.diff(pose, axis=0)).mean(-1)
            energy = np.concatenate([energy[:1], energy])
            t_audio = np.linspace(0, 1, num_audio)
            t_pose = np.linspace(0, 1, num_pose)
            energy_audio = np.interp(t_audio, t_pose, energy)
            mel = (rng.normal(size=(num_audio, MEL_FEATS)) * 0.1
                   + energy_audio[:, None])

            h5path = Path(path2data) / "processed" / speaker / f"{interval_id}.h5"
            HDF5.append(h5path, "pose/data", pose)
            HDF5.append(h5path, "audio/log_mel_512", mel)
            if with_text:
                w2v = np.repeat(rng.normal(size=(num_pose // 15 + 1, W2V_FEATS)),
                                15, axis=0)[:num_pose]
                HDF5.append(h5path, "text/w2v", w2v)

            if with_raw_audio:
                import wave

                adir = Path(path2data) / "raw" / f"{speaker}_cropped"
                os.makedirs(adir, exist_ok=True)
                sr = 16000
                t = np.arange(int(interval_seconds * sr)) / sr
                hz = 220.0 + 40.0 * np.interp(
                    t / interval_seconds, t_pose, energy)
                tone = np.sin(2 * np.pi * np.cumsum(hz) / sr)
                pcm = (tone * 18000).astype(np.int16)
                with wave.open(str(adir / f"{video_id}_{interval_id}.wav"),
                               "wb") as wf:
                    wf.setnchannels(1)
                    wf.setsampwidth(2)
                    wf.setframerate(sr)
                    wf.writeframes(pcm.tobytes())

            dataset = ["train", "dev", "test"][min(k, 2)] \
                if num_intervals_per_speaker >= 3 else "train"
            rows.append({"speaker": speaker, "interval_id": interval_id,
                         "dataset": dataset, "delta_time": interval_seconds,
                         "start_time": _fmt_td(video_start),
                         "end_time": _fmt_td(video_start + interval_seconds),
                         "video_fn": f"{speaker}_video.mp4",
                         "video_link":
                             f"https://youtube.com/watch?v={video_id}"})
        if with_raw_transcripts:
            tdir = Path(path2data) / "raw" / speaker / f"{video_id}_transcripts"
            os.makedirs(tdir, exist_ok=True)
            _write_csv(tdir / f"{video_id}.csv", transcript_rows)
        if with_raw_keypoints:
            video_dir = f"{speaker}_video"  # video_fn minus extension
            simple = Path(path2data) / speaker / "keypoints_simple" / video_dir
            kp_all = Path(path2data) / speaker / "keypoints_all" / video_dir
            os.makedirs(simple, exist_ok=True)
            os.makedirs(kp_all, exist_ok=True)
            total_s = num_intervals_per_speaker * interval_seconds
            n_frames = int(round(total_s * POSE_FS)) + 1  # boundary shared
            for fi in range(n_frames):
                t = fi / POSE_FS
                h = int(t // 3600)
                m = int(t % 3600 // 60)
                s = t % 60
                stem = f"{video_dir}_{h}_{m:02d}_{s:09.6f}"
                kp = rng.normal(size=(2, 52)) * 40 + 300
                np.savetxt(simple / f"{stem}.txt", kp)
                for part, joints in (("pose", 25), ("hand_left", 21),
                                     ("hand_right", 21)):
                    vals = rng.random(joints * 3).round(4).tolist()
                    with open(kp_all / f"{stem}_{part}.yml", "w") as f:
                        f.write("%YAML:1.0\n---\n"
                                f"name: {part}\n"
                                f"data: {vals}\n")
    _write_csv(Path(path2data) / "cmu_intervals_df.csv", rows)
    return path2data


WAVE_MEL_FS = 103      # log_mel_400 rows/sec (audio.py fs_map)
WAVE_MEL_FEATS = 64


def append_log_mel_400(path2data: str, seed: int = 0) -> str:
    """Add an ``audio/log_mel_400`` stream (103 rows/s, 64 mels, the
    waveform frontend's features) to every interval of a dataset written by
    ``make_synthetic_dataset``: its ``log_mel_512`` rows scaled to 103 per
    second, drawn from ``seed``.  A generator configured with
    ``-modalities '["pose/data", "audio/log_mel_400"]'`` then trains and
    serves from it, the waveform endpoint included."""
    rng = np.random.default_rng(seed)
    for h5path in sorted((Path(path2data) / "processed").glob("*/*.h5")):
        n = HDF5.load_array(str(h5path), "audio/log_mel_512").shape[0]
        rows = int(n / AUDIO_FS * WAVE_MEL_FS)
        HDF5.append(h5path, "audio/log_mel_400",
                    rng.normal(size=(rows, WAVE_MEL_FEATS)))
    return path2data
