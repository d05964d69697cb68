"""2D skeleton modality: the PATS kinematic tree and the keypoint
preprocessing (the port's copy of ``mixstage_tpu/data/skeleton.py``).

Raw per-frame keypoint files → root-relative pose vectors (``pose/data``),
shoulder-normalized pose (``pose/normalize``, shoulder length 167 px),
OpenPose confidences (``pose/confidence``); the 52-joint PATS tree (10 body
+ 2×21 fingers).  The Berkeley confidence branch reads OpenPose's
OpenCV-YAML dumps with the port's own reader (``load_yaml_keypoints``: the
port imports no PyYAML).
"""

from __future__ import annotations

import os
import re
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from mixstage_tpu_torch.data.common import MissingData, Modality

# 52-joint kinematic tree (reference skeleton.py:247-264)
PARENTS = [-1,
           0, 1, 2,
           0, 4, 5,
           0, 7, 7,
           6,
           10, 11, 12, 13,
           10, 15, 16, 17,
           10, 19, 20, 21,
           10, 23, 24, 25,
           10, 27, 28, 29,
           3,
           31, 32, 33, 34,
           31, 36, 37, 38,
           31, 40, 41, 42,
           31, 44, 45, 46,
           31, 48, 49, 50]

JOINT_NAMES = ["Neck",
               "RShoulder", "RElbow", "RWrist",
               "LShoulder", "LElbow", "LWrist",
               "Nose", "REye", "LEye",
               "LHandRoot"] + \
    [f"LHand{f}{i}" for f in ["Thumb", "Index", "Middle", "Ring", "Little"]
     for i in range(1, 5)] + \
    ["RHandRoot"] + \
    [f"RHand{f}{i}" for f in ["Thumb", "Index", "Middle", "Ring", "Little"]
     for i in range(1, 5)]

ROOT = 0
FS_POSE = 15  # pose frame rate (skeleton.py:295-296)
NUM_JOINTS = len(PARENTS)  # 52
REF_SHOULDER_LEN = 167.0   # normalization target (skeleton.py:118)

# OpenPose BODY_25 → 10-joint upper-body subset (reference skeleton.py:43)
BERK_BODY_IDX = [0, 1, 2, 3, 4, 5, 6, 18, 19, 21]


_YAML_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_YAML_SPECIAL = re.compile(r"^([-+]?)\.(inf|Inf|INF)$|^\.(nan|NaN|NAN)$")


def _yaml_number(token: str):
    """A scalar of an OpenCV matrix as PyYAML's safe loader reads it: an
    int, a float, or ``.nan`` / ``.inf`` in the cases YAML 1.1 allows."""
    t = token.strip()
    if _YAML_INT.match(t):
        return int(t.replace("_", ""))
    special = _YAML_SPECIAL.match(t)
    if special:
        return float("nan") if special.group(3) else \
            float(special.group(1) + "inf")
    return float(t)


def load_yaml_keypoints(filename: str) -> np.ndarray:
    """OpenCV-YAML keypoint matrix → ``(J, 3)`` x/y/confidence array (the
    reference's ``loadYAML``, skeleton.py:29-34).  The port's own reader of
    the matrix: the first 3 lines (the ``%YAML`` directive block) are
    skipped, as the JAX package skips them, and the ``data: [ ... ]`` list
    is read, over as many lines as it spans."""
    with open(filename) as f:
        text = "".join(f.readlines()[3:])
    m = re.search(r"(?m)^\s*data\s*:\s*\[(.*?)\]", text, re.S)
    if m is None:
        raise ValueError(f"{filename}: no 'data: [...]' matrix")
    tokens = [t for t in m.group(1).replace("\n", " ").split(",")
              if t.strip()]
    return np.array([_yaml_number(t) for t in tokens]).reshape(-1, 3)


def load_pose(filename: str) -> np.ndarray:
    """``<base>_{pose,hand_left,hand_right}.yml`` → ``(52, 3)`` stack (the
    reference's ``loadPose``, skeleton.py:36-48)."""
    base = "_".join(filename.split("_")[:-1])
    pose = load_yaml_keypoints(base + "_pose.yml")[BERK_BODY_IDX]
    left = load_yaml_keypoints(base + "_hand_left.yml")[:21]
    right = load_yaml_keypoints(base + "_hand_right.yml")[:21]
    return np.concatenate([pose, left, right])


def timedelta_seconds(text: str) -> float:
    """Seconds of a PATS time stamp ``"[D days ]H:MM:SS[.ffffff]"`` (the
    master CSV's format), as ``pd.to_timedelta(text).total_seconds()``
    gives them."""
    text = str(text).strip()
    days = 0.0
    if "day" in text:
        d, text = text.split("day", 1)
        days = float(d)
        text = text.lstrip("s").strip()
    parts = text.split(":")
    if len(parts) != 3:
        raise ValueError(f"not a time stamp: {text!r}")
    h, m, s = parts
    return days * 86400.0 + int(h) * 3600.0 + int(m) * 60.0 + float(s)


class Skeleton2D(Modality):
    def __init__(self, path2data="../dataset/groot/data",
                 path2outdata="../dataset/groot/data", speaker="all",
                 preprocess_methods="data"):
        super().__init__(path2data=path2data, path2outdata=path2outdata,
                         speaker=speaker)
        self.preprocess_methods = preprocess_methods
        self.missing = MissingData(self.path2outdata)

    # ------------------------------------------------------------------ const
    @property
    def parents(self):
        return list(PARENTS)

    @property
    def joint_names(self):
        return list(JOINT_NAMES)

    @property
    def joint_subset(self):
        """Relevant keypoints (nose/eyes removed) — skeleton.py:266-269."""
        return np.r_[range(7), range(10, NUM_JOINTS)]

    @property
    def root(self):
        return ROOT

    def fs(self, modality):
        return FS_POSE

    @property
    def h5_key(self):
        return "pose"

    # ----------------------------------------------------------------- kernel
    @staticmethod
    def process_keypoints(keypoints: np.ndarray, inv: bool = False):
        """Root-relative encoding: subtract the root from every joint, keep
        the root absolute (skeleton.py:192-201)."""
        if not inv:
            out = keypoints - keypoints[..., ROOT:ROOT + 1]
            out[..., ROOT] = keypoints[..., ROOT]
            return out.reshape(out.shape[0], -1)
        keypoints = keypoints.reshape(keypoints.shape[0], 2, -1)
        out = keypoints + keypoints[..., ROOT:ROOT + 1]
        out[..., ROOT] = keypoints[..., ROOT]
        return out

    @staticmethod
    def normalize_shoulder(data: np.ndarray) -> np.ndarray:
        """Scale pose so the (root→RShoulder) length == 167 px
        (skeleton.py:112-137); joints 0/52 (root x,y) stay absolute."""
        ratio = REF_SHOULDER_LEN / np.sqrt(
            (data.reshape(data.shape[0], 2, -1)[..., 1] ** 2).sum(1))
        keypoints = ratio.reshape(-1, 1) * data
        keypoints[:, [0, NUM_JOINTS]] = data[:, [0, NUM_JOINTS]]
        return keypoints

    # ------------------------------------------------------------ offline CLI
    def preprocess(self):
        speakers = self.speaker if self.speaker[0] != "all" else self.speakers
        for speaker in speakers:
            df_speaker = self.get_df_subset("speaker", speaker)
            interval_ids = np.array(sorted(
                set(df_speaker.unique("interval_id"))
                - self.missing.load_intervals()))
            missing = [self.save_intervals(i, speaker) for i in interval_ids]
            self.missing.save_intervals(missing)

    def save_intervals(self, interval_id, speaker) -> Optional[str]:
        if self.preprocess_methods == "data":
            fn = self.process_interval
        elif self.preprocess_methods == "normalize":
            fn = self.normalize
        elif self.preprocess_methods == "confidence":
            fn = self.confidence
        else:
            raise ValueError(
                f"preprocess_methods = {self.preprocess_methods} not found")
        keypoints = fn(interval_id)
        if keypoints is None:
            return interval_id
        filename = (Path(self.path2outdata) / "processed" / speaker
                    / f"{interval_id}.h5")
        key = self.add_key(self.h5_key, [self.preprocess_methods])
        try:
            self.append(filename, key, keypoints)
        except Exception:
            return interval_id
        return None

    def process_interval(self, interval_id):
        file_list = self.get_filelist(interval_id)
        if file_list is None:
            return None
        keypoints = np.stack([np.loadtxt(f) for f in file_list], axis=0)
        return self.process_keypoints(keypoints)

    def normalize(self, interval_id):
        speaker = self.get_df_subset("interval_id", interval_id)["speaker"][0]
        filename = (Path(self.path2outdata) / "processed" / speaker
                    / f"{interval_id}.h5")
        try:
            data = self.load_array(filename, "pose/data")
        except Exception:
            warnings.warn(f"pose/data not found in {filename}")
            return None
        if data.ndim == 3:
            return None
        return self.normalize_shoulder(data)

    def confidence(self, interval_id):
        """OpenPose confidences duplicated across x/y.  CMU intervals
        (leading 'c') read the cached ``raw_keypoints`` h5; Berkeley ids
        re-read the OpenPose YAML dumps (reference skeleton.py:174-178
        dispatch)."""
        if str(interval_id)[:1] == "c":
            return self.cmu_confidence(interval_id)
        return self.berk_confidence(interval_id)

    def cmu_confidence(self, interval_id):
        """(skeleton.py:161-172)"""
        filename = (Path(self.path2outdata) / "raw_keypoints"
                    / self.get_df_subset("interval_id", interval_id)["speaker"][0]
                    / f"{interval_id}.h5")
        try:
            data = self.load_array(filename.as_posix(), "pose/data")
        except Exception:
            warnings.warn(f"interval {interval_id} not found")
            return None
        keypoints = data[:, -1, :]
        return np.concatenate([keypoints] * 2, axis=1)

    def berk_confidence(self, interval_id):
        """Confidence column of the interval's OpenPose YAML dumps under
        the sibling ``keypoints_all`` tree (skeleton.py:139-156)."""
        file_list = self.get_filelist(interval_id)
        if file_list is None:
            return None
        kp = []
        for f in file_list:
            p = Path(f)
            yml = (p.parent.parent.parent / "keypoints_all" / p.parent.name
                   / (p.name[:-4] + "_pose.yml"))
            kp.append(load_pose(yml.as_posix()))
        try:
            keypoints = np.stack(kp, axis=0)[..., -1]
        except ValueError:
            warnings.warn(f"[BERK_CONFIDENCE] interval_id: {interval_id}")
            return None
        return np.concatenate([keypoints] * 2, axis=1)

    @staticmethod
    def time_from_file(name: str) -> str:
        """``<video>_H_MM_SS[.ffffff].<ext>`` → ``H:MM:SS.ffffff``
        (reference ``get_time_from_file``, skeleton.py:241-246)."""
        stem = ".".join(name.split(".")[:-1]) if "." in name else name
        t = ":".join(stem.split("_")[-3:])
        return t if "." in t else t + ".000000"

    def get_filelist(self, interval_id):
        """The interval's ``[start_time, end_time]`` slice of its video's
        per-frame keypoint files, ordered by the timestamps embedded in the
        filenames; ``None`` when a boundary frame is absent or the slice has
        frame-rate gaps (reference skeleton.py:228-245, incl. the
        ``are_keypoints_complete`` 8e-5 s tolerance).  Boundary matching is
        numeric (seconds) instead of the reference's string equality, which
        is fragile to zero-padding."""
        df = self.df.rows(self.df["interval_id"] == interval_id)
        if not len(df):
            return None
        to_secs = timedelta_seconds
        start_s = to_secs(str(df["start_time"][0]))
        end_s = to_secs(str(df["end_time"][0]))
        speaker = df["speaker"][0]
        video_fn = df["video_fn"][0].split(".")[0]
        video_fn = "_".join(video_fn.split(" "))
        path2keypoints = (Path(self.path2data) / speaker / "keypoints_simple"
                          / video_fn)
        if not path2keypoints.exists():
            return None
        names = os.listdir(path2keypoints)
        if not names:
            return None
        secs = np.array([to_secs(self.time_from_file(n)) for n in names])
        order = np.argsort(secs, kind="stable")
        names = [names[i] for i in order]
        secs = secs[order]
        hit_s = np.flatnonzero(np.abs(secs - start_s) < 5e-4)
        hit_e = np.flatnonzero(np.abs(secs - end_s) < 5e-4)
        if not len(hit_s) or not len(hit_e):
            warnings.warn(f"interval_id: {interval_id} not found.")
            return None
        s, e = int(hit_s[0]), int(hit_e[0])
        fs = self.fs("pose/data")
        if np.any(np.abs(np.diff(secs[s:e + 1]) - 1.0 / fs) > 8e-5):
            warnings.warn(f"interval_id: {interval_id} has keypoint gaps.")
            return None
        return [str(path2keypoints / n) for n in names[s:e + 1]]

