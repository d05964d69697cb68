"""Render CLI: a sampled experiment's keypoint h5 trees → videos and the
HTML grid (the port's counterpart of ``mixstage_tpu/cli/render.py``).

  python -m mixstage_tpu_torch.cli.render -load <PREFIX_weights.p> \
    [-render N] [-clean_render 0] [-render_list FILE] [-render_text 0]

For each ``keypoints*/`` directory of the experiment, ``-render N``
intervals per (split, speaker) are rendered prediction beside ground truth
(``render[_<sub>]/``) and prediction alone (``render_eval[_<sub>]/``); the
style-transfer matrix pages (``videos.html``, ``videos_subset.html``)
follow when transfer directories exist.  The experiment's args come back
from ``PREFIX_args.args`` with the flags typed on the command line over
them (after the reference's ``src/render.py:19-132``).  Host work only: the
rasteriser is host C++ (``animation/raster.py``).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from mixstage_tpu_torch.animation.animation import animate
from mixstage_tpu_torch.config import Config, argparse_n_loop
from mixstage_tpu_torch.data.dataset import Data
from mixstage_tpu_torch.data.hdf5 import HDF5
from mixstage_tpu_torch.htmlgrid.to_html import make_html_file


def select_render_files(kp_dir: Path, n: int) -> list:
    """Pick ``n`` interval files per (split, speaker) subdirectory of a
    keypoints tree, reseeding for each so the choice is stable run-to-run
    and matches the reference's selection (render.py:78-83: sorted listdir
    → np.random.seed(0) → permutation[:n]; n=0 therefore selects nothing,
    as upstream does)."""
    files: list = []
    for split_spk_dir in sorted(d for d in kp_dir.glob("*/*") if d.is_dir()):
        group = sorted(split_spk_dir.glob("*.h5"))
        np.random.seed(0)
        idxs = np.random.permutation(np.arange(len(group)))[:n]
        files.extend(group[i] for i in idxs)
    return files


def render(args: Config, exp_num: int):
    assert args.load, "pass -load <PREFIX_weights.p> of a sampled experiment"
    # restore the experiment's args from the checkpoint, keeping explicit CLI
    # overrides (reference render.py:23-27 via pycasper get_args_update_dict)
    from mixstage_tpu_torch.bookkeeping import BookKeeper
    from mixstage_tpu_torch.config import get_args_update_dict

    book = BookKeeper(args, ["exp", "cpk", "speaker", "model", "note"],
                      args_dict_update=get_args_update_dict(args))
    args = book.args
    exp_dir = Path(args.load.replace("_weights.p", ""))
    assert exp_dir.exists(), f"experiment dir {exp_dir} not found"

    data = Data(args.path2data, args.speaker, args.modalities, args.fs_new,
                time=args.time, split=args.split, batch_size=args.batch_size,
                shuffle=False, window_hop=0)
    output_modality = (args.output_modalities or args.modalities[:1])[0]
    feats_shape = data.shape[output_modality][-1] // 2
    parents = data.modality_classes[output_modality].parents

    render_list = None
    if args.render_list:
        with open(args.render_list) as f:
            render_list = set(f.read().split())

    for kp_dir in sorted(exp_dir.glob("keypoints*")):
        subname = kp_dir.name.replace("keypoints", "").lstrip("_") or None
        for h5file in select_render_files(kp_dir, args.render):
            interval_id = h5file.stem
            if render_list and interval_id not in render_list:
                continue
            desc = h5file.parent.parent.name
            y_pred = HDF5.load_array(h5file.as_posix(), output_modality)
            if y_pred.ndim == 2:
                y_pred = y_pred.reshape(-1, 2, feats_shape)
            y_pred = y_pred.copy()
            y_pred[..., 0] = 0  # pin the root joint like GT (render.py:93-98)
            try:
                y_gt = HDF5.load_array(data.getPath2file(interval_id),
                                       output_modality)
                y_gt = y_gt.reshape(-1, 2, feats_shape).copy()
                y_gt[..., 0] = 0
                y_gt = y_gt[:y_pred.shape[0]]
                ys = [y_pred, y_gt]
            except (OSError, KeyError, IndexError, ValueError):  # no GT
                ys = y_pred
            # -render_text: caption the video from the ground-truth file's
            # text/meta word spans (reference render.py:101-107)
            text = None
            if args.render_text:
                from mixstage_tpu_torch.data.text import read_text_meta
                try:
                    text = read_text_meta(data.getPath2file(interval_id))
                except (OSError, KeyError, IndexError,
                        NotImplementedError):
                    text = None
            out = Path(exp_dir)
            target = (out / (f"render_{subname}" if subname else "render")
                      / desc / data.getSpeaker(interval_id)
                      / f"{interval_id}.mp4")
            if not args.clean_render and any(
                    target.with_suffix(ext).exists()
                    for ext in (".mp4", ".gif", ".avi")):
                continue
            # start=0: interval audio clips are per-interval crops, so the
            # mux seeks from 0 (reference render.py:112)
            animate(ys, interval_id, parents, out.as_posix(), desc, data,
                    0, None, None, subname, text=text)
            # prediction-only pass, rendered under render_eval*
            # (reference render.py:123-126)
            animate([y_pred], interval_id, parents, out.as_posix(), desc,
                    data, 0, None, None,
                    f"eval_{subname}" if subname else "eval", text=text)
    # style-transfer matrix pages, only when transfer dirs exist
    # (reference render.py:129-132: 'videos' + a 4-clip 'videos_subset')
    kp_names = {d.name for d in exp_dir.glob("keypoints*")}
    if kp_names - {"keypoints", "keypoints_style"}:
        page = make_html_file(exp_dir.as_posix(), args.render, "videos")
        make_html_file(exp_dir.as_posix(), 4, "videos_subset")
        print(f"HTML grid: {page}")


def main(argv=None):
    argparse_n_loop(render, argv)


if __name__ == "__main__":
    main()
