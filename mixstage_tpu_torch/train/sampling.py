"""Whole-interval sampling and cross-speaker style transfer (the port's
copy of ``mixstage_tpu/train/sampling.py``).

Iterate the per-interval datasets, run each interval as ONE batch-1
full-length sequence (the nets are fully convolutional), enumerate the
style-transfer targets (``Trainer.update_kwargs_styles``), update the
label histograms and the per-style-pair metric stacks, and dump the
predicted keypoints to ``keypoints[_name]/<split>/<speaker>/<interval>.h5``.

The window count of an interval is padded up to the next power of two by
repeating its last window, as in the JAX package, so the batch holds the
same frames in both packages; every module runs in eval mode, so the
padding changes no output frame, and it is trimmed before any metric sees
it.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from mixstage_tpu_torch.data.dataset import DataLoader
from mixstage_tpu_torch.ops.bucketing import next_pow2, pad_repeat_last
from mixstage_tpu_torch.parallel.parallel import parallel


def to_numpy(x, dtype=np.float64) -> Optional[np.ndarray]:
    """A step output (tensor on any device, in any float dtype) or array as
    a host array of ``dtype``; ``None`` stays ``None``."""
    if x is None:
        return None
    if torch.is_tensor(x):
        x = x.detach()
        x = (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x, dtype)


class _MetricWorker:
    """Runs the host-side metric cascade on a single background thread so it
    overlaps the NEXT interval's dispatch and compute on the card.

    One worker, FIFO queue → metric-update order is identical to the inline
    path, so streaming FID moments / W1 histograms / label histograms (and
    therefore the bit-determinism contract) are unchanged."""

    def __init__(self, maxsize: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._exc is not None:
                continue  # drain after failure
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                self._exc = e

    def submit(self, fn, *args, **kwargs):
        if self._exc is not None:
            self.join()
        self._q.put((fn, args, kwargs))

    def join(self):
        self._q.put(None)
        self._thread.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _flatten_windows(step_batch: Dict, pad_to: int) -> Dict:
    """(B, T, ...) windows → one (1, B*T, ...) sequence, padding the window
    count to ``pad_to`` by repeating the last window (``ops/bucketing.py``,
    the pair serving uses)."""
    out = {}
    for key, val in step_batch.items():
        if key == "x":
            out["x"] = tuple(_flatten_one(np.asarray(v), pad_to) for v in val)
        else:
            out[key] = _flatten_one(np.asarray(val), pad_to)
    return out


def _flatten_one(v: np.ndarray, pad_to: int) -> np.ndarray:
    v = pad_repeat_last(v, pad_to)
    if v.ndim == 3:
        return v.reshape(1, -1, v.shape[-1])
    return v.reshape(1, -1)


def sample_loop(trainer, desc: str):
    trainer.metrics_reset()
    datasets = trainer.data.datasets[desc].datasets
    running, running_count = {"pose": 0.0}, [1e-10]
    filenames, keys, y_outs = [], [], []
    collate_fn = trainer.data.dataLoader_kwargs.get("collate_fn")
    worker = _MetricWorker()

    def host_side(losses, y_cap, aux, pad_to, T, B, y_, insert,
                  kwargs_name, style_id, style_target, fname, flush):
        """Everything downstream of the eval step: fetch, label histogram,
        loss accumulation, metric cascade, dump batching.  Runs on the
        metric worker thread, in dispatch order."""
        trainer._update_labels(to_numpy(aux.get("labels_cap_soft")), desc,
                               style=style_id, kwargs_name=kwargs_name)
        y_cap = to_numpy(y_cap).reshape(pad_to, T, -1)[:B]
        running["pose"] += float(losses["pose"]) * B
        running_count[0] += B
        metric_kwargs = ({"style": np.asarray(style_target)}
                         if trainer.step_cfg.has_style else {})
        y_cap_out = trainer.calculate_metrics(y_cap, y_, kwargs_name,
                                              insert=insert, **metric_kwargs)
        filenames.append(fname)
        keys.append(trainer.output_modality)
        y_outs.append(y_cap_out)  # (B*T, 2, joints) raw, root-zeroed
        if flush:
            if trainer.layout.is_main:              # rank 0 writes them
                parallel(trainer.data.modality_classes[
                    trainer.output_modality].append, -1, filenames, keys,
                    y_outs)
            filenames.clear(), keys.clear(), y_outs.clear()

    len_data = len(datasets)
    for count, minidata in enumerate(datasets):
        if len(minidata) == 0:
            continue
        loader = DataLoader(minidata, batch_size=len(minidata), shuffle=False,
                            collate_fn=collate_fn)
        batch = next(iter(loader))
        step_batch, y_, insert = trainer.get_processed_batch(batch)
        step_batch = {k: (tuple(np.asarray(v) for v in val)
                          if k == "x" else np.asarray(val))
                      for k, val in step_batch.items()}
        B, T = y_.shape[0], y_.shape[1]
        pad_to = next_pow2(B)
        flat = _flatten_windows(step_batch, pad_to)

        interval_id = batch["meta"]["interval_id"][0]
        speaker = trainer.data.getSpeaker(interval_id)
        orig_style = flat.get("style")
        style_id = int(np.asarray(batch["style"]).reshape(-1)[0]) \
            if "style" in batch else 0

        for style_target, kwargs_name in trainer.update_kwargs_styles(
                orig_style if orig_style is not None else np.zeros((1, 1))):
            fb = dict(flat)
            if trainer.step_cfg.has_style:
                if isinstance(style_target, str) and style_target == "__mix__":
                    S = trainer.step_cfg.num_speakers
                    fb["style_soft"] = np.full(
                        flat["style"].shape + (S,), 1.0 / S)
                    style_target = orig_style
                fb["style"] = np.asarray(style_target, np.int32)
            # dispatch is async: the worker fetches + runs the metric math
            # while the NEXT interval's eval computes on the card
            losses, y_cap, aux = trainer.steps["eval"](
                trainer.state, fb, use_pose_input=False, sample_flag=True)
            dir_name = "keypoints" if kwargs_name is None \
                else f"keypoints_{kwargs_name}"
            fname = (Path(trainer.dir_name) / dir_name / desc
                     / speaker / f"{interval_id}.h5").as_posix()
            flush = (count + 1) % 100 == 0 or count == len_data - 1
            worker.submit(host_side, losses, y_cap, aux, pad_to, T, B, y_,
                          insert, kwargs_name, style_id, style_target, fname,
                          flush)

    worker.join()
    loss_avg = running["pose"] / running_count[0]
    if trainer.args.metrics:
        metrics, metrics_split = trainer.get_metrics(desc)
    else:
        metrics, metrics_split = {}, {}
    return loss_avg, metrics, metrics_split
