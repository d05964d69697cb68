"""Dataset and dataloader runtime (the port's copy of
``mixstage_tpu/data/dataset.py``).

``Data`` turns the master CSV into per-interval datasets and train / dev /
test loaders; ``MiniData`` windows one interval's h5 file; the samplers
(seeded 11212) pick the training windows; batches are dicts of numpy
arrays, which the train steps move to the card.  The windowing math is the
reference's (dataUtils.py:510-527): ``window = time * fs(modality)``,
subsample stride ``round(fs / fs_new)``, window starts every ``window`` (no
hop) or every ``window_hop * stride``.

``DataLoader.iter_all`` gathers each interval's windows in bulk with numpy
(the JAX package's numpy path of ``data/native.py::gather_windows``; its C++
gatherer is not ported), except where a text modality is loaded: then
``MiniData.__getitem__`` builds each window (with its text keys) and the
loader's collate pads the ragged text (``text.collate_fn_pad``), as the JAX
package does.

Text (``mixstage_tpu/data/dataset.py:162-281``): ``MiniData`` reads the
interval's ``text/meta`` word table (``text.read_text_meta``) and adds
``text/token_duration`` (the frames of each word in the window) and, with
``filler``, ``text/filler`` (1 on stopwords) to every text item;
``repeat_text=0`` keeps one row per word instead of one per frame.
"""

from __future__ import annotations

import bisect
from functools import partial
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from mixstage_tpu_torch.data.audio import Audio
from mixstage_tpu_torch.data.common import (MissingData, Modality, Table,
                                            infer_as_str)
from mixstage_tpu_torch.data.hdf5 import HDF5
from mixstage_tpu_torch.data.skeleton import Skeleton2D
from mixstage_tpu_torch.data.text import (Text, collate_fn_pad,
                                          english_stopwords, meta_columns,
                                          read_text_meta)

# the text keys the pad collate pads (dataset.py:469-473)
TEXT_PAD_KEYS = ["text/w2v", "text/bert", "text/filler", "text/tokens",
                 "text/token_duration"]


def gather_windows(data: np.ndarray, starts, steps: int,
                   stride: int) -> np.ndarray:
    """(rows, cols) + window starts → (n, steps, cols) float64 (the numpy
    path of ``mixstage_tpu/data/native.py::gather_windows``)."""
    data = np.ascontiguousarray(data, np.float64)
    starts = np.ascontiguousarray(starts, np.int64)
    idx = starts[:, None] + stride * np.arange(steps)[None, :]
    idx = np.minimum(idx, data.shape[0] - 1)
    return data[idx]

# ---------------------------------------------------------------------------
# Collate + loader
# ---------------------------------------------------------------------------


def default_collate(batch: List[Dict]) -> Dict:
    out = {}
    for key in batch[0]:
        vals = [b[key] for b in batch]
        if isinstance(vals[0], dict):
            out[key] = {k: [v[k] for v in vals] for k in vals[0]}
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = np.asarray(vals)
    return out


class DataLoader:
    """Minimal host dataloader: dataset + sampler/shuffle + collate."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 sampler=None, collate_fn=None, drop_last: bool = False,
                 seed: int = 11212):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx.tolist()

    def __iter__(self):
        indices = self._indices()
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[i] for i in chunk])

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def iter_all(self, batch_size: int = 32):
        """Sequential sweep of the whole dataset irrespective of the sampler —
        used by ZNorm/KMeans statistics (reference transform.py:200-204).

        For MiniData concatenations without text the windows of each
        interval are gathered in bulk (``gather_windows``), one batch never
        spanning two intervals, as the JAX package batches them; with text
        the items are collated in order, across intervals.
        """
        ds = self.dataset
        if (isinstance(ds, ConcatDatasetIndex) and ds.datasets
                and all(isinstance(d, MiniData) and not d.text_in_modalities
                        for d in ds.datasets)):
            yield from self._iter_all_bulk(batch_size)
            return
        for start in range(0, len(self.dataset), batch_size):
            items = [self.dataset[i]
                     for i in range(start, min(start + batch_size,
                                               len(self.dataset)))]
            yield self.collate_fn(items)

    def _iter_all_bulk(self, batch_size: int):
        for md in self.dataset.datasets:
            n = len(md)
            if n == 0:
                continue
            arrays = {}
            for i, modality in enumerate(md.modalities):
                starts = np.ascontiguousarray(
                    md.idx_start_list_dict[modality][:n], np.int64)
                stride = md.idx_interval_dict[modality]
                window = int(md.idx_end_list_dict[modality][0]
                             - md.idx_start_list_dict[modality][0])
                steps = len(range(0, window, stride))
                arrays[modality] = gather_windows(md.data[i], starts,
                                                  steps, stride)
            style = np.zeros((n, arrays[md.modalities[0]].shape[1])) + md.style
            for b0 in range(0, n, batch_size):
                batch = {m: a[b0:b0 + batch_size] for m, a in arrays.items()}
                batch["style"] = style[b0:b0 + batch_size]
                yield batch


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


class MiniData(HDF5):
    """One h5 interval file → windowed samples, whole interval in RAM
    (dataUtils.py:466-616)."""

    def __init__(self, path2h5, modalities, fs_new, time, modality_classes,
                 window_hop, style=0, repeat_text=1, text_in_modalities=False,
                 filler=0, stopwords=None, tokenizer=None):
        super().__init__()
        self.path2h5 = path2h5
        self.modalities = modalities
        self.fs_new = fs_new
        self.time = time
        self.modality_classes = modality_classes
        self.window_hop = window_hop
        self.style = style
        self.repeat_text = repeat_text
        self.text_in_modalities = text_in_modalities
        self.filler = filler
        self.stopwords = stopwords
        # a subword tokenizer (``tokenize(str) -> list``) for the filler
        # masks of bert/tokens streams; tokenising comes with item 7, so
        # ``Data`` passes None, as the JAX package's does
        self.tokenizer = tokenizer

        self.shapes, self.data = [], []
        for modality in self.modalities:
            arr = self.load_array(self.path2h5, modality)
            self.shapes.append(arr.shape)
            self.data.append(arr)

        self.text_df = read_text_meta(self.path2h5) \
            if self.text_in_modalities else None

        self.idx_start_list_dict: Dict[str, np.ndarray] = {}
        self.idx_end_list_dict: Dict[str, np.ndarray] = {}
        self.idx_interval_dict: Dict[str, int] = {}
        self.update_idx_list(self.time, self.window_hop)

    def update_idx_list(self, time, window_hop=0):
        for modality, fs_new, shape in zip(self.modalities, self.fs_new,
                                           self.shapes):
            fs = self.modality_classes[modality].fs(modality)
            window = int(time * fs)
            assert window_hop < window, \
                f"hop size {window_hop} must be less than window size {window}"
            fs_ratio = round(fs / fs_new)
            self.idx_interval_dict[modality] = fs_ratio
            if not window_hop:
                starts = np.r_[range(0, shape[0] - window, int(window))]
            else:
                starts = np.r_[range(0, shape[0] - window,
                                     int(window_hop * fs_ratio))]
            self.idx_start_list_dict[modality] = starts[:]
            self.idx_end_list_dict[modality] = starts + window

    def __len__(self):
        return min(len(self.idx_start_list_dict[m]) for m in self.modalities)

    def __getitem__(self, idx):
        item = {}
        start_time = 0.0
        for i, modality in enumerate(self.modalities):
            data = self.data[i]
            start = self.idx_start_list_dict[modality][idx]
            end = self.idx_end_list_dict[modality][idx]
            interval = self.idx_interval_dict[modality]
            item[modality] = data[start:end:interval].astype(np.float64)
            start_time = data[0:start:interval].shape[0] / self.fs_new[-1]
            if "text" in modality:
                self._text_item(item, modality, start, end, interval)

        duration = item[self.modalities[0]].shape[0] / self.fs_new[-1]
        item["meta"] = {"interval_id": Path(self.path2h5).stem,
                        "start": start_time,
                        "end": start_time + duration,
                        "idx": idx}
        item["style"] = np.zeros(item[self.modalities[0]].shape[0]) + self.style
        return item

    def _words_in(self, start, end):
        """The ``text/meta`` words that overlap frames [start, end]:
        (words, their start frames)."""
        words, starts, ends = meta_columns(self.text_df)
        sel = (start <= ends) & (end > starts)
        return [w for w, k in zip(words, sel) if k], starts[sel]

    def _text_item(self, item, modality, start, end, interval):
        """Word spans → token durations, filler masks and, with
        ``repeat_text=0``, one row per word (``dataset.py:237-281``)."""
        vec = item[modality]
        indices = [0]
        if self.text_df is None or modality == "text/tokens":
            # a new token wherever the frame's vector changes
            for t in range(1, vec.shape[0]):
                if (vec[t] - vec[indices[-1]]).sum() != 0:
                    indices.append(t)
        else:
            starts_ = self._words_in(start, end)[1] - start
            if len(starts_):
                starts_[0] = 0
                indices = list(starts_.astype(np.int64))
        if not self.repeat_text:
            item[modality] = vec[indices]

        if self.filler:
            filler = np.zeros((len(indices),))
            if self.text_df is not None and self.stopwords is not None:
                words = [w.lower() for w in self._words_in(start, end)[0]]
                if ("bert" in modality or "tokens" in modality) \
                        and self.tokenizer is not None:
                    words = self.tokenizer.tokenize(" ".join(words))
                for i, word in enumerate(words[:len(indices)]):
                    if word in self.stopwords:
                        filler[i] = 1
            if self.repeat_text:
                filler_ = np.zeros((vec.shape[0],))
                end_indices = indices[1:] + [vec.shape[0]]
                for i, (st, en) in enumerate(zip(indices, end_indices)):
                    filler_[st:en] = filler[i]
                filler = filler_
            item["text/filler"] = filler

        indices_arr = np.array(indices, dtype=np.int64)
        length_word = np.zeros_like(indices_arr)
        length_word[:-1] = indices_arr[1:] - indices_arr[:-1]
        duration = (end - start) / interval
        length_word[-1] = duration - indices_arr[-1]
        item["text/token_duration"] = length_word


class ConcatDatasetIndex:
    """Concatenate datasets; inject the global sample index as batch['idx']
    (dataUtils.py:695-712) for per-sample weighting."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        dataset_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if dataset_idx == 0 else \
            idx - self.cumulative_sizes[dataset_idx - 1]
        batch = self.datasets[dataset_idx][sample_idx]
        if isinstance(batch, dict):
            batch["idx"] = idx
        return batch


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


class AlternateClassSampler:
    """Round-robin uniform sampling per speaker — the batch interleaves
    speakers, load-bearing for style losses (dataUtils.py:657-673)."""

    def __init__(self, class_count, num_samples, seed=11212):
        self.num_samples_per_class = num_samples // len(class_count)
        self.num_samples = self.num_samples_per_class * len(class_count)
        self.class_count = class_count
        self.starts, self.ends = [0], []
        for counts in class_count:
            self.starts.append(self.starts[-1] + counts)
            self.ends.append(self.starts[-1])
        self.starts = self.starts[:-1]
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        cols = [self._rng.integers(s, e, size=self.num_samples_per_class)
                for s, e in zip(self.starts, self.ends)]
        return iter(np.stack(cols, axis=1).reshape(-1).tolist())

    def __len__(self):
        return self.num_samples


class BalanceClassSampler:
    """Uniform over velocity-quantile classes (dataUtils.py:675-693)."""

    def __init__(self, classes, num_samples, seed=11212):
        self.classes = [np.asarray(c) for c in classes if len(c) > 0]
        self.num_samples_per_class = num_samples // len(self.classes)
        self.num_samples = self.num_samples_per_class * len(self.classes)
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        cols = [c[self._rng.integers(0, len(c), size=self.num_samples_per_class)]
                for c in self.classes]
        return iter(np.stack(cols, axis=1).reshape(-1).tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler:
    def __init__(self, indices, seed=11212):
        self.indices = np.asarray(indices)
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self._rng.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler:
    """Replacement sampling ∝ mutable ``weights`` (feeds the weighted-GAN
    loop, reference trainer.py:502-520)."""

    def __init__(self, weights, num_samples, seed=11212):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        w = np.maximum(self.weights, 0)
        p = w / w.sum() if w.sum() > 0 else None
        return iter(self._rng.choice(len(self.weights), size=self.num_samples,
                                     replace=True, p=p).tolist())

    def __len__(self):
        return self.num_samples


class RandomSampler:
    def __init__(self, data_len, num_samples=None, replacement=False, seed=11212):
        self.data_len = data_len
        self.num_samples = num_samples or data_len
        self.replacement = replacement
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        if self.replacement:
            return iter(self._rng.integers(0, self.data_len,
                                           size=self.num_samples).tolist())
        return iter(self._rng.permutation(self.data_len)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


# ---------------------------------------------------------------------------
# Master data wrapper
# ---------------------------------------------------------------------------


class Data(Modality):
    """Master wrapper: csv table → interval datasets → train/dev/test loaders
    (dataUtils.py:51-464)."""

    def __init__(self, path2data, speaker,
                 modalities=("pose/data", "audio/log_mel_512"),
                 fs_new=(15, 15), time=4.3, split=None, batch_size=100,
                 shuffle=True, num_workers=0, window_hop=0, load_data=True,
                 style_iters=0, num_training_sample=None, sample_all_styles=0,
                 repeat_text=1, quantile_sample=None,
                 quantile_num_training_sample=None, weighted=0, filler=0,
                 num_training_iters=None):
        super().__init__(path2data=path2data)
        self.path2data = path2data
        self.speaker = [speaker] if isinstance(speaker, str) else list(speaker)
        self.modalities = list(modalities)
        self.fs_new = list(fs_new)
        self.time = time
        self.split = split
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.window_hop = window_hop
        self.load_data = load_data
        self.style_iters = style_iters
        self.num_training_sample = num_training_sample
        self.sample_all_styles = sample_all_styles
        self.quantile_sample = quantile_sample
        self.quantile_num_training_sample = quantile_num_training_sample
        self.repeat_text = repeat_text
        self.weighted = weighted
        self.filler = filler
        self.num_training_iters = num_training_iters
        self.stopwords, self.tokenizer = None, None
        if self.filler:
            self.stopwords = english_stopwords()
        self.text_in_modalities = any("text" in m for m in self.modalities)
        self.missing = MissingData(self.path2data)

        self.modality_classes = self._load_modality_classes()

        # master table (+ mirrored evil twins, dataUtils.py:133-135)
        # (pandas infers each CSV's column types, then casts the ids to str)
        tables = [Table.read_csv(Path(self.path2data) / "cmu_intervals_df.csv")]
        twins = Path(self.path2data) / "cmu_intervals_df_transforms.csv"
        if twins.exists():
            tables.append(Table.read_csv(twins))
        for t in tables:
            t["interval_id"] = infer_as_str(t["interval_id"])
        self.df = Table.concat(tables)

        if self.speaker[0] == "all":
            self.speaker = self.speakers
        self.df = self.get_df_subset("speaker", self.speaker)
        assert len(self.df), f"speaker `{speaker}` not found"
        self.style_dict = {sp: i for i, sp in enumerate(self.speaker)}

        self.datasets = self.tdt_split()
        self.dataLoader_kwargs = {"batch_size": batch_size, "shuffle": shuffle}
        if self.text_in_modalities:
            self.dataLoader_kwargs["collate_fn"] = partial(
                collate_fn_pad, pad_key=TEXT_PAD_KEYS, dim=0)
        self.update_dataloaders(time, window_hop)

    # ------------------------------------------------------------------ maps
    def _load_modality_classes(self):
        out = {}
        for modality in self.modalities:
            out[modality] = self.mod_map(modality.split("/")[0])
        return out

    def mod_map(self, mod):
        cls = {"pose": Skeleton2D, "audio": Audio, "text": Text}[mod]
        return cls(path2data=self.path2data, speaker=self.speaker)

    def getSpeaker(self, interval_id):
        return self.get_df_subset("interval_id", interval_id)["speaker"][0]

    def getPath2file(self, interval_id):
        return (Path(self.path2data) / "processed" / self.getSpeaker(interval_id)
                / str(interval_id)).as_posix() + ".h5"

    def getStyle(self, interval_id):
        speaker = self.get_df_subset("interval_id", interval_id)["speaker"][0]
        return self.style_dict[speaker]

    def load(self, path2h5, key):
        return HDF5.load(path2h5, key)

    # ------------------------------------------------------------------ split
    def get_transforms_missing_intervals(self, missing_intervals):
        transforms = sorted({sp.split("|")[-1] for sp in self.speaker
                             if "|" in sp})
        new = {f"{interval}|{t}" for t in transforms
               for interval in missing_intervals}
        missing_intervals.update(new)
        return missing_intervals

    def order_intervals(self, intervals):
        interval_dict = {sp: [] for sp in self.style_dict}
        for interval in intervals:
            interval_dict[self.getSpeaker(interval)].append(interval)
        intervals_dict = [(k, interval_dict[k]) for k in interval_dict]
        ordered = [iv for _, ivs in intervals_dict for iv in ivs]
        return intervals_dict, ordered

    @property
    def minidataKwargs(self):
        return {"modalities": self.modalities, "fs_new": self.fs_new,
                "time": self.time, "modality_classes": self.modality_classes,
                "window_hop": self.window_hop, "repeat_text": self.repeat_text,
                "text_in_modalities": self.text_in_modalities,
                "filler": self.filler, "stopwords": self.stopwords,
                "tokenizer": self.tokenizer}

    def get_minidata_list(self, intervals):
        return [MiniData(self.getPath2file(i), style=self.getStyle(i),
                         **self.minidataKwargs) for i in intervals]

    def tdt_split(self):
        if not self.split:
            df_train = self.get_df_subset("dataset", "train")
            df_dev = self.get_df_subset("dataset", "dev")
            df_test = self.get_df_subset("dataset", "test")
        else:
            length = len(self.df)
            end_train = int(length * self.split[0])
            end_dev = int(end_train + length * self.split[1])
            df_train = self.df.rows(slice(None, end_train))
            df_dev = self.df.rows(slice(end_train, end_dev))
            df_test = self.df.rows(slice(end_dev, None))

        missing = self.missing.load_intervals()
        missing = self.get_transforms_missing_intervals(missing)
        get_intervals = lambda df: sorted(set(df.unique("interval_id")) - missing)
        train_intervals = get_intervals(df_train)
        dev_intervals = get_intervals(df_dev)
        test_intervals = get_intervals(df_test)

        self.train_intervals_all = train_intervals
        self.dev_intervals_all = dev_intervals
        self.test_intervals_all = test_intervals

        if not self.load_data:  # just enough data to derive shapes
            train_intervals = train_intervals[:10]
            dev_intervals = dev_intervals[:10]
            test_intervals = test_intervals[:10]

        (train_intervals, dev_intervals, test_intervals,
         train_intervals_dict) = self.update_intervals(
             train_intervals, dev_intervals, test_intervals)
        self.train_intervals = train_intervals
        self.dev_intervals = dev_intervals
        self.test_intervals = test_intervals

        dataset_train = ConcatDatasetIndex(self.get_minidata_list(train_intervals))
        dataset_dev = ConcatDatasetIndex(self.get_minidata_list(dev_intervals))
        dataset_test = ConcatDatasetIndex(self.get_minidata_list(test_intervals))
        self.dataset_train = dataset_train
        self.train_intervals_dict = train_intervals_dict
        self.train_sampler = self.get_train_sampler(dataset_train,
                                                    train_intervals_dict)
        return {"train": dataset_train, "dev": dataset_dev,
                "test": dataset_test}

    def update_intervals(self, train_intervals, dev_intervals, test_intervals):
        def subsample(x):
            temp = []
            for _, ivs in x:
                if self.sample_all_styles > 0:
                    temp.extend(ivs[:self.sample_all_styles])
                elif self.sample_all_styles == -1:
                    temp.extend(ivs)
            return temp

        if self.sample_all_styles != 0:
            train_dict, train_intervals = self.order_intervals(train_intervals)
            dev_dict, dev_intervals = self.order_intervals(dev_intervals)
            test_dict, test_intervals = self.order_intervals(test_intervals)
            train_intervals = subsample(train_dict)
            dev_intervals = subsample(dev_dict)
            test_intervals = subsample(test_dict)
        elif self.style_iters > 0:
            train_dict, train_intervals = self.order_intervals(train_intervals)
        else:
            train_dict = None
        return train_intervals, dev_intervals, test_intervals, train_dict

    def update_dataloaders(self, time, window_hop):
        for key in self.datasets:
            for d_ in self.datasets[key].datasets:
                d_.update_idx_list(time, window_hop)
        train_kwargs = dict(self.dataLoader_kwargs)
        if self.train_sampler:
            train_kwargs["shuffle"] = False
            train_kwargs["sampler"] = self.train_sampler
        self.train = DataLoader(ConcatDatasetIndex(self.datasets["train"].datasets),
                                **train_kwargs)
        self.dev = DataLoader(ConcatDatasetIndex(self.datasets["dev"].datasets),
                              **self.dataLoader_kwargs)
        self.test = DataLoader(ConcatDatasetIndex(self.datasets["test"].datasets),
                               **self.dataLoader_kwargs)

    # --------------------------------------------------------------- samplers
    def get_alternate_class_sampler(self, dataset, intervals_dict, num_samples):
        class_count, interval_offset = [], 0
        for _, ivs in intervals_dict:
            count = sum(len(dataset.datasets[i + interval_offset])
                        for i in range(len(ivs)))
            class_count.append(count)
            interval_offset += len(ivs)
        return AlternateClassSampler(class_count, num_samples * self.batch_size)

    def get_quantile_sample(self, loader, q):
        """Velocity-quantile training subsets (dataUtils.py:353-421)."""
        pose_modality = next((k for k in self.modalities if "pose" in k), None)
        assert pose_modality is not None, "can't find pose modality"
        if isinstance(q, (int, float)):
            if q < 1:
                kind = "above"
            elif q > 1:
                kind, q = "rebalance", int(q)
            else:
                raise ValueError("q can't be 1 or negative")
        else:
            assert len(q) == 2 and all(0 <= q_ <= 1 for q_ in q)
            kind = "tail"

        def vel(pose):
            pose = pose.reshape(pose.shape[0], 2, -1).transpose(0, 2, 1)
            d = pose[1:, 1:] - pose[:-1, 1:]
            return np.sqrt((d ** 2).sum(-1)).mean()

        samples = [vel(np.asarray(loader.dataset[i][pose_modality]))
                   for i in range(len(loader.dataset))]
        samples = np.array(samples, dtype=np.float64)
        if kind == "above":
            v0 = np.quantile(samples, q)
            subset_idx = [i for i, v in enumerate(samples) if v > v0]
        elif kind == "tail":
            v0 = [np.quantile(samples, q[0]), np.quantile(samples, q[1])]
            subset_idx = [i for i, v in enumerate(samples)
                          if v > v0[1] or v < v0[0]]
        else:  # rebalance
            lo, hi = samples.min(), samples.max()
            v0 = np.arange(lo, hi + 1e-5, (hi - lo) / q)
            subset_idx = [[] for _ in range(len(v0) - 1)]
            for i, v in enumerate(samples):
                j = int(np.clip(np.searchsorted(v0, v, side="right") - 1, 0,
                                len(v0) - 2))
                subset_idx[j].append(i)
        return subset_idx, kind

    def get_train_sampler(self, dataset_train, train_intervals_dict):
        if self.style_iters > 0 and self.sample_all_styles == 0:
            return self.get_alternate_class_sampler(
                dataset_train, train_intervals_dict, self.style_iters)
        if self.num_training_sample is not None:
            perm = np.random.default_rng(11212).permutation(len(dataset_train))
            return SubsetRandomSampler(perm[:self.num_training_sample])
        if self.quantile_sample is not None:
            loader = DataLoader(dataset_train, batch_size=1)
            subset_idx, kind = self.get_quantile_sample(loader,
                                                        self.quantile_sample)
            if kind in ("above", "tail"):
                return SubsetRandomSampler(subset_idx)
            if self.quantile_num_training_sample is not None:
                return BalanceClassSampler(
                    subset_idx,
                    int(self.quantile_num_training_sample) * self.batch_size)
        if self.weighted:
            return WeightedRandomSampler([1.0] * len(dataset_train),
                                         self.weighted * self.batch_size)
        if self.num_training_iters is not None:
            return RandomSampler(len(dataset_train),
                                 self.num_training_iters * self.batch_size,
                                 replacement=True)
        return RandomSampler(len(dataset_train))

    # ------------------------------------------------------------------ shape
    @property
    def shape(self):
        minidata = None
        for md in self.train.dataset.datasets:
            if len(md) > 0:
                minidata = md
                break
        assert minidata is not None, "no non-empty interval found"
        shape = {}
        for modality, feats_shape in zip(self.modalities, minidata.shapes):
            start = minidata.idx_start_list_dict[modality][0]
            end = minidata.idx_end_list_dict[modality][0]
            interval = minidata.idx_interval_dict[modality]
            length = len(range(start, end, interval))
            shape[modality] = [length, feats_shape[-1]]
        return shape


class DataSample(Data):
    """Data variant whose h5 files are an experiment's *predicted* keypoints
    (reference ``DataSample``, dataUtils.py:618-655) — used to render/evaluate
    saved samples from a view directory."""

    def __init__(self, path2data, speaker, view=None, **kwargs):
        self.view = view
        super().__init__(path2data, speaker, **kwargs)

    def get_tdt(self, interval_id):
        return self.get_df_subset("interval_id", interval_id)["dataset"][0]

    def getPath2file(self, interval_id):
        return (Path(self.view) / "keypoints" / self.get_tdt(interval_id)
                / self.getSpeaker(interval_id)
                / str(interval_id)).as_posix() + ".h5"

    def get_minidata_list(self, intervals):
        import os

        existing = [i for i in intervals
                    if os.path.exists(self.getPath2file(i))]
        return [MiniData(self.getPath2file(i), style=self.getStyle(i),
                         **self.minidataKwargs) for i in existing]

