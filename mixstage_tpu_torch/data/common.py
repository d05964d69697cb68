"""Dataset registry, the master-CSV table and the missing-interval ledger.

The port's copy of ``mixstage_tpu/data/common.py``: ``Modality`` (the
master CSV and the 25-speaker PATS registry) and ``MissingData`` (the
persistent ledger of intervals that failed preprocessing).  The JAX package
reads ``cmu_intervals_df.csv`` with pandas; the port reads it with the
standard ``csv`` module into ``Table``, a small column table that does what
the data layer asks of a data frame: row subsets, ``isin``, unique values,
the twin-CSV concatenation and the two column casts.
"""

from __future__ import annotations

import csv
import os
import re
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mixstage_tpu_torch.data.hdf5 import HDF5

# PATS speaker registry (reference common.py:152-179)
SPEAKERS: List[str] = [
    "oliver", "jon", "conan", "rock", "chemistry", "ellen", "almaram",
    "angelica", "seth", "shelly", "colbert", "corden", "fallon", "huckabee",
    "maher", "lec_cosmic", "lec_evol", "lec_hist", "lec_law", "minhaj",
    "ytch_charisma", "ytch_dating", "ytch_prof", "bee", "noah",
]

_INT = re.compile(r"^\s*[+-]?\d+\s*$")


class Table:
    """Named columns of equal length, each a numpy object array of the
    CSV's strings (or of what a cast made of them)."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = {k: np.asarray(v, dtype=object)
                        for k, v in columns.items()}
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length {sorted(lengths)}")

    @classmethod
    def read_csv(cls, path) -> "Table":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        return cls({name: np.array([r[i] if i < len(r) else ""
                                    for r in body], dtype=object)
                    for i, name in enumerate(header)})

    @classmethod
    def concat(cls, tables: Sequence["Table"]) -> "Table":
        """Rows of every table in order; a column one table lacks is empty
        there (``pd.concat(..., ignore_index=True)``)."""
        names: List[str] = []
        for t in tables:
            names += [n for n in t.columns if n not in names]
        return cls({n: np.concatenate([
            t.columns[n] if n in t.columns
            else np.full(len(t), "", dtype=object) for t in tables])
            for n in names})

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, column: str) -> np.ndarray:
        return self.columns[column]

    def __setitem__(self, column: str, values) -> None:
        self.columns[column] = np.asarray(values, dtype=object)

    def rows(self, index) -> "Table":
        """The rows selected by a boolean mask, an index array or a
        slice."""
        return Table({k: v[index] for k, v in self.columns.items()})

    def isin(self, column: str, values) -> np.ndarray:
        wanted = set(values)
        return np.array([v in wanted for v in self.columns[column]],
                        dtype=bool)

    def unique(self, column: str) -> list:
        """Distinct values in order of first appearance."""
        return list(dict.fromkeys(self.columns[column].tolist()))


def infer_as_str(values) -> np.ndarray:
    """A column as pandas would infer its type on ``read_csv`` and then
    cast it to ``str``: all integers → ``str(int)`` (leading zeros and signs
    dropped), all floats → ``str(float)``, otherwise the strings as read."""
    vals = [str(v) for v in values]
    if vals and all(_INT.match(v) for v in vals):
        return np.array([str(int(v)) for v in vals], dtype=object)
    try:
        floats = [float(v) for v in vals]
    except ValueError:
        return np.array(vals, dtype=object)
    return np.array([str(v) for v in floats], dtype=object)


class Modality(HDF5):
    """Base class for a preprocessed modality rooted at ``path2data``."""

    def __init__(self, path2data="../dataset/groot/data",
                 path2outdata="../dataset/groot/data", speaker="all",
                 preprocess_methods=("log_mel_512",)):
        super().__init__()
        self.path2data = path2data
        self.path2outdata = path2outdata
        self.speaker = speaker
        self.preprocess_methods = list(preprocess_methods)
        csv_path = Path(self.path2data) / "cmu_intervals_df.csv"
        if csv_path.exists():
            # every column as read (pandas dtype=object), then the casts
            self.df = Table.read_csv(csv_path)
            self.df["delta_time"] = [float(v) for v in self.df["delta_time"]]
            self.df["interval_id"] = [str(v) for v in self.df["interval_id"]]
        else:
            self.df = None

    def preprocess(self):
        raise NotImplementedError

    def get_df_subset(self, column, value) -> Table:
        if isinstance(value, list):
            return self.df.rows(self.df.isin(column, value))
        return self.df.rows(self.df[column] == value)

    @property
    def speakers(self):
        return list(SPEAKERS)


class MissingData(HDF5):
    """Persistent set of interval ids that failed preprocessing."""

    def __init__(self, path2data):
        super().__init__()
        self.path2file = Path(path2data) / "missing_intervals.h5"
        if not os.path.exists(self.path2file):
            self.h5_close(self.h5_open(self.path2file, "a"))
        self.key = "intervals"
        self.missing_data_list: List[Optional[str]] = []

    def append_interval(self, data):
        self.missing_data_list.append(data)
        warnings.warn(f"interval_id: {data} not found.")

    def save_intervals(self, missing_data_list):
        """Merge new missing ids into the ledger."""
        import h5py

        dt = h5py.special_dtype(vlen=str)
        new = set(missing_data_list) - {None}
        intervals = self.load_intervals() | new
        HDF5.append(self.path2file, self.key,
                    np.array(sorted(intervals), dtype=dt))

    def save(self, missing_data_list):
        import h5py

        dt = h5py.special_dtype(vlen=str)
        HDF5.append(self.path2file, self.key,
                    np.array(sorted(set(missing_data_list) - {None}), dtype=dt))

    def load_intervals(self) -> set:
        if HDF5.isDatasetInFile(self.path2file, self.key):
            arr = HDF5.load_array(self.path2file, self.key)
            return {x.decode() if isinstance(x, bytes) else str(x) for x in arr}
        return set()
