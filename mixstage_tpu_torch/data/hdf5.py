"""HDF5 storage layer (the port's copy of ``mixstage_tpu/data/hdf5.py``).

Create-or-append CRUD on h5 files with the PATS dataset-key conventions,
so preprocessed PATS h5 files and the ``preprocessing/{muvar,kmeans}``
caches written by either package are read by the other.  ``h5py`` is
imported when a file is opened, not when the module is: the serving path
imports the data package and runs where ``h5py`` is absent.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np


class HDF5:
    @staticmethod
    def h5_open(filename, mode):
        import h5py

        os.makedirs(Path(filename).parent, exist_ok=True)
        return h5py.File(filename, mode)

    @staticmethod
    def h5_close(h5):
        h5.close()

    @staticmethod
    def append(filename, key, data):
        """Create file if needed; create-or-replace dataset at key."""
        h5 = HDF5.h5_open(filename, "a")
        try:
            HDF5.update_dataset(h5, key, data)
        except Exception:
            warnings.warn(f"could not update dataset {key} in {filename}")
        finally:
            h5.close()

    @staticmethod
    def load(filename, key):
        """Return (dataset, open_file); caller closes the file."""
        h5 = HDF5.h5_open(filename, "r")
        return h5[key], h5

    @staticmethod
    def load_array(filename, key) -> np.ndarray:
        """Convenience: load a dataset fully into memory and close the file."""
        data, h5 = HDF5.load(filename, key)
        arr = np.asarray(data[()])
        h5.close()
        return arr

    @staticmethod
    def isDatasetInFile(filename, key) -> bool:
        if not os.path.exists(filename):
            return False
        with HDF5.h5_open(filename, "r") as h5:
            return key in h5

    @staticmethod
    def add_dataset(h5, key, data, exist_ok=False):
        if key in h5:
            if exist_ok:
                del h5[key]
                h5.create_dataset(key, data=data)
            else:
                warnings.warn(f"dataset {key} already exists. Skipping...")
        else:
            h5.create_dataset(key, data=data)

    @staticmethod
    def update_dataset(h5, key, data):
        HDF5.add_dataset(h5, key, data, exist_ok=True)

    @staticmethod
    def del_dataset(h5, key) -> bool:
        if key in h5:
            del h5[key]
            return True
        warnings.warn("Key not found. Skipping...")
        return False

    @staticmethod
    def add_key(base_key, sub_keys=()):
        if isinstance(sub_keys, str):
            sub_keys = [sub_keys]
        return (Path(base_key) / Path("/".join(sub_keys))).as_posix()
