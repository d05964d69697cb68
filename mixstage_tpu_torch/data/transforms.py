"""Invertible, disk-cached data transforms (the port's copy of
``mixstage_tpu/data/transforms.py``).

``Compose``, ``ZNorm``, ``KMeansTransform``, ``Relative2Parent`` and
``RemoveJoints`` on numpy batches, on the host.  The h5 cache layouts
(muvar, and the k-means centres under the reference's exact key format)
are those of the JAX package, so either package reads the statistics the
other wrote.  The JAX package fits the centres with scikit-learn's
``MiniBatchKMeans`` (unseeded); the port fits them with its own mini-batch
k-means (``minibatch_kmeans``), seeded, over the same pass of
``iter_all(batch_size=32)``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mixstage_tpu_torch.data.hdf5 import HDF5


def remove_slices(x: np.ndarray, mask: Sequence[int], axis: int = -1):
    """Drop indices ``mask`` along ``axis``; return (kept, removed).

    Equivalent of ``pycasper.torchUtils.remove_slices`` used at
    transform.py:499."""
    axis = axis % x.ndim
    n = x.shape[axis]
    keep = sorted(set(range(n)) - set(mask))
    removed = np.take(x, list(mask), axis=axis)
    kept = np.take(x, keep, axis=axis)
    return kept, removed


def add_slices(x: np.ndarray, insert: np.ndarray, mask: Sequence[int],
               axis: int = -1) -> np.ndarray:
    """Inverse of :func:`remove_slices` (pycasper ``add_slices``,
    transform.py:484-487)."""
    axis = axis % x.ndim
    n = x.shape[axis] + len(mask)
    keep = sorted(set(range(n)) - set(mask))
    shape = list(x.shape)
    shape[axis] = n
    out = np.empty(shape, dtype=x.dtype)
    idx = [slice(None)] * x.ndim
    for j, k in enumerate(keep):
        idx[axis] = k
        out[tuple(idx)] = np.take(x, j, axis=axis)
    for j, m in enumerate(mask):
        idx[axis] = m
        out[tuple(idx)] = np.take(insert, j, axis=axis)
    return out


class Compose:
    """Compose transforms; ``inv=True`` applies inverses in reverse order
    (transform.py:50-96)."""

    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, batch, inv: bool = False, **kwargs):
        ts = self.transforms if not inv else self.transforms[::-1]
        for t in ts:
            batch = t(batch, inv=inv, **kwargs)
        return batch

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{self.__class__.__name__}(\n{inner}\n)"


class ZNorm:
    """Z-normalization with streaming mean/var over the train set, disk-cached
    at ``savepath/<key>.h5`` under ``<variable>/{mean,var}`` (transform.py:99-244)."""

    def __init__(self, variable_list=(), savepath="./preprocessing/muvar",
                 key="key", data=None, num_dims: int = 2, verbose=True,
                 relative2parent=0, pre=None, eps: float = 1e-8):
        os.makedirs(savepath, exist_ok=True)
        self.variable_list = list(variable_list)
        self.savepath = savepath
        self.key = "_".join(key) if isinstance(key, list) else key
        self.data = data
        self.relative2parent = relative2parent
        self.pre = pre
        self.eps = eps
        self.hdf5 = HDF5()
        self.variable_dict: Dict[str, List[np.ndarray]] = {}

        suffix = "_relative2parent.h5" if relative2parent else ".h5"
        path2file = Path(savepath) / (self.key + suffix)
        for variable in self.variable_list:
            muvar = self._loadfile(path2file, variable)
            if muvar is None:
                if verbose:
                    print(f"Calculating Mean-Variance for {variable}")
                muvar = self._cal_muvar(path2file, variable, num_dims)
            elif verbose:
                print(f"Loading Mean-Variance for {variable}")
            self.variable_dict[variable] = muvar

    def _loadfile(self, path2file, variable):
        if not self.hdf5.isDatasetInFile(path2file, variable):
            return None
        mu = self.hdf5.load_array(path2file, self.hdf5.add_key(variable, ["mean"]))
        var = self.hdf5.load_array(path2file, self.hdf5.add_key(variable, ["var"]))
        return [np.asarray(mu, np.float64), np.asarray(var, np.float64)]

    def _cal_muvar(self, path2file, variable, num_dims):
        """Streaming E[x], E[x^2] over the full dataset (transform.py:196-219)."""
        assert self.data is not None, "ZNorm needs `data` to compute statistics"
        mean, energy, count = 0.0, 0.0, 0
        for batch in self.data.iter_all(batch_size=32):
            b = batch[variable] if self.pre is None else self.pre(batch)[variable]
            b = np.asarray(b, np.float64)
            dims = tuple(range(num_dims))
            mean = mean + b.sum(axis=dims, keepdims=True)
            energy = energy + (b ** 2).sum(axis=dims, keepdims=True)
            count += int(np.prod(np.array(b.shape)[list(dims)]))
        mean = mean / count
        var = energy / count - mean ** 2
        muvar = [mean, var]
        self.hdf5.append(path2file, self.hdf5.add_key(variable, ["mean"]), mean)
        self.hdf5.append(path2file, self.hdf5.add_key(variable, ["var"]), var)
        return muvar

    def znorm(self, x, muvar):
        mu, var = muvar
        std = np.sqrt(var * (var >= 0))
        std = np.where(std == 0, self.eps, std)
        # multiply by the reciprocal: one fewer full-batch division on the
        # hot host path (std is a (1, 1, F) vector; x is the whole batch)
        return (x - mu) * (1.0 / std)

    def inv_znorm(self, x, muvar):
        mu, var = muvar
        return x * np.sqrt(np.maximum(var, 0)) + mu

    def __call__(self, batch, inv: bool = False, **kwargs):
        out = {}
        for variable in batch:
            if variable in self.variable_dict:
                fn = self.inv_znorm if inv else self.znorm
                out[variable] = fn(np.asarray(batch[variable]),
                                   self.variable_dict[variable])
            else:
                out[variable] = batch[variable]
        return out

    def __repr__(self):
        return f"ZNorm(variable_list={self.variable_list}, key={self.key})"


class MiniBatchKMeans:
    """Mini-batch k-means, one ``partial_fit`` per batch, as
    scikit-learn's ``MiniBatchKMeans.partial_fit`` runs it: the first batch
    seeds the centres by greedy k-means++ (2 + ⌊ln k⌋ candidates a centre),
    then each batch assigns its points to the nearest centre and moves each
    centre to the running mean of every point ever assigned to it.  Seeded:
    the same batches give the same centres."""

    def __init__(self, n_clusters: int, seed: int = 11212):
        self.n_clusters = n_clusters
        self._rng = np.random.default_rng(seed)
        self.cluster_centers_: Optional[np.ndarray] = None
        self._counts: Optional[np.ndarray] = None

    @staticmethod
    def _sq_dist(x: np.ndarray, c: np.ndarray) -> np.ndarray:
        d = (x ** 2).sum(-1)[:, None] - 2.0 * x @ c.T + (c ** 2).sum(-1)[None]
        return np.maximum(d, 0.0)

    def _kmeans_pp(self, x: np.ndarray) -> np.ndarray:
        k, n = self.n_clusters, x.shape[0]
        trials = 2 + int(np.log(k))
        centers = [x[self._rng.integers(n)]]
        closest = self._sq_dist(x, centers[0][None])[:, 0]
        for _ in range(1, k):
            total = closest.sum()
            if total <= 0:                       # fewer distinct points
                centers.append(x[self._rng.integers(n)])
                continue
            cand = np.searchsorted(np.cumsum(closest),
                                   self._rng.random(trials) * total)
            cand = np.minimum(cand, n - 1)
            d = np.minimum(closest[None], self._sq_dist(x, x[cand]).T)
            best = int(np.argmin(d.sum(-1)))
            centers.append(x[cand[best]])
            closest = d[best]
        return np.stack(centers)

    def partial_fit(self, x: np.ndarray) -> "MiniBatchKMeans":
        x = np.asarray(x, np.float64)
        if self.cluster_centers_ is None:
            self.cluster_centers_ = self._kmeans_pp(x)
            self._counts = np.zeros(self.n_clusters)
        labels = self._sq_dist(x, self.cluster_centers_).argmin(-1)
        for j in np.unique(labels):
            pts = x[labels == j]
            new = self._counts[j] + len(pts)
            self.cluster_centers_[j] = (self.cluster_centers_[j]
                                        * (self._counts[j] / new)
                                        + pts.sum(0) / new)
            self._counts[j] = new
        return self

    def inertia(self, x: np.ndarray) -> float:
        """Sum of squared distances of ``x`` to their nearest centres."""
        x = np.asarray(x, np.float64)
        return float(self._sq_dist(x, self.cluster_centers_).min(-1).sum())


class KMeansTransform:
    """MiniBatch-KMeans pose clustering with disk-cached centers.

    Cache key format matches the reference exactly (transform.py:320-327):
    ``centers/{M}_{feat...}_{mask...}_{variable with '/'→'_'}`` inside
    ``savepath/<key>.h5``, so shipped center files are reusable.  ``seed``
    seeds the fit when no centres are cached.
    """

    def __init__(self, variable_list=(), savepath="./preprocessing/kmeans",
                 key="key", data=None, num_clusters=8, mask=(0, 7, 8, 9),
                 feats=("pose", "velocity"), verbose=True, seed=11212):
        os.makedirs(savepath, exist_ok=True)
        self.variable_list = list(variable_list)
        self.variable = self.variable_list[0]
        self.key = "_".join(key) if isinstance(key, list) else key
        self.data = data
        self.num_clusters = num_clusters
        self.mask = list(mask)
        self.remove_joints = RemoveJoints(self.mask)
        self.feats = list(feats)
        self.seed = seed
        self.hdf5 = HDF5()

        # muvar needed by the 'spatial' feature (transform.py:308-309);
        # cached as a sibling of the kmeans dir (preprocessing/{muvar,kmeans})
        muvar_path = (Path(savepath).parent / "muvar").as_posix()
        pre = ZNorm(self.variable_list, savepath=muvar_path, key=key,
                    data=data, verbose=False)
        self.variable_dict = pre.variable_dict
        self.output_modality = None
        for var in self.variable_list:
            if var in ("pose/data", "pose/normalize"):
                self.output_modality = var
                break
        if self.output_modality is None:
            raise ValueError("pose variable not found in variable_list")

        path2file = Path(savepath) / (self.key + ".h5")
        key_name = "centers/{}".format(self.num_clusters)
        key_name += ("_{}" * len(self.feats)).format(*self.feats)
        key_name += ("_{}" * len(self.mask)).format(*self.mask)
        key_name += "_{}".format("_".join(self.variable.split("/")))

        if self.hdf5.isDatasetInFile(path2file, key_name):
            if verbose:
                print(f"Loading KMeans model for {self.key}/{key_name}")
            self.centers = self.hdf5.load_array(path2file, key_name)
        else:
            if verbose:
                print(f"Calculating KMeans model for {self.key}/{key_name}")
            self.centers = self._fit()
            self.hdf5.append(path2file, key_name, self.centers)
        self.centers = np.asarray(self.centers, np.float64)

    def get_feats(self, x: np.ndarray) -> np.ndarray:
        """Feature construction per configured kinds (transform.py:352-379).

        Each feature block is written straight into one preallocated output
        (no zero-fill pass, no concatenate copy) — this runs per batch on
        the host hot path."""
        F = x.shape[-1]
        widths = [F // 2 if f == "speed" else F for f in self.feats]
        out = np.empty(x.shape[:-1] + (sum(widths),), x.dtype)
        ofs = 0
        for feat, w in zip(self.feats, widths):
            dst = out[..., ofs:ofs + w]
            ofs += w
            if feat == "pose":
                dst[...] = x
            elif feat == "velocity":
                dst[:, :1] = 0
                np.subtract(x[:, 1:], x[:, :-1], out=dst[:, 1:])
            elif feat == "speed":
                v = np.zeros_like(x)
                v[:, 1:, :] = x[:, 1:] - x[:, :-1]
                v = v.reshape(v.shape[0], v.shape[1], 2, -1)
                dst[...] = np.sqrt((v ** 2).sum(axis=-2))
            elif feat == "acceleration":
                # a[1] = v[1] - v[0] = v[1]; a[t>=2] = x[t] - 2x[t-1] + x[t-2]
                dst[:, :1] = 0
                np.subtract(x[:, 1:], x[:, :-1], out=dst[:, 1:])
                dst[:, 2:] -= dst[:, 1:-1].copy()
            elif feat == "spatial":
                mean = self.variable_dict[self.output_modality][0][:, :, 8:]
                np.subtract(x, mean, out=dst)
        return out

    def _fit(self) -> np.ndarray:
        assert self.data is not None
        model = MiniBatchKMeans(self.num_clusters, seed=self.seed)
        for batch in self.data.iter_all(batch_size=32):
            pose = np.asarray(batch[self.variable], np.float64)
            pose = self.remove_joints(pose)
            pose = self.get_feats(pose)
            model.partial_fit(pose.reshape(-1, pose.shape[-1]))
        return model.cluster_centers_

    def predict(self, x: np.ndarray, soft_labels: bool = False):
        """Hard (or softmax-of-negative-mse) cluster labels
        (transform.py:395-410).

        Same math as the reference's broadcast form ``((c - x)**2).sum(-1)``
        regrouped as ``||x||^2 - 2 x.c + ||c||^2`` so the (N, F) x (F, M)
        contraction runs as one BLAS GEMM instead of materializing the
        (N, M, F) fp64 difference tensor (the hottest op of the host batch
        path in the JAX package's measurements).
        """
        x = np.asarray(x, np.float64)
        x = self.get_feats(x)
        x_shape = list(x.shape)
        flat = x.reshape(-1, x_shape[-1])
        # -2 x.c + ||c||^2  (the per-row ||x||^2 shifts every column equally)
        mse = flat @ (-2.0 * self.centers.T)
        mse += (self.centers ** 2).sum(-1)[None]
        if soft_labels:
            # the softmax temperature divides by the row mean of the TRUE
            # mse, so the per-row ||x||^2 term matters here
            mse += (flat ** 2).sum(-1, keepdims=True)
            np.maximum(mse, 0.0, out=mse)  # clip fp regrouping residue
            z = -mse / mse.mean(-1, keepdims=True)
            z = z - z.max(-1, keepdims=True)
            p = np.exp(z)
            p /= p.sum(-1, keepdims=True)
            return p.reshape(x_shape[:-1] + [self.centers.shape[0]])
        return mse.argmin(axis=-1).reshape(x_shape[:-1])

    def inv_predict(self, y: np.ndarray):
        y_shape = list(y.shape) + [self.centers.shape[-1]]
        return self.centers[y.reshape(-1).astype(int)].reshape(y_shape)

    def update(self, batch):
        pass

    def __call__(self, batch, inv: bool = False, **kwargs):
        if not inv:
            return self.predict(batch, **kwargs)
        return self.inv_predict(batch)

    def __repr__(self):
        return f"KMeansTransform(variable={self.variable}, key={self.key})"


class Relative2Parent:
    """Express each joint relative to its parent (transform.py:429-461)."""

    def __init__(self, parents: Optional[Sequence[int]] = None):
        if parents is None:
            from mixstage_tpu_torch.data.skeleton import PARENTS
            parents = PARENTS
        self.parents = list(parents)

    def inv(self, pose):
        for i, parent in enumerate(self.parents[1:]):
            pose[..., i + 1] += pose[..., parent]
        return pose

    def __call__(self, batch, inv: bool = False, **kwargs):
        out = {}
        for key in batch:
            if "pose" in key:
                pose = np.array(batch[key], copy=True)
                B, T = pose.shape[0], pose.shape[1]
                pose = pose.reshape(B, T, 2, -1)
                root = pose[..., 0].copy()
                pose[..., 0] = 0
                if inv:
                    pose = self.inv(pose)
                else:
                    pose[..., 1:] = pose[..., 1:] - pose[..., self.parents[1:]]
                pose[..., 0] = root
                out[key] = pose.reshape(B, T, -1)
            else:
                out[key] = batch[key]
        return out

    def __repr__(self):
        return "Relative2Parent()"


class RemoveJoints:
    """Mask joints out of the pose vector; invertible (transform.py:463-510).

    Forward: (B, T, 2*J) → (B, T, 2*(J-len(mask))), saving the removed slices.
    Inverse: reinsert; with ``parents`` + ``batch_gt``, reattach masked children
    relative to predicted parents for visualization.
    """

    def __init__(self, mask: Sequence[int], parents: Optional[Sequence[int]] = None):
        self.mask = list(mask)
        self.parents = list(parents) if parents is not None else None
        self.insert: Optional[np.ndarray] = None

    def __call__(self, batch, inv: bool = False, insert=None, **kwargs):
        """``insert``: explicit removed-slices array for the inverse.  Pass
        the insert captured alongside the SAME batch's forward pass whenever
        forward calls can run ahead of inverses (prefetch workers, the scan
        driver's k-chunk, the sampling metric worker thread) — the shared
        ``self.insert`` state is only safe for strictly serial
        forward-then-inverse use."""
        batch = np.asarray(batch)
        B, T = batch.shape[0], batch.shape[1]
        if inv:
            if insert is None:
                insert = self.insert
            assert insert is not None, \
                "Call RemoveJoints first before calling the inverse version"
            x = batch.reshape(B, T, 2, -1)
            if insert.shape[:2] != (B, T):
                # sampling reshapes (B, T) → (1, B*T); follow the data
                insert = insert.reshape(B, T, *insert.shape[2:])
            out = add_slices(x, insert, self.mask, axis=-1)
            if self.parents is not None and "batch_gt" in kwargs:
                gt = np.asarray(kwargs["batch_gt"]).reshape(B, T, 2, -1)
                for i in self.mask:  # topological order
                    if i != 0:
                        j = self.parents[i]
                        out[..., i] = (gt[..., i] - gt[..., j]) + out[..., j]
            return out.reshape(B, T, -1)
        x = batch.reshape(B, T, 2, -1)
        kept, removed = remove_slices(x, self.mask, axis=-1)
        if kwargs.get("save_insert", True):
            self.insert = removed
        return kept.reshape(B, T, -1)

    def __repr__(self):
        return f"RemoveJoints(mask={self.mask})"

