"""The port's data pipeline against the JAX package's, on one synthetic PATS
fixture: the synthetic writer, ``Data`` (splits, ``style_dict``, shapes
and every batch of every loader), the master-CSV reading, ZNorm and the
k-means transform.

Everything here is exact (the same numpy operations on the same arrays)
except the statistics computed afresh (mu / var within 1e-12 relative: the
two packages sum the same float64 batches, but numpy's pairwise summation
may group them differently) and the k-means fit, which the JAX package
leaves unseeded (scikit-learn's ``MiniBatchKMeans``): the port's own fit is
held by what a fit must satisfy, determinism under its seed and an inertia
within 10% of scikit-learn's on the same batches.
"""

import shutil
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest

from mixstage_tpu.data import dataset as jds
from mixstage_tpu.data import transforms as jtr
from mixstage_tpu.data.synthetic import make_synthetic_dataset as jax_synth
from mixstage_tpu_torch.data import dataset as pds
from mixstage_tpu_torch.data import transforms as ptr
from mixstage_tpu_torch.data.common import Table, infer_as_str
from mixstage_tpu_torch.data.skeleton import timedelta_seconds
from mixstage_tpu_torch.data.synthetic import \
    make_synthetic_dataset as port_synth

SPEAKERS = ["oliver", "maher"]
MASK = [0, 7, 8, 9]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    path = tmp_path_factory.mktemp("pats_data")
    jax_synth(str(path), SPEAKERS, 3)
    return str(path)


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                  if p.is_file())


def test_synthetic_writers_write_the_same_dataset(tmp_path):
    kw = dict(speakers=["oliver", "maher", "jon"], num_intervals_per_speaker=4,
              with_text=True, with_raw_transcripts=True,
              with_raw_keypoints=True, with_raw_audio=True, seed=3)
    j, p = tmp_path / "jax", tmp_path / "port"
    jax_synth(str(j), interval_seconds=6.0, **kw)
    port_synth(str(p), interval_seconds=6.0, **kw)
    files = _files(j)
    assert files == _files(p)
    for f in files:
        if f.endswith(".h5"):
            with h5py.File(j / f) as a, h5py.File(p / f) as b:
                keys = []
                a.visit(lambda k: keys.append(k)
                        if isinstance(a[k], h5py.Dataset) else None)
                assert keys and all(k in b for k in keys), f
                for k in keys:
                    np.testing.assert_array_equal(a[k][()], b[k][()], f)
        else:                      # the CSVs, txt, yml and wav byte for byte
            assert (j / f).read_bytes() == (p / f).read_bytes(), f


def _assert_batches_equal(a, b, where):
    assert sorted(a) == sorted(b), where
    for k in a:
        if isinstance(a[k], dict):
            assert sorted(a[k]) == sorted(b[k]), (where, k)
            for kk in a[k]:
                np.testing.assert_array_equal(np.asarray(a[k][kk]),
                                              np.asarray(b[k][kk]),
                                              err_msg=f"{where} {k}/{kk}")
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, \
                (where, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")


DATA_CASES = {
    "hop0": dict(window_hop=0),
    "hop5": dict(window_hop=5),
    "style_iters": dict(window_hop=5, style_iters=3),
    "quantile_above": dict(window_hop=5, quantile_sample=0.5),
    "quantile_rebalance": dict(window_hop=5, quantile_sample=3,
                               quantile_num_training_sample=2),
    "split": dict(window_hop=5, split=(0.5, 0.25)),
    "all_styles": dict(window_hop=0, sample_all_styles=-1),
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_data_matches_jax(synth, case):
    kw = dict(batch_size=4, **DATA_CASES[case])
    jd = jds.Data(synth, SPEAKERS, **kw)
    pd_ = pds.Data(synth, SPEAKERS, **kw)
    for attr in ("train_intervals", "dev_intervals", "test_intervals",
                 "train_intervals_all", "style_dict", "shape"):
        assert getattr(jd, attr) == getattr(pd_, attr), attr
    assert type(jd.train_sampler).__name__ == \
        type(pd_.train_sampler).__name__
    for split in ("train", "dev", "test"):
        jl, pl = getattr(jd, split), getattr(pd_, split)
        assert len(jl) == len(pl), split
        n = 0
        for epoch in range(2):           # the samplers draw anew each epoch
            for i, (a, b) in enumerate(zip(jl, pl, strict=True)):
                _assert_batches_equal(a, b, f"{case} {split}[{epoch}:{i}]")
                n += 1
        assert n > 0, split
        for i, (a, b) in enumerate(zip(jl.iter_all(batch_size=32),
                                       pl.iter_all(batch_size=32),
                                       strict=True)):
            _assert_batches_equal(a, b, f"{case} {split} iter_all[{i}]")


def test_master_csv_types_match_pandas(synth, tmp_path):
    """Interval ids with leading zeros (pandas reads them as integers, so
    the files are named without them), a twin CSV of another speaker whose
    ids pandas keeps as strings, and the dtype=object reading of
    ``Modality``: the same table, split and interval order as JAX's."""
    root = tmp_path / "pats"
    shutil.copytree(synth, root)
    df = pd.read_csv(root / "cmu_intervals_df.csv", dtype=object)
    df["interval_id"] = "0" + df["interval_id"]
    df.to_csv(root / "cmu_intervals_df.csv", index=False)
    twins = df[df["speaker"] == "maher"].copy()
    twins["speaker"] = "maher|mirror"
    twins["interval_id"] = twins["interval_id"] + "|mirror"
    twins.to_csv(root / "cmu_intervals_df_transforms.csv", index=False)
    jd = jds.Data(str(root), SPEAKERS, batch_size=4, window_hop=5,
                  style_iters=2)
    pd_ = pds.Data(str(root), SPEAKERS, batch_size=4, window_hop=5,
                   style_iters=2)
    for attr in ("train_intervals", "dev_intervals", "test_intervals",
                 "train_intervals_dict", "style_dict", "shape"):
        assert getattr(jd, attr) == getattr(pd_, attr), attr
    assert jd.train_intervals[0] == "100000"
    for a, b in zip(jd.train, pd_.train, strict=True):
        _assert_batches_equal(a, b, "train")
    # the concatenated table, column by column, as pandas' str cast
    want = pd.concat([pd.read_csv(root / "cmu_intervals_df.csv"),
                      pd.read_csv(root / "cmu_intervals_df_transforms.csv")],
                     ignore_index=True)
    want["interval_id"] = want["interval_id"].astype(str)
    tables = [Table.read_csv(root / "cmu_intervals_df.csv"),
              Table.read_csv(root / "cmu_intervals_df_transforms.csv")]
    for t in tables:
        t["interval_id"] = infer_as_str(t["interval_id"])
    got = Table.concat(tables)
    assert list(got["interval_id"]) == list(want["interval_id"])
    assert list(got["speaker"]) == list(want["speaker"])
    # Modality's dtype=object reading keeps the zeros
    from mixstage_tpu.data.common import Modality as JaxModality
    from mixstage_tpu_torch.data.common import Modality
    jm, pm = JaxModality(str(root)), Modality(str(root))
    assert list(pm.df["interval_id"]) == list(jm.df["interval_id"])
    assert list(pm.df["delta_time"]) == list(jm.df["delta_time"])
    sub_j = jm.get_df_subset("speaker", ["maher"])
    sub_p = pm.get_df_subset("speaker", ["maher"])
    assert list(sub_p["interval_id"]) == list(sub_j["interval_id"])


@pytest.mark.parametrize("text", ["0 days 0:00:25.000000",
                                  "0 days 1:02:03.500000", "0:00:01.5",
                                  "2 days 0:10:00", "0:01:02.123456"])
def test_time_stamps_parse_as_pandas(text):
    assert timedelta_seconds(text) == pd.to_timedelta(text).total_seconds()


def _loader(synth, window_hop=5):
    return pds.Data(synth, SPEAKERS, batch_size=4,
                    window_hop=window_hop).train


def test_znorm_matches_jax(synth, tmp_path):
    """Computed afresh from the same batches, mu / var agree to 1e-12
    relative; each package reads the other's cache exactly; the transform
    and its inverse are the same numpy arithmetic."""
    mods = ["pose/data", "audio/log_mel_512"]
    jl = jds.Data(synth, SPEAKERS, batch_size=4, window_hop=5).train
    pl = _loader(synth)
    jz = jtr.ZNorm(mods, savepath=str(tmp_path / "j"), key=SPEAKERS, data=jl)
    pz = ptr.ZNorm(mods, savepath=str(tmp_path / "p"), key=SPEAKERS, data=pl)
    for m in mods:
        for a, b in zip(jz.variable_dict[m], pz.variable_dict[m]):
            assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max(), m
    pz2 = ptr.ZNorm(mods, savepath=str(tmp_path / "j"), key=SPEAKERS,
                    data=None)
    jz2 = jtr.ZNorm(mods, savepath=str(tmp_path / "p"), key=SPEAKERS,
                    data=None)
    batch = next(pl.iter_all(batch_size=8))
    for m in mods:
        for a, b in zip(jz.variable_dict[m], pz2.variable_dict[m]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(pz.variable_dict[m], jz2.variable_dict[m]):
            np.testing.assert_array_equal(a, b)
        out_j = jz({m: batch[m]})
        out_p = pz2({m: batch[m]})
        np.testing.assert_array_equal(out_j[m], out_p[m])
        np.testing.assert_array_equal(jz({m: out_j[m]}, inv=True)[m],
                                      pz2({m: out_p[m]}, inv=True)[m])


@pytest.fixture(scope="module")
def shared_kmeans(synth, tmp_path_factory):
    """Centres fitted once by the JAX package (scikit-learn) into a cache
    both packages then read."""
    pre = tmp_path_factory.mktemp("pre")
    jl = jds.Data(synth, SPEAKERS, batch_size=4, window_hop=5).train
    jk = jtr.KMeansTransform(["pose/data"], savepath=str(pre / "kmeans"),
                             key=SPEAKERS, data=jl, num_clusters=4,
                             mask=MASK)
    pk = ptr.KMeansTransform(["pose/data"], savepath=str(pre / "kmeans"),
                             key=SPEAKERS, data=None, num_clusters=4,
                             mask=MASK)
    return jk, pk


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_kmeans_predict_matches_jax_on_shared_centres(synth, shared_kmeans,
                                                      soft):
    jk, pk = shared_kmeans
    np.testing.assert_array_equal(jk.centers, pk.centers)
    for batch in _loader(synth).iter_all(batch_size=16):
        pose = jtr.RemoveJoints(MASK)(batch["pose/data"])
        np.testing.assert_array_equal(jk.predict(pose, soft_labels=soft),
                                      pk.predict(pose, soft_labels=soft))


def _features(synth):
    k = ptr.KMeansTransform.__new__(ptr.KMeansTransform)
    k.feats = ["pose", "velocity"]
    out = []
    for batch in _loader(synth).iter_all(batch_size=32):
        pose = k.get_feats(ptr.RemoveJoints(MASK)(batch["pose/data"]))
        out.append(pose.reshape(-1, pose.shape[-1]))
    return out


def test_kmeans_fit_is_seeded(synth, tmp_path):
    def fit(seed, where):
        return ptr.KMeansTransform(
            ["pose/data"], savepath=str(tmp_path / where / "kmeans"),
            key=SPEAKERS, data=_loader(synth), num_clusters=4, mask=MASK,
            seed=seed).centers
    a, b, c = fit(1, "a"), fit(1, "b"), fit(2, "c")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("k", [2, 8])
def test_kmeans_fit_reaches_sklearns_inertia(synth, k):
    """Over the same ``iter_all(batch_size=32)`` pass, the port's fit ends
    within 10% of scikit-learn's inertia (scikit-learn seeded here only to
    make the test repeatable; the JAX package leaves it unseeded)."""
    import sklearn.cluster

    batches = _features(synth)
    allx = np.concatenate(batches)
    ours = ptr.MiniBatchKMeans(k, seed=11212)
    ref = sklearn.cluster.MiniBatchKMeans(n_clusters=k, random_state=0)
    for x in batches:
        ours.partial_fit(x)
        ref.partial_fit(x)
    assert ours.inertia(allx) <= 1.10 * -ref.score(allx)
