"""The text modality's data layer, port against the JAX package.

``data/text.py`` (the ``text/meta`` word table, the pad collate, the
subword frame distribution, the time parser, the POS tags and the frame
alignment) and the text parts of ``data/dataset.py`` (``MiniData``'s text
items with and without ``text/meta``, ``repeat_text`` 0 and 1, ``filler``
with a given stopword list; ``Data``'s loaders and the pad collate) on
synthetic PATS intervals carrying ``text/w2v``, a frame-aligned
``text/tokens`` stream and a ``text/meta`` table.  Every comparison is
exact: both packages index and copy the same numpy arrays.

nltk is not installed here; where ``-filler`` asks it for English
stopwords, both packages get one stand-in list through a fake ``nltk``
module (the JAX package falls back to ``[]`` without it, and so does the
port).
"""

import sys
import types
from pathlib import Path

import h5py
import numpy as np
import pytest

from _torch_port_memory import release_memory  # noqa: F401
from mixstage_tpu.data import dataset as jds
from mixstage_tpu.data import text as jtext
from mixstage_tpu_torch.data import dataset as pds
from mixstage_tpu_torch.data import text as ptext
from mixstage_tpu_torch.data.common import Table
from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset

SPEAKERS = ["oliver", "maher"]
STOPWORDS = ["the", "a", "and", "of", "to"]
VOCAB = STOPWORDS + ["hands", "gesture", "speech", "model", "style"]
BATCH = 4


def add_text(path, meta: bool, seed: int = 0):
    """Write ``text/tokens`` (one id a word, repeated over its frames) and,
    with ``meta``, the ``text/meta`` table into every interval."""
    rng = np.random.default_rng(seed)
    for f in sorted(Path(path, "processed").glob("*/*.h5")):
        with h5py.File(f, "r") as h5:
            n = h5["pose/data"].shape[0]
        starts = np.concatenate([[0], np.cumsum(rng.integers(3, 12, 200))])
        starts = starts[starts < n]
        ends = np.append(starts[1:], n)
        ids = rng.integers(0, len(VOCAB), len(starts))
        tokens = np.zeros(n)
        for s, e, i in zip(starts, ends, ids):
            tokens[s:e] = i + 1
        with h5py.File(f, "a") as h5:
            h5["text/tokens"] = tokens
        if meta:
            ptext.write_text_meta(f, {"Word": [VOCAB[i] for i in ids],
                                      "start_frame": starts,
                                      "end_frame": ends})


@pytest.fixture(scope="module")
def pats(tmp_path_factory):
    """{"meta": data with text/meta, "plain": data without}."""
    out = {}
    for kind in ("meta", "plain"):
        path = str(tmp_path_factory.mktemp(f"pats_text_{kind}"))
        make_synthetic_dataset(path, SPEAKERS, 3, with_text=True)
        add_text(path, meta=kind == "meta")
        out[kind] = path
    return out


@pytest.fixture
def fake_nltk(monkeypatch):
    """An ``nltk`` whose English stopwords are ``STOPWORDS``."""
    corpus = types.ModuleType("nltk.corpus")
    corpus.stopwords = types.SimpleNamespace(
        words=lambda lang: list(STOPWORDS))
    nltk = types.ModuleType("nltk")
    nltk.corpus = corpus
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)


def assert_same(a, b, what=""):
    """Two items or batches equal key for key (arrays exactly, with their
    dtypes; the ``meta`` dicts value for value)."""
    assert sorted(a) == sorted(b), what
    for k in a:
        if isinstance(a[k], dict):
            assert sorted(a[k]) == sorted(b[k]), (what, k)
            for m in a[k]:
                np.testing.assert_array_equal(np.asarray(a[k][m]),
                                              np.asarray(b[k][m]),
                                              err_msg=f"{what} {k}/{m}")
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (what, k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


# --------------------------------------------------------------- text/meta
def test_text_meta_round_trips_between_the_packages(tmp_path):
    words = ["hello", "gesturing", "world"]
    meta = {"Word": words, "start_frame": np.array([0, 5, 9]),
            "end_frame": np.array([5, 9, 20])}
    port_file, jax_file = tmp_path / "p.h5", tmp_path / "j.h5"
    ptext.write_text_meta(port_file, meta)
    import pandas as pd

    jtext.write_text_meta(jax_file, pd.DataFrame(meta))
    for f in (port_file, jax_file):
        got = ptext.read_text_meta(f)
        want = jtext.read_text_meta(f)
        assert isinstance(got, Table)
        assert list(got["Word"]) == list(want["Word"]) == words
        for key in ("start_frame", "end_frame"):
            np.testing.assert_array_equal(
                np.asarray(got[key], np.int64), want[key].values)
    # create-only, as the JAX package's
    ptext.write_text_meta(port_file, {"Word": ["x"], "start_frame": [0],
                                      "end_frame": [1]})
    assert list(ptext.read_text_meta(port_file)["Word"]) == words


def test_text_meta_reads_str_words(tmp_path, monkeypatch):
    """h5py gives vlen strings as bytes; a stand-in that stores them as
    numpy ``str_`` (chip_smoke's, on a machine without h5py) is read
    alike."""
    f = tmp_path / "m.h5"
    ptext.write_text_meta(f, {"Word": ["ab", "cd"], "start_frame": [0, 2],
                              "end_frame": [2, 4]})
    raw = h5py.File(f, "r")["text/meta/Word"][()]
    assert isinstance(raw[0], bytes)
    load = ptext.HDF5.load_array

    def as_str(filename, key):
        arr = load(filename, key)
        return arr.astype(str) if arr.dtype == object else arr
    monkeypatch.setattr(ptext.HDF5, "load_array", staticmethod(as_str))
    assert list(ptext.read_text_meta(f)["Word"]) == ["ab", "cd"]


def test_text_meta_absent_or_in_another_layout(tmp_path):
    """No ``text/meta``: None in both packages.  A ``text/meta`` group in
    another layout (pytables') raises ``NotImplementedError`` naming item
    7: the JAX package would read it with pandas and cut other windows."""
    f = tmp_path / "none.h5"
    with h5py.File(f, "a") as h5:
        h5["pose/data"] = np.zeros((3, 2))
    assert ptext.read_text_meta(f) is None
    assert jtext.read_text_meta(f) is None
    with h5py.File(f, "a") as h5:
        h5["text/meta/table"] = np.zeros(3)
    with pytest.raises(NotImplementedError, match="item 7"):
        ptext.read_text_meta(f)


# ------------------------------------------------------- the pure helpers
def test_collate_fn_pad_matches_jax():
    rng = np.random.default_rng(1)
    batch = [{"text/w2v": rng.normal(size=(n, 6)),
              "text/token_duration": rng.integers(1, 9, size=(n,)),
              "audio/log_mel_512": rng.normal(size=(8, 4)),
              "meta": {"interval_id": str(i), "idx": i}, "idx": i}
             for i, n in enumerate((3, 7, 5))]
    keys = pds.TEXT_PAD_KEYS
    got = ptext.collate_fn_pad(batch, pad_key=keys)
    assert_same(got, jtext.collate_fn_pad(batch, pad_key=keys))
    assert got["text/w2v"].shape == (3, 7, 6)
    assert got["text/token_count"].tolist() == [3, 7, 5]


def test_subword_frames_times_tags_and_alignment_match_jax():
    words = ["hello", "gesturing", "world", "unknownword"]
    delta = [10, 7, 3, 5]
    toks = ["hello", "ges", "##tur", "##ing", "world", "[UNK]", "extra"]
    got = ptext.distribute_frames_over_subwords(words, delta, toks)
    assert got == jtext.distribute_frames_over_subwords(words, delta, toks)
    vecs = np.random.default_rng(2).normal(size=(len(toks), 4))
    starts, ends = [0, 10, 17, 20], [10, 17, 20, 25]
    np.testing.assert_array_equal(
        ptext._expand_subwords(vecs, got, starts, ends, 24),
        jtext._expand_subwords(vecs, got, starts, ends, 24))
    for t in ("0 days 00:00:25.000", "0:00:25.00", "01:02:03.5",
              "0 days 00:01:05.250000"):
        assert ptext._to_seconds(t) == jtext._to_seconds(t), t
    np.testing.assert_array_equal(ptext.pos_tags(words),
                                  jtext.pos_tags(words))
    assert ptext.POS_TAGSET == jtext.POS_TAGSET
    assert (ptext.W2V_DIM, ptext.BERT_DIM, ptext.TEXT_FS) == \
        (jtext.W2V_DIM, jtext.BERT_DIM, jtext.TEXT_FS)
    s, e = np.array([-2, 3, 9]), np.array([3, 9, 40])
    v = np.random.default_rng(3).normal(size=(3, 5))
    np.testing.assert_array_equal(
        ptext.Text.frame_align(None, words[:3], s, e, v, 30),
        jtext.Text.frame_align(None, words[:3], s, e, v, 30))


def test_text_preprocessing_is_refused():
    with pytest.raises(NotImplementedError, match="item 7"):
        ptext.Text(path2data="/nonexistent").preprocess()


# ------------------------------------------------------------- MiniData
class _Fs:
    """The rows per second of each stream, as the modality classes give
    them (pose and text 15, log_mel_512 89)."""

    def fs(self, modality):
        return 89 if modality.startswith("audio") else 15


ITEM_CASES = {   # name: (data, modalities, repeat_text, filler)
    "meta": ("meta", ("pose/data", "audio/log_mel_512", "text/w2v"), 1, 0),
    "meta_filler": ("meta", ("pose/data", "text/w2v"), 1, 1),
    "meta_words": ("meta", ("pose/data", "text/w2v"), 0, 1),
    "tokens_filler": ("meta", ("pose/data", "text/tokens"), 1, 1),
    "plain": ("plain", ("pose/data", "audio/log_mel_512", "text/w2v"), 1, 1),
    "plain_words": ("plain", ("pose/data", "text/w2v"), 0, 0),
}


@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_minidata_text_items_match_jax(pats, case):
    """Every window of two intervals: the text stream (one row a frame, or
    one a word with ``repeat_text`` 0), ``text/token_duration``,
    ``text/filler`` on the given stopwords, ``meta`` and ``style``."""
    data, modalities, repeat, filler = ITEM_CASES[case]
    files = sorted(Path(pats[data], "processed").glob("*/*.h5"))[:2]
    kw = dict(modalities=list(modalities), fs_new=[15] * len(modalities),
              time=4.3, modality_classes={m: _Fs() for m in modalities},
              window_hop=5, style=1, repeat_text=repeat,
              text_in_modalities=True, filler=filler, stopwords=STOPWORDS)
    n_items = 0
    for f in files:
        got, want = pds.MiniData(str(f), **kw), jds.MiniData(str(f), **kw)
        assert (got.text_df is None) == (data == "plain")
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert_same(a, b, f"{f.name}[{i}]")
            n_items += 1
            if filler:
                assert "text/filler" in a
    assert n_items > 20


# ------------------------------------------------------------------ Data
DATA_CASES = {   # name: (data, modalities, Data kwargs)
    "w2v": ("meta", ["pose/data", "audio/log_mel_512", "text/w2v"], {}),
    "filler": ("meta", ["pose/data", "audio/log_mel_512", "text/w2v"],
               {"filler": 1}),
    "ragged": ("meta", ["pose/data", "text/w2v", "text/tokens"],
               {"repeat_text": 0}),
    "no_meta": ("plain", ["pose/data", "audio/log_mel_512", "text/w2v"],
                {"window_hop": 0}),
}


@pytest.mark.parametrize("case", sorted(DATA_CASES))
def test_data_batches_match_jax(pats, fake_nltk, case):
    """``Data``'s train (seeded sampler), dev and test loaders and the
    sequential sweep (``iter_all``, which ZNorm and k-means read: with
    text, one item at a time through the pad collate), batch for batch."""
    data, modalities, kw = DATA_CASES[case]
    kw = dict(dict(window_hop=5), **kw)
    common = dict(modalities=modalities, fs_new=[15] * len(modalities),
                  batch_size=BATCH, **kw)
    got = pds.Data(pats[data], SPEAKERS, **common)
    want = jds.Data(pats[data], SPEAKERS, **common)
    assert got.text_in_modalities and want.text_in_modalities
    assert got.stopwords == want.stopwords
    assert (got.stopwords == STOPWORDS) == bool(kw.get("filler"))
    assert got.shape == want.shape
    for split in ("train", "dev", "test"):
        pl, jl = getattr(got, split), getattr(want, split)
        assert len(pl) == len(jl)
        for i, (a, b) in enumerate(zip(pl, jl)):
            assert_same(a, b, f"{split}[{i}]")
    sweeps = (list(got.train.iter_all(batch_size=BATCH)),
              list(want.train.iter_all(batch_size=BATCH)))
    assert len(sweeps[0]) == len(sweeps[1]) > 1
    for i, (a, b) in enumerate(zip(*sweeps)):
        assert_same(a, b, f"iter_all[{i}]")
    if kw.get("repeat_text") == 0:
        # ragged words, padded: the lengths differ between windows
        counts = np.concatenate([b["text/token_count"] for b in sweeps[0]])
        assert len(set(counts.tolist())) > 1
