"""Text preprocessing (``data/text.py::Text.preprocess``,
``cli.preprocess -modalities '["text"]'``) against the JAX package's
``mixstage_tpu/data/text.py:330-518``, on the CPU, with nothing
downloaded: huggingface_hub's offline guard is set
(``_torch_port_helpers.no_hub_requests``) so the JAX package's BERT
lookups fail at once, as the port's (local files only) do; nltk's tagger
data is absent here, so both tag every word 0.

The data are the synthetic writers' at 5 s intervals with the raw PATS
transcripts (``with_raw_transcripts``: one video a speaker, a word every
0.5 s), plus seeded rows that take the corners: a word spelled ``NA``
(pandas reads NaN), numbers, a word past every interval, a word ending on
an interval's boundary, a second video whose id matches no interval (the
non-youtube lookup), and one interval without its h5 file.

Held bit for bit: every dataset of every h5 file both packages write (the
``text/meta`` table, ``text/{w2v,bert,pos,tokens}``, the missing-interval
ledger), on the not-aligned path (``-text_aligned 0``: ``text/meta`` from
the transcripts), on the aligned path (``-text_aligned 1``: from an
existing ``text/meta``) and through both CLIs.
"""

import csv
import shutil
from pathlib import Path

import numpy as np
import pytest

from _torch_port_helpers import no_hub_requests
from mixstage_tpu.cli import preprocess as jpre
from mixstage_tpu.config import argparse_n_loop as jax_loop
from mixstage_tpu.data import text as jtext
from mixstage_tpu.data.synthetic import make_synthetic_dataset
from mixstage_tpu_torch.cli import preprocess as ppre
from mixstage_tpu_torch.data import text as ptext
from test_torch_port_preprocess import _assert_same_h5, _h5_tree

SPEAKERS = ["oliver", "maher"]
METHODS = ["w2v", "bert", "pos", "tokens"]
# both packages warn for every interval whose streams fall back
pytestmark = pytest.mark.filterwarnings("ignore")


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    no_hub_requests(monkeypatch)


def _extra_rows(rng):
    """Transcript rows that take the corners (video seconds)."""
    return [{"Word": "NA", "Start": 1.05, "End": 1.2},
            {"Word": "42", "Start": 2.2, "End": 2.4},
            {"Word": "3.5", "Start": 3.1, "End": 3.3},
            {"Word": "edge", "Start": 4.8, "End": 5.0},     # the boundary
            {"Word": "after", "Start": 99.0, "End": 99.5}] + [
        {"Word": f"w{int(rng.integers(100))}",
         "Start": round(float(t), 3), "End": round(float(t) + 0.3, 3)}
        for t in np.sort(rng.uniform(5.0, 14.0, size=6))]


def _append_rows(path: Path, rows):
    with open(path, newline="") as f:
        old = list(csv.DictReader(f))
    merged = sorted(old + [{k: str(v) for k, v in r.items()} for r in rows],
                    key=lambda r: float(r["End"]))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["Word", "Start", "End"])
        w.writeheader()
        w.writerows(merged)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("text_raw")
    make_synthetic_dataset(str(root), SPEAKERS, 3, interval_seconds=5.0,
                           with_raw_transcripts=True)
    rng = np.random.default_rng(20)
    for sp in SPEAKERS:
        _append_rows(root / "raw" / sp / f"{sp}vid00_transcripts" /
                     f"{sp}vid00.csv", _extra_rows(rng))
    # a video whose id matches no interval: the non-youtube lookup
    other = root / "raw" / "oliver" / "a-b-c-d-e-f_transcripts"
    other.mkdir(parents=True)
    with open(other / "a-b-c-d-e-f.csv", "w") as f:
        f.write("Word,Start,End\nlost,1.0,1.5\n")
    # an interval whose h5 file is missing
    (root / "processed" / "maher" / "100005.h5").unlink()
    return root


def _copy(src, dst):
    shutil.copytree(src, dst)
    return Path(dst)


def _run(module, root, aligned, methods=METHODS, speaker=SPEAKERS):
    module.Text(path2data=str(root), path2outdata=str(root),
                speaker=list(speaker), preprocess_methods=methods,
                text_aligned=aligned).preprocess()


def test_not_aligned_path_writes_jax_files(raw, tmp_path):
    roots = {name: _copy(raw, tmp_path / name) for name in ("jax", "port")}
    _run(jtext, roots["jax"], 0)
    _run(ptext, roots["port"], 0)
    _assert_same_h5(roots["jax"], roots["port"])
    tree = _h5_tree(roots["port"])
    f = tree["processed/oliver/100000.h5"]
    words = [w.decode() for w in f["text/meta/Word"]]
    assert "nan" in words and "42" in words and "3.5" in words
    assert f["text/w2v"].shape == (f["pose/data"].shape[0], 300)
    assert f["text/bert"].shape[1] == 768 and not f["text/bert"].any()
    assert f["text/tokens"].max() == len(words) - 1
    missing = tree["missing_intervals.h5"]["intervals"]
    assert [m.decode() for m in missing] == ["100005"]


def test_aligned_path_writes_jax_files(raw, tmp_path):
    """From the ``text/meta`` the not-aligned path wrote (the JAX
    package's), each method's stream; an interval without ``text/meta``
    is recorded missing."""
    base = _copy(raw, tmp_path / "base")
    _run(jtext, base, 0, methods=["pos"])
    from mixstage_tpu_torch.data.hdf5 import HDF5

    for f in sorted((base / "processed").rglob("*.h5")):
        for key in ("text/pos",):
            h5 = HDF5.h5_open(f, "a")
            HDF5.del_dataset(h5, key)
            h5.close()
    h5 = HDF5.h5_open(base / "processed" / "maher" / "100004.h5", "a")
    del h5["text/meta"]
    h5.close()
    roots = {name: _copy(base, tmp_path / name) for name in ("jax", "port")}
    _run(jtext, roots["jax"], 1)
    _run(ptext, roots["port"], 1)
    _assert_same_h5(roots["jax"], roots["port"])
    missing = _h5_tree(roots["port"])["missing_intervals.h5"]["intervals"]
    assert sorted(m.decode() for m in missing) == ["100004", "100005"]


@pytest.mark.parametrize("aligned", [0, 1])
def test_cli_preprocess_text_equals_jax(raw, tmp_path, aligned):
    roots = {}
    for name, loop in (("jax", lambda a: jax_loop(jpre.loop, a)),
                       ("port", ppre.main)):
        root = _copy(raw, tmp_path / name)
        if aligned:                      # text/meta from the transcripts
            _run(jtext, root, 0, methods=[])
        roots[name] = root
        loop(["-modalities", '["text"]', "-speaker", '["oliver"]',
              "-preprocess_methods", '["w2v", "pos", "tokens"]',
              "-text_aligned", str(aligned), "-path2data", str(root),
              "-path2outdata", str(root)])
    _assert_same_h5(roots["jax"], roots["port"])
    f = _h5_tree(roots["port"])["processed/oliver/100001.h5"]
    assert {"text/w2v", "text/pos", "text/tokens"} <= set(f)


def test_frame_spans_match_jax(raw):
    """The word spans of one video's transcript, interval by interval:
    the first word from frame 0, each next where the previous ends, the
    last to the interval's end."""
    tj = jtext.Text(path2data=str(raw), speaker=["oliver"])
    tp = ptext.Text(path2data=str(raw), speaker=["oliver"])
    csv_path = raw / "raw" / "oliver" / "olivervid00_transcripts" / \
        "olivervid00.csv"
    import pandas as pd

    jt = pd.read_csv(csv_path)
    pt = ptext.read_transcript(csv_path)
    assert [str(w) for w in jt["Word"]] == list(pt["Word"])
    np.testing.assert_array_equal(jt["End"].to_numpy(),
                                  np.asarray(pt["End"], float))
    df = tj.get_df_subset("speaker", "oliver").copy()
    df["Start"] = df["start_time"].apply(jtext._to_seconds)
    df["End"] = df["end_time"].apply(jtext._to_seconds)
    dp = tp.get_df_subset("speaker", "oliver")
    dp["Start"] = [ptext._to_seconds(t) for t in dp["start_time"]]
    dp["End"] = [ptext._to_seconds(t) for t in dp["end_time"]]
    dp["interval_id"] = [str(i) for i in dp["interval_id"]]
    for end in list(jt["End"]) + [0.0, 5.0, 10.0, 15.0, 99.5]:
        assert tp.find_interval_for_words(end, dp) == \
            tj.find_interval_for_words(end, df), end


def test_embedders_without_their_files_behave_as_jax():
    words = ["hello", "gesturing", "world"]
    np.testing.assert_array_equal(ptext.Word2VecEmbedder()(words),
                                  jtext.Word2VecEmbedder()(words))
    pb, jb = ptext.BertEmbedder(), jtext.BertEmbedder()
    assert pb.model is None and jb.model is None
    np.testing.assert_array_equal(pb(words), jb(words))
    assert ptext.BertSentenceBatching().tokenizer is None
    assert jtext.BertSentenceBatching().tokenizer is None
    assert ptext.BertSentenceBatching()(["a b"]) == (None, None, None)
    with pytest.raises(NotImplementedError, match="item 7"):
        ptext.Word2VecEmbedder("GoogleNews-vectors-negative300.bin")
