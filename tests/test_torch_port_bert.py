"""BERT from local files (``data/text.py``: ``BertEmbedder``,
``BertSentenceBatching``, ``Text``'s ``text/bert`` and ``text/tokens``)
against the JAX package's (``mixstage_tpu/data/text.py:111-199``,
``:484-516``), bit for bit on the CPU.

A tiny ``bert-base-uncased`` snapshot (one encoder layer at BERT's width
768, seeded weights, a vocabulary of the synthetic transcripts' words with
some split into ``##`` pieces and some left out, so they become ``[UNK]``)
is written into a temporary ``HF_HOME``.  One child process
(``_torch_port_bert_child.py``) runs both packages on it: the hub reads
``HF_HOME`` and the offline switches once, at import, so they are set in
the child's environment before ``transformers`` is imported
(``HF_HUB_OFFLINE=1``, ``TRANSFORMERS_OFFLINE=1``: nothing is requested
from the network; ``USE_TF=0``: no TensorFlow).  Both packages run the
same library on the same weights and inputs, so every output is held
equal: the word means of ``__call__``, ``subword_embed``'s hidden states
and tokens (also past BERT's 512 positions), the token batches (one
sentence, one cut into chunks of 510, two padded with ``[SEP]``), and the
h5 files ``Text.preprocess`` writes with ``-text_aligned 0`` (through
``cli.preprocess``'s loop) and ``1`` (one interval's ``text/meta`` longer
than a chunk).  With the files present and no card, the port's default
device raises.  The absent-files behaviour is held in
``test_torch_port_text_preprocess.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_port_bert_child import LONG, VOCAB, WORDS
from _torch_port_memory import release_memory  # noqa: F401
from test_torch_port_preprocess import _assert_same_h5, _h5_tree

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The child's outputs: (arrays, lists and messages, its directory)."""
    out = tmp_path_factory.mktemp("bert")
    env = dict(os.environ, HF_HOME=str(out / "hf"), HF_HUB_OFFLINE="1",
               TRANSFORMERS_OFFLINE="1", USE_TF="0", JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_port_bert_child.py"),
         str(out)], env=env, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    arrays = dict(np.load(out / "results.npz"))
    meta = json.loads((out / "results.json").read_text())
    return arrays, meta, out


def test_both_packages_load_the_snapshot(run):
    _, meta, _ = run
    assert meta["model"] == ["BertModel", "BertModel", "cpu"]


@pytest.mark.parametrize("name", ["words", "long"])
def test_word_means_match_jax(run, name):
    arrays, _, _ = run
    want, got = arrays[f"call_{name}_jax"], arrays[f"call_{name}_port"]
    words = WORDS if name == "words" else LONG
    assert got.dtype == np.float64 and got.shape == (len(words), 768)
    np.testing.assert_array_equal(got, want)
    rows = np.abs(got).sum(1) > 0
    if name == "words":
        assert rows.all()
    else:                # the words past the cut stay zeros
        assert rows[:300].all() and not rows[-150:].any()


@pytest.mark.parametrize("name", ["words", "long"])
def test_subword_embed_matches_jax(run, name):
    arrays, meta, _ = run
    want, got = arrays[f"sub_{name}_jax"], arrays[f"sub_{name}_port"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    tokens = meta[f"sub_{name}_port"]
    assert tokens == meta[f"sub_{name}_jax"] and len(tokens) == len(got)
    if name == "words":
        assert tokens[:3] == ["the", "gest", "##ure"]
        assert "[UNK]" in tokens and "##believ" in tokens
    else:
        assert len(tokens) == 510


@pytest.mark.parametrize("name,rows", [("short", 1), ("long", 2),
                                       ("pair", 2)])
def test_sentence_batching_matches_jax(run, name, rows):
    arrays, meta, _ = run
    for part in ("ids", "mask"):
        want = arrays[f"batch_{name}_jax_{part}"]
        got = arrays[f"batch_{name}_port_{part}"]
        assert got.dtype == np.int64 and got.shape[0] == rows
        np.testing.assert_array_equal(got, want)
    toks = meta[f"batch_{name}_port_toks"]
    assert toks == meta[f"batch_{name}_jax_toks"]
    assert all(t[0] == "[CLS]" for t in toks)
    assert max(len(t) for t in toks) <= 512


@pytest.mark.parametrize("aligned", [0, 1])
def test_text_streams_match_jax(run, aligned):
    _, _, out = run
    jax_root, port_root = (out / "text" / f"{pkg}_{aligned}"
                           for pkg in ("jax", "port"))
    _assert_same_h5(jax_root, port_root)
    tree = _h5_tree(port_root)
    files = [k for k in tree if k.startswith("processed/")]
    assert len(files) == 4
    for f in files:
        h5 = tree[f]
        frames = h5["pose/data"].shape[0]
        assert h5["text/bert"].shape == (frames, 768)
        assert h5["text/tokens"].shape == (frames,)
        assert np.abs(h5["text/bert"]).sum() > 0
        # vocabulary ids (0 where no subword lands), not word indices
        ids = set(np.unique(h5["text/tokens"]).astype(int))
        assert ids <= set(range(len(VOCAB))) - {2, 3, 4}
    assert 1 in set(np.unique(np.concatenate(
        [tree[f]["text/tokens"] for f in files])).astype(int))


def test_the_default_device_needs_the_card(run):
    _, meta, _ = run
    assert meta["no_card"] is not None and "CUDA device" in meta["no_card"]
