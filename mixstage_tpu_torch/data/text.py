"""The text modality: frame-aligned transcript features in the PATS h5 files.

The port's copy of ``mixstage_tpu/data/text.py`` as far as training on
*preprocessed* text uses it: the ``text/meta`` word table
(``write_text_meta`` / ``read_text_meta``), ``collate_fn_pad`` (the pad
collate of ragged ``text/*`` windows), the POS tag classes, the subword
frame distribution of the BERT features, and the ``Text`` modality's rows
per second and h5 key.  The training path reads ``text/w2v`` (300 dims),
``text/bert`` (768) and ``text/tokens`` as stored.

``text/meta`` is read in h5py's native layout (``text/meta/{Word,
start_frame, end_frame}``), as a ``Table``: the port imports no pandas.  A
file whose ``text/meta`` is a pytables group (the JAX package reads it with
``pd.read_hdf``) raises ``NotImplementedError``: reading it comes with text
preprocessing (ROADMAP queue 1 item 7), and returning nothing would cut
other windows than the JAX package.  The embedders (word2vec, BERT, its
tokenizer, nltk's tagger data) and ``Text.preprocess`` belong to that item
too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from mixstage_tpu_torch.data.common import MissingData, Modality, Table
from mixstage_tpu_torch.data.hdf5 import HDF5

W2V_DIM = 300
BERT_DIM = 768
TEXT_FS = 15  # words are frame-aligned to the pose stream

PREPROCESS_LATER = ("text preprocessing and its embedders (word2vec, BERT "
                    "and its tokenizer, nltk's tagger) come with "
                    "cli/preprocess (ROADMAP queue 1 item 7)")

# universal POS tag classes, the -pos cluster labels
POS_TAGSET = ["NOUN", "VERB", "ADJ", "ADV", "PRON", "DET", "ADP", "NUM",
              "CONJ", "PRT", ".", "X"]


def write_text_meta(filename, meta) -> None:
    """Write the per-word frame-span table (a ``Table`` or a dict of
    columns ``Word``, ``start_frame``, ``end_frame``) in h5py's native
    layout: vlen-str ``text/meta/Word`` and int64 spans.  Create-only: a
    file that has the table keeps it."""
    import h5py

    if HDF5.isDatasetInFile(filename, "text/meta/Word"):
        return
    dt = h5py.special_dtype(vlen=str)
    HDF5.append(filename, "text/meta/Word",
                np.array([str(w) for w in meta["Word"]], dtype=dt))
    for key in ("start_frame", "end_frame"):
        HDF5.append(filename, f"text/meta/{key}",
                    np.asarray(meta[key]).astype(np.int64))


def read_text_meta(filename) -> Optional[Table]:
    """``text/meta`` as a ``Table`` (``Word`` as str, the spans as int64),
    or None when the file has none.  Words stored as ``bytes`` (h5py) or
    ``str`` are both read.  A ``text/meta`` group in another layout (the
    pytables format of original PATS files) raises ``NotImplementedError``
    (ROADMAP queue 1 item 7)."""
    if HDF5.isDatasetInFile(filename, "text/meta/Word"):
        words = HDF5.load_array(filename, "text/meta/Word")
        return Table({
            "Word": [w.decode() if isinstance(w, bytes) else str(w)
                     for w in words],
            "start_frame": HDF5.load_array(filename, "text/meta/start_frame"),
            "end_frame": HDF5.load_array(filename, "text/meta/end_frame")})
    if HDF5.isDatasetInFile(filename, "text/meta"):
        raise NotImplementedError(
            f"{filename}: text/meta is not in h5py's native layout (a "
            f"pytables table, read with pandas); reading it comes with "
            f"text preprocessing (ROADMAP queue 1 item 7)")
    return None


def meta_columns(table: Table):
    """(words, start_frame int64, end_frame int64) of a ``text/meta``
    table."""
    return ([str(w) for w in table["Word"]],
            np.asarray(table["start_frame"], np.int64),
            np.asarray(table["end_frame"], np.int64))


def _to_seconds(timestr) -> float:
    """'0 days 00:00:25.000' or '0:00:25.00' → seconds: the last
    whitespace-separated field as ``[-]H:M:S[.f]``, what ``pd.to_timedelta``
    makes of the master CSV's times."""
    field = str(timestr).split()[-1]
    sign = -1.0 if field.startswith("-") else 1.0
    parts = field.lstrip("+-").split(":")
    if len(parts) != 3:
        raise ValueError(f"not a time of day: {timestr!r}")
    h, m, s = parts
    return sign * (int(h) * 3600 + int(m) * 60 + float(s))


def pos_tags(words: List[str]) -> np.ndarray:
    """Universal POS tag-class indices of ``words`` (``POS_TAGSET``), from
    nltk's tagger when it and its data are installed, else zeros."""
    try:
        import nltk

        tags = nltk.pos_tag(words, tagset="universal")
        return np.array([POS_TAGSET.index(t) if t in POS_TAGSET
                         else POS_TAGSET.index("X") for _, t in tags])
    except Exception:
        return np.zeros(len(words), dtype=np.int64)


def english_stopwords() -> list:
    """nltk's English stopwords when nltk and its corpus are installed,
    else ``[]`` (the ``-filler`` masks)."""
    try:
        from nltk.corpus import stopwords

        return stopwords.words("english")
    except Exception:
        return []


def collate_fn_pad(batch: List[Dict], pad_key: Sequence[str], dim: int = 0):
    """Stack a list of items, zero-padding the arrays under ``pad_key``
    along ``dim`` to the longest and counting each item's length in
    ``text/token_count`` (the last padded key's counts)."""
    out: Dict[str, np.ndarray] = {}
    for key in batch[0].keys():
        vals = [b[key] for b in batch]
        if key in pad_key and isinstance(vals[0], np.ndarray):
            max_len = max(v.shape[dim] for v in vals)
            padded, counts = [], []
            for v in vals:
                pad_width = [(0, 0)] * v.ndim
                pad_width[dim] = (0, max_len - v.shape[dim])
                padded.append(np.pad(v, pad_width))
                counts.append(v.shape[dim])
            out[key] = np.stack(padded)
            out["text/token_count"] = np.array(counts)
        elif key == "meta":
            out[key] = {k: [v[k] for v in vals] for k in vals[0]}
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = np.asarray(vals)
    return out


def distribute_frames_over_subwords(words: List[str],
                                    delta_frames: List[int],
                                    subword_tokens: List[str]):
    """Split each word's frame span across its BERT subword tokens
    (``[CLS]``/``[SEP]`` excluded): an equal integer share each, the
    remainder to the last.  One ``(word_index, n_frames)`` per subword;
    ``(-1, 0)`` for tokens that could not be grouped into a word."""
    out: List = []
    count, piece = 0, []
    for tok in subword_tokens:
        piece.append(tok[2:] if tok.startswith("##") else tok)
        if count < len(words) and (
                "".join(piece) == words[count].lower()
                or tok == "[UNK]" or len(piece) > 20):
            n = len(piece)
            share = [int(delta_frames[count] / n)] * n
            share[-1] = int(delta_frames[count]) - sum(share[:-1])
            out += [(count, s) for s in share]
            piece = []
            count += 1
    out += [(-1, 0)] * (len(subword_tokens) - len(out))
    return out


def _expand_subwords(vecs: np.ndarray, assignments, starts, ends,
                     num_frames: int) -> np.ndarray:
    """Write each subword's vector into its share of its word's frame
    span."""
    out = np.zeros((num_frames, vecs.shape[-1]))
    cursors = {i: int(starts[i]) for i in range(len(starts))}
    for (wi, nf), vec in zip(assignments, vecs):
        if wi < 0 or nf <= 0:
            continue
        s = cursors[wi]
        e = min(s + nf, int(ends[wi]), num_frames)
        if e > s:
            out[s:e] = vec
        cursors[wi] = s + nf
    return out


class Text(Modality):
    """Transcripts as frame-aligned ``text/*`` h5 datasets, at the pose
    stream's 15 rows per second."""

    def __init__(self, path2data="../dataset/groot/data",
                 path2outdata="../dataset/groot/data", speaker="all",
                 preprocess_methods=("w2v",), text_aligned=1):
        super().__init__(path2data=path2data, path2outdata=path2outdata,
                         speaker=speaker, preprocess_methods=preprocess_methods)
        self.missing = MissingData(self.path2data)
        self.text_aligned = text_aligned

    def fs(self, modality):
        return TEXT_FS

    @property
    def h5_key(self):
        return "text"

    def frame_align(self, words: List[str], starts: np.ndarray,
                    ends: np.ndarray, vecs: np.ndarray,
                    num_frames: int) -> np.ndarray:
        """Repeat each word's vector across its [start_frame, end_frame)
        span of a (num_frames, dims) array."""
        out = np.zeros((num_frames, vecs.shape[-1]))
        for i in range(len(words)):
            s = int(max(0, starts[i]))
            e = int(min(num_frames, ends[i]))
            if e > s:
                out[s:e] = vecs[i]
        return out

    def preprocess(self):
        raise NotImplementedError(PREPROCESS_LATER)
