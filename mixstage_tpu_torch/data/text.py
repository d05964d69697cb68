"""The text modality: frame-aligned transcript features in the PATS h5 files.

The port's copy of ``mixstage_tpu/data/text.py``: the ``text/meta`` word
table (``write_text_meta`` / ``read_text_meta``), ``collate_fn_pad`` (the
pad collate of ragged ``text/*`` windows), the POS tag classes, the subword
frame distribution of the BERT features, and ``Text``, whose
``preprocess`` (``cli.preprocess -modalities '["text"]'``) writes the
``text/{w2v,bert,pos,tokens}`` streams:

* aligned (``-text_aligned 1``): from each interval's ``text/meta``;
* not aligned (``-text_aligned 0``): from the transcripts
  ``raw/<speaker>/<video>_transcripts/<video>.csv`` (columns ``Word``,
  ``Start``, ``End`` in seconds, read with ``csv``), each word assigned to
  the interval whose span holds its end, its frames counted from the
  interval's start; ``text/meta`` is written, then the streams.

``text/meta`` is read in h5py's native layout (``text/meta/{Word,
start_frame, end_frame}``), as a ``Table``: the port imports no pandas.  A
file whose ``text/meta`` is a pytables group (the JAX package reads it with
``pd.read_hdf``) raises ``NotImplementedError``: it waits until a
pytables-format PATS file is in the repository to be held against
(returning nothing would cut other windows than the JAX package).

The embedders behave as the JAX package's do where their files are absent:
``Word2VecEmbedder()`` gives zeros; ``BertEmbedder`` and
``BertSentenceBatching`` look for ``bert-base-uncased`` through
``transformers`` (local files only: nothing is downloaded) and, without it,
warn and give zeros and word indices; ``pos_tags`` tags with nltk's data
where installed, else gives zeros.  The real embedders (GoogleNews
word2vec weights, ``bert-base-uncased`` and its tokenizer) raise
``NotImplementedError``: they wait until their files are in the
repository.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mixstage_tpu_torch.data.common import MissingData, Modality, Table
from mixstage_tpu_torch.data.hdf5 import HDF5

W2V_DIM = 300
BERT_DIM = 768
TEXT_FS = 15  # words are frame-aligned to the pose stream

WAITS = ("waits until {} is in the repository, to be held against the "
         "JAX package (ROADMAP queue 1 item 7)")

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
    pytables format of original PATS files) raises ``NotImplementedError``:
    reading it waits for such a file in the repository."""
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
            f"pytables table, read with pandas); reading it "
            + WAITS.format("a pytables-format PATS file"))
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


class Word2VecEmbedder:
    """GoogleNews-300 word2vec lookup (``text.py:87-108``): without weights
    (what ``Text`` builds) every word's vector is zeros."""

    def __init__(self, path2weights: Optional[str] = None):
        if path2weights:
            raise NotImplementedError(
                f"word2vec weights {path2weights}: loading them "
                + WAITS.format("the GoogleNews word2vec file"))
        self.model = None

    def __call__(self, words: List[str]) -> np.ndarray:
        return np.zeros((len(words), W2V_DIM))


def _bert_files(what: str, load):
    """``load()`` (``from_pretrained`` of local files only) or, where the
    files are absent, None after the JAX package's warning."""
    try:
        load()
    except Exception as e:  # noqa: BLE001 - no transformers, no files
        warnings.warn(f"{what} unavailable: {e}")
        return None
    raise NotImplementedError(
        f"bert-base-uncased is installed: running it "
        + WAITS.format("bert-base-uncased and its tokenizer"))


class BertEmbedder:
    """Frozen bert-base-uncased sequence embeddings (``text.py:111-165``);
    without its files, zeros."""

    def __init__(self):
        def load():
            from transformers import BertModel, BertTokenizer

            BertTokenizer.from_pretrained("bert-base-uncased",
                                          local_files_only=True)
            BertModel.from_pretrained("bert-base-uncased",
                                      local_files_only=True)
        self.model = _bert_files("BERT", load)

    def __call__(self, words: List[str]) -> np.ndarray:
        return np.zeros((len(words), BERT_DIM))

    def subword_embed(self, words: List[str]):
        return None


class BertSentenceBatching:
    """Sentences → BERT token ids and mask (``text.py:168-204``); without
    the tokenizer's files, ``(None, None, None)``."""

    def __init__(self):
        def load():
            from transformers import BertTokenizer

            BertTokenizer.from_pretrained("bert-base-uncased",
                                          local_files_only=True)
        self.tokenizer = _bert_files("BERT tokenizer", load)

    def __call__(self, sentences: List[str]):
        return None, None, None


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


# pandas' default missing-value strings: a transcript word spelled so is
# read as NaN, which ``str`` makes "nan"
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def _float(v: str) -> float:
    return float("nan") if v in _NA else float(v)


def _words(values) -> List[str]:
    """A transcript's ``Word`` column as ``str`` makes of what
    ``pd.read_csv`` infers: missing values "nan", an all-integer column
    ``str(int)``, an all-number column ``str(float)``."""
    vals = [str(v) for v in values]
    present = [v for v in vals if v not in _NA]
    try:
        if present and len(present) == len(vals) and \
                all(float(v) == int(v) for v in present):
            return [str(int(v)) for v in vals]
    except ValueError:
        pass
    try:
        return [str(_float(v)) for v in vals]
    except ValueError:
        return ["nan" if v in _NA else v for v in vals]


def read_transcript(path) -> Table:
    """A transcript CSV (``Word``, ``Start``, ``End``) as a ``Table``: the
    words as ``_words`` reads them, the times as floats."""
    table = Table.read_csv(path)
    table["Word"] = _words(table["Word"])
    for key in ("Start", "End"):
        table[key] = [_float(v) for v in table[key]]
    return table


class Text(Modality):
    """Transcripts as frame-aligned ``text/*`` h5 datasets, at the pose
    stream's 15 rows per second (``text.py:309-518``)."""

    def __init__(self, path2data="../dataset/groot/data",
                 path2outdata="../dataset/groot/data", speaker="all",
                 preprocess_methods=("w2v",), text_aligned=1):
        super().__init__(path2data=path2data, path2outdata=path2outdata,
                         speaker=speaker, preprocess_methods=preprocess_methods)
        self.missing = MissingData(self.path2data)
        self.text_aligned = text_aligned
        self._embedders: Dict[str, object] = {}

    def fs(self, modality):
        return TEXT_FS

    @property
    def h5_key(self):
        return "text"

    def embedder(self, method):
        if method not in self._embedders:
            if method == "w2v":
                self._embedders[method] = Word2VecEmbedder()
            elif method == "bert":
                self._embedders[method] = BertEmbedder()
            elif method == "tokens":
                self._embedders[method] = BertSentenceBatching()
        return self._embedders.get(method)

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

    def _filename(self, speaker, interval_id) -> Path:
        return (Path(self.path2outdata) / "processed" / speaker
                / f"{interval_id}.h5")

    def preprocess(self):
        speakers = self.speaker if self.speaker[0] != "all" else self.speakers
        if self.text_aligned:
            self.text_aligned_preprocessing(speakers)
        else:
            self.text_not_aligned_preprocessing(speakers)

    # -- aligned: text/meta already in each interval's file ---------------
    def text_aligned_preprocessing(self, speakers):
        for speaker in speakers:
            df_speaker = self.get_df_subset("speaker", speaker)
            missing = [self.save_interval(interval_id, speaker)
                       for interval_id in df_speaker.unique("interval_id")]
            self.missing.save_intervals(missing)

    # -- not aligned: text/meta from the raw transcripts -------------------
    def text_not_aligned_preprocessing(self, speakers):
        for speaker in speakers:
            df_speaker = self.get_df_subset("speaker", speaker)
            df_speaker["video_id"] = [str(x).split("=")[-1]
                                      for x in df_speaker["video_link"]]
            df_speaker["Start"] = [_to_seconds(t)
                                   for t in df_speaker["start_time"]]
            df_speaker["End"] = [_to_seconds(t)
                                 for t in df_speaker["end_time"]]
            interval_ids = df_speaker.unique("interval_id")
            parent = Path(self.path2data) / "raw" / speaker
            done: List[str] = []
            if parent.exists():
                # raw/<speaker>/<video>_transcripts/<video>.csv
                tdirs = [d for d in os.listdir(parent)
                         if d.split("_")[-1] == "transcripts"]
                rels = ["{}/{}.csv".format(d, "_".join(d.split("_")[:-1]))
                        for d in tdirs]
                for rel in [r for r in rels if (parent / r).exists()]:
                    done += self.get_intervals_from_video(
                        Path(rel).stem, df_speaker, parent / rel, speaker)
            self.missing.save_intervals(set(interval_ids) - set(done))

    @staticmethod
    def _by_start_time(table: Table) -> Table:
        order = sorted(range(len(table)),
                       key=lambda i: table["start_time"][i])
        return table.rows(np.asarray(order, dtype=np.int64))

    def find_interval_for_words(self, end_time, df_video: Table
                                ) -> Optional[str]:
        """The interval whose [Start, End] holds the word's end time (the
        first of several, with a warning)."""
        hits = [i for i in range(len(df_video))
                if df_video["End"][i] >= end_time > df_video["Start"][i]]
        if len(hits) > 1:
            warnings.warn("More than one interval for one word")
        if not hits:
            return None
        return str(df_video["interval_id"][hits[0]])

    def get_intervals_from_video(self, key, df_speaker: Table, path2csv,
                                 speaker) -> List[str]:
        """Assign one video's transcript words to intervals, count their
        frames, write ``text/meta`` and the streams; the interval ids done."""
        text = read_transcript(path2csv)
        if key[:2] == "_-":
            key = key[2:]
        df_video = self._by_start_time(
            df_speaker.rows(df_speaker["video_id"] == key))
        if len(df_video) == 0:              # non-youtube videos
            new_key = "-".join(key.split("-")[-5:])
            df_video = self._by_start_time(df_speaker.rows(np.array(
                [new_key in x for x in df_speaker["video_id"]], dtype=bool)))
        word_interval = [self.find_interval_for_words(e, df_video)
                         for e in text["End"]]
        done = []
        for interval_id in dict.fromkeys(word_interval):
            if interval_id is None:
                continue
            try:
                max_len = self.load_array(self._filename(speaker,
                                                         interval_id),
                                          "pose/data").shape[0]
            except Exception:  # noqa: BLE001 - interval missing on disk
                continue
            row = self.df.rows(self.df["interval_id"] == interval_id)
            start_offset = _to_seconds(row["start_time"][0])
            idx = [i for i, w in enumerate(word_interval) if w == interval_id]
            # the first word starts at frame 0, each next where the previous
            # ends, the last ends at the interval's last frame
            starts, ends = [0], []
            for i in idx[1:]:
                starts.append(int(min(int((text["Start"][i] - start_offset)
                                          * self.fs("text")), max_len)))
                ends.append(starts[-1])
            ends.append(max_len)
            meta = Table({"Word": [text["Word"][i] for i in idx],
                          "start_frame": starts, "end_frame": ends})
            if self.save_interval_from_meta(interval_id, speaker,
                                            meta) is None:
                done.append(interval_id)
        return done

    def save_interval_from_meta(self, interval_id, speaker,
                                meta) -> Optional[str]:
        """Write ``text/meta``, then the streams; the interval id where
        that fails (with a warning), else None."""
        filename = self._filename(speaker, interval_id)
        try:
            write_text_meta(filename, meta)
            return self._embed_and_save(filename, meta)
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"text preprocess failed for {interval_id}: {e}")
            return interval_id

    def save_interval(self, interval_id, speaker) -> Optional[str]:
        filename = self._filename(speaker, interval_id)
        try:
            meta = read_text_meta(filename)
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 - an unreadable file
            meta = None
        if meta is None:
            warnings.warn(f"text/meta missing for {interval_id}")
            return interval_id
        try:
            return self._embed_and_save(filename, meta)
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"text preprocess failed for {interval_id}: {e}")
            return interval_id

    def _embed_and_save(self, filename, meta) -> None:
        """Each preprocess method's frame-aligned stream into the file
        (``process_interval``, ``text.py:445-475``)."""
        num_frames = self.load_array(filename, "pose/data").shape[0]
        words, starts, ends = meta_columns(meta)
        for method in self.preprocess_methods:
            if method == "w2v":
                aligned = self.frame_align(words, starts, ends,
                                           self.embedder(method)(words),
                                           num_frames)
            elif method == "bert":
                aligned = self._bert_aligned(words, starts, ends,
                                             num_frames)
            elif method == "pos":
                labels = pos_tags(words)
                aligned = self.frame_align(words, starts, ends,
                                           labels[:, None].astype(float),
                                           num_frames)[:, 0]
            elif method == "tokens":
                aligned = self._tokens_aligned(words, starts, ends,
                                               num_frames)
            else:
                continue
            self.append(filename, self.add_key(self.h5_key, [method]),
                        aligned)
        return None

    def _bert_aligned(self, words, starts, ends, num_frames) -> np.ndarray:
        """BERT features over each word's frames: without BERT's files the
        word vectors (zeros), frame-aligned, as the JAX package falls
        back."""
        vecs = self.embedder("bert")(words)
        return self.frame_align(words, starts, ends, vecs, num_frames)

    def _tokens_aligned(self, words, starts, ends, num_frames) -> np.ndarray:
        """Frame-aligned token ids: without the tokenizer's files each
        word's index, as the JAX package falls back."""
        self.embedder("tokens")
        idx = np.arange(len(words), dtype=float)[:, None]
        return self.frame_align(words, starts, ends, idx, num_frames)[:, 0]
