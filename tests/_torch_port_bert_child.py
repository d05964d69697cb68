"""The child process of ``test_torch_port_bert.py``: writes a tiny
``bert-base-uncased`` snapshot into ``$HF_HOME``'s hub cache, then runs
the JAX package's BERT embedders and text preprocessing and the port's
(``device="cpu"``) on the same inputs, and leaves both packages' outputs
in ``OUT`` (``results.npz``, ``results.json`` and the h5 trees under
``text/``) for the test to compare.

    HF_HOME=<dir> HF_HUB_OFFLINE=1 TRANSFORMERS_OFFLINE=1 USE_TF=0 \\
        python tests/_torch_port_bert_child.py OUT

The environment must be set before ``transformers`` is imported: the hub
reads it once, at import.
"""

import json
import shutil
import sys
import warnings
from functools import partial
from pathlib import Path

import numpy as np

# the synthetic transcripts' words (``data/synthetic.py``), some split
# into ## pieces; "louder", "matters" and "gesturing" are left out, so
# they become [UNK]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "gest",
         "##ure", "speaks", "than", "words", "and", "style", "un",
         "##believ", "##able", "punct", "##uation", "hello", "world",
         "lost", "edge"]
WORDS = ["the", "gesture", "speaks", "louder", "than", "words", "and",
         "style", "matters", "unbelievable", "punctuation", "hello",
         "gesturing", "world"]
# 600 words, 771 subwords: past BERT's 512 positions (≈400 words)
LONG = [WORDS[i % len(WORDS)] for i in range(600)]
SPEAKERS = ["oliver", "maher"]
SNAPSHOT = "0123456789abcdef0123456789abcdef01234567"
SEED = 21


def write_snapshot(hub: Path) -> None:
    """One encoder layer at BERT's width (the JAX package fixes 768),
    seeded weights, the vocabulary above."""
    import torch
    from transformers import BertConfig, BertModel

    repo = hub / "models--bert-base-uncased"
    snap = repo / "snapshots" / SNAPSHOT
    snap.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(SNAPSHOT)
    torch.manual_seed(SEED)
    BertModel(BertConfig(vocab_size=len(VOCAB), hidden_size=768,
                         num_hidden_layers=1, num_attention_heads=12,
                         intermediate_size=64)).save_pretrained(snap)
    (snap / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (snap / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": True, "model_max_length": 512}))


def long_meta(h5_path: Path) -> None:
    """Replace a file's ``text/meta`` with ``LONG`` spread over its
    frames: more subwords than BERT's positions (the cut) and than one
    chunk of the tokens' batching."""
    import h5py

    with h5py.File(h5_path, "a") as h5:
        frames = h5["pose/data"].shape[0]
        del h5["text/meta"]
        starts = np.linspace(0, frames, len(LONG), endpoint=False)
        starts = starts.astype(np.int64)
        ends = np.append(starts[1:], frames)
        h5["text/meta/Word"] = np.array(LONG, dtype=h5py.special_dtype(
            vlen=str))
        h5["text/meta/start_frame"] = starts
        h5["text/meta/end_frame"] = ends


def main(out: Path) -> None:
    import os

    from mixstage_tpu.data import text as jtext
    from mixstage_tpu_torch.cli import preprocess as ppre
    from mixstage_tpu_torch.config import argparse_n_loop
    from mixstage_tpu_torch.data import text as ptext
    from mixstage_tpu_torch.data.synthetic import make_synthetic_dataset

    write_snapshot(Path(os.environ["HF_HOME"]) / "hub")
    arrays, meta = {}, {}
    jemb, pemb = jtext.BertEmbedder(), ptext.BertEmbedder(device="cpu")
    meta["model"] = [type(jemb.model).__name__, type(pemb.model).__name__,
                     str(next(pemb.model.parameters()).device)]
    for name, words in (("words", WORDS), ("long", LONG)):
        arrays[f"call_{name}_jax"] = jemb(words)
        arrays[f"call_{name}_port"] = pemb(words)
        for pkg, emb in (("jax", jemb), ("port", pemb)):
            hidden, tokens = emb.subword_embed(words)
            arrays[f"sub_{name}_{pkg}"] = hidden
            meta[f"sub_{name}_{pkg}"] = list(tokens)
    sentences = {"short": [" ".join(WORDS)], "long": [" ".join(LONG)],
                 "pair": ["the style", "unbelievable punctuation and words"]}
    jbat, pbat = jtext.BertSentenceBatching(), ptext.BertSentenceBatching()
    for name, sents in sentences.items():
        for pkg, bat in (("jax", jbat), ("port", pbat)):
            ids, mask, toks = bat(sents)
            arrays[f"batch_{name}_{pkg}_ids"] = ids
            arrays[f"batch_{name}_{pkg}_mask"] = mask
            meta[f"batch_{name}_{pkg}_toks"] = toks
    try:                     # the files are here, the card is not
        ptext.BertEmbedder()
        meta["no_card"] = None
    except RuntimeError as e:
        meta["no_card"] = str(e)

    # text/bert and text/tokens as Text.preprocess writes them
    base = out / "text" / "base"
    make_synthetic_dataset(str(base), SPEAKERS, 2, interval_seconds=5.0,
                           with_raw_transcripts=True)
    methods = ["bert", "tokens"]
    for aligned in (0, 1):
        src = base
        if aligned:          # text/meta from the transcripts, one long
            src = out / "text" / "meta"
            shutil.copytree(base, src)
            jtext.Text(path2data=str(src), path2outdata=str(src),
                       speaker=SPEAKERS, preprocess_methods=[],
                       text_aligned=0).preprocess()
            long_meta(src / "processed" / SPEAKERS[0] / "100000.h5")
        roots = {pkg: out / "text" / f"{pkg}_{aligned}"
                 for pkg in ("jax", "port")}
        for root in roots.values():
            shutil.copytree(src, root)
        jtext.Text(path2data=str(roots["jax"]),
                   path2outdata=str(roots["jax"]), speaker=SPEAKERS,
                   preprocess_methods=methods,
                   text_aligned=aligned).preprocess()
        if aligned:
            ptext.Text(path2data=str(roots["port"]),
                       path2outdata=str(roots["port"]), speaker=SPEAKERS,
                       preprocess_methods=methods, text_aligned=1,
                       device="cpu").preprocess()
        else:                # through the CLI's loop
            argparse_n_loop(partial(ppre.loop, device="cpu"), [
                "-modalities", '["text"]', "-speaker", json.dumps(SPEAKERS),
                "-preprocess_methods", json.dumps(methods),
                "-text_aligned", "0", "-path2data", str(roots["port"]),
                "-path2outdata", str(roots["port"])])
    np.savez(out / "results.npz", **arrays)
    (out / "results.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    warnings.simplefilter("ignore")
    main(Path(sys.argv[1]))
