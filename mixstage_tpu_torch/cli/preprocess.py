"""Preprocessing CLI, one command per modality (the port's counterpart of
``mixstage_tpu/cli/preprocess.py``, after the reference's modules that
double as CLIs: ``src/data/audio.py:189-198``, ``skeleton.py:302-311``).

  python -m mixstage_tpu_torch.cli.preprocess -modalities '["audio"]' \
      -path2data <raw> -path2outdata <out> -speaker '["all"]' \
      -preprocess_methods '["log_mel_512"]'
  python -m mixstage_tpu_torch.cli.preprocess -modalities '["pose"]' \
      -path2data <raw> -path2outdata <out> -speaker '["oliver"]' \
      -preprocess_methods '["data"]'        # or normalize, confidence
  python -m mixstage_tpu_torch.cli.preprocess -modalities '["text"]' \
      -path2data <data> -path2outdata <out> -speaker '["oliver"]' \
      -preprocess_methods '["w2v", "bert", "pos", "tokens"]' \
      -text_aligned 0             # 1: from each interval's text/meta

Audio needs ``soundfile`` to read the raw mp3s.  Text runs without
downloads: ``bert`` runs ``bert-base-uncased`` from local files on the card
(``loop(args, exp_num, device=...)`` takes another device from Python, as
``cli.train``'s loop does), ``tokens`` its tokenizer; where their files
are absent it writes what the JAX package writes then (``data/text.py``:
zeros for w2v and bert, word indices for tokens).
"""

from __future__ import annotations

from mixstage_tpu_torch.config import Config, argparse_n_loop
from mixstage_tpu_torch.data.audio import Audio
from mixstage_tpu_torch.data.skeleton import Skeleton2D
from mixstage_tpu_torch.data.text import Text

MODALITY_MAP = {"audio": Audio, "pose": Skeleton2D, "skeleton": Skeleton2D,
                "text": Text}


def loop(args: Config, exp_num: int, device=None):
    modalities = args.modalities if isinstance(args.modalities, list) \
        else [args.modalities]
    for modality in modalities:
        kind = modality.split("/")[0]
        cls = MODALITY_MAP[kind]
        methods = args.preprocess_methods
        if kind in ("pose", "skeleton") and isinstance(methods, list):
            methods = methods[0]
        speaker = args.speaker if isinstance(args.speaker, list) \
            else [args.speaker]
        extra = dict(text_aligned=args.text_aligned, device=device) \
            if kind == "text" else {}
        mod = cls(path2data=args.path2data, path2outdata=args.path2outdata,
                  speaker=speaker, preprocess_methods=methods, **extra)
        mod.preprocess()
        print(f"{modality} preprocessing done")


def main(argv=None):
    argparse_n_loop(loop, argv)


if __name__ == "__main__":
    main()
