"""Delete preprocessed datasets from the h5 store (the port's counterpart
of ``mixstage_tpu/cli/delete_keys.py``): ``<modality>/<method>`` datasets
across a speaker's interval files, after the reference's ``common.py``
main (``delete_keys``, common.py:249-255).

  python -m mixstage_tpu_torch.cli.delete_keys -path2outdata <data> \
      -speaker '["oliver"]' -modalities '["audio"]' \
      -preprocess_methods '["log_mel_512"]'
"""

from __future__ import annotations

from mixstage_tpu_torch.config import Config, argparse_n_loop
from mixstage_tpu_torch.data.common import Modality


def loop(args: Config, exp_num: int):
    speaker = args.speaker if isinstance(args.speaker, list) else [args.speaker]
    modality = Modality(args.path2data, args.path2outdata,
                        speaker[0] if len(speaker) == 1 else "all",
                        args.preprocess_methods)
    modality.del_keys(args.modalities)


def main(argv=None):
    argparse_n_loop(loop, argv)


if __name__ == "__main__":
    main()
