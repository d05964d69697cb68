"""Import a REFERENCE (chahuja/mix-stage, PyTorch) checkpoint into a port
experiment: the port's counterpart of ``mixstage_tpu/cli/import_torch.py``.

Converts a pycasper ``PREFIX_weights.p`` (a saved ``model.state_dict()``,
reference ``src/model/trainer.py:142-148``) into the port's checkpoint
(``{gen, psenc, disc}`` state dicts) and writes a standalone experiment
directory::

    python -m mixstage_tpu_torch.cli.import_torch \\
        -load /ref/save/exp_XX_..._weights.p -path2data <pats> \\
        -out_dir save/imported

The experiment's args come back from the reference's adjacent
``_args.args`` (as for ``cli.sample``); flags typed on the command line
override them.  The conversion itself (``interop/torch_import.py``) also
runs whenever a CLI of the port gets ``-load <reference file>``; this
command writes the converted weights once, in the port's format.
``loop(args, exp_num, device="cpu")`` runs it on the CPU from Python.
"""

from __future__ import annotations

import os

import torch

from mixstage_tpu_torch.config import (Config, argparse_n_loop,
                                       get_args_update_dict)


def loop(args: Config, exp_num: int, device=None):
    from mixstage_tpu_torch.interop.torch_import import (
        is_reference_state_dict, sniff_torch_file)
    from mixstage_tpu_torch.train.trainer import Trainer

    assert args.load, "pass -load <reference PREFIX_weights.p>"
    assert sniff_torch_file(args.load) and is_reference_state_dict(
        torch.load(args.load, map_location="cpu", weights_only=True)), (
        f"{args.load} is not a reference state dict; checkpoints of the "
        f"port need no import")
    out_dir = args.out_dir or os.path.join(args.save_dir or "save",
                                           "imported")
    update = get_args_update_dict(args)
    update["window_hop"] = 0      # a template only: no training windows
    # the Trainer's BookKeeper._load_model converts the state dict
    trainer = Trainer(args, ["exp", "cpk", "speaker", "model", "note"],
                      update, device=device)
    path = trainer.book.export_experiment(trainer.state, out_dir)
    trainer.book.log(f"imported reference checkpoint → {path}")
    trainer.finish_exp()


def main(argv=None):
    argparse_n_loop(loop, argv)


if __name__ == "__main__":
    main()
