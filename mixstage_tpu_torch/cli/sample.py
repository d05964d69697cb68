"""Sample CLI — restore a checkpointed experiment and run the sample loop
on the card (the port's counterpart of ``mixstage_tpu/cli/sample.py``).

  python -m mixstage_tpu_torch.cli.sample -load <PREFIX_weights.p>

The args come back from the checkpoint's ``PREFIX_args.args``, with the
flags typed on the command line over them and ``window_hop`` 0.  Under
``torchrun --nproc_per_node N`` the ranks sample together (``cli.train``'s
set-up; ``-num_devices`` 0 or N), rank 0 writing the files.
"""

from __future__ import annotations

import torch

from mixstage_tpu_torch.config import (Config, argparse_n_loop,
                                       get_args_update_dict)
from mixstage_tpu_torch.parallel import multihost
from mixstage_tpu_torch.train.trainer import Trainer


def loop(args: Config, exp_num: int, device=None):
    assert args.load, "pass -load <PREFIX_weights.p>"
    multihost.setup(device_type=None if device is None
                    else torch.device(device).type)
    args_subset = ["exp", "cpk", "speaker", "model", "note"]
    # explicit CLI flags survive the checkpoint-args restore
    # (reference sample.py:10: get_args_update_dict)
    update = get_args_update_dict(args)
    update["window_hop"] = 0
    trainer = Trainer(args, args_subset, update, device=device)
    trainer.book._set_seed()
    trainer.sample(exp_num)
    trainer.finish_exp()


def main(argv=None):
    argparse_n_loop(loop, argv)
    multihost.teardown()


if __name__ == "__main__":
    main()
