"""Train CLI — full train → (quantile finetune) → sample pipeline on the
card (the port's counterpart of ``mixstage_tpu/cli/train.py``).

The JAX package's commands run unchanged against the port, e.g. the
Mix-StAGE job with the training decoder on the CUDA kernel K3:

  python -m mixstage_tpu_torch.cli.train \
    -path2data <data> -speaker '["oliver", "maher"]' \
    -model JointLateClusterSoftStyle4_G -gan 1 -loss L1Loss \
    -modalities '["pose/data", "audio/log_mel_512"]' -fs_new '[15, 15]' \
    -num_clusters 8 -batch_size 16 -num_epochs 20 -stop_thresh 3 \
    -dev_key dev_spatialNorm -style_iters 3000 -window_hop 5 \
    -fused_decoder 1

A SIGTERM checkpoints the live state and exits with code 75; rerunning the
same command resumes from it.  ``loop(args, exp_num, device=...)`` takes
the device from Python (``"cpu"`` in the tests); the command line always
runs on the card.

Data-parallel training over N ranks (``-num_devices N``, or 0 for all the
ranks launched), one process a rank:

  torchrun --nproc_per_node N -m mixstage_tpu_torch.cli.train \
    -num_devices N ... (the flags above)

Each rank joins the process group through ``parallel/multihost.setup``
(NCCL when every rank has a card, gloo when ranks share one) and runs on
``cuda:(LOCAL_RANK % device_count)``; rank 0 writes the files.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from mixstage_tpu_torch.config import Config, argparse_n_loop
from mixstage_tpu_torch.parallel import multihost
from mixstage_tpu_torch.train.trainer import Trainer, TrainingPreempted


def loop(args: Config, exp_num: int, device=None):
    multihost.setup(device_type=None if device is None
                    else torch.device(device).type)
    try:
        _loop(args, exp_num, device)
    except TrainingPreempted as e:
        # live state is already checkpointed (PREFIX_preempt.p); rc 75 =
        # EX_TEMPFAIL tells the scheduler to retry the same command, which
        # auto-resumes (Trainer._maybe_resume_preempt)
        import sys

        print(f"preempted ({e}); live state checkpointed — "
              f"rerun the same command to resume", flush=True)
        sys.exit(75)


def _loop(args: Config, exp_num: int, device=None):
    sample_all_styles = args.sample_all_styles
    finetune_quantile_sample = args.finetune_quantile_sample
    args_subset = ["exp", "cpk", "speaker", "model", "note"]

    # ---- TRAIN ------------------------------------------------------------
    trainer = Trainer(args, args_subset, {"sample_all_styles": 0},
                      device=device)
    trainer.start_exp()
    trainer.book._set_seed()
    trainer.train(exp_num)

    # ---- quantile finetune (train.py:45-75) -------------------------------
    if finetune_quantile_sample is not None:
        try:
            trainer.state = trainer.book._load_model(trainer.state)
        except Exception:
            pass
        trainer.data.quantile_sample = finetune_quantile_sample
        trainer.data.train_sampler = trainer.data.get_train_sampler(
            trainer.data.dataset_train, trainer.data.train_intervals_dict)
        trainer.data.update_dataloaders(trainer.data.time,
                                        trainer.data.window_hop)
        trainer.data_train = trainer.data.train
        trainer.data_dev = trainer.data.dev
        trainer.data_test = trainer.data.test
        trainer.args.weighted = 0
        trainer.args.num_epochs = 20
        trainer.num_epochs = 20
        trainer.book.best_dev_score = np.inf * trainer.book.dev_sign
        trainer.book.stop_count = 0
        trainer.train(exp_num)

    # ---- sample-all-styles pass (train.py:83-92) --------------------------
    args.load = trainer.book.name(*trainer.book.weights_ext,
                                  trainer.args.save_dir)
    if sample_all_styles != 0:
        del trainer
        gc.collect()
        print("Sampling all styles!!!")
        trainer = Trainer(args, args_subset,
                          {"render": args.render, "window_hop": 0,
                           "sample_all_styles": sample_all_styles},
                          device=device)
        trainer.sample(exp_num)

    # ---- final sample pass (train.py:94-106) ------------------------------
    del trainer
    gc.collect()
    print("Loading the best model and running the sample loop")
    trainer = Trainer(args, args_subset,
                      {"render": args.render, "window_hop": 0,
                       "sample_all_styles": 0}, device=device)
    trainer.sample(exp_num)
    trainer.finish_exp()
    print(f"\nExperiment Number: {args.exp}")


def main(argv=None):
    argparse_n_loop(loop, argv)
    multihost.teardown()


if __name__ == "__main__":
    main()
