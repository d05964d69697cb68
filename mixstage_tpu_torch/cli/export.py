"""Export CLI — restore a checkpointed experiment and write a serving
artifact (``torch.export`` programs + the serving weights; see
``mixstage_tpu_torch/export.py``), the port's counterpart of
``mixstage_tpu/cli/export.py``.

  python -m mixstage_tpu_torch.cli.export -load <PREFIX_weights.p> \\
      -path2data <data> -export_dir out/artifact \\
      [-export_variants plain,kernel]

``-export_variants`` takes ``plain`` (cpu and cuda) and ``kernel`` (the
card, through K1); the JAX package's ``xla`` / ``pallas`` are read as
those two.  The CLI runs on the card; ``loop(args, exp_num,
device="cpu")`` from Python exports ``plain`` alone on the CPU (asking for
``kernel`` there raises).  The artifact serves with
``mixstage_tpu_torch.export.load_serving`` or ``python -m
mixstage_tpu_torch.cli.serve -export_dir out/artifact``.
"""

from __future__ import annotations

import json

from mixstage_tpu_torch.config import (Config, argparse_n_loop,
                                       get_args_update_dict)


def loop(args: Config, exp_num: int, device=None):
    assert args.load, "pass -load <PREFIX_weights.p>"
    assert args.export_dir, "pass -export_dir <output directory>"
    from mixstage_tpu_torch.export import export_serving
    from mixstage_tpu_torch.train.trainer import Trainer

    update = get_args_update_dict(args)
    update["window_hop"] = 0
    update["render"] = 0
    trainer = Trainer(args, ["exp", "cpk", "speaker", "model", "note"],
                      update, device=device)
    variants = [v.strip() for v in args.export_variants.split(",")
                if v.strip()]
    manifest = export_serving(
        trainer.state.gen, args.export_dir,
        batch=int(trainer.args.batch_size or 32), variants=variants,
        input_modalities=trainer.input_modalities,
        model_name=trainer.args.model, device=trainer.device)
    print(json.dumps({"export_dir": args.export_dir,
                      "variants": sorted(manifest["variants"]),
                      "batch": manifest["batch"],
                      "frames": manifest["frames"]}), flush=True)


def main(argv=None):
    argparse_n_loop(loop, argv)


if __name__ == "__main__":
    main()
