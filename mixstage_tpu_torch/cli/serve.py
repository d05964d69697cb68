"""Serving CLI — restore a checkpointed experiment (or load an exported
artifact) and serve audio→pose over HTTP with dynamic batching, on the
card: the port's counterpart of ``mixstage_tpu/cli/serve.py``.

  python -m mixstage_tpu_torch.cli.serve -load <PREFIX_weights.p> \\
      -path2data <data> -batch_size 32 -serve_port 8008 [-serve_int8 1]
  python -m mixstage_tpu_torch.cli.serve -export_dir out/artifact

Endpoints: POST /v1/pose (JSON {"audio": (T, mel), "style": id} or npz
octet-stream), POST /v1/stream…, POST /v1/pose_from_waveform (models on
``audio/log_mel_400``, checkpoint mode), GET /healthz, GET /stats (see
``mixstage_tpu_torch/serving/server.py``).

Checkpoint mode (``-load``) restores the experiment through the
``Trainer`` (a reference checkpoint is converted on the way,
``bookkeeping.py``) and serves ``serve.build_serving_fn`` at the
checkpoint's compute dtype: K1 runs the classifier and the decoder.
``-serve_int8 1`` serves the int8 tier instead (K4, or its bf16-feature
mode on a bf16 model, plus K1 for the classifier), its activations
calibrated on ``-serve_calib_batches`` loader windows pooled at start-up.
Artifact mode (``-export_dir`` with no ``-load``) needs no model code, no
checkpoint and no data: it serves ``export.load_serving``'s static-shape
program (the ``kernel`` variant on the card), and the server takes
exactly the artifact's frame count.

``build(args, device=None)`` returns the running ``(server, batchers)``;
``loop`` serves until interrupted.  The command line runs on the card;
``device="cpu"`` from Python runs the plain versions on the CPU.

Several devices (one process, JAX's single-controller mesh): the cards the
machine has, or ``-num_devices N`` of them (N may exceed the card count:
the list then repeats cards, ``cuda:i % count``), serve in the layout of
``-serve_partition`` (``batch``, ``time`` or ``expert``;
``serve.build_serving_fn``), as ``resolve_partition`` resolves it:

  python -m mixstage_tpu_torch.cli.serve -load <PREFIX_weights.p> \
      -path2data <data> -serve_partition expert -num_devices 2
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from mixstage_tpu_torch.config import (Config, argparse_n_loop,
                                       get_args_update_dict)


def resolve_partition(partition, n_dev: int, batch: int):
    """``-serve_partition`` layout resolution (``cli/serve.py:24-44``):
    batch DP only engages when the static batch divides the device count;
    'time' / 'expert' take the mesh regardless.  Returns
    ``(effective_partition, use_mesh)``; on one device every (valid)
    partition collapses to the single-device path.  Unknown values raise on
    any device count."""
    partition = str(partition or "batch")
    if partition not in ("batch", "time", "expert"):
        raise ValueError(f"unknown -serve_partition {partition!r}; "
                         "expected 'batch', 'time' or 'expert'")
    use_mesh = n_dev > 1 and (partition != "batch" or batch % n_dev == 0)
    return (partition if use_mesh else "batch"), use_mesh


def serving_devices(device, num_devices: int):
    """The device list to serve over: ``num_devices`` devices of
    ``device``'s type (0: every card, one on the CPU), ``cuda:i`` for the
    i-th repeating over the cards."""
    import torch

    if device.type != "cuda":
        return [device] * max(int(num_devices or 1), 1)
    count = torch.cuda.device_count()
    n = int(num_devices) if num_devices and num_devices > 0 else count
    return [torch.device("cuda", i % count) for i in range(n)]


def _calib_windows(trainer, n_batches: int, batch_size: int = 8):
    """Pool several real loader windows into one int8 calibration batch
    (``cli/serve.py:47-63``): static activation scales clip everything
    above the calibration maxima, so the sample should cover the
    activation distribution.  Returns (audio, style ids)."""
    xs, stys = [], []
    for cb in trainer.peek_batches(n_batches, batch_size=batch_size):
        xs.append(np.asarray(cb["x"][0], np.float32))
        stys.append(np.asarray(cb["style"][:, 0], np.int32)
                    if "style" in cb
                    else np.zeros((cb["x"][0].shape[0],), np.int32))
    return np.concatenate(xs), np.concatenate(stys)


def build(args: Config, device=None):
    """Set up the serving stack of ``args`` and start its HTTP server on
    ``-serve_port`` (0 picks a free port).  Returns ``(server, batchers)``;
    stop with ``server.shutdown()``, ``server.server_close()`` and each
    batcher's ``close()``."""
    assert args.load or args.export_dir, \
        "pass -load <PREFIX_weights.p> or -export_dir <artifact>"
    from mixstage_tpu_torch.serving import (DynamicBatcher, PoseService,
                                            start_http_server)

    wav_fn = None
    static_frames = None
    if args.export_dir and not args.load:
        # serve straight from the artifact: no checkpoint, no model code
        from mixstage_tpu_torch.export import load_serving

        serve_fn = load_serving(args.export_dir, device=device)
        batch = serve_fn.static_batch
        num_styles = serve_fn.manifest["num_speakers"]
        mel_bins = int(serve_fn.manifest["mel"])
        static_frames = int(serve_fn.frames)   # the program's T is static
        backend = serve_fn.device.type
    else:
        from mixstage_tpu_torch.serve import (build_serving_fn,
                                              build_waveform_serving_fn)
        from mixstage_tpu_torch.train.trainer import Trainer

        update = get_args_update_dict(args)
        update["window_hop"] = 0
        update["render"] = 0
        # -num_devices counts serving devices here, not training ranks
        trainer = Trainer(dataclasses.replace(args, num_devices=0),
                          ["exp", "cpk", "speaker", "model", "note"],
                          update, device=device)
        batch = int(trainer.args.batch_size or 32)
        dev = trainer.device
        devices = serving_devices(dev, args.num_devices)
        partition, use_mesh = resolve_partition(
            getattr(trainer.args, "serve_partition", None), len(devices),
            batch)
        layout = dict(devices=devices, partition=partition) if use_mesh \
            else {}
        mel_bins = int(trainer._peek_batch()["x"][0].shape[-1])
        quant_kw = {}
        if getattr(trainer.args, "serve_int8", 0):
            n_cal = int(getattr(trainer.args, "serve_calib_batches", 0) or 8)
            quant_kw = {"quantize_int8": True,
                        "calib": _calib_windows(trainer, n_cal)}
        model = trainer.state.gen
        serve_fn = build_serving_fn(model, device=dev, **quant_kw, **layout)
        num_styles = model.num_speakers
        backend = dev.type
        # the raw-16 kHz endpoint, for models on the log_mel_400 frontend
        if "audio/log_mel_400" in trainer.input_modalities:
            wav_fn = build_waveform_serving_fn(model, device=dev)
    wait_ms = float(getattr(args, "serve_wait_ms", None) or 5.0)
    max_queue = int(args.serve_max_queue or 0) or None

    batcher = DynamicBatcher(serve_fn, batch_size=batch, max_wait_ms=wait_ms,
                             input_shape=(static_frames, mel_bins),
                             max_queue=max_queue)
    batchers = [batcher]
    wav_batcher = None
    if wav_fn is not None:
        wav_batcher = DynamicBatcher(wav_fn, batch_size=batch,
                                     max_wait_ms=wait_ms, input_shape=(None,),
                                     max_queue=max_queue)
        batchers.append(wav_batcher)
    service = PoseService(batcher, backend=backend, num_styles=num_styles,
                          waveform_batcher=wav_batcher,
                          frames=int(getattr(serve_fn, "frames", 0) or 64),
                          mel_bins=mel_bins, static_frames=static_frames,
                          # 0 or unset is the 4096 default (config.py help)
                          max_frames=int(args.serve_max_frames or 0) or 4096)
    port = 8008 if args.serve_port is None else int(args.serve_port)
    server = start_http_server(service, port=port, host="0.0.0.0")
    print(f"serving on :{server.server_address[1]} (backend={backend}, "
          f"batch={batch})", flush=True)
    return server, batchers


def loop(args: Config, exp_num: int, device=None):
    server, batchers = build(args, device=device)
    try:
        threading.Event().wait()  # serve until killed
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        for b in batchers:
            b.close()


def main(argv=None):
    argparse_n_loop(loop, argv)


if __name__ == "__main__":
    main()
