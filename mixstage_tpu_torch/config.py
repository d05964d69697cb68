"""Typed experiment configuration with grid-sweep CLI semantics.

The port's own copy of ``mixstage_tpu/config.py``, with every flag, so a
job script runs unchanged against either package: every flag is
``nargs='+'``, the cartesian product over all list-valued flags is the
built-in hyper-parameter sweep, and each permutation is handed to a
``loop`` callback as a typed ``Config``.

Flags of the JAX package's TPU machinery keep their names and defaults;
the port's trainer reads the ones it can honour (``-dtype``,
``-fused_decoder``, ``-scan_steps``, ``-preempt_save``, ``-save_optim``,
``-num_workers``, ``-profile_dir``) and refuses, with
``NotImplementedError``, the values it cannot run yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
from ast import literal_eval
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Flag table.  (name, type, default, help).  `literal_eval` types accept python
# literals exactly like the reference.  Defaults are the JAX package's.
# ---------------------------------------------------------------------------

_E = literal_eval

_FLAGS: List[Tuple[str, Any, Any, str]] = [
    # dataset
    ("path2data", str, "../dataset/groot/data", "path to data"),
    ("path2outdata", str, "../dataset/groot/data", "path to output data (pre-processing)"),
    ("speaker", _E, "oliver", "speaker name(s) or 'all'"),
    ("modalities", _E, ["pose/data", "audio/log_mel_512"], "modalities loaded by the dataloader"),
    ("input_modalities", _E, None, "input modalities (default: modalities[1:])"),
    ("output_modalities", _E, None, "output modalities (default: modalities[:1])"),
    ("mask", _E, [0, 7, 8, 9], "joints masked out of the pose"),
    ("split", _E, None, "(train,dev) split fractions; None uses the master csv"),
    ("batch_size", int, 32, "minibatch size"),
    ("shuffle", int, 1, "reshuffle each epoch"),
    ("time", float, 4.3, "seconds per sample window"),
    ("fs_new", _E, [15, 15], "new sampling frequency per modality"),
    ("num_workers", int, 1, "prefetch pipeline worker threads (order-preserving)"),
    ("window_hop", int, 0, "window hop in pose frames; 0 = non-overlapping"),
    ("num_clusters", int, None, "number of pose clusters (M sub-generators)"),
    ("pos", int, 0, "use POS tags as cluster labels"),
    ("feats", _E, ["pose", "velocity"], "features used for clustering"),
    ("style_dim", int, 10, "style embedding dimension"),
    # default mirrors reference argsUtils.py:45 (weights of the Disentangle
    # generator's internal losses)
    ("style_losses", _E, {"id_a": 1, "id_p": 1, "cluster_a": 1, "cluster_p": 1,
                          "style_a": 1, "style_p": 1, "content_+": 1,
                          "content_-": 1, "rec_a": 1, "rec_p": 1},
     "style loss weights dict (disentangle models)"),
    ("style_iters", int, 0, "iterations for style-balanced sampling (AlternateClassSampler)"),
    ("load_data", int, 1, "0 skips full data load (pretrained models)"),
    ("repeat_text", int, 1, "repeat word vectors to pose fs"),
    ("filler", int, 0, "return filler masks with text modality"),
    ("relative2parent", int, 0, "joints relative to parents instead of root"),
    ("quantile_sample", _E, None, "velocity-quantile subset spec"),
    ("quantile_num_training_sample", int, 3000, "samples/epoch after rebalancing"),
    ("finetune_quantile_sample", float, None, "quantile finetune phase after training"),
    ("pretrained_model", int, 0, "this is a pretrained model"),
    ("pretrained_model_weights", str, None, "path to pretrained weights"),
    ("noise", float, 0.0, "std of gaussian noise added to ground truth"),
    ("view", str, "sentences.txt", "sentence list for DataSample"),
    # bookkeeping
    ("exp", int, None, "experiment number"),
    ("debug", int, 0, "debug mode: truncate loops after N batches"),
    ("save_dir", str, "save/model", "checkpoint directory"),
    ("cpk", str, "m", "checkpoint name"),
    ("dev_key", str, "dev", "metric used for early stopping"),
    ("dev_sign", int, 1, "1 if lower dev metric is better, else -1"),
    ("tb", int, 0, "tensorboard flag"),
    ("seed", int, 11212, "manual seed"),
    ("load", str, None, "load weights from this PREFIX_weights.p checkpoint"),
    ("out_dir", str, None, "output dir for cli.import_torch conversions"),
    ("cuda", int, -1, "kept for CLI parity; the port always runs on the first card"),
    ("overfit", int, 0, "disable early stopping (overfit check)"),
    ("note", str, None, "experiment note"),
    # model
    ("model", str, "Speech2Gesture_G", "model name (registry key)"),
    ("modelKwargs", _E, {}, "model kwargs"),
    # gan
    ("gan", int, 0, "adversarial training on/off"),
    ("dg_iter_ratio", float, 1.0, "discriminator/generator iteration ratio"),
    ("lambda_gan", float, 1.0, "generator GAN loss weight"),
    ("lambda_D", float, 1.0, "discriminator fake loss weight"),
    ("joint", int, 0, "feed inputs to the discriminator too"),
    ("update_D_prob_flag", int, 0, "update D_prob from sample weights"),
    ("no_grad", int, 0, "stop grad through D during the G step"),
    ("discriminator", str, None, "discriminator name; None infers <model>_D"),
    ("weighted", int, 0, "sample-weighted GAN (GANWeighted)"),
    ("noise_only", int, 0, "train with noise inputs"),
    # loss
    ("loss", str, "MSELoss", "loss name: MSELoss | L1Loss | SmoothL1Loss | HuberLoss"),
    ("lossKwargs", _E, {}, "loss kwargs"),
    # preprocessing
    ("preprocess_methods", _E, ["log_mel_512"], "preprocess methods"),
    ("preprocess_only", int, 0, "exit after data preprocessing"),
    ("text_aligned", int, 1, "transcripts are time-aligned"),
    # training
    ("num_epochs", int, 50, "number of epochs"),
    ("early_stopping", int, 1, "early stopping on/off"),
    ("greedy_save", int, 1, "save weights after each improving epoch"),
    ("save_model", int, 1, "save model at all"),
    ("stop_thresh", int, 3, "consecutive non-improvements before stopping"),
    ("min_epochs", int, 0, "min epochs before early stopping"),
    ("eps", float, 0.0, "improvement threshold for early stopping"),
    ("num_iters", int, 0, "truncate non-train loops after N batches"),
    ("num_training_iters", int, None, "bounded random sampling: iters per epoch"),
    ("num_training_sample", int, None, "few-shot: fixed number of training samples"),
    ("metrics", int, 1, "update all metrics"),
    ("curriculum", int, 0, "timestep curriculum (unused by shipped models)"),
    ("kl_anneal", int, 0, "anneal kl loss (unused by shipped models)"),
    # optimizer
    ("optim", str, "Adam", "optimizer: Adam | AdamW | SGD | RMSprop"),
    ("lr", float, 1e-4, "learning rate"),
    ("optimKwargs", _E, {}, "optimizer kwargs"),
    ("optim_separate", float, None, "separate lr for the text (bert) encoder"),
    ("optim_mu_dtype", str, None,
     "dtype for Adam first moments (bfloat16 halves optimizer HBM traffic)"),
    ("scheduler", str, None, "lr schedule kind: None (exp decay) | linear_decay"),
    ("scheduler_warmup_steps", int, 0, "warmup steps for linear decay"),
    ("gamma", float, 0.99, "exponential lr decay"),
    # augmentation / jobs
    ("angles", _E, [90], "augmentation angles"),
    ("config", str, None, "slurm generator config (parity stub)"),
    ("script", str, None, "slurm generator script (parity stub)"),
    ("prequel", str, "", "slurm generator prequel (parity stub)"),
    # sampling
    ("sample_all_styles", int, 0, "sample every style pair (>0: N intervals each, -1: all)"),
    ("mix", int, 0, "sample as mixture of styles"),
    # render
    ("clean_render", int, 1, "re-render all videos"),
    ("render_list", str, None, "render only listed intervals"),
    ("render", int, 0, "render animations after sampling"),
    ("render_text", int, 1, "render captions"),
    ("render_transparent", int, 0, "transparent background"),
    # evil twins
    ("transforms", _E, ["mirror"], "speaker transforms (mirrored twins)"),
    ("cpu", int, 10, "cpus for rendering fan-out"),
    ("mem", int, 16000, "memory hint (parity stub)"),
    # --- additions of the JAX package (not in the reference) ---
    ("dtype", str, "float32", "compute dtype: float32 | bfloat16 | float64"),
    ("num_devices", int, 0, "data-parallel devices; 0 = all available"),
    ("donate", int, 1, "donate train-state buffers to jit"),
    ("remat", int, 0, "rematerialize the generator to save HBM"),
    ("profile_dir", str, None, "torch.profiler Chrome trace directory (first train epoch)"),
    ("fused_kernels", int, 1, "use Pallas fused kernels on TPU where available"),
    ("save_optim", int, 0, "also checkpoint optimizer state + counters (exact resume)"),
    ("ckpt_backend", str, "msgpack", "'msgpack' (reference PREFIX_weights.p contract) or "
     "'orbax' (atomic PREFIX_weights.orbax dir incl. optimizer state)"),
    ("scan_steps", int, 0, "run k train steps per call of the k-step driver (0 = per-step)"),
    ("fused_decoder", int, 0,
     "run the mixture decoder's train fwd+bwd as the hand-written CUDA "
     "kernel K3 (requires modelKwargs p == 0)"),
    ("audio_lowering", str, "native",
     "audio conv pyramid relowering plan: 'native' | 'tpu' (best measured) | "
     "8 comma-separated conv|s2d|im2col entries — exact math, same params, "
     "perf-only (layers.resolve_audio_lowerings)"),
    ("preempt_save", int, 1,
     "on SIGTERM, checkpoint the LIVE train state (weights + optimizer + "
     "counters) to PREFIX_preempt.p and exit 75 (EX_TEMPFAIL); rerunning "
     "the same command auto-resumes from it (preemption survival)"),
    ("export_dir", str, None,
     "AOT serving artifact directory (cli.export writes one from -load; "
     "cli.serve can serve straight from it, no model code needed)"),
    ("export_variants", str, "xla,pallas",
     "serving variants to export, comma-separated: 'plain' (portable "
     "cpu+cuda program: cuDNN convolutions and the plain folded decoder) "
     "and/or 'kernel' (the card's fast path through K1); the JAX package's "
     "names 'xla' and 'pallas', the shared default, mean 'plain' and "
     "'kernel'"),
    ("serve_port", int, 8008, "HTTP port for cli.serve (0 = ephemeral)"),
    ("serve_int8", int, 0,
     "serve the int8-quantized mixture decoder (ops/pallas/quant.py): "
     "~2x MXU rate on v5e, post-training symmetric quantization calibrated "
     "on one real data batch; opt-in accuracy tier — a few percent drift, "
     "outside the 1% fused-path contract"),
    ("serve_wait_ms", float, 5.0,
     "dynamic-batcher gather window for cli.serve (per-request latency "
     "bound before a partial batch is padded and dispatched)"),
    ("serve_calib_batches", int, 8,
     "number of loader windows pooled for the -serve_int8 one-shot "
     "activation calibration (more windows = tighter per-layer activation "
     "maxima than a single 2-sample peek)"),
    ("serve_max_queue", int, 0,
     "serving queue bound before requests shed with HTTP 429 "
     "(0 = 4x the static batch size)"),
    ("serve_max_frames", int, 4096,
     "per-request frame cap for cli.serve (longer audio → HTTP 400; "
     "bounds the pow-2 bucket set, i.e. the number of compiled shapes, "
     "and the padded device batch size — use streaming for long inputs). "
     "0 means the 4096 default; the cap cannot be disabled, because an "
     "uncapped request length would reopen the unbounded-compile stall"),
    ("serve_partition", str, "batch",
     "multi-chip serving layout (serve.build_serving_fn partition=): "
     "'batch' = DP shard_map over the batch (default; all tiers); "
     "'time' = GSPMD sequence parallelism over one clip's time axis "
     "(latency lever for long single requests; XLA decoder path); "
     "'expert' = mixture experts sharded with one psum (f32/bf16 only)"),
]

_FLAG_NAMES = [f[0] for f in _FLAGS]


def _fields():
    out = []
    for name, typ, default, _ in _FLAGS:
        pytype = Any if typ is _E else (Optional[typ] if default is None else typ)
        out.append((name, pytype, dataclasses.field(default_factory=lambda d=default: d)
                    if isinstance(default, (list, dict)) else default))
    return out


Config = dataclasses.make_dataclass("Config", _fields())
Config.__doc__ = "Typed experiment configuration (attribute-parity with the reference args)."


def _to_dict(self) -> Dict[str, Any]:
    return {k: getattr(self, k) for k in _FLAG_NAMES}


def _update(self, d: Dict[str, Any]) -> "Config":
    for k, v in d.items():
        setattr(self, k, v)
    return self


Config.to_dict = _to_dict
Config.update = _update


def _save(self, path: str) -> None:
    with open(path, "w") as f:
        json.dump(self.to_dict(), f, indent=2, default=str)


Config.save = _save


def config_from_dict(d: Dict[str, Any]) -> "Config":
    cfg = Config()
    known = {k: v for k, v in d.items() if k in _FLAG_NAMES}
    return cfg.update(known)


def load_config(path: str) -> "Config":
    with open(path) as f:
        return config_from_dict(json.load(f))


# ---------------------------------------------------------------------------
# CLI with cartesian-product sweep (argsUtils.py:245-258 semantics).
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    for name, typ, default, help_ in _FLAGS:
        parser.add_argument("-" + name, "--" + name, nargs="+", type=typ,
                            default=[default], help=help_)
    return parser


def get_args_perm(argv=None):
    """Parse argv; return (args_namespace, list of permutation dicts)."""
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print("unknown args ignored:", unknown)
    args_dict = vars(args)
    keys = sorted(args_dict)
    perms = [dict(zip(keys, prod))
             for prod in itertools.product(*(args_dict[k] for k in keys))]
    return args, perms


def _typed_flag_names(argv) -> list:
    """Config-flag names that appear as ``-flag``/``--flag`` tokens."""
    names = set(_FLAG_NAMES)
    typed = set()
    for tok in argv:
        if isinstance(tok, str) and tok.startswith("-"):
            name = tok.lstrip("-").split("=")[0]
            if name in names:
                typed.add(name)
    return sorted(typed)


def get_args_update_dict(cfg: "Config", argv=None) -> dict:
    """Flags the user explicitly typed on the CLI → ``{name: cfg value}``.

    Parity: ``pycasper.argsUtils.get_args_update_dict`` (SURVEY §1.1), used
    by the inference CLIs (reference sample.py:10, render.py:24) so explicit
    CLI overrides survive the checkpoint-args restore.  Without an explicit
    ``argv``, the typed-flag list recorded by ``argparse_n_loop`` is used —
    NOT raw ``sys.argv``, which would misread the host process's own tokens
    (e.g. pytest's ``--tb``) as config overrides; programmatic callers that
    never went through the CLI therefore get ``{}``."""
    if argv is None:
        typed = getattr(cfg, "typed_flags", None) or ()
    else:
        typed = _typed_flag_names(argv)
    return {k: getattr(cfg, k) for k in typed if k != "load"}


def argparse_n_loop(loop, argv=None):
    """Run ``loop(cfg, exp_index)`` for every permutation of list-valued flags."""
    import sys

    _, perms = get_args_perm(argv)
    typed = _typed_flag_names(sys.argv[1:] if argv is None else argv)
    for i, perm in enumerate(perms):
        cfg = config_from_dict(perm)
        cfg.typed_flags = typed  # consumed by get_args_update_dict
        loop(cfg, i)


# Reference-spelled alias so job scripts translate 1:1.
argparseNloop = argparse_n_loop
