"""Serving export: the serving call written to disk as ``torch.export``
programs, served with no model code and no checkpoint.

Counterpart of ``mixstage_tpu/export.py`` (``export_serving`` ``:56-127``,
``load_serving`` ``:130-203``).  The BN-folded serving body
(``serve.ServingProgram``) is traced once per variant with
``torch.export`` and saved with ``torch.export.save``; a serving host loads
it with this module and the port's kernels, and needs neither the model's
modules nor a checkpoint.

Artifact directory layout::

  manifest.json        format version, shapes, platforms, model metadata
  weights.pt           the serving weights (the programs' ARGUMENTS):
                       the generator's state dict and the folded decoder
                       and classifier, ``torch.save``d, read with
                       ``weights_only=True``
  serving_plain.pt2    portable variant (cpu and cuda): cuDNN convolutions
                       and the plain folded decoder
  serving_kernel.pt2   the card's fast path (cuda): the classifier chain and
                       the decoder through K1, as the registered operator
                       ``mixstage_tpu_torch::fused_mixstage_decoder``

The weights stay arguments of the programs rather than constants inside
them (``ServingProgram`` swaps them into the model on every call), so one
weights file feeds either variant.  K1 reads its weights split and packed
(``pack_decoder_bf16``): the loader packs them once, at load, from the
folded weights in ``weights.pt``, and passes them as further arguments.
Packing at load keeps a single weights file for both variants and ties
the packed layout to the kernel that reads it (the loader's), not to the
one that was built when the artifact was written; it is exact and costs
one pass over the weights.

The plain program is traced from CPU tensors and moved to the card when
loaded there (``torch.export.passes.move_to_device_pass``); the kernel
program is traced on the card.  ``chip_smoke.py`` runs both on the card
and the CPU tests run the plain one on the CPU: the platforms in the
manifest are those.  The manifest records the format and the producing
torch version, and the loader refuses a format newer than its own.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import torch

from mixstage_tpu_torch.device import resolve_device

ARTIFACT_FORMAT = 1
MANIFEST = "manifest.json"
WEIGHTS = "weights.pt"

_VARIANTS = {
    # name -> (filename, use_kernel, platforms)
    "plain": ("serving_plain.pt2", False, ("cpu", "cuda")),
    "kernel": ("serving_kernel.pt2", True, ("cuda",)),
}
# the JAX package's variant names (its shared -export_variants flag)
ALIASES = {"xla": "plain", "pallas": "kernel"}

# serving consumes the first (audio) modality; widths per steps.py:181
_MODALITY_WIDTHS = {"audio/log_mel_512": 128, "audio/log_mel_400": 64}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def resolve_variants(names: Sequence[str]) -> tuple:
    """Variant names, with the JAX package's ``xla`` / ``pallas`` read as
    ``plain`` / ``kernel``; an unknown name raises."""
    out = []
    for name in names:
        name = ALIASES.get(name, name)
        if name not in _VARIANTS:
            raise ValueError(f"unknown serving variant {name!r}; expected "
                             f"one of {sorted(_VARIANTS)} (or the JAX "
                             f"names {sorted(ALIASES)})")
        if name not in out:
            out.append(name)
    return tuple(out)


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in tree.items()}


def _export(program, args) -> "torch.export.ExportedProgram":
    ep = torch.export.export(program, args, strict=False)
    try:                  # the example inputs would carry the weights along
        ep.example_inputs = None
    except AttributeError:
        ep._example_inputs = None
    return ep


def export_serving(model, out_dir: str, batch: int = 32, frames: int = 64,
                   variants=("plain", "kernel"), mel: Optional[int] = None,
                   input_modalities=("audio/log_mel_512",),
                   model_name: Optional[str] = None, device=None) -> dict:
    """Export the serving call of ``model`` (a generator of the port) to
    ``out_dir``: ``variants`` picks the programs to write (``_VARIANTS``;
    ``xla`` / ``pallas`` are read as ``plain`` / ``kernel``).  The model is
    moved to ``device`` (default: the card; raises without one), folded
    there once, and both programs read the one ``weights.pt``.  The
    ``kernel`` variant runs K1 and is traced on the card: asking for it on
    the CPU raises.  Returns the manifest dict."""
    from mixstage_tpu_torch.serve import build_serving_fn

    variants = resolve_variants(variants)
    device = resolve_device(device)
    if "kernel" in variants and device.type != "cuda":
        raise ValueError(f"the 'kernel' variant runs K1 and is exported on "
                         f"the card; device {device} has no CUDA kernels "
                         f"(export 'plain' alone, or run on the card)")
    modalities = list(input_modalities)
    if mel is None:
        if modalities[0] not in _MODALITY_WIDTHS:
            raise ValueError(f"pass mel= explicitly for modality "
                             f"{modalities[0]!r}")
        mel = _MODALITY_WIDTHS[modalities[0]]
    os.makedirs(out_dir, exist_ok=True)
    S = model.num_speakers

    manifest = {
        "format": ARTIFACT_FORMAT,
        "model": model_name or type(model).__name__,
        "batch": int(batch),
        "frames": int(frames),
        "mel": int(mel),
        "num_speakers": int(S),
        "num_clusters": int(model.num_clusters),
        "out_feats": None,
        "input_modalities": modalities,
        "dtype": _DTYPE_NAMES[model.dtype],
        "torch_version": torch.__version__,
        "variants": {},
    }
    weights = None
    for name in variants:
        fname, use_kernel, platforms = _VARIANTS[name]
        fn = build_serving_fn(model, device=device, use_kernel=use_kernel)
        gen, fd, fc, packed = fn.bound_args
        if weights is None:
            # identical across variants: the same folded weights either way
            weights = {"gen": _cpu(gen), "fd": _cpu(fd), "fc": _cpu(fc)}
            manifest["out_feats"] = int(fd["w_logits"].shape[-1])
        at = device if use_kernel else torch.device("cpu")
        args = ({k: v.to(at) for k, v in weights["gen"].items()},
                {k: v.to(at) for k, v in weights["fd"].items()},
                {k: v.to(at) for k, v in weights["fc"].items()}, packed,
                torch.zeros((batch, frames, mel), device=at),
                torch.zeros((batch, S), device=at))
        ep = _export(fn.program, args)
        torch.export.save(ep, os.path.join(out_dir, fname))
        manifest["variants"][name] = {"file": fname,
                                      "platforms": list(platforms),
                                      "use_kernel": use_kernel}
    torch.save(weights, os.path.join(out_dir, WEIGHTS))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_serving(path: str, prefer: Optional[str] = None, device=None):
    """Load an exported artifact; return ``fn(audio, style) -> pose``.

    ``style`` accepts int ids ``(B,)`` (one-hot'ed here) or soft mixture
    rows ``(B, num_speakers)``, the contract of
    ``serve.build_serving_fn``; the pose is a float32 tensor on ``device``
    (default: the card; raises without one).  Picks the ``kernel`` variant
    on a card when present, else the first one exported for the device's
    platform; override with ``prefer`` (``xla`` / ``pallas`` are read as
    ``plain`` / ``kernel``).  The returned fn carries ``.manifest``,
    ``.variant``, ``.static_batch``, ``.frames`` and ``.device`` for the
    serving front end.
    """
    from torch.export.passes import move_to_device_pass

    from mixstage_tpu_torch.ops.cuda import build
    from mixstage_tpu_torch.ops.cuda.fused_conv import pack_decoder_bf16
    from mixstage_tpu_torch.serve import style_weights

    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format", 0) > ARTIFACT_FORMAT:
        raise ValueError(
            f"artifact format {manifest['format']} is newer than this "
            f"loader ({ARTIFACT_FORMAT})")

    device = resolve_device(device)
    backend = device.type
    variants = manifest["variants"]
    if prefer is None:
        if backend == "cuda" and "kernel" in variants:
            prefer = "kernel"
        else:
            compat = [n for n, m in variants.items()
                      if backend in m["platforms"]]
            if not compat:
                raise ValueError(
                    f"no variant lowered for backend {backend!r}: artifact "
                    f"has " + ", ".join(f"{n} (lowered for "
                                        f"{m['platforms']})"
                                        for n, m in variants.items()))
            prefer = compat[0]
    prefer = ALIASES.get(prefer, prefer)
    if prefer not in variants:
        raise ValueError(f"variant {prefer!r} not in artifact "
                         f"(has {sorted(variants)})")
    meta = variants[prefer]
    if backend not in meta["platforms"]:
        raise ValueError(
            f"variant {prefer!r} was lowered for {meta['platforms']}, "
            f"but the current backend is {backend!r}")

    if meta["use_kernel"]:
        # the program calls K1 as an operator that importing fused_conv
        # registered; build its library now, so a failed build raises here
        build.load_library("fused_decoder_wgmma")
    ep = torch.export.load(os.path.join(path, meta["file"]))
    call = move_to_device_pass(ep, str(device)).module()
    w = torch.load(os.path.join(path, WEIGHTS), map_location=device,
                   weights_only=True)
    gen, fd, fc = w["gen"], w["fd"], w["fc"]
    packed = ({"classifier": pack_decoder_bf16(fc),
               "decoder": pack_decoder_bf16(fd)} if meta["use_kernel"]
              else {})

    B, T, mel = manifest["batch"], manifest["frames"], manifest["mel"]
    S = manifest["num_speakers"]

    @torch.inference_mode()
    def fn(audio, style):
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        if tuple(audio.shape) != (B, T, mel):
            raise ValueError(
                f"exported graph is static: audio must be {(B, T, mel)}, "
                f"got {tuple(audio.shape)} (pad partial batches upstream — "
                f"serving.DynamicBatcher does)")
        return call(gen, fd, fc, packed, audio,
                    style_weights(style, S, device))

    fn.manifest = manifest
    fn.variant = prefer
    fn.static_batch = B
    fn.frames = T
    fn.device = device
    return fn
