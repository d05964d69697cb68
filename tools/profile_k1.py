#!/usr/bin/env python3
"""Trace kernel K1 and its plain PyTorch version on one CUDA card.

For each shape (the bs32 decoder and classifier chain, and both at the
server's 4096-frame bucket) it runs K1 and the plain version
(``fused_mixstage_decoder_plain``: cuDNN convolutions and matmuls) five
times each under ``torch.profiler`` and prints, per version: the device
kernels with their launch count and device time per call, the device busy
time per call (union of kernel intervals), the host's wall time per call,
and the device's idle share of that wall time.  It does the same for one
bs32 serving call of the full-width flagship model, f32 and int8 (K1's
classifier launch, then K4).

``--dtype bfloat16`` runs the same at the bf16 compute dtype: K1's bf16
mode (bf16 features, f32 weights) against its plain version, and one bs32
serving call of a bf16 model, f32-weight and int8 (K1's bf16 mode on the
classifier, then K4's bf16-feature mode).

``--sweep`` also times K1 (in the ``--dtype`` mode) and K4 (CUDA events)
at every time tile that fits, at every shape ``chip_smoke.py`` launches
them at, beside the tile their rule picks, and K3 in the ``--dtype`` mode
at bs32 x 64 and ragged B=3 T=50 with its GEMM passes forced onto each tile
and its weight gradients onto 1, 2 and 4 splits, beside the plan.
``--parent DIR`` builds every kernel source of an earlier version found in
DIR (``*.cu``, with the headers they include, e.g. written there by ``git
show <commit>:mixstage_tpu_torch/ops/cuda/csrc/<file>``) into
``build/parent_kernels/`` and times them against the current kernels in
turns (parent, current, current, parent) at those shapes.  K1 in the
``--dtype`` mode: from the parent's ``fused_decoder_wgmma.cu`` where it
has one (both modes on packed weights); else float32 from its
``fused_decoder.cu`` (``mixstage_fused_decoder_f32``, the ``mma.sync``
kernel on unpacked weights) and bf16 from its ``fused_decoder_bf16.cu``
(or, older, its ``fused_decoder.cu``); K1's bf16 mode is checked against
a parent on packed weights bit for bit.  A parent with the ``mma.sync``
K1 also reports the widest C0 (at L = 3) and the deepest chain (at C0 =
266) its tile function takes at T = 64 on this card, and the current f32
mode runs both against its plain version.  With the float32 ``--dtype``
the bs32 serving calls (f32 and int8) are traced and timed with the
parent's K1 in place of the current one, in turns.
K3-fwd and K3-bwd at bs32 x 64 and at the ragged B=3 T=50: the f32 mode
(max |current - parent| / max |parent|: a parent on the 3xTF32
``mma.sync`` route sums other products), and at bf16 also the bf16 mode
(the parent's ``*_bf16`` entry points), checked against the parent bit for
bit, with out's and cs's bf16 ULPs and differing shares; K4 in both
modes (f32 and bf16 features) at every K4 shape, checked against the
parent bit for bit (a parent older than the
wgmma kernel gets its own operands, ``quant.pack_words``).
``--k1`` limits ``--parent`` and ``--sweep`` to K1, ``--k3`` to K3,
``--k4`` to K4 (the last two without the traces).
``--k2`` runs K2 alone, in both modes, at every K2 shape of
``chip_smoke.py``: on weights packed once (``pack_chain_bf16``) against
the same op packing them on each call, in turns (once, per call, per
call, once); and with ``--parent DIR`` the parent's K2 (its
``conv_chain.cu``, the FFMA chain on unpacked float32 weights, with the
headers it includes) against the current one on packed weights, in turns
as above (f32: max |current - parent| / max |parent|; bf16: bf16 ULPs and
the share of differing elements).

    python3 tools/profile_k1.py [--seed 0] [--dtype float32|bfloat16]
                                [--sweep] [--parent DIR]
                                [--k1 | --k2 | --k3 | --k4]
                                [--out profile.json]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (C, C0, K1_SHAPES, K2_SHAPES, K3_RAGGED,  # noqa: E402
                        K4_SHAPES, MEL, MODEL, B, T, bf16_ulps, cuda_ms,
                        k1_work, random_folded, random_train, trace)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G  # noqa: E402
from mixstage_tpu_torch.models.layers import reset_parameters_  # noqa: E402
from mixstage_tpu_torch import serve as tserve  # noqa: E402
from mixstage_tpu_torch.ops.cuda import build, fused_conv  # noqa: E402
from mixstage_tpu_torch.ops.cuda import quant as q8  # noqa: E402
from mixstage_tpu_torch.ops.cuda import train_decoder as td  # noqa: E402
from mixstage_tpu_torch.ops.cuda.fused_conv import (  # noqa: E402
    device_tile_frames, fused_grouped_conv_chain, fused_mixstage_decoder,
    fused_mixstage_decoder_plain, pack_chain_bf16)
from mixstage_tpu_torch.serve import build_serving_fn  # noqa: E402

SHAPES = {   # name: (B, T, G, L, F)
    "decoder": (B, T, 8, 3, 96),
    "classifier": (B, T, 1, 5, 8),
    "decoder_T4096": (1, 4096, 8, 3, 96),
    "classifier_T4096": (1, 4096, 1, 5, 8),
}
CALLS = 5
_P, _I = ctypes.c_void_p, ctypes.c_int


def report(label: str, rec: dict, flops: float = 0.0) -> None:
    rate = (f", {flops / (rec['device_busy_ms'] / 1e3) / 1e12:.2f} TFLOP/s "
            f"over busy time" if flops and rec["device_busy_ms"] else "")
    print(f"[profile] {label}: wall {rec['wall_ms']:.4f} ms/call, device "
          f"busy {rec['device_busy_ms']:.4f} ms/call, idle share "
          f"{rec['idle_share']:.3f}{rate}", flush=True)
    for k in rec["kernels"][:6]:
        print(f"[profile]   {k['ms_per_call']:.4f} ms x"
              f"{k['launches_per_call']:g}  {k['name'][:110]}", flush=True)


def k1_inputs(gen, device, dtype):
    """Seeded folded weights and features (of ``dtype``) at every K1 shape,
    and the weights packed for the kernel."""
    out = {}
    for name, (b, t, g, layers, f) in K1_SHAPES.items():
        x, *w = random_folded(torch, gen, b, t, g, layers, f, device)
        packed = fused_conv.pack_decoder_bf16(dict(w0=w[0], wc=w[1],
                                                   w_logits=w[3]))
        out[name] = ((x.to(dtype), *w), g, packed)
    return out


def k4_inputs(gen, device):
    """One seeded quantized decoder (G=8, L=3, F=96) and features at every
    K4 shape.  The dict holds the current kernel's wgmma images and, as
    ``w0_p``, ``wc_p``, ``wl_p``, the words of four channels that the
    earlier ``mma.sync`` kernel (a ``--parent`` of that age) takes."""
    G, L, F = MODEL["num_clusters"], 3, MODEL["out_feats"]
    _, w0, wc, biases, wl, bl = random_folded(torch, gen, 1, 1, G, L, F,
                                              device)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl),
        torch.randn(B, T, C0, generator=gen).to(device)))
    qfd.update({k + "_p": q8.pack_words(qfd[k + "_i8"])
                for k in ("w0", "wc", "wl")})
    xs = {name: torch.randn(b, t, C0, generator=gen).to(device)
          for name, (b, t) in K4_SHAPES.items()}
    return qfd, xs


def sweep(k1_in, qfd, xs, device) -> dict:
    """K1 and K4 at every tile that launches, beside the rule's tile (K4:
    with the wgmma width N each tile takes)."""
    lib1 = fused_conv.bind_decoder(build.load_library("fused_decoder_wgmma"))
    lib4 = q8.bind(build.load_library("decoder_int8"))
    G = MODEL["num_clusters"]
    runs = {}
    for name, (a, g, packed) in k1_in.items():
        b, t, layers, f = a[0].shape[0], a[0].shape[1], a[2].shape[0], \
            a[4].shape[-1]
        act = a[0].element_size()
        runs[f"K1 {name}"] = (
            device_tile_frames(b, t, C0, C, layers, f, g, device, act),
            lambda tile, a=a, g=g, packed=packed: launch_k1_packed(
                lib1, a, g, tile, packed))
    widths = {}
    for name, x in xs.items():
        runs[f"K4 {name}"] = (
            q8.device_tile_frames(x.shape[0], x.shape[1], C0, C, 3,
                                  MODEL["out_feats"], G, device),
            lambda tile, x=x: launch_k4(lib4, x, qfd, G, tile))
        widths[f"K4 {name}"] = {
            tile: lib4.mixstage_decoder_int8_width(x.shape[1], 3, tile)
            for tile in (8, 16, 32, 64)}
    out = {}
    for name, (rule, run) in runs.items():
        times = {}
        for tile in (8, 16, 32, 64):
            try:
                times[tile] = cuda_ms(torch, lambda: run(tile))
            except RuntimeError:           # the tile's rows do not fit
                continue
        out[name] = dict(rule=rule, ms=times, widths=widths.get(name))
        best = min(times, key=times.get)
        n = widths.get(name, {})
        print(f"[sweep] {name}: rule tile {rule}, fastest {best}; "
              + ", ".join(f"{k}" + (f" (N={n[k]})" if n else "")
                          + f": {v:.4f}" for k, v in times.items())
              + " ms", flush=True)
    return out


def k3_sweep(gen, device, dtype) -> dict:
    """K3 in the mode of ``dtype`` at bs32 x 64 and the ragged shape with
    every GEMM pass forced onto tile index 0-3 (``td.gemm_tiles``) and
    every dW pass onto 1, 2 and 4 splits of the frames (CUDA events),
    beside the plan's choice; and the plan of each pass at bs32."""
    lib = td.bind(build.load_library("train_decoder"))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    G, F = MODEL["num_clusters"], MODEL["out_feats"]
    terms, tag = (1, "K3-bf16") if dtype == torch.bfloat16 else (3, "K3")
    for mode, j, n, taps in (("conv", C0, C, 3), ("conv", C, C, 3),
                             ("conv", C, F, 1), ("convT", F, C, 1),
                             ("convT", C, C, 3), ("convT", C, C0, 3),
                             ("dW", C, F, 1), ("dW", C, C, 3),
                             ("dW", C0, C, 3)):
        tile, splits = td.gemm_plan(lib, mode, B, T, j, n, taps, G, sms,
                                    terms)
        print(f"[sweep] {tag} plan bs{B}: {mode} J={j} N={n} taps={taps}:"
              f" tile {td.gemm_tiles(mode, terms)[tile]}, {splits} "
              f"split(s)", flush=True)
    out = {}
    for shape, (b, t) in (("bs32", (B, T)), ("ragged", K3_RAGGED)):
        a = tuple(v.to(dtype)
                  for v in random_train(torch, gen, b, t, device))
        x, w0, wc, _, gamma, beta, wl, _ = a
        _, cs, mu, var = td.decoder_train_fwd(*a)
        dout = torch.randn(w0.shape[0], b, t, wl.shape[-1],
                           generator=gen).to(device).to(dtype)
        bwd = (dout, x, cs, mu, var, w0, wc, gamma, beta, wl)
        rec = {}
        for tile in range(-1, len(td.GEMM_TILES)):
            name = "plan" if tile < 0 else f"tile {tile}"
            for splits in (0, 1, 2, 4):
                lib.mixstage_train_decoder_force(tile, splits)
                key = f"{name}/{'plan' if splits == 0 else splits}"
                rec[key] = dict(bwd=cuda_ms(
                    torch, lambda: td.decoder_train_bwd(*bwd), reps=10))
                if splits == 0:
                    rec[key]["fwd"] = cuda_ms(
                        torch, lambda: td.decoder_train_fwd(*a), reps=10)
        lib.mixstage_train_decoder_force(-1, 0)
        out[shape] = rec
        print(f"[sweep] {tag} {shape} (tile/splits: fwd, bwd ms): "
              + ", ".join(f"{k}: " + "/".join(f"{v:.4f}" for v in r.values())
                          for k, r in rec.items()), flush=True)
    return out


def build_parent(src: Path, names=None) -> dict:
    """Build and bind the kernels of the sources in ``src`` (every
    ``*.cu``, or those of ``names`` it has)."""
    dst = build.BUILD_DIR.parent / "parent_kernels"
    dst.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for cu in sorted(src.glob("*.cu")):
        name = cu.stem
        if names is not None and name not in names:
            continue
        lib = dst / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src / name}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[parent build] {name}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    # K1: both modes on packed weights (fused_decoder_wgmma.cu), the bf16
    # mode alone on packed weights (fused_decoder_bf16.cu), or both on
    # unpacked float32 weights (fused_decoder.cu, older: mma.sync); K4's C
    # entry point is the current one (with a time tile)
    if "fused_decoder_wgmma" in libs:    # (a parent may have no K2)
        for mode in ("f32", "bf16"):
            fn = getattr(libs["fused_decoder_wgmma"],
                         f"mixstage_fused_decoder_{mode}")
            fn.argtypes = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I,
                                                 ctypes.c_longlong, _P]
            fn.restype = _I
    if "fused_decoder_bf16" in libs:
        fn = libs["fused_decoder_bf16"].mixstage_fused_decoder_bf16
        fn.argtypes = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I,
                                             ctypes.c_longlong, _P]
        fn.restype = _I
    if "fused_decoder" in libs:
        lib = libs["fused_decoder"]
        fns = [lib.mixstage_fused_decoder_f32]
        if "fused_decoder_bf16" not in libs:
            fns.append(lib.mixstage_fused_decoder_bf16)
        for fn in fns:
            fn.argtypes = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _P]
            fn.restype = _I
        lib.mixstage_fused_decoder_tile.argtypes = [_I] * 8 + [
            ctypes.c_size_t]
        lib.mixstage_fused_decoder_tile.restype = _I
    if "decoder_int8" in libs:
        q8.bind(libs["decoder_int8"])
    if "conv_chain" in libs:             # K2's FFMA chain, both modes
        for mode in ("f32", "bf16"):
            fn = getattr(libs["conv_chain"], f"mixstage_conv_chain_{mode}")
            fn.argtypes = [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P]
            fn.restype = _I
    if "train_decoder" not in libs:
        return libs
    # K3's (both modes), without the scratch query the current library adds
    lib = libs["train_decoder"]
    for mode in ("f32", "bf16"):
        fwd = getattr(lib, f"mixstage_train_decoder_fwd_{mode}")
        bwd = getattr(lib, f"mixstage_train_decoder_bwd_{mode}")
        fwd.argtypes = [_P] * 13 + [_I] * 6 + [_P]
        bwd.argtypes = [_P] * 21 + [_I] * 6 + [_P]
        fwd.restype = bwd.restype = _I
    return libs


def _k3_dims(x, w0, wl):
    (b, t, c0), c, f, g = x.shape, w0.shape[-1], wl.shape[-1], w0.shape[0]
    # the current kernels' scratch, at least the (G, B, T, C) the parent's
    # take
    scratch = td.bind(build.load_library(
        "train_decoder")).mixstage_train_decoder_scratch_floats(
            b, t, c0, c, f, g)
    return (b, t, c0, c, f, g), torch.empty(scratch, device=x.device)


def _mode(x):
    return "bf16" if x.dtype == torch.bfloat16 else "f32"


def parent_k3_fwd(lib, a):
    """The parent's K3-fwd on the inputs ``a`` of ``random_train`` (all
    float32, or all bfloat16: its bf16 mode)."""
    x, w0, wc, cb, gamma, beta, wl, bl = a
    dims, h = _k3_dims(x, w0, wl)
    b, t, _, c, f, g = dims
    new = dict(device=x.device, dtype=torch.float32)
    out = torch.empty(g, b, t, f, device=x.device, dtype=x.dtype)
    cs = torch.empty(4, g, b, t, c, device=x.device, dtype=x.dtype)
    mu, var = torch.empty(g, 4, c, **new), torch.empty(g, 4, c, **new)
    err = getattr(lib, f"mixstage_train_decoder_fwd_{_mode(x)}")(
        *(v.data_ptr() for v in (*a, out, cs, mu, var, h)), *dims,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent K3-fwd launch failed: error {err}")
    return out, cs, mu, var


def parent_k3_bwd(lib, dout, x, cs, mu, var, w0, wc, gamma, beta, wl):
    """The parent's K3-bwd: (dx, dw0, dwc, dcb, dgamma, dbeta, dwl, dbl),
    float32 in both modes."""
    dims, h = _k3_dims(x, w0, wl)
    _, _, _, c, f, g = dims
    new = dict(device=x.device, dtype=torch.float32)
    grads = (torch.empty(x.shape, **new), torch.empty(w0.shape, **new),
             torch.empty(wc.shape, **new),
             *(torch.empty(g, 4, c, **new) for _ in range(3)),
             torch.empty(wl.shape, **new), torch.empty(g, 1, f, **new))
    # a parent's backward takes a d(conv output) scratch after dh
    dh, dc = torch.empty(cs[0].shape, **new), torch.empty_like(cs[0])
    err = getattr(lib, f"mixstage_train_decoder_bwd_{_mode(x)}")(
        *(v.data_ptr() for v in (dout, x, cs, mu, var, w0, wc, gamma, beta,
                                 wl, *grads, h, dh, dc)), *dims,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent K3-bwd launch failed: error {err}")
    return grads


def k3_calls(lib, gen, device, dtype) -> dict:
    """{name: (parent call, current call)} of K3-fwd and K3-bwd at bs32 x
    64 and at the ragged shape, on seeded inputs: the f32 mode, and at
    ``dtype`` bfloat16 also the bf16 mode (``-bf16`` names)."""
    calls = {}
    modes = [torch.float32] + ([torch.bfloat16]
                               if dtype == torch.bfloat16 else [])
    for mode in modes:
        tag = "-bf16" if mode == torch.bfloat16 else ""
        for shape, (b, t) in (("bs32", (B, T)), ("ragged", K3_RAGGED)):
            a = tuple(v.to(mode)
                      for v in random_train(torch, gen, b, t, device))
            x, w0, wc, _, gamma, beta, wl, _ = a
            _, cs, mu, var = td.decoder_train_fwd(*a)
            dout = torch.randn(w0.shape[0], b, t, wl.shape[-1],
                               generator=gen).to(device).to(mode)
            bwd = (dout, x, cs, mu, var, w0, wc, gamma, beta, wl)
            calls[f"K3-fwd{tag} {shape}"] = (
                lambda a=a: parent_k3_fwd(lib, a),
                lambda a=a: td.decoder_train_fwd(*a))
            calls[f"K3-bwd{tag} {shape}"] = (
                lambda bwd=bwd: parent_k3_bwd(lib, *bwd),
                lambda bwd=bwd: td.decoder_train_bwd(*bwd))
    return calls


def k2_inputs(gen, device) -> dict:
    """{name: (x in both dtypes, weights, biases, G, packed weights)} at
    every K2 shape, seeded as chip_smoke.py draws them."""
    out = {}
    for name, (b, t, g, c, layers) in K2_SHAPES.items():
        x = torch.randn(b, t, g * c, generator=gen).to(device)
        w = (torch.randn(layers, g, 3, c, c, generator=gen)
             * (3 * c) ** -0.5).to(device)
        bias = (torch.randn(layers, g * c, generator=gen) * 0.1).to(device)
        out[name] = ({"": x, "-bf16": x.bfloat16()}, w, bias, g,
                     pack_chain_bf16(w))
    return out


def parent_k2(lib, x, w, bias, g):
    """A parent's K2 (``conv_chain.cu``: float32 weights as they are) in
    the mode of ``x``."""
    (b, t, _), (layers, _, _, c, _) = x.shape, w.shape
    out = torch.empty_like(x)
    fn = (lib.mixstage_conv_chain_bf16 if x.dtype == torch.bfloat16
          else lib.mixstage_conv_chain_f32)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
             t, c, layers, g, 0.2, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent K2 launch failed: error {err}")
    return out


def k2_calls(lib, k2_in) -> dict:
    """{name: (parent call, current call)} of K2 in both modes at every K2
    shape, the current one on weights packed once."""
    calls = {}
    for name, (xs, w, bias, g, packed) in k2_in.items():
        for tag, x in xs.items():
            calls[f"K2{tag} {name}"] = (
                lambda x=x, w=w, bias=bias, g=g: parent_k2(lib, x, w, bias,
                                                           g),
                lambda x=x, w=w, bias=bias, g=g, p=packed:
                    fused_grouped_conv_chain(x, w, bias, groups=g, packed=p))
    return calls


def k2_packing(k2_in) -> dict:
    """K2 on weights packed once against K2 packing them on each call
    (CUDA events, not queued: what a caller waits, host time included), in
    turns (once, per call, per call, once), both modes, every K2 shape."""
    out = {}
    for name, (xs, w, bias, g, packed) in k2_in.items():
        for tag, x in xs.items():
            calls = {"packed": lambda: fused_grouped_conv_chain(
                         x, w, bias, groups=g, packed=packed),
                     "per_call": lambda: fused_grouped_conv_chain(
                         x, w, bias, groups=g)}
            turns = dict(packed=[], per_call=[])
            for who in ("packed", "per_call", "per_call", "packed"):
                turns[who].append(cuda_ms(torch, calls[who]))
            rec = {k: sum(v) / len(v) for k, v in turns.items()}
            rec["turns"] = turns
            out[f"K2{tag} {name}"] = rec
            print(f"[k2-pack] K2{tag} {name}: packed once "
                  f"{rec['packed']:.4f} ms, packed per call "
                  f"{rec['per_call']:.4f} ms "
                  f"(+{rec['per_call'] - rec['packed']:.4f}); turns {turns}",
                  flush=True)
    return out


def rel_diff(got, ref) -> float:
    """max |got - ref| / max |ref|, the worst over paired outputs."""
    if isinstance(ref, torch.Tensor):
        got, ref = (got,), (ref,)
    return max(float((a - b).abs().max()) / float(b.abs().max().clamp_min(
        1e-30)) for a, b in zip(got, ref))


def launch_k1(lib, a, g, tile):
    """K1 of ``lib`` on the folded inputs ``a`` with ``tile`` output frames
    per CTA (0: the library's rule), through its entry point that takes
    float32 weights: ``mixstage_fused_decoder_f32`` for float32 features,
    ``mixstage_fused_decoder_bf16`` (a parent's fused_decoder.cu) for
    bfloat16 ones, whose output is bfloat16."""
    x, w0, wc, _, wl, _ = a
    (b, t, c0), c, layers, f = x.shape, w0.shape[-1], wc.shape[0], wl.shape[-1]
    fn = (lib.mixstage_fused_decoder_bf16 if x.dtype == torch.bfloat16
          else lib.mixstage_fused_decoder_f32)
    out = torch.empty(b, t, g * f, device=x.device, dtype=x.dtype)
    err = fn(*(v.data_ptr() for v in a), out.data_ptr(), b, t, c0, c, layers,
             f, g, 0.2, tile, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 launch failed: error {err}")
    return out


def launch_k1_packed(lib, a, g, tile, packed):
    """K1 of a ``fused_decoder_wgmma`` library (both modes) or a
    ``fused_decoder_bf16`` one (bfloat16 features) on the weights
    ``packed`` by ``pack_decoder_bf16``, in the mode of the features;
    ``tile`` as in ``launch_k1``."""
    x, w0, wc, biases, wl, bl = a
    (b, t, c0), c, layers, f = x.shape, w0.shape[-1], wc.shape[0], wl.shape[-1]
    mode = "bf16" if x.dtype == torch.bfloat16 else "f32"
    out = torch.empty(b, t, g * f, device=x.device, dtype=x.dtype)
    err = getattr(lib, f"mixstage_fused_decoder_{mode}")(
        x.data_ptr(), packed.data_ptr(), biases.data_ptr(), bl.data_ptr(),
        out.data_ptr(), b, t, c0, c, layers, f, g, 0.2, tile,
        fused_conv.packed_elems(c0, c, layers, f),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 ({mode}) launch failed: error {err}")
    return out


def k1_packed(libs, dtype):
    """The parent's library whose K1 takes packed weights in ``dtype``'s
    mode, or None (its K1 takes float32 weights as they are)."""
    if "fused_decoder_wgmma" in libs:
        return libs["fused_decoder_wgmma"]
    if dtype == torch.bfloat16 and "fused_decoder_bf16" in libs:
        return libs["fused_decoder_bf16"]
    return None


def parent_k1(libs, a, g, packed, tile=0):
    """The parent's K1 on the folded inputs ``a`` (``packed`` where it takes
    packed weights)."""
    lib = k1_packed(libs, a[0].dtype)
    if lib is not None:
        return launch_k1_packed(lib, a, g, tile, packed)
    return launch_k1(libs["fused_decoder"], a, g, tile)


def launch_k4(lib, x, qfd, g, tile, parent=False):
    """K4 of ``lib`` on the packed weights ``qfd`` (f32 or bf16 features
    ``x``): the wgmma images, or with ``parent`` the words of four
    channels of the earlier ``mma.sync`` kernel; ``tile`` as in
    ``launch_k1``."""
    w = ("w0_p", "wc_p", "wl_p") if parent else ("w0_img", "wc_img",
                                                 "wl_img")
    keys = ("s_vec", *w, "m0", "mc", "ml", "rq", "biases", "b_logits")
    (b, t, c0), c = x.shape, qfd["w0_i8"].shape[-1]
    layers, f = qfd["wc_i8"].shape[0], qfd["wl_i8"].shape[-1]
    out = torch.empty(b, t, g * f, device=x.device)
    fn = (lib.mixstage_decoder_int8_bf16 if x.dtype == torch.bfloat16
          else lib.mixstage_decoder_int8)
    err = fn(
        x.data_ptr(), *(qfd[k].data_ptr() for k in keys), out.data_ptr(), b,
        t, c0, c, layers, f, g, 0.2, tile,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch failed: error {err}")
    return out


def against_parent(libs, k1_in, qfd, xs, extra) -> dict:
    """Parent and current kernels in turns (P, C, C, P) at every shape,
    each turn queued behind a sleep (``cuda_ms(queued=True)``), so that the
    current kernel's Python wrapper and the parent's bare ``ctypes`` call
    add no host time to a short kernel's; also max |current - parent| /
    max |parent| (K3-bwd: the worst of its gradients; its dcb is float
    noise around 0 in both), and whether K3's bf16 mode, K4 (both modes) and
    K1's bf16 mode (against a parent on packed weights) equal the parent's
    bit for bit (``bitwise``).  ``extra`` holds more (parent, current)
    pairs by name (K3's or K2's)."""
    G = MODEL["num_clusters"]

    calls = {f"K1 {name}": (
                 lambda a=a, g=g, p=packed: parent_k1(libs, a, g, p),
                 lambda a=a, g=g, p=packed: fused_mixstage_decoder(
                     *a, groups=g, packed=p))
             for name, (a, g, packed) in k1_in.items()}
    # K4 in both modes; a parent older than the wgmma kernel takes its
    # words of four channels
    words = xs and not hasattr(libs["decoder_int8"],
                               "mixstage_decoder_int8_width")
    for name, x in xs.items():
        for tag, xm in (("", x), ("-bf16", x.bfloat16())):
            calls[f"K4{tag} {name}"] = (
                lambda xm=xm: launch_k4(libs["decoder_int8"], xm, qfd, G, 0,
                                        parent=words),
                lambda xm=xm: q8.fused_mixstage_decoder_int8(xm, qfd,
                                                             groups=G))
    calls.update(extra)
    out = {}
    for name, (old, new) in calls.items():
        ref, got = old(), new()
        bitwise = None
        if name.startswith("K3") and "bf16" in name:
            bitwise = all(torch.equal(p, q) for p, q in zip(got, ref))
        if name.startswith("K4"):                # exact in both modes
            bitwise = torch.equal(got, ref)
        if name.startswith("K1") and k1_packed(libs, got.dtype) is not None:
            bitwise = torch.equal(got, ref)      # the same mode's kernel
        if name.startswith("K3-bwd"):          # dcb: noise around 0
            ref, got = ref[:3] + ref[4:], got[:3] + got[4:]
        if name.startswith("K3-fwd-bf16"):     # out, cs in bf16 ULPs
            ulps = [bf16_ulps(torch, p, q) for p, q in zip(got[:2], ref[:2])]
            ulps = (max(u for u, _ in ulps), max(s for _, s in ulps))
            diff = rel_diff(tuple(v.float() for v in got),
                            tuple(v.float() for v in ref))
        else:
            bf16 = isinstance(got, torch.Tensor) and \
                got.dtype == torch.bfloat16
            diff = rel_diff(got.float(), ref.float()) if bf16 else \
                rel_diff(got, ref)
            ulps = bf16_ulps(torch, got, ref) if bf16 else None
        turns = dict(parent=[], current=[])
        for who in ("parent", "current", "current", "parent"):
            turns[who].append(cuda_ms(torch, old if who == "parent" else new,
                                      queued=True))
        rec = {k: sum(v) / len(v) for k, v in turns.items()}
        rec.update(turns=turns, rel_diff=diff)
        if bitwise is not None:
            rec["bitwise"] = bitwise
        if ulps:
            rec.update(bf16_ulps=ulps[0], differing=ulps[1])
        out[name] = rec
        print(f"[parent] {name}: current {rec['current']:.4f} ms, parent "
              f"{rec['parent']:.4f} ms ({rec['parent'] / rec['current']:.2f}x)"
              f"; turns {turns}; max|current - parent|/max|parent| "
              f"{diff:.3e}" + (f" ({ulps[0]:.2f} bf16 ULPs of max|parent|, "
                               f"{ulps[1]:.2%} of elements differ)"
                               if ulps else "")
              + ("" if bitwise is None else
                 f"; bit for bit: {'yes' if bitwise else 'NO'}"), flush=True)
    return out


def parent_widest(libs, device) -> dict:
    """The widest C0 (at L = 3, F = 96) and the deepest chain (at C0 = 266,
    F = 8) that the parent's ``mma.sync`` K1 takes at B = 1, T = 64 (its
    tile function on this card), and the current f32 mode at both against
    its plain version (max |err| / max |ref|)."""
    lib = libs["fused_decoder"]
    props = torch.cuda.get_device_properties(device)
    sms, smem = props.multi_processor_count, \
        props.shared_memory_per_block_optin

    def takes(c0, layers, f):
        return lib.mixstage_fused_decoder_tile(1, T, c0, C, layers, f, 1, sms,
                                               smem) > 0

    wide = max(c0 for c0 in range(C, 4097) if takes(c0, 3, 96))
    deep = max(n for n in range(129) if takes(C0, n, 8))
    gen = torch.Generator().manual_seed(5)
    out = {}
    for name, (g, c0, layers, f) in (("widest_C0", (2, wide, 3, 96)),
                                     ("deepest_L", (1, C0, deep, 8))):
        def draw(*shape, scale):
            return (torch.randn(*shape, generator=gen) * scale).to(device)

        a = (draw(1, T, c0, scale=1.0), draw(g, 3, c0, C, scale=(3 * c0)
                                             ** -.5),
             draw(layers, g, 3, C, C, scale=(3 * C) ** -.5),
             draw(g, layers + 1, C, scale=0.1), draw(g, C, f, scale=C ** -.5),
             draw(g, f, scale=0.1))
        got = fused_mixstage_decoder(*a, groups=g)
        ref = fused_mixstage_decoder_plain(*a, groups=g)
        tile = device_tile_frames(1, T, c0, C, layers, f, g, device)
        out[name] = dict(C0=c0, L=layers, tile=tile, rel_err=rel_diff(got,
                                                                      ref))
        print(f"[parent] {name}: the parent takes C0={c0} L={layers} at "
              f"T={T}; the f32 mode (tile {tile}) max|err|/max|ref| "
              f"{out[name]['rel_err']:.3e}", flush=True)
    return out


@contextlib.contextmanager
def k1_of(fn):
    """Serving calls with ``fn`` in place of the port's K1 wrapper."""
    old = tserve.fused_mixstage_decoder
    tserve.fused_mixstage_decoder = fn
    try:
        yield
    finally:
        tserve.fused_mixstage_decoder = old


def serving_turns(calls, libs) -> dict:
    """Each serving call with the parent's K1 and with the current one, in
    turns (P, C, C, P): device busy time, idle share and launches per call
    (``trace``), and its CUDA-event time (mean of 20 calls)."""
    def parent(x, w0, wc, biases, wl, bl, groups, negative_slope=0.2,
               packed=None):
        return parent_k1(libs, (x, w0, wc, biases, wl, bl), groups, packed)

    out = {}
    for name, fn in calls.items():
        turns = dict(parent=[], current=[])
        for who in ("parent", "current", "current", "parent"):
            with k1_of(parent) if who == "parent" else contextlib.nullcontext():
                rec = trace(torch, fn, CALLS)
                rec["event_ms"] = cuda_ms(torch, fn, reps=20)
            turns[who].append(rec)
        rec = {}
        for who, recs in turns.items():
            mean = {k: sum(r[k] for r in recs) / len(recs)
                    for k in ("device_busy_ms", "idle_share",
                              "launches_per_call", "event_ms")}
            mean["frames_per_s"] = B * T / (mean["event_ms"] / 1e3)
            mean["turns"] = [{k: r[k] for k in ("device_busy_ms",
                                                "idle_share", "event_ms")}
                             for r in recs]
            rec[who] = mean
        out[name] = rec
        p, c = rec["parent"], rec["current"]
        print(f"[parent] {name}: busy {p['device_busy_ms']:.4f} -> "
              f"{c['device_busy_ms']:.4f} ms, idle {p['idle_share']:.3f} -> "
              f"{c['idle_share']:.3f}, launches {p['launches_per_call']:g} -> "
              f"{c['launches_per_call']:g}; CUDA events {p['event_ms']:.3f} "
              f"-> {c['event_ms']:.3f} ms = {p['frames_per_s']:.1f} -> "
              f"{c['frames_per_s']:.1f} frames/s; turns {rec}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the compute dtype of the "
                    "traced K1 calls and serving call")
    ap.add_argument("--sweep", action="store_true",
                    help="time K1, K4 and K3 at every tile that fits")
    ap.add_argument("--parent", type=Path, default=None,
                    help="directory of an earlier version's kernel "
                         "sources (*.cu and the headers they include) to "
                         "time against")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--k1", action="store_true",
                      help="with --parent or --sweep: K1 only (no K3 or "
                           "K4)")
    only.add_argument("--k3", action="store_true",
                      help="with --parent or --sweep: K3 only (no K1, K4 "
                           "or serving traces)")
    only.add_argument("--k2", action="store_true",
                      help="K2 only, both modes: packed once against per "
                           "call, and with --parent against the parent's "
                           "K2 (no K1, K3, K4 or serving traces)")
    only.add_argument("--k4", action="store_true",
                      help="with --parent or --sweep: K4 only (both "
                           "modes; no K1, K3 or serving traces)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    dtype = getattr(torch, args.dtype)
    print(f"[profile] {smi}; torch {torch.__version__}; {args.dtype}",
          flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    out = {"card": smi, "dtype": args.dtype}
    libs = None
    with torch.inference_mode():
        if args.k2:
            k2_in = k2_inputs(gen, device)
            if args.parent:
                libs = build_parent(args.parent, ("conv_chain",))
                out["parent"] = against_parent(
                    libs, {}, None, {}, k2_calls(libs["conv_chain"], k2_in))
            out["k2_packing"] = k2_packing(k2_in)
            return finish(out, args, smi)
        if args.sweep or args.parent:
            k1_in = {} if args.k3 or args.k4 else k1_inputs(gen, device,
                                                            dtype)
            qfd, xs = (None, {}) if args.k1 or args.k3 else k4_inputs(
                gen, device)
            if args.parent:
                libs = build_parent(args.parent, ("decoder_int8",)
                                    if args.k4 else None)
                k3 = {} if args.k1 or args.k4 else k3_calls(
                    libs["train_decoder"], gen, device, dtype)
                out["parent"] = against_parent(libs, k1_in, qfd, xs, k3)
                del k3
                if k1_in and "fused_decoder" in libs:
                    out["parent_widest"] = parent_widest(libs, device)
            if args.sweep:
                if not args.k3:
                    out["sweep"] = sweep(k1_in, qfd, xs, device)
                if not (args.k1 or args.k4):
                    out["sweep_k3"] = k3_sweep(gen, device, dtype)
            del k1_in, xs
            if args.k3 or args.k4:
                return finish(out, args, smi)
        for name, (b, t, g, layers, f) in SHAPES.items():
            x, *w = random_folded(torch, gen, b, t, g, layers, f, device)
            a = (x.to(dtype), *w)            # the weights stay f32
            # packed once, as the serving function does
            packed = fused_conv.pack_decoder_bf16(dict(w0=w[0], wc=w[1],
                                                       w_logits=w[3]))
            flops, _ = k1_work(b, t, g, layers, f)
            tile = device_tile_frames(b, t, C0, C, layers, f, g, device,
                                      x.to(dtype).element_size())
            k1 = trace(torch, lambda: fused_mixstage_decoder(
                *a, groups=g, packed=packed), CALLS)
            plain = trace(torch, lambda: fused_mixstage_decoder_plain(
                *a, groups=g), CALLS)
            report(f"{name} K1 (tile {tile})", k1, flops)
            report(f"{name} plain", plain, flops)
            out[name] = dict(tile=tile, flops=flops, k1=k1, plain=plain)

        model = JointLateClusterSoftStyle4_G(**MODEL, dtype=dtype)
        reset_parameters_(model, torch.Generator().manual_seed(args.seed + 1),
                          random_bn_stats=True)
        serve = build_serving_fn(model)
        audio = torch.randn(B, T, MEL, generator=gen).to(device)
        styles = torch.randint(0, MODEL["num_speakers"], (B,),
                               generator=gen).to(device)
        out["serving_bs32"] = trace(torch, lambda: serve(audio, styles), CALLS)
        report(f"{args.dtype} serving call bs{B} T{T}", out["serving_bs32"])
        calib = (torch.randn(B, T, MEL, generator=gen),
                 torch.randint(0, MODEL["num_speakers"], (B,), generator=gen))
        serve8 = build_serving_fn(model, quantize_int8=True, calib=calib)
        out["serving_int8_bs32"] = trace(torch, lambda: serve8(audio, styles),
                                          CALLS)
        report(f"int8 serving call ({args.dtype} model) bs{B} T{T}",
               out["serving_int8_bs32"])
        if libs is not None and dtype == torch.float32:
            out["serving_turns"] = serving_turns(
                {"f32 serving call bs32": lambda: serve(audio, styles),
                 "int8 serving call (f32 model) bs32":
                     lambda: serve8(audio, styles)}, libs)
    return finish(out, args, smi)


def finish(out, args, smi) -> int:
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[profile] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
