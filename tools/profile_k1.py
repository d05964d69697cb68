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

``--sweep`` also times K1 and K4 (CUDA events) at every time tile that
fits, at every shape ``chip_smoke.py`` launches them at, beside the tile
their rule picks.  ``--parent DIR`` builds an earlier version's
``fused_decoder.cu``, ``decoder_int8.cu`` and ``train_decoder.cu`` (with
the headers they include, e.g. written there by
``git show <commit>:mixstage_tpu_torch/ops/cuda/csrc/<file>``) into
``build/parent_kernels/`` and times them against the current kernels in
turns (parent, current, current, parent) at those shapes; K3-fwd and
K3-bwd at bs32 x 64 and at the ragged B=3 T=50.

    python3 tools/profile_k1.py [--seed 0] [--sweep] [--parent DIR]
                                [--out profile.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (C, C0, K1_SHAPES, K3_RAGGED, K4_SHAPES, MEL,  # noqa: E402
                        MODEL, B, T, cuda_ms, k1_work, random_folded,
                        random_train)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.models import JointLateClusterSoftStyle4_G  # noqa: E402
from mixstage_tpu_torch.models.layers import reset_parameters_  # noqa: E402
from mixstage_tpu_torch.ops.cuda import build, fused_conv  # noqa: E402
from mixstage_tpu_torch.ops.cuda import quant as q8  # noqa: E402
from mixstage_tpu_torch.ops.cuda import train_decoder as td  # noqa: E402
from mixstage_tpu_torch.ops.cuda.fused_conv import (  # noqa: E402
    device_tile_frames, fused_mixstage_decoder, fused_mixstage_decoder_plain)
from mixstage_tpu_torch.serve import build_serving_fn  # noqa: E402

SHAPES = {   # name: (B, T, G, L, F)
    "decoder": (B, T, 8, 3, 96),
    "classifier": (B, T, 1, 5, 8),
    "decoder_T4096": (1, 4096, 8, 3, 96),
    "classifier_T4096": (1, 4096, 1, 5, 8),
}
CALLS = 5
_P, _I = ctypes.c_void_p, ctypes.c_int


def trace(fn) -> dict:
    """Device kernels, busy time and idle share of ``CALLS`` calls of fn."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    spans, kernels = [], {}
    for e in p.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (end - start) / 1e3
    busy_us, edge = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
    busy_ms = busy_us / 1e3 / CALLS
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=(1 - busy_ms / wall_ms) if wall_ms else None,
                kernels=[dict(name=n, launches_per_call=c / CALLS,
                              ms_per_call=ms / CALLS) for n, (c, ms) in top])


def report(label: str, rec: dict, flops: float = 0.0) -> None:
    rate = (f", {flops / (rec['device_busy_ms'] / 1e3) / 1e12:.2f} TFLOP/s "
            f"over busy time" if flops and rec["device_busy_ms"] else "")
    print(f"[profile] {label}: wall {rec['wall_ms']:.4f} ms/call, device "
          f"busy {rec['device_busy_ms']:.4f} ms/call, idle share "
          f"{rec['idle_share']:.3f}{rate}", flush=True)
    for k in rec["kernels"][:6]:
        print(f"[profile]   {k['ms_per_call']:.4f} ms x"
              f"{k['launches_per_call']:g}  {k['name'][:110]}", flush=True)


def k1_inputs(gen, device):
    """Seeded folded weights and features at every K1 shape."""
    return {name: (random_folded(torch, gen, b, t, g, layers, f, device), g)
            for name, (b, t, g, layers, f) in K1_SHAPES.items()}


def k4_inputs(gen, device):
    """One seeded quantized decoder (G=8, L=3, F=96) and features at every
    K4 shape."""
    G, L, F = MODEL["num_clusters"], 3, MODEL["out_feats"]
    _, w0, wc, biases, wl, bl = random_folded(torch, gen, 1, 1, G, L, F,
                                              device)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl),
        torch.randn(B, T, C0, generator=gen).to(device)))
    xs = {name: torch.randn(b, t, C0, generator=gen).to(device)
          for name, (b, t) in K4_SHAPES.items()}
    return qfd, xs


def sweep(k1_in, qfd, xs, device) -> dict:
    """K1 and K4 at every tile that launches, beside the rule's tile."""
    lib1 = fused_conv.bind(build.load_library("fused_decoder"))
    lib4 = q8.bind(build.load_library("decoder_int8"))
    G = MODEL["num_clusters"]
    runs = {}
    for name, (a, g) in k1_in.items():
        b, t, layers, f = a[0].shape[0], a[0].shape[1], a[2].shape[0], \
            a[4].shape[-1]
        runs[f"K1 {name}"] = (
            device_tile_frames(b, t, C0, C, layers, f, g, device),
            lambda tile, a=a, g=g: launch_k1(lib1, a, g, tile))
    for name, x in xs.items():
        runs[f"K4 {name}"] = (
            q8.device_tile_frames(x.shape[0], x.shape[1], C0, C, 3,
                                  MODEL["out_feats"], G, device),
            lambda tile, x=x: launch_k4(lib4, x, qfd, G, tile))
    out = {}
    for name, (rule, run) in runs.items():
        times = {}
        for tile in (8, 16, 32, 64):
            try:
                times[tile] = cuda_ms(torch, lambda: run(tile))
            except RuntimeError:           # the tile's rows do not fit
                continue
        out[name] = dict(rule=rule, ms=times)
        best = min(times, key=times.get)
        print(f"[sweep] {name}: rule tile {rule}, fastest {best}; "
              + ", ".join(f"{k}: {v:.4f}" for k, v in times.items())
              + " ms", flush=True)
    return out


def build_parent(src: Path) -> dict:
    """Build and bind the kernels of the sources in ``src``."""
    dst = build.BUILD_DIR.parent / "parent_kernels"
    dst.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in build.SOURCES:
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
    # K1's and K4's C entry points are the current ones (with a time tile)
    fused_conv.bind(libs["fused_decoder"])
    q8.bind(libs["decoder_int8"])
    # K3's, without the scratch query the current library adds
    lib = libs["train_decoder"]
    lib.mixstage_train_decoder_fwd_f32.argtypes = [_P] * 13 + [_I] * 6 + [_P]
    lib.mixstage_train_decoder_bwd_f32.argtypes = [_P] * 21 + [_I] * 6 + [_P]
    lib.mixstage_train_decoder_fwd_f32.restype = _I
    lib.mixstage_train_decoder_bwd_f32.restype = _I
    return libs


def _k3_dims(x, w0, wl):
    (b, t, c0), c, f, g = x.shape, w0.shape[-1], wl.shape[-1], w0.shape[0]
    # the current kernels' scratch, at least the (G, B, T, C) the parent's
    # take
    scratch = td.bind(build.load_library(
        "train_decoder")).mixstage_train_decoder_scratch_floats(
            b, t, c0, c, f, g)
    return (b, t, c0, c, f, g), torch.empty(scratch, device=x.device)


def parent_k3_fwd(lib, a):
    """The parent's K3-fwd on the inputs ``a`` of ``random_train``."""
    x, w0, wc, cb, gamma, beta, wl, bl = a
    dims, h = _k3_dims(x, w0, wl)
    b, t, _, c, f, g = dims
    new = dict(device=x.device, dtype=torch.float32)
    out = torch.empty(g, b, t, f, **new)
    cs = torch.empty(4, g, b, t, c, **new)
    mu, var = torch.empty(g, 4, c, **new), torch.empty(g, 4, c, **new)
    err = lib.mixstage_train_decoder_fwd_f32(
        *(v.data_ptr() for v in (*a, out, cs, mu, var, h)), *dims,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent K3-fwd launch failed: error {err}")
    return out, cs, mu, var


def parent_k3_bwd(lib, dout, x, cs, mu, var, w0, wc, gamma, beta, wl):
    """The parent's K3-bwd: (dx, dw0, dwc, dcb, dgamma, dbeta, dwl, dbl)."""
    dims, h = _k3_dims(x, w0, wl)
    _, _, _, c, f, g = dims
    new = dict(device=x.device, dtype=torch.float32)
    grads = (torch.empty_like(x), torch.empty_like(w0), torch.empty_like(wc),
             *(torch.empty(g, 4, c, **new) for _ in range(3)),
             torch.empty_like(wl), torch.empty(g, 1, f, **new))
    dh, dc = torch.empty_like(cs[0]), torch.empty_like(cs[0])
    err = lib.mixstage_train_decoder_bwd_f32(
        *(v.data_ptr() for v in (dout, x, cs, mu, var, w0, wc, gamma, beta,
                                 wl, *grads, h, dh, dc)), *dims,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent K3-bwd launch failed: error {err}")
    return grads


def k3_calls(lib, gen, device) -> dict:
    """{name: (parent call, current call)} of K3-fwd and K3-bwd at bs32 x
    64 and at the ragged shape, on seeded inputs."""
    calls = {}
    for shape, (b, t) in (("bs32", (B, T)), ("ragged", K3_RAGGED)):
        a = random_train(torch, gen, b, t, device)
        x, w0, wc, _, gamma, beta, wl, _ = a
        _, cs, mu, var = td.decoder_train_fwd(*a)
        dout = torch.randn(w0.shape[0], b, t, wl.shape[-1],
                           generator=gen).to(device)
        bwd = (dout, x, cs, mu, var, w0, wc, gamma, beta, wl)
        calls[f"K3-fwd {shape}"] = (lambda a=a: parent_k3_fwd(lib, a),
                                    lambda a=a: td.decoder_train_fwd(*a))
        calls[f"K3-bwd {shape}"] = (
            lambda bwd=bwd: parent_k3_bwd(lib, *bwd),
            lambda bwd=bwd: td.decoder_train_bwd(*bwd))
    return calls


def rel_diff(got, ref) -> float:
    """max |got - ref| / max |ref|, the worst over paired outputs."""
    if isinstance(ref, torch.Tensor):
        got, ref = (got,), (ref,)
    return max(float((a - b).abs().max()) / float(b.abs().max().clamp_min(
        1e-30)) for a, b in zip(got, ref))


def launch_k1(lib, a, g, tile):
    """K1 of ``lib`` on the folded inputs ``a`` with ``tile`` output frames
    per CTA (0: the library's rule)."""
    x, w0, wc, _, wl, _ = a
    (b, t, c0), c, layers, f = x.shape, w0.shape[-1], wc.shape[0], wl.shape[-1]
    out = torch.empty(b, t, g * f, device=x.device)
    err = lib.mixstage_fused_decoder_f32(
        *(v.data_ptr() for v in a), out.data_ptr(), b, t, c0, c, layers, f,
        g, 0.2, tile, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 launch failed: error {err}")
    return out


def launch_k4(lib, x, qfd, g, tile):
    """K4 of ``lib`` on the packed weights ``qfd``; ``tile`` as in
    ``launch_k1``."""
    keys = ("s_vec", "w0_p", "wc_p", "wl_p", "m0", "mc", "ml", "rq",
            "biases", "b_logits")
    (b, t, c0), c = x.shape, qfd["w0_i8"].shape[-1]
    layers, f = qfd["wc_i8"].shape[0], qfd["wl_i8"].shape[-1]
    out = torch.empty(b, t, g * f, device=x.device)
    err = lib.mixstage_decoder_int8(
        x.data_ptr(), *(qfd[k].data_ptr() for k in keys), out.data_ptr(), b,
        t, c0, c, layers, f, g, 0.2, tile,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch failed: error {err}")
    return out


def against_parent(libs, k1_in, qfd, xs, k3) -> dict:
    """Parent and current kernels in turns (P, C, C, P) at every shape;
    also max |current - parent| / max |parent| (K3-bwd: the worst of its
    gradients; its dcb is float noise around 0 in both)."""
    G = MODEL["num_clusters"]
    calls = {f"K1 {name}": (lambda a=a, g=g: launch_k1(
                 libs["fused_decoder"], a, g, 0),
             lambda a=a, g=g: fused_mixstage_decoder(*a, groups=g))
             for name, (a, g) in k1_in.items()}
    calls.update({f"K4 {name}": (lambda x=x: launch_k4(
                      libs["decoder_int8"], x, qfd, G, 0),
                  lambda x=x: q8.fused_mixstage_decoder_int8(x, qfd,
                                                             groups=G))
                  for name, x in xs.items()})
    calls.update(k3)
    out = {}
    for name, (old, new) in calls.items():
        ref, got = old(), new()
        if name.startswith("K3-bwd"):          # dcb: noise around 0
            ref, got = ref[:3] + ref[4:], got[:3] + got[4:]
        diff = rel_diff(got, ref)
        turns = dict(parent=[], current=[])
        for who in ("parent", "current", "current", "parent"):
            turns[who].append(cuda_ms(torch, old if who == "parent" else new))
        rec = {k: sum(v) / len(v) for k, v in turns.items()}
        rec.update(turns=turns, rel_diff=diff)
        out[name] = rec
        print(f"[parent] {name}: current {rec['current']:.4f} ms, parent "
              f"{rec['parent']:.4f} ms ({rec['parent'] / rec['current']:.2f}x)"
              f"; turns {turns}; max|current - parent|/max|parent| "
              f"{diff:.3e}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="time K1 and K4 at every tile that fits")
    ap.add_argument("--parent", type=Path, default=None,
                    help="directory of an earlier fused_decoder.cu, "
                         "decoder_int8.cu and train_decoder.cu to time "
                         "against")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[profile] {smi}; torch {torch.__version__}", flush=True)
    gen = torch.Generator().manual_seed(args.seed)
    out = {"card": smi}
    with torch.inference_mode():
        if args.sweep or args.parent:
            k1_in = k1_inputs(gen, device)
            qfd, xs = k4_inputs(gen, device)
            if args.parent:
                libs = build_parent(args.parent)
                k3 = k3_calls(libs["train_decoder"], gen, device)
                out["parent"] = against_parent(libs, k1_in, qfd, xs, k3)
                del k3
            if args.sweep:
                out["sweep"] = sweep(k1_in, qfd, xs, device)
            del k1_in, xs
        for name, (b, t, g, layers, f) in SHAPES.items():
            a = random_folded(torch, gen, b, t, g, layers, f, device)
            flops, _ = k1_work(b, t, g, layers, f)
            tile = device_tile_frames(b, t, C0, C, layers, f, g, device)
            k1 = trace(lambda: fused_mixstage_decoder(*a, groups=g))
            plain = trace(lambda: fused_mixstage_decoder_plain(*a, groups=g))
            report(f"{name} K1 (tile {tile})", k1, flops)
            report(f"{name} plain", plain, flops)
            out[name] = dict(tile=tile, flops=flops, k1=k1, plain=plain)

        model = JointLateClusterSoftStyle4_G(**MODEL)
        reset_parameters_(model, torch.Generator().manual_seed(args.seed + 1),
                          random_bn_stats=True)
        serve = build_serving_fn(model)
        audio = torch.randn(B, T, MEL, generator=gen).to(device)
        styles = torch.randint(0, MODEL["num_speakers"], (B,),
                               generator=gen).to(device)
        out["serving_bs32"] = trace(lambda: serve(audio, styles))
        report(f"serving call bs{B} T{T}", out["serving_bs32"])
        calib = (torch.randn(B, T, MEL, generator=gen),
                 torch.randint(0, MODEL["num_speakers"], (B,), generator=gen))
        serve8 = build_serving_fn(model, quantize_int8=True, calib=calib)
        out["serving_int8_bs32"] = trace(lambda: serve8(audio, styles))
        report(f"int8 serving call bs{B} T{T}", out["serving_int8_bs32"])
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[profile] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
