#!/usr/bin/env python3
"""K1's kernel against variants of itself, on one CUDA card, in one mode.

Each variant is ``csrc/fused_decoder_wgmma.cu`` with one edit, written to
``build/k1_variants/`` and built there with the port's ``nvcc`` flags (all
variants at once, one ``nvcc`` each).  Each then runs in a process of its
own, so that a variant that cannot finish (one whose ring deadlocks) is
ended by a timeout and the rest still run.  Per variant it prints the
``ptxas`` registers, spills and any "Potential Performance Loss" advisory,
and at every shape of ``chip_smoke.K1_SHAPES`` the time at the tile the
variant's own rule picks (CUDA events, the launches queued behind a sleep)
and, for the variants
that compute the function, the error against the plain version: in the
f32 mode max |err| / max |ref| (the kernel is held to 1e-4), in the bf16
mode the bf16 rule, the bf16 ULPs of max |plain| and the share of
differing elements.

The f32 mode's variants (``--mode f32``, the default):

* ``kernel``: the source as it is;
* ``no-mma``: the wgmmas skipped: the weight stream, the input stage, the
  epilogues and the pipeline's synchronisation;
* ``no-copy``: the weight copies skipped (the MMAs run on whatever the
  ring holds): the consumers alone;
* ``no-epilogue``: no layer's epilogue (no bias, leaky, split or store;
  the wgmmas kept live by a test of one sum that never holds);
* ``two-buffers``: two activation buffers, each layer written into the
  other, as the bf16 mode does (the tile rule then picks among the tiles
  that fit with them);
* ``group-4``: groups of up to 4 chunks whatever the ring's stages (no
  chunk in flight while a group's wgmmas run where the ring has 4);
* ``partials-1``: one chunk (16 channels) per zeroed partial;
* ``one-product``: x1w1 alone, both operands rounded to bf16 (a fault the
  1e-4 limit must catch).

The bf16 mode's (``--mode bf16``): ``kernel``, ``no-mma``, ``no-copy``;
``partials-2``, ``partials-3`` (chunks per zeroed partial); ``stages-5``
(a ring of at most 5 stages); ``runtime-ring`` (the ring's stages and
group read at run time, as the f32 mode reads them, not fixed at compile
time); ``direct`` (no partials: the wgmmas
accumulate straight into the accumulator, each group's stages released
one group later); ``double-buffered`` (two partials, each group issued
before the one before it is waited for); ``rz-last`` (the last hidden
layer rounded toward zero, not to nearest: a fault the differing-share
check must catch).

``--k2`` runs each variant's chain mode (K2: ``mixstage_conv_chain_*``
on weights packed by ``pack_chain_bf16``) at every shape of
``chip_smoke.K2_SHAPES`` instead, against ``chain_plain``.

    python3 tools/k1_variants.py [--mode f32|bf16] [--seed 0] [--k2]
                                 [--only NAME ...]
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (C, C0, K1_SHAPES, K2_SHAPES, KERNEL_TOL,  # noqa: E402
                        bf16_rule, bf16_ulps, cuda_ms, ptxas_summary,
                        random_folded)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.ops.cuda import build, fused_conv  # noqa: E402

OUT = build.BUILD_DIR.parent / "k1_variants"

# the consumer's group loop, replaced whole by two of the bf16 variants
LOOP = """      for (int c0 = 0; c0 < n; c0 += group) {
        const int nc = min(group, n - c0);
        const int s0 = s;
        // wait for the group's chunks; their A and B addresses
        uint32_t a[kGroupChunks], bb[kGroupChunks];
#pragma unroll
        for (int i = 0; i < kGroupChunks; ++i) {
          if (i < nc) {
            const int c = c0 + i, tap = c / ly.nk, kc = c - tap * ly.nk;
            sm90::mbar_wait(&full[s], ph);
            a[i] = a_addr + (uint32_t)s * slot;
            bb[i] = b_addr + (uint32_t)(2 * kc * nrows + tap) * line;
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
        mma_group_n<N, kGroupChunks, KX>(nc, part, a, bb, 2 * mp * line,
                                         term_b, mp * line, lbo_b);
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          sm90::fence_operand(part[i]);
          acc[i] += part[i];
        }
        // this warp is done with the group's stages
        if (lane == 0) {
          int st = s0;
          for (int i = 0; i < nc; ++i) {
            sm90::mbar_arrive(&empty[st]);
            if (++st == stages) st = 0;
          }
        }
      }
"""

# wait for the group of chunks from c0 and note their A and B addresses
TAKE = """      auto take = [&](int c0, uint32_t (&a)[kGroupChunks],
                      uint32_t (&bb)[kGroupChunks]) {
        const int nc = min(group, n - c0);
#pragma unroll
        for (int i = 0; i < kGroupChunks; ++i) {
          if (i < nc) {
            const int c = c0 + i, tap = c / ly.nk, kc = c - tap * ly.nk;
            sm90::mbar_wait(&full[s], ph);
            a[i] = a_addr + (uint32_t)s * slot;
            bb[i] = b_addr + (uint32_t)(2 * kc * nrows + tap) * line;
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
        return nc;
      };
      auto release = [&](int s0, int nc) {
        if (lane == 0) {
          int st = s0;
          for (int i = 0; i < nc; ++i) {
            sm90::mbar_arrive(&empty[st]);
            if (++st == stages) st = 0;
          }
        }
      };
"""
MMA_CALL = """mma_group_n<N, kGroupChunks, KX>({nc}, {d}, a, bb, 2 * mp * line,
                                         term_b, mp * line, lbo_b);"""

DIRECT = TAKE + """      int s_prev = 0, nc_prev = 0;
      for (int c0 = 0; c0 < n; c0 += group) {
        uint32_t a[kGroupChunks], bb[kGroupChunks];
        const int s0 = s, nc = take(c0, a, bb);
        """ + MMA_CALL.format(nc="nc", d="acc") + """
        sm90::wgmma_wait<1>();
        release(s_prev, nc_prev);
        s_prev = s0;
        nc_prev = nc;
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sm90::fence_operand(acc[i]);
      release(s_prev, nc_prev);
"""

DOUBLE = TAKE + """      auto retire = [&](float (&p)[N / 2], int s0, int nc) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          sm90::fence_operand(p[i]);
          acc[i] += p[i];
        }
        release(s0, nc);
      };
      int s_prev = 0, nc_prev = 0;
      for (int c0 = 0; c0 < n; c0 += 2 * group) {
        uint32_t a[kGroupChunks], bb[kGroupChunks];
        const int sa = s, nca = take(c0, a, bb);
        """ + MMA_CALL.format(nc="nca", d="part") + """
        if (nc_prev) {
          sm90::wgmma_wait<1>();
          retire(part2, s_prev, nc_prev);
        }
        if (c0 + group < n) {
          const int sb = s, ncb = take(c0 + group, a, bb);
          """ + MMA_CALL.format(nc="ncb", d="part2") + """
          sm90::wgmma_wait<1>();
          retire(part, sa, nca);
          s_prev = sb;
          nc_prev = ncb;
        } else {
          sm90::wgmma_wait<0>();
          retire(part, sa, nca);
          nc_prev = 0;
        }
      }
      if (nc_prev) {
        sm90::wgmma_wait<0>();
        retire(part2, s_prev, nc_prev);
      }
"""

FEATURE = "Feature<KX>::of(leaky(v, slope))"
COPY = """          sm90::mbar_arrive_expect_tx(&full[s], bytes);
          sm90::bulk_copy(ring + (size_t)s * slot, src, bytes, &full[s]);
"""
MMA = "        mma_group_n<N, kGroupChunks, KX>(nc, part, a, bb,"
GROUP = """    group = stages - 2 < 1 ? 1
            : stages - 2 > kGroupChunks ? kGroupChunks : stages - 2;"""


def variants(mode: str) -> dict:
    """{name: [(old, new), ...]}: the edits of each variant of ``mode``."""
    common = {
        "kernel": [],
        "no-mma": [(MMA, "        if (false) " + MMA.lstrip())],
        "no-copy": [(COPY, "          sm90::mbar_arrive(&full[s]);\n")],
    }
    if mode == "f32":
        return {
            **common,
            # (a store on a value no sum reaches keeps the wgmmas live:
            # without one ptxas drops them)
            "no-epilogue": [("      if (wg * 64 < ly.cout) {",
                             "      if (wg * 64 < ly.cout && acc[0] == "
                             "-1.2345e-38f) {")],
            "two-buffers": [("return terms == 1 ? 2 : 1;", "return 2;")],
            "group-4": [(GROUP, "    group = stages < kGroupChunks ? stages"
                                " : kGroupChunks;")],
            "partials-1": [("kGroupChunks = 4;", "kGroupChunks = 1;")],
            "one-product": [("for (int k = 2; k >= 0; --k) {",
                             "for (int k = 0; k >= 0; --k) {"),
                            ("(c > 0 || k < 2 || i > 0) ? 1 : 0",
                             "c > 0 ? 1 : 0")],
        }
    two = ("kGroupChunks = 4;", "kGroupChunks = 2;")
    return {
        **common,
        "partials-2": [two],
        "partials-3": [("kGroupChunks = 4;", "kGroupChunks = 3;")],
        "stages-5": [("kStages = 6;", "kStages = 5;")],
        # the ring's stages and group as run-time values, as the f32 mode
        # takes them
        "runtime-ring": [("  if (KX == 1) {\n    stages = kStages;\n"
                          "    group = kGroupChunks;\n  }\n", "")],
        # a group is released only after the next is issued: two groups
        # must fit the ring
        "direct": [two, (LOOP, DIRECT),
                   ("            (c > 0 || k < 2 || i > 0) ? 1 : 0);",
                    "            1);")],
        "double-buffered": [two, (LOOP, DOUBLE),
                            ("    float acc[N / 2], part[N / 2];",
                             "    float acc[N / 2], part[N / 2], "
                             "part2[N / 2];")],
        "rz-last": [(FEATURE, f"(l == L ? Feature<KX>::of(__bfloat162float("
                              f"__float2bfloat16_rz(leaky(v, slope)))) : "
                              f"{FEATURE})")],
    }


# the variants that compute the function (the rest are timed only)
COMPUTING = {"f32": ("kernel", "two-buffers", "group-4", "partials-1",
                     "one-product"),
             "bf16": ("kernel", "partials-2", "partials-3", "stages-5",
                      "runtime-ring", "direct", "double-buffered", "rz-last")}


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit does not apply once to the source: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_all(mode, names) -> None:
    """Write and build every variant in ``names``, one nvcc each."""
    src = build.SOURCES["fused_decoder_wgmma"].read_text()
    edits = variants(mode)
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, OUT)
    jobs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(patched(src, edits[name]))
        jobs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        terms = 3 if mode == "f32" else 1
        for chain in ("false", "true"):
            regs = sorted({(r, st, ld) for k, r, st, ld in ptxas_summary(log)
                           if k.endswith(f", {terms}, {chain}>")})
            print(f"[build] {name}: (registers, spill stores, spill loads) "
                  f"of its {mode} {'chain' if chain == 'true' else 'decoder'}"
                  f" instances {regs}", flush=True)
        for line in log.splitlines():
            if "Performance Loss" in line:
                print(f"[build] {name}: {line.split(':', 1)[1].strip()[:150]}",
                      flush=True)


def run(mode: str, name: str, seed: int) -> None:
    """Time and check one built variant (in this process)."""
    device = resolve_device("cuda")
    lib = fused_conv.bind_decoder(ctypes.CDLL(str(OUT / f"lib{name}.so")))
    launch_fn = getattr(lib, f"mixstage_fused_decoder_{mode}")
    gen = torch.Generator().manual_seed(seed)
    for shape, (b, t, g, layers, f) in K1_SHAPES.items():
        x, *w = random_folded(torch, gen, b, t, g, layers, f, device)
        xm = x.bfloat16() if mode == "bf16" else x
        packed = fused_conv.pack_decoder_bf16(dict(w0=w[0], wc=w[1],
                                                   w_logits=w[3]))
        gstride = fused_conv.packed_elems(C0, C, layers, f)

        def launch():
            out = torch.empty(b, t, g * f, device=device, dtype=xm.dtype)
            err = launch_fn(
                xm.data_ptr(), packed.data_ptr(), w[2].data_ptr(),
                w[4].data_ptr(), out.data_ptr(), b, t, C0, C, layers, f, g,
                0.2, 0, gstride, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {name} launch failed: {err}")
            return out

        out = launch()
        torch.cuda.synchronize()
        line = f"[variant] {mode} {name} {shape}:"
        if name in COMPUTING[mode] and mode == "f32":
            ref = fused_conv.fused_mixstage_decoder_plain(x, *w, groups=g)
            rel = float((out - ref).abs().max() / ref.abs().max())
            line += (f" max|err|/max|ref| {rel:.3e} "
                     f"({'within' if rel <= KERNEL_TOL else 'ABOVE'} "
                     f"{KERNEL_TOL:g})")
        elif name in COMPUTING[mode]:
            ref = fused_conv.fused_mixstage_decoder_plain(xm, *w, groups=g)
            truth = fused_conv.fused_mixstage_decoder_plain(x, *w, groups=g)
            dp, dq, ok = bf16_rule(out, ref, truth)
            ulps, share = bf16_ulps(torch, out, ref)
            line += (f" bf16 rule {'ok' if ok else 'FAILS'} ({dp:.4e} / "
                     f"{dq:.4e}), {ulps:.2f} bf16 ULPs, {share:.2%} of "
                     f"elements differ")
        props = torch.cuda.get_device_properties(device)
        tile = getattr(lib, f"mixstage_fused_decoder_{mode}_tile")(
            b, t, C0, C, layers, f, g, props.multi_processor_count,
            props.shared_memory_per_block_optin)
        print(f"{line}; tile {tile}: {cuda_ms(torch, launch, queued=True):.4f}"
              f" ms", flush=True)


def run_k2(mode: str, name: str, seed: int) -> None:
    """Time and check one built variant's chain mode (in this process)."""
    device = resolve_device("cuda")
    lib = fused_conv.bind_decoder(ctypes.CDLL(str(OUT / f"lib{name}.so")))
    launch_fn = getattr(lib, f"mixstage_conv_chain_{mode}")
    gen = torch.Generator().manual_seed(seed)
    for shape, (b, t, g, c, layers) in K2_SHAPES.items():
        x = torch.randn(b, t, g * c, generator=gen).to(device)
        w = (torch.randn(layers, g, 3, c, c, generator=gen)
             * (3 * c) ** -0.5).to(device)
        bias = (torch.randn(layers, g * c, generator=gen) * 0.1).to(device)
        xm = x.bfloat16() if mode == "bf16" else x
        packed = fused_conv.pack_chain_bf16(w)

        def launch():
            out = torch.empty_like(xm)
            err = launch_fn(
                xm.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, t, c, layers, g, 0.2, 0,
                fused_conv.chain_packed_elems(c, layers),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {name} launch failed: {err}")
            return out

        out = launch()
        torch.cuda.synchronize()
        line = f"[variant] {mode} {name} K2 {shape}:"
        ref = fused_conv.chain_plain(xm, w, bias, groups=g)
        if name in COMPUTING[mode] and mode == "f32":
            rel = float((out - ref).abs().max() / ref.abs().max())
            line += (f" max|err|/max|ref| {rel:.3e} "
                     f"({'within' if rel <= KERNEL_TOL else 'ABOVE'} "
                     f"{KERNEL_TOL:g})")
        elif name in COMPUTING[mode]:
            truth = fused_conv.chain_plain(x, w, bias, groups=g)
            dp, dq, ok = bf16_rule(out, ref, truth)
            ulps, share = bf16_ulps(torch, out, ref)
            line += (f" bf16 rule {'ok' if ok else 'FAILS'} ({dp:.4e} / "
                     f"{dq:.4e}), {ulps:.2f} bf16 ULPs, {share:.2%} of "
                     f"elements differ")
        tile = fused_conv.chain_tile_frames(b, t, c, layers, g, device,
                                            xm.element_size())
        print(f"{line}; tile {tile}: {cuda_ms(torch, launch, queued=True):.4f}"
              f" ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k2", action="store_true",
                    help="run the chain mode at the K2 shapes")
    ap.add_argument("--only", nargs="+", default=None,
                    help="the variants to build and run (default: all)")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:                     # the child process of one variant
        (run_k2 if args.k2 else run)(args.mode, args.run, args.seed)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[variants] {smi}; torch {torch.__version__}; {args.mode} mode",
          flush=True)
    names = args.only or list(variants(args.mode))
    build_all(args.mode, names)
    for name in names:
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--mode", args.mode, "--run",
                 name, "--seed", str(args.seed)]
                + (["--k2"] if args.k2 else []), timeout=240)
            status = f"exit {proc.returncode}"
        except subprocess.TimeoutExpired:
            status = "did not finish in 240 s"
        print(f"[variants] {name}: {status}", flush=True)
    print(f"[variants] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
