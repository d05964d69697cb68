#!/usr/bin/env python3
"""K1's bf16 kernel against variants of itself, on one CUDA card.

Each variant is ``csrc/fused_decoder_bf16.cu`` with one edit, written to
``build/k1_bf16_variants/`` and built there with the port's ``nvcc``
flags (all variants at once, one ``nvcc`` each).  Each then runs in a
process of its own, so that a variant that cannot finish (one whose ring
deadlocks) is ended by a timeout and the rest still run.  Per variant it
prints the ``ptxas`` registers, spills and any "Potential Performance
Loss" advisory, the time of the bs32 decoder and classifier at the tile
the rule picks (CUDA events), and, for the variants that compute the
function, the bf16 rule, the bf16 ULPs of max |plain| and the share of
differing elements against the plain version at every shape of
``chip_smoke.K1_SHAPES``.  The variants:

* ``kernel``: the source as it is;
* ``no-mma``: the wgmmas skipped: the weight stream and the pipeline's
  synchronisation alone;
* ``no-copy``: the weight copies skipped (the MMAs run on whatever the
  ring holds): the consumers alone;
* ``partials-2``, ``partials-3``: 2 or 3 chunks per zeroed partial;
* ``stages-5``: a 5-stage ring;
* ``direct``: no partials: the wgmmas accumulate straight into the
  accumulator, each group's stages released one group later;
* ``double-buffered``: two partials, each group issued before the one
  before it is waited for;
* ``rz-last``: the last hidden layer rounded toward zero, not to nearest
  (a fault the differing-share check must catch).

    python3 tools/k1_bf16_variants.py [--seed 0] [--only NAME ...]
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

from chip_smoke import (C, C0, K1_SHAPES, bf16_rule, bf16_ulps,  # noqa: E402
                        cuda_ms, ptxas_summary, random_folded)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.ops.cuda import build, fused_conv  # noqa: E402

OUT = build.BUILD_DIR.parent / "k1_bf16_variants"
TIMED = ("decoder", "classifier")
COMPUTING = ("kernel", "partials-2", "partials-3", "stages-5", "direct",
             "double-buffered", "rz-last")

# the consumer's group loop, replaced whole by the last two variants
LOOP = """      for (int c0 = 0; c0 < n; c0 += kGroupChunks) {
        const int nc = min(kGroupChunks, n - c0);
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
            if (++s == kStages) {
              s = 0;
              ph ^= 1;
            }
          }
        }
        mma_group_n<N, kGroupChunks>(nc, part, a, bb, 2 * mp * line,
                                     mp * line, lbo_b);
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
            if (++st == kStages) st = 0;
          }
        }
      }
"""

# wait for the group of chunks from c0 and note their A and B addresses
TAKE = """      auto take = [&](int c0, uint32_t (&a)[kGroupChunks],
                      uint32_t (&bb)[kGroupChunks]) {
        const int nc = min(kGroupChunks, n - c0);
#pragma unroll
        for (int i = 0; i < kGroupChunks; ++i) {
          if (i < nc) {
            const int c = c0 + i, tap = c / ly.nk, kc = c - tap * ly.nk;
            sm90::mbar_wait(&full[s], ph);
            a[i] = a_addr + (uint32_t)s * slot;
            bb[i] = b_addr + (uint32_t)(2 * kc * nrows + tap) * line;
            if (++s == kStages) {
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
            if (++st == kStages) st = 0;
          }
        }
      };
"""

DIRECT = TAKE + """      int s_prev = 0, nc_prev = 0;
      for (int c0 = 0; c0 < n; c0 += kGroupChunks) {
        uint32_t a[kGroupChunks], bb[kGroupChunks];
        const int s0 = s, nc = take(c0, a, bb);
        mma_group_n<N, kGroupChunks>(nc, acc, a, bb, 2 * mp * line,
                                     mp * line, lbo_b);
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
      for (int c0 = 0; c0 < n; c0 += 2 * kGroupChunks) {
        uint32_t a[kGroupChunks], bb[kGroupChunks];
        const int sa = s, nca = take(c0, a, bb);
        mma_group_n<N, kGroupChunks>(nca, part, a, bb, 2 * mp * line,
                                     mp * line, lbo_b);
        if (nc_prev) {
          sm90::wgmma_wait<1>();
          retire(part2, s_prev, nc_prev);
        }
        if (c0 + kGroupChunks < n) {
          const int sb = s, ncb = take(c0 + kGroupChunks, a, bb);
          mma_group_n<N, kGroupChunks>(ncb, part2, a, bb, 2 * mp * line,
                                       mp * line, lbo_b);
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

ROUND = "__float2bfloat16_rn(leaky(v, slope))"
COPY = """          sm90::mbar_arrive_expect_tx(&full[s], bytes);
          sm90::bulk_copy(ring + (size_t)s * slot, src, bytes, &full[s]);
"""
MMA = "        mma_group_n<N, kGroupChunks>(nc, part, a, bb,"


def variants() -> dict:
    """{name: [(old, new), ...]}: the edits of each variant."""
    two = ("kGroupChunks = 4;", "kGroupChunks = 2;")
    return {
        "kernel": [],
        "no-mma": [(MMA, "        if (false) " + MMA.lstrip())],
        "no-copy": [(COPY, "          sm90::mbar_arrive(&full[s]);\n")],
        "partials-2": [two],
        "partials-3": [("kGroupChunks = 4;", "kGroupChunks = 3;")],
        "stages-5": [("kStages = 6;", "kStages = 5;")],
        # a group is released only after the next is issued: two groups
        # must fit the ring
        "direct": [two, (LOOP, DIRECT),
                   ("          (c > 0 || t < 2) ? 1 : 0);", "          1);")],
        "double-buffered": [two, (LOOP, DOUBLE),
                            ("    float acc[N / 2], part[N / 2];",
                             "    float acc[N / 2], part[N / 2], "
                             "part2[N / 2];")],
        "rz-last": [(ROUND, f"(l == L ? __float2bfloat16_rz(leaky(v, slope))"
                            f" : {ROUND})")],
    }


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit does not apply once to the source: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_all(names) -> None:
    """Write and build every variant in ``names``, one nvcc each."""
    src = build.SOURCES["fused_decoder_bf16"].read_text()
    edits = variants()
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
        regs = sorted({(r, st, ld) for _, r, st, ld in ptxas_summary(log)})
        print(f"[build] {name}: (registers, spill stores, spill loads) of "
              f"its instances {regs}", flush=True)
        for line in log.splitlines():
            if "Performance Loss" in line:
                print(f"[build] {name}: {line.split(':', 1)[1].strip()[:150]}",
                      flush=True)


def run(name: str, seed: int) -> None:
    """Time and check one built variant (in this process)."""
    device = resolve_device("cuda")
    lib = fused_conv.bind_bf16(ctypes.CDLL(str(OUT / f"lib{name}.so")))
    gen = torch.Generator().manual_seed(seed)
    for shape, (b, t, g, layers, f) in K1_SHAPES.items():
        x, *w = random_folded(torch, gen, b, t, g, layers, f, device)
        if name not in COMPUTING and shape not in TIMED:
            continue
        x16 = x.bfloat16()
        packed = fused_conv.pack_decoder_bf16(dict(w0=w[0], wc=w[1],
                                                   w_logits=w[3]))
        gstride = fused_conv.packed_elems(C0, C, layers, f)

        def launch():
            out = torch.empty(b, t, g * f, device=device,
                              dtype=torch.bfloat16)
            err = lib.mixstage_fused_decoder_bf16(
                x16.data_ptr(), packed.data_ptr(), w[2].data_ptr(),
                w[4].data_ptr(), out.data_ptr(), b, t, C0, C, layers, f, g,
                0.2, 0, gstride, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {name} launch failed: {err}")
            return out

        out = launch()
        torch.cuda.synchronize()
        line = f"[variant] {name} {shape}:"
        if name in COMPUTING:
            ref = fused_conv.fused_mixstage_decoder_plain(x16, *w, groups=g)
            truth = fused_conv.fused_mixstage_decoder_plain(x, *w, groups=g)
            dp, dq, ok = bf16_rule(out, ref, truth)
            ulps, share = bf16_ulps(torch, out, ref)
            line += (f" bf16 rule {'ok' if ok else 'FAILS'} ({dp:.4e} / "
                     f"{dq:.4e}), {ulps:.2f} bf16 ULPs, {share:.2%} of "
                     f"elements differ")
        if shape in TIMED:
            line += f"; {cuda_ms(torch, launch):.4f} ms"
        print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", default=None,
                    help="the variants to build and run (default: all)")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:                     # the child process of one variant
        run(args.run, args.seed)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[variants] {smi}; torch {torch.__version__}", flush=True)
    names = args.only or list(variants())
    build_all(names)
    for name in names:
        try:
            proc = subprocess.run(
                [sys.executable, __file__, "--run", name, "--seed",
                 str(args.seed)], timeout=240)
            status = f"exit {proc.returncode}"
        except subprocess.TimeoutExpired:
            status = "did not finish in 240 s"
        print(f"[variants] {name}: {status}", flush=True)
    print(f"[variants] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
