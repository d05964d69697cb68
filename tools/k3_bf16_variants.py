#!/usr/bin/env python3
"""K3's bf16 wgmma GEMM against variants of itself, on one CUDA card.

Each variant is the port's ``csrc/train_decoder.cu`` with one edit to it
or to its GEMM header ``csrc/train_gemm_bf16.cuh``, written to
``build/k3_bf16_variants/<name>/`` and built there with the port's ``nvcc``
flags (all variants at once, one ``nvcc`` each).  Each then runs in a
process of its own, so that a variant that cannot finish is ended by a
timeout and the rest still run.  Per variant it prints the ``ptxas``
registers, spills and any "Potential Performance Loss" advisory, the time
of K3-fwd-bf16 and K3-bwd-bf16 at bs32 x 64 and at the ragged B=3 T=50
(CUDA events), and, for the variants that compute the function, out's and
cs's bf16 ULPs of max |plain| and share of elements differing from the
plain version, and the bf16 rule on every output.  The variants:

* ``kernel``: the source as it is;
* ``no-mma``: the wgmmas skipped: the copies and the ring alone;
* ``no-copy``: the copies skipped (the wgmmas run on whatever the ring
  holds): the consumers alone;
* ``chunks-32``: conv chunks (and partials) of 32 reduced channels by 3
  taps, dW chunks of 64 padded rows (the kernel's: 64 and 128);
* ``direct``: no partials: the wgmmas accumulate straight into the
  accumulator;
* ``no-round``: the conv's sum not rounded to bf16 before the bias add (a
  fault the differing-share check must catch);
* ``columns-64``: the bf16 column passes in CTAs of 64 threads, not 256;
* ``no-store``: the GEMMs' epilogues store nothing;
* ``no-copy-no-mma``: neither copies nor MMAs: the ring's handshakes, the
  launches and the epilogues; ``no-gemm``: the GEMM kernels return at
  once: the column passes, the packing and the launches alone.

    python3 tools/k3_bf16_variants.py [--seed 0] [--only NAME ...]
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

from chip_smoke import (B, K3_RAGGED, T, bf16_rule, bf16_ulps,  # noqa: E402
                        cuda_ms, ptxas_summary, random_train)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.ops.cuda import build  # noqa: E402
from mixstage_tpu_torch.ops.cuda import train_decoder as td  # noqa: E402

OUT = build.BUILD_DIR.parent / "k3_bf16_variants"
HEADER = "train_gemm_bf16.cuh"
SOURCE = "train_decoder.cu"      # an edit (SOURCE, old, new) edits it
COMPUTING = ("kernel", "chunks-32",
             "direct", "no-round")

COPY = """        if (lane == 0) sm90::mbar_arrive_expect_tx(&full[s], bytes);
        __syncwarp();
        for (int i = lane; i < copies; i += 32)
          chunk_copy<kMode, Tl>(p, a, b, ring + (size_t)s * Tl::kSlot,
                                id.c_begin + c, id.m0, id.n0, i, &full[s]);
"""
MMA3 = "        mma_chunk<kN, TA, TB, 3, KS>(part, a0, b0,"
MMA1 = "        mma_chunk<kN, TA, TB, 1, KS>(part, a0, b0,"
ADD = """      for (int i = 0; i < kN / 2; ++i) {
        sm90::fence_operand(part[i]);
        acc[i] += part[i];
      }
"""
KC = "constexpr int kKCConv = 64, kKCDW = 128;"
ENTRY = """__global__ void __launch_bounds__(kThreads, 1) wgmma_gemm_kernel(Params p,
                                                                 int tiles) {
"""
ROUND = """            if (p.round_acc)
              v[e] = __bfloat162float(__float2bfloat16_rn(v[e]));
"""


def variants() -> dict:
    """{name: [(old, new), ...]}: the edits of each variant."""
    out = {
        "kernel": [],
        "no-mma": [(MMA3, "      if (false) " + MMA3.lstrip()),
                   (MMA1, "      if (false) " + MMA1.lstrip())],
        "no-copy": [(COPY, "        if (lane == 0) sm90::mbar_arrive(&full[s]);\n")],
        "chunks-32": [(KC, "constexpr int kKCConv = 32, kKCDW = 64;")],
        "direct": [(MMA3, MMA3.replace("(part,", "(acc,")),
                   (MMA1, MMA1.replace("(part,", "(acc,")),
                   ("          (k > 0 || kk > 0) ? 1 : 0);", "          1);"),
                   (ADD, "      for (int i = 0; i < kN / 2; ++i) "
                         "sm90::fence_operand(acc[i]);\n")],
        "no-round": [(ROUND, "")],
    }
    out["columns-64"] = [(SOURCE, "constexpr int kImgThreads = 256;",
                          "constexpr int kImgThreads = 64;")]
    out["no-store"] = [("      if (row < 0) continue;\n      O* orow",
                        "      if (row < 0 || p.N > 0) continue;\n      O* orow")]
    out["no-copy-no-mma"] = out["no-copy"] + out["no-mma"]
    out["no-gemm"] = [(ENTRY, ENTRY + "  if (p.N > 0) return;\n")]
    return out


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit does not apply once to the source: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_all(names) -> None:
    """Write and build every variant in ``names``, one nvcc each."""
    edits = variants()
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True)
        for f in list(build.CSRC.glob("*.cuh")) + [
                build.SOURCES["train_decoder"]]:
            shutil.copy(f, d)
        for fname in (HEADER, SOURCE):
            mine = [e[-2:] for e in edits[name]
                    if (e[0] if len(e) == 3 else HEADER) == fname]
            (d / fname).write_text(
                patched((build.CSRC / fname).read_text(), mine))
        jobs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "train_decoder.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        regs = sorted({(r, st, ld) for k, r, st, ld in ptxas_summary(log)
                       if k.startswith("wgmma_gemm_kernel")})
        print(f"[build] {name}: (registers, spill stores, spill loads) of "
              f"its wgmma instances {regs}", flush=True)
        for line in log.splitlines():
            if "Performance Loss" in line:
                print(f"[build] {name}: {line.split(':', 1)[1].strip()[:150]}",
                      flush=True)


def _grads(x, w0, wc, wl, c, f, g, device):
    new = dict(device=device, dtype=torch.float32)
    return (torch.empty(x.shape, **new), torch.empty(w0.shape, **new),
            torch.empty(wc.shape, **new),
            *(torch.empty(g, 4, c, **new) for _ in range(3)),
            torch.empty(wl.shape, **new), torch.empty(g, 1, f, **new))


def run(name: str, seed: int) -> None:
    """Time and check one built variant (in this process)."""
    device = resolve_device("cuda")
    lib = td.bind(ctypes.CDLL(str(OUT / name / "lib.so")))
    gen = torch.Generator().manual_seed(seed)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (b, t) in (("bs32", (B, T)), ("ragged", K3_RAGGED)):
        a32 = tuple(v.bfloat16().float()
                    for v in random_train(torch, gen, b, t, device))
        a16 = tuple(v.bfloat16() for v in a32)
        x, w0, wc, _, gamma, beta, wl, _ = a16
        (b_, t_, c0), c, f, g = x.shape, w0.shape[-1], wl.shape[-1], \
            w0.shape[0]
        dims = (b_, t_, c0, c, f, g)
        h = torch.empty(lib.mixstage_train_decoder_scratch_floats(*dims),
                        device=device)

        def fwd():
            out = torch.empty(g, b, t, f, device=device, dtype=torch.bfloat16)
            cs = torch.empty(4, g, b, t, c, device=device,
                             dtype=torch.bfloat16)
            mu = torch.empty(g, 4, c, device=device)
            var = torch.empty(g, 4, c, device=device)
            err = lib.mixstage_train_decoder_fwd_bf16(
                *(v.data_ptr() for v in (*a16, out, cs, mu, var, h)), *dims,
                stream)
            if err:
                raise RuntimeError(f"variant {name}: fwd error {err}")
            return out, cs, mu, var

        ref = td.decoder_train_fwd_plain(*a16)
        dout = torch.randn(ref[0].shape, generator=gen).to(device).bfloat16()
        bwd_args = (dout, x, ref[1], ref[2], ref[3], w0, wc, gamma, beta, wl)
        grads = _grads(x, w0, wc, wl, c, f, g, device)
        dh = torch.empty(g, b, t, c, device=device)
        dc = torch.empty(g, b, t, c, device=device, dtype=torch.bfloat16)

        def bwd():
            err = lib.mixstage_train_decoder_bwd_bf16(
                *(v.data_ptr() for v in (*bwd_args, *grads, h, dh, dc)),
                *dims, stream)
            if err:
                raise RuntimeError(f"variant {name}: bwd error {err}")
            return grads

        got = fwd()
        bwd()
        torch.cuda.synchronize()
        line = f"[variant] {name} {shape}:"
        if name in COMPUTING:
            truth = td.decoder_train_fwd_plain(*a32)
            fails = [w for w, p, q, r in zip(("out", "cs", "mu", "var"), got,
                                             ref, truth)
                     if not bf16_rule(p, q, r)[2]]
            want = td.decoder_train_bwd_plain(*bwd_args)
            x32, w032, wc32, _, g32, b32, wl32, _ = a32
            true = td.decoder_train_bwd_plain(dout.float(), x32, *truth[1:],
                                              w032, wc32, g32, b32, wl32)
            fails += [w for w, p, q, r in zip(
                ("dx", "dw0", "dwc", "dcb", "dgamma", "dbeta", "dwl", "dbl"),
                grads, want, true)
                if w != "dcb" and not bf16_rule(p, q, r, frobenius=True)[2]]
            for w, p, q in zip(("out", "cs"), got, ref):
                ulps, share = bf16_ulps(torch, p, q)
                line += f" {w} {ulps:.2f} ULPs, {share:.2%} differ;"
            line += f" bf16 rule {'ok' if not fails else f'FAILS on {fails}'};"
        line += (f" fwd {cuda_ms(torch, fwd, reps=10):.4f} ms, bwd "
                 f"{cuda_ms(torch, bwd, reps=10):.4f} ms")
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
