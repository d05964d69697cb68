#!/usr/bin/env python3
"""K4 (the int8 decoder) against variants of itself, on one CUDA card.

Each variant is ``csrc/decoder_int8.cu`` with one edit, written to
``build/k4_variants/`` beside the headers it includes and built there
with the port's ``nvcc`` flags (all variants at once, one ``nvcc`` each).
Each then runs in a process of its own, so that a variant that cannot
finish (one whose ring deadlocks) is ended by a timeout and the rest still
run.  Per variant it prints the ``ptxas`` registers, spills and any
"Potential Performance Loss" advisory and, in both modes (f32 and bf16
features), the time (CUDA events over 50 calls, back to back and queued
behind a sleep so that no host gap falls between them) at bs32 x 64 and
at the ragged B=3 T=50 at the tile the rule picks; the variants that compute the function are
also held to ``decoder_int8_plain`` at every shape of
``chip_smoke.K4_SHAPES`` (the count of differing elements, 0 by design).

``--parent DIR`` probes an earlier version instead: DIR holds its
``decoder_int8.cu`` and the headers it includes (written there with
``git show <commit>:mixstage_tpu_torch/ops/cuda/csrc/<file>``; the card's
copy of the repo has no ``.git``), which take the weights as
``quant.pack_words`` packs them, and the edits are those of that version
(``PARENT_VARIANTS``: the earlier ``mma.sync`` kernel).

The variants of both versions:

* ``kernel``: the source as it is;
* ``no-mma``: no tensor-core MMAs (in the parent, each MMA replaced by an
  XOR of its fragments, so the fragment loads stay; here the wgmmas
  skipped);
* ``no-copy``: no weight copies (the MMAs run on whatever the ring holds);
* ``neither``: no MMAs and no weight copies;
* ``no-store``: the hidden layers' requantized activations computed but
  not stored (a store guarded by a test that never holds);
* ``no-input``, ``no-epilogue`` (current kernel only): the input stage
  writes zeros without loading or dividing; the epilogues skipped;
* ``i2f-add``, ``no-quant`` (current kernel only, probes that do not
  compute the function): the epilogue's int-to-float conversion done by
  an add (exact only below 2^22); its requantization replaced by a bit
  cast;

and of the current kernel only:

* ``stages-3``, ``stages-5``: a ring of 3 or 5 stages (groups);
* ``group-2``: 2 chunks per stage and committed group, 8 stages;
* ``wait-0``: each group waited for at once and its stage released (no
  group in flight while the next is issued);
* ``tap-shift``: the middle tap's activations read one row late (a fault
  the comparison must catch).

    python3 tools/k4_variants.py [--seed 0] [--parent DIR] [--only NAME ...]
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

from chip_smoke import (C0, K4_SHAPES, MODEL, B, T, cuda_ms,  # noqa: E402
                        ptxas_summary, random_folded)
from mixstage_tpu_torch import resolve_device  # noqa: E402
from mixstage_tpu_torch.ops.cuda import build  # noqa: E402
from mixstage_tpu_torch.ops.cuda import quant as q8  # noqa: E402

OUT = build.BUILD_DIR.parent / "k4_variants"
TIMED = ("bs32", "ragged")
COMPUTING = ("kernel", "stages-3", "stages-5", "wait-0", "group-2",
             "tap-shift")
G, L, F = MODEL["num_clusters"], 3, MODEL["out_feats"]

# the parent (the mma.sync body that decoder_int8.cu had before wgmma)
P_MMA = "      if (kFullN || j < nt) mixstage::mma_s8(acc[i][j], af[i], bf[j]);"
P_XOR = ("      if (kFullN || j < nt) acc[i][j][0] ^= af[i][0] ^ af[i][1] ^ "
         "af[i][2] ^ af[i][3] ^ bf[j][0] ^ bf[j][1];")
P_STAGE = "    if (c < nchunks) {\n      const int tap = c / kchunks;"
P_NOSTAGE = "    if (false) {\n      const int tap = c / kchunks;"
P_STORE = """          static_cast<int8_t*>(out)[row * out_stride + c] =
              (int8_t)quant8(__fmul_rn(y, r));"""
P_NOSTORE = """          const int qv = quant8(__fmul_rn(y, r));
          if (qv == __float_as_int(slope))
            static_cast<int8_t*>(out)[row * out_stride + c] = (int8_t)qv;"""
PARENT_VARIANTS = {
    "kernel": [],
    "no-mma": [(P_MMA, P_XOR)],
    "no-copy": [(P_STAGE, P_NOSTAGE)],
    "neither": [(P_MMA, P_XOR), (P_STAGE, P_NOSTAGE)],
    "no-store": [(P_STORE, P_NOSTORE)],
}

# the current kernel
MMA = "      mma_group_n<N, kGroupChunks>(nc, acc, a, bb,"
COPY = """          sm90::mbar_arrive_expect_tx(&full[s], bytes);
          sm90::bulk_copy(ring + (size_t)s * stage, src, bytes, &full[s]);
"""
STORE = "              nxt[act_byte(m, r, nrows)] = (int8_t)q;"
NOSTORE = ("              if (q == __float_as_int(slope)) "
           "nxt[act_byte(m, r, nrows)] = (int8_t)q;")
TAP = "        bb[i] = b_addr + (uint32_t)(2 * kc * nrows + tap) * 16;"
I2F = "__fmul_rn(__int2float_rn(acc[4 * j + e]),"
WAIT1 = """      sm90::wgmma_wait<1>();
      if (s_prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[s_prev]);
      s_prev = s;
"""
WAIT0 = """      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
"""
VARIANTS = {
    "kernel": [],
    "no-mma": [(MMA, "      if (false) " + MMA.lstrip())],
    "no-copy": [(COPY, "          sm90::mbar_arrive(&full[s]);\n")],
    "neither": [(MMA, "      if (false) " + MMA.lstrip()),
                (COPY, "          sm90::mbar_arrive(&full[s]);\n")],
    "no-store": [(STORE, NOSTORE)],
    "no-input": [("        const bool live = i < items && r >= v_lo && r < v_hi;",
                  "        const bool live = i < items && r >= v_lo && r < v_hi &&\n"
                  "                          slope > 1e30f;")],
    "no-epilogue": [("    if (wg * 64 < ly.cout) {",
                     "    if (wg * 64 < ly.cout && slope > 1e30f) {")],
    "i2f-add": [(I2F, "__fmul_rn(__int_as_float(acc[4 * j + e] + 0x4B400000) - "
                      "12582912.f,")],
    "no-quant": [("              const int q = quant8(__fmul_rn(y, rr[h]));",
                  "              const int q = __float_as_int(__fmul_rn(y, "
                  "rr[h]));")],
    "stages-3": [("kStages = 4;", "kStages = 3;")],
    "stages-5": [("kStages = 4;", "kStages = 5;")],
    "wait-0": [(WAIT1, WAIT0)],
    "group-2": [("kGroupChunks = 4;", "kGroupChunks = 2;"),
                ("kStages = 4;", "kStages = 8;")],
    "tap-shift": [(TAP, "        bb[i] = b_addr + (uint32_t)(2 * kc * "
                        "nrows + tap + (tap == 1)) * 16;")],
}


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit does not apply once to the source: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_all(names, src_dir: Path, table: dict) -> None:
    """Write and build every variant in ``names`` of the source in
    ``src_dir``, one nvcc each."""
    src = (src_dir / "decoder_int8.cu").read_text()
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    for header in src_dir.glob("*.cuh"):
        shutil.copy(header, OUT)
    jobs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(patched(src, table[name]))
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
              f"its kernels {regs}", flush=True)
        for line in log.splitlines():
            if "Performance Loss" in line:
                print(f"[build] {name}: {line.split(':', 1)[1].strip()[:150]}",
                      flush=True)


def operands(qfd: dict, parent: bool):
    """The weight operands of the kernel's C entry points: the parent's
    words of four channels, or the current wgmma images."""
    if parent:
        return [q8.pack_words(qfd[k]) for k in ("w0_i8", "wc_i8", "wl_i8")]
    return [qfd[k] for k in ("w0_img", "wc_img", "wl_img")]


def run(name: str, seed: int, parent: bool) -> None:
    """Time and check one built variant (in this process)."""
    device = resolve_device("cuda")
    lib = q8.bind(ctypes.CDLL(str(OUT / f"lib{name}.so")))
    gen = torch.Generator().manual_seed(seed)
    _, w0, wc, biases, wl, bl = random_folded(torch, gen, 1, 1, G, L, F,
                                              device)
    qfd = q8.pack_decoder_int8(q8.quantize_folded_decoder(
        dict(w0=w0, wc=wc, biases=biases, w_logits=wl, b_logits=bl),
        torch.randn(B, T, C0, generator=gen).to(device)))
    w = operands(qfd, parent)
    rest = [qfd[k] for k in ("m0", "mc", "ml", "rq", "biases", "b_logits")]
    C = qfd["w0_i8"].shape[-1]
    for shape, (b, t) in K4_SHAPES.items():
        x32 = torch.randn(b, t, C0, generator=gen).to(device)
        if name not in COMPUTING and shape not in TIMED:
            continue
        for mode, x in (("f32", x32), ("bf16", x32.bfloat16())):
            fn = (lib.mixstage_decoder_int8_bf16 if mode == "bf16"
                  else lib.mixstage_decoder_int8)

            def launch(x=x, fn=fn, b=b, t=t):
                out = torch.empty(b, t, G * F, device=device)
                err = fn(x.data_ptr(), qfd["s_vec"].data_ptr(),
                         *(v.data_ptr() for v in w + rest), out.data_ptr(),
                         b, t, C0, C, L, F, G, 0.2, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name} launch failed: {err}")
                return out

            out = launch()
            torch.cuda.synchronize()
            line = f"[variant] {name} {mode} {shape} B={b} T={t}:"
            if name in COMPUTING:
                ref = q8.decoder_int8_plain(x, qfd, G)
                line += (f" {int((out != ref).sum())} of {out.numel()} "
                         f"elements differ from the plain version")
            if shape in TIMED:
                line += (f"; {cuda_ms(torch, launch, reps=50):.4f} ms, "
                         f"queued {cuda_ms(torch, launch, reps=50, queued=True):.4f}"
                         f" ms")
            print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="directory of an earlier decoder_int8.cu and its "
                         "headers to probe instead")
    ap.add_argument("--only", nargs="+", default=None,
                    help="the variants to build and run (default: all)")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    parent = args.parent is not None
    if args.run:                     # the child process of one variant
        run(args.run, args.seed, parent)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[variants] {smi}; torch {torch.__version__}; "
          f"{'parent ' + str(args.parent) if parent else 'current'} source",
          flush=True)
    table = PARENT_VARIANTS if parent else VARIANTS
    names = args.only or list(table)
    build_all(names, args.parent if parent else build.CSRC, table)
    for name in names:
        cmd = [sys.executable, __file__, "--run", name, "--seed",
               str(args.seed)] + (["--parent", str(args.parent)]
                                  if parent else [])
        try:
            status = f"exit {subprocess.run(cmd, timeout=240).returncode}"
        except subprocess.TimeoutExpired:
            status = "did not finish in 240 s"
        print(f"[variants] {name}: {status}", flush=True)
    print(f"[variants] done ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
