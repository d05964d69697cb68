"""K3 on Hopper: the Mix-StAGE mixture decoder's TRAINING forward and
backward as hand-written CUDA kernels.

Counterpart of ``mixstage_tpu/ops/pallas/train_decoder.py``: the TPU
kernels ``_fwd_call`` (``:126-173``) and ``_bwd_call`` (``:284-345``) become
the CUDA C++ entry points of ``csrc/train_decoder.cu`` (design and bound
noted there), bound with ``ctypes``.  Per group g of G the chain is four
(k=3 'same' conv + bias → train-mode BatchNorm with float32 batch mean and
biased variance over B·T → leaky 0.2) layers, then the 1×1 logits.

Layout (JAX's, without its TPU padding of C0 and F):
  x (B, T, C0); w0 (G, 3, C0, C); wc (3, G, 3, C, C); cb / gamma / beta
  (G, 4, C); wl (G, C, F); bl (G, 1, F); out (G, B, T, F); the conv
  outputs saved for the backward cs (4, G, B, T, C); mu / var (G, 4, C).

``decoder_train_fwd`` and ``decoder_train_bwd`` validate their arguments,
then on CPU tensors compute the plain versions (``*_plain``: the forward
with ``F.conv1d``, the backward as the explicit formulas in the kernel's
order, not autograd); on CUDA tensors they launch the kernels or raise —
there is no fall-back.  Each counts its launches in ``.launches``.
``DecoderTrain`` is the ``torch.autograd.Function`` of the pair (the
custom_vjp of ``:353-385``).

Both modes run every GEMM pass on ``wgmma`` (``csrc/train_gemm_bf16.cuh``).
f32 mode: every operand element is split into three bfloat16 terms that sum
to it exactly (``fused_conv.split_bf16x3``) and each product is taken as
the six bf16 products of the two splits whose terms are largest, small ones
first, in float32 sums (f32 accuracy); everything it stores is float32.

bf16 mode (the TPU kernels' ``dtype=bfloat16`` function, every weight cast
to the features' dtype by ``fused_decoder_train``, ``:486-493``): x, the
weights, out and cs are bfloat16; each conv's float32 sum of exact bf16
products is rounded to bf16 before the bias add (``:93-95``), BatchNorm's
statistics and the leaky unit run in float32 and the activation is rounded
(``:105-106``); the backward recomputes the activations from the bf16 cs,
rounds dc to bf16 before the dW and d(input) products (``:227``), and
returns every gradient in float32 (``:332-341``).  mu and var are float32
in both modes.

Data parallelism (``parallel/mesh.py``): BatchNorm's statistics are the
data group's global batch's.  Each C entry runs in five stages, cut at the
statistics; between two of them the wrapper hands a layer's (G, 2, C)
float32 sums (forward: c and c²; backward: dpre and dpre·xhat) to an
``exchange`` hook that sums them over the ranks.  Without a hook the sums
are the local ones, reduced in the order the undivided kernel reduced
them, so one rank computes what it computed before.  The plain versions
take the same hook.

K3 has no float64 mode.  The plain versions also take float64 tensors on
the CPU (the JAX package's float64 parity mode, where they compute
everything in float64); on CUDA a float64 call raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from mixstage_tpu_torch.ops.cuda import build

EPS = 1e-5
SLOPE = 0.2
L = 4                     # ConvNormRelu layers (1 rectangular + 3 square)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
STAGES = L + 1            # the C entry's stages a call (see _run_stages)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _bn_leaky(cf, mu, var, gamma, beta):
    """(xhat, pre, leaky(pre)) of one layer from its conv output (N, C)."""
    xhat = (cf - mu) * torch.rsqrt(var + EPS)
    pre = xhat * gamma + beta
    return xhat, pre, torch.where(pre >= 0, pre, SLOPE * pre)


def _acc(dt):
    """The plain versions' accumulation dtype: float64 for float64
    inputs, else float32."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _conv_bias(h, w, cb):
    """K3's conv + bias: at float32 (float64) one conv with its bias; below
    it the float32 sum rounded to ``h.dtype`` before the bias add, and the
    sum rounded again (flax's ``nn.Conv``, ``train_decoder.py:93-95``)."""
    dt = h.dtype
    if dt in (torch.float32, torch.float64):
        return F.conv1d(h, w, cb, padding=1)
    acc = F.conv1d(h.float(), w.float(), None, padding=1)
    return (acc.to(dt).float() + cb.float()[:, None]).to(dt)


def _exchanged(sums, rows, exchange):
    """A layer's (G, 2, C) local sums summed over the data group by
    ``exchange`` (in place), and the rows they cover; the local ones
    without an exchange."""
    if exchange is None:
        return sums, rows
    return sums, exchange(sums, rows)


def decoder_train_fwd_plain(x, w0, wc, cb, gamma, beta, wl, bl,
                            exchange=None):
    """The training forward in plain PyTorch, layer by layer over the
    groups with ``F.conv1d``: returns (out (G,B,T,F), cs (4,G,B,T,C) in
    ``x.dtype``, mu, var (G,4,C) float32), rounding as K3 does at either
    dtype.  Each layer's statistics come from its (G, 2, C) sums of c and
    c² over the rows, which ``exchange(sums, rows) → total rows`` sums over
    the data group in place (K3's stages take the same hook)."""
    B, T, _ = x.shape
    G, C, Fo = w0.shape[0], w0.shape[-1], wl.shape[-1]
    dt = x.dtype
    acc = _acc(dt)
    hs = [x.transpose(1, 2)] * G                            # (B, cin, T)
    cs = [[] for _ in range(G)]
    mus, vrs = [[] for _ in range(G)], [[] for _ in range(G)]
    for layer in range(L):
        cfs = []
        for g in range(G):
            w = w0[g] if layer == 0 else wc[layer - 1, g]   # (3, cin, C)
            c = _conv_bias(hs[g], w.permute(2, 1, 0), cb[g, layer])
            c = c.transpose(1, 2).reshape(B * T, C)
            cs[g].append(c.reshape(B, T, C))
            cfs.append(c.to(acc))
        sums, rows = _exchanged(
            torch.stack([torch.stack([cf.sum(0), (cf * cf).sum(0)])
                         for cf in cfs]), B * T, exchange)
        for g, cf in enumerate(cfs):
            mu = sums[g, 0] / rows
            var = sums[g, 1] / rows - mu * mu
            _, _, act = _bn_leaky(cf, mu, var, gamma[g, layer].to(acc),
                                  beta[g, layer].to(acc))
            mus[g].append(mu)
            vrs[g].append(var)
            hs[g] = act.to(dt).reshape(B, T, C).transpose(1, 2)
    outs = [(hs[g].transpose(1, 2).to(acc) @ wl[g].to(acc)
             + bl[g].to(acc)).to(dt) for g in range(G)]
    return (torch.stack(outs), torch.stack([torch.stack(c) for c in cs],
                                           dim=1),
            torch.stack([torch.stack(m) for m in mus]),
            torch.stack([torch.stack(v) for v in vrs]))


def _shift(a, s):
    """(B, T, C) shifted in time by ``s`` (±1) with a zero row at the
    sequence's own end: out[:, t] = a[:, t + s]."""
    z = torch.zeros_like(a[:, :1])
    return torch.cat([a[:, 1:], z], 1) if s > 0 else \
        torch.cat([z, a[:, :-1]], 1)


def decoder_train_bwd_plain(dout, x, cs, mu, var, w0, wc, gamma, beta, wl,
                            exchange=None):
    """The training backward as explicit formulas, in the order of the TPU
    kernel's ``_bwd_kernel``: the logits head (dwl, dbl, dh), then layer by
    layer walking back: leaky', dγ, dβ, the train-mode BN backward
    ``inv·(dxhat − mean(dxhat) − xhat·mean(dxhat·xhat))``, dcb, the per-tap
    dW and d(input) with the taps shifted back; dx is summed over groups.
    Returns (dx, dw0, dwc, dcb, dgamma, dbeta, dwl, dbl), all float32
    (float64 for float64 inputs).  With bfloat16 inputs the recomputed
    activations and dc are rounded to bfloat16 where they feed a product,
    as K3 rounds them.  The two means come from each layer's (G, 2, C)
    sums of dpre and dpre·xhat, which ``exchange`` sums over the data group
    (as in ``decoder_train_fwd_plain``); dγ and dβ stay local."""
    B, T, C0 = x.shape
    G, C, N = w0.shape[0], w0.shape[-1], B * T
    dt = x.dtype
    acc = _acc(dt)

    def rounded(v):              # at float32 (float64) both casts are no-ops
        return v.to(dt).to(acc)

    f32 = dict(dtype=acc, device=x.device)
    dx = torch.zeros(x.shape, **f32)
    dw0, dwc = torch.empty(w0.shape, **f32), torch.empty(wc.shape, **f32)
    dcb, dg, db = (torch.empty(gamma.shape, **f32) for _ in range(3))
    dwl = torch.empty(wl.shape, **f32)
    dbl = torch.empty((G, 1, wl.shape[-1]), **f32)
    x, cs, w0, wc, gamma, beta, wl = (t.to(acc) for t in (x, cs, w0, wc,
                                                          gamma, beta, wl))

    def act(g, layer):
        return _bn_leaky(cs[layer, g].reshape(N, C), mu[g, layer],
                         var[g, layer], gamma[g, layer], beta[g, layer])

    dhs = []
    for g in range(G):
        do = dout[g].reshape(N, -1).to(acc)
        h3 = rounded(act(g, L - 1)[2])
        dwl[g] = h3.T @ do
        dbl[g, 0] = do.sum(0)
        dhs.append(do @ wl[g].T)
    for layer in range(L - 1, -1, -1):
        pieces = []
        for g in range(G):
            xhat, pre, _ = act(g, layer)
            dpre = torch.where(pre >= 0, dhs[g], SLOPE * dhs[g])
            db[g, layer] = dpre.sum(0)
            dg[g, layer] = (dpre * xhat).sum(0)
            pieces.append((xhat, dpre))
        sums, rows = _exchanged(
            torch.stack([db[:, layer], dg[:, layer]], dim=1).clone(), N,
            exchange)
        for g, (xhat, dpre) in enumerate(pieces):
            inv = torch.rsqrt(var[g, layer] + EPS)
            gm = gamma[g, layer]
            dc = inv * (dpre * gm - gm * sums[g, 0] / rows
                        - xhat * (gm * sums[g, 1] / rows))
            dcb[g, layer] = dc.sum(0)
            dc = rounded(dc)
            if layer == 0:
                inp, w = x, w0[g]
            else:
                inp, w = rounded(act(g, layer - 1)[2]).reshape(B, T, C), \
                    wc[layer - 1, g]
            cin = inp.shape[-1]
            taps = (_shift(inp, -1), inp, _shift(inp, 1))
            dW = torch.stack([t.reshape(N, cin).T @ dc for t in taps])
            if layer == 0:
                dw0[g] = dW
            else:
                dwc[layer - 1, g] = dW
            u = [(dc @ w[k].T).reshape(B, T, cin) for k in range(3)]
            dinp = u[1] + _shift(u[0], 1) + _shift(u[2], -1)
            if layer == 0:
                dx += dinp
            else:
                dhs[g] = dinp.reshape(N, cin)
    return dx, dw0, dwc, dcb, dg, db, dwl, dbl


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_STATS = ("mu", "var")           # float32 in both modes


def _check(**tensors):
    """The device of ``tensors`` and their mode's dtype (float32, or
    bfloat16 for all but mu / var; float64 throughout for the CPU plain
    versions); raises on anything else."""
    first = next(iter(tensors.values()))
    dev, dt = first.device, first.dtype
    if dt == torch.float64 and dev.type != "cpu":
        raise NotImplementedError(
            "K3 has no float64 mode: the float64 parity mode runs its plain "
            "versions on the CPU (ROADMAP queue 3)")
    if dt not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"K3 takes float32 or bfloat16 tensors, got {dt}")
    for name, t in tensors.items():
        want = _acc(dt) if name in _STATS else dt
        if t.dtype != want:
            raise TypeError(f"{name} must be {want} (the {dt} mode), got "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev, dt


def _shapes(x, w0, wl):
    if x.ndim != 3 or w0.ndim != 4 or wl.ndim != 3:
        raise ValueError("expected x (B, T, C0), w0 (G, 3, C0, C), "
                         "wl (G, C, F)")
    B, T, C0 = x.shape
    return B, T, C0, w0.shape[-1], wl.shape[-1], w0.shape[0]


def _expect(B, T, C0, C, Fo, G, **tensors):
    want = dict(x=(B, T, C0), w0=(G, 3, C0, C), wc=(L - 1, G, 3, C, C),
                cb=(G, L, C), gamma=(G, L, C), beta=(G, L, C), wl=(G, C, Fo),
                bl=(G, 1, Fo), dout=(G, B, T, Fo), cs=(L, G, B, T, C),
                mu=(G, L, C), var=(G, L, C))
    for name, t in tensors.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded ``train_decoder`` library."""
    if lib.mixstage_train_decoder_fwd_f32.argtypes is None:
        for mode in ("f32", "bf16"):
            getattr(lib, f"mixstage_train_decoder_fwd_{mode}").argtypes = \
                [_P] * 13 + [_I] * 6 + [_P]
            getattr(lib, f"mixstage_train_decoder_bwd_{mode}").argtypes = \
                [_P] * 20 + [_I] * 6 + [_P]
            getattr(lib, f"mixstage_train_decoder_fwd_stage_{mode}"
                    ).argtypes = [_I] + [_P] * 14 + [_F] + [_I] * 6 + [_P]
            getattr(lib, f"mixstage_train_decoder_bwd_stage_{mode}"
                    ).argtypes = [_I] + [_P] * 21 + [_F] + [_I] * 6 + [_P]
            for way in ("fwd", "bwd", "fwd_stage", "bwd_stage"):
                getattr(lib, f"mixstage_train_decoder_{way}_{mode}"
                        ).restype = _I
        lib.mixstage_train_decoder_error_string.argtypes = [_I]
        lib.mixstage_train_decoder_error_string.restype = ctypes.c_char_p
        lib.mixstage_train_decoder_scratch_floats.argtypes = [_I] * 6
        lib.mixstage_train_decoder_scratch_floats.restype = ctypes.c_longlong
        lib.mixstage_train_decoder_plan.argtypes = [_I] * 9 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.mixstage_train_decoder_plan.restype = None
        lib.mixstage_train_decoder_force.argtypes = [_I, _I]
        lib.mixstage_train_decoder_force.restype = None
    return lib


# the GEMM's tiles (csrc/train_gemm_bf16.cuh::kTiles), by index, both
# modes; the f32 mode's dW, whose tiles hold every tap (kTilesAllTaps)
GEMM_TILES = ("128x128", "64x256", "64x192", "64x96")
GEMM_TILES_ALL_TAPS = ("128x64", "64x128", "64x96", "128x48")
GEMM_PASSES = {"conv": 0, "convT": 1, "dW": 2}


def gemm_tiles(mode, terms):
    """The tile names of GEMM pass ``mode`` in the mode of ``terms``."""
    return GEMM_TILES_ALL_TAPS if mode == "dW" and terms == 3 else \
        GEMM_TILES


def gemm_plan(lib, mode, B, T, J, N, taps, G, sms, terms
              ) -> Tuple[int, int]:
    """(tile index into ``gemm_tiles(mode, terms)``, dW's splits of the
    frames) that the
    wgmma GEMM picks for one pass (``mode`` of ``GEMM_PASSES``) on a card
    of ``sms`` SMs, in the mode of ``terms`` bf16 terms (1: bf16, 3:
    f32)."""
    tile, splits = ctypes.c_int(), ctypes.c_int()
    lib.mixstage_train_decoder_plan(GEMM_PASSES[mode], terms, B, T, J, N,
                                    taps, G, sms, ctypes.byref(tile),
                                    ctypes.byref(splits))
    return tile.value, splits.value


def _raise_on(lib, err, what, dims):
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.mixstage_train_decoder_error_string(err).decode()} "
            f"(error {err}; B,T,C0,C,F,G = {dims})")


def _scratch(lib, dims, new):
    """The kernels' scratch, sized for either mode: the GEMMs' operand
    images (three bf16 terms an element in the f32 mode), the column
    passes' partial sums, dW's split-K partials and layer 0's per-group dx
    partials."""
    return torch.empty(lib.mixstage_train_decoder_scratch_floats(*dims),
                       **new)


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _mode(dt):
    return "bf16" if dt == torch.bfloat16 else "f32"


def _run_stages(entry, ptrs, stats, rows, dims, stream, exchange,
                layer_of):
    """The C entry's stages in order; after stage s < L the layer
    ``layer_of(s)``'s (G, 2, C) sums in ``stats`` go through ``exchange``
    (summed over the data group) and the next stage reads them over the
    rows it returns.  Returns the first error (0: none)."""
    total = rows
    for stage in range(STAGES):
        err = entry(stage, *ptrs, stats.data_ptr(), float(total), *dims,
                    stream)
        if err:
            return err
        if stage < L and exchange is not None:
            total = exchange(stats[layer_of(stage)], rows)
    return 0


def decoder_train_fwd(x, w0, wc, cb, gamma, beta, wl, bl, exchange=None
                      ) -> Tuple[torch.Tensor, ...]:
    """K3-fwd: (out (G,B,T,F), cs (4,G,B,T,C), mu, var (G,4,C)).  All
    contiguous, all float32 or all bfloat16 (the bf16 mode: out and cs
    bfloat16, mu and var float32); plain version on the CPU, kernel on
    CUDA.  ``exchange(sums (G, 2, C), rows) → total rows`` sums each
    layer's statistics over the data group between the kernel's stages
    (``parallel/mesh.py::stats_exchange``); None keeps them local.  One
    launch is counted a call, whatever its stages."""
    dev, dt = _check(x=x, w0=w0, wc=wc, cb=cb, gamma=gamma, beta=beta,
                     wl=wl, bl=bl)
    dims = _shapes(x, w0, wl)
    _expect(*dims, x=x, w0=w0, wc=wc, cb=cb, gamma=gamma, beta=beta, wl=wl,
            bl=bl)
    if dev.type == "cpu":
        return decoder_train_fwd_plain(x, w0, wc, cb, gamma, beta, wl, bl,
                                       exchange)
    if dev.type != "cuda":
        raise ValueError(f"decoder_train_fwd runs on CUDA (or the CPU plain "
                         f"version), got device {dev}")
    B, T, C0, C, Fo, G = dims
    lib = bind(build.load_library("train_decoder"))
    new = dict(device=dev, dtype=torch.float32)
    out = torch.empty((G, B, T, Fo), device=dev, dtype=dt)
    cs = torch.empty((L, G, B, T, C), device=dev, dtype=dt)
    mu = torch.empty((G, L, C), **new)
    var = torch.empty((G, L, C), **new)
    h = _scratch(lib, dims, new)
    stats = torch.empty((L, G, 2, C), **new)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _run_stages(
            getattr(lib, f"mixstage_train_decoder_fwd_stage_{_mode(dt)}"),
            _ptrs(x, w0, wc, cb, gamma, beta, wl, bl, out, cs, mu, var, h),
            stats, B * T, dims, stream, exchange, lambda s: s)
    _raise_on(lib, err, f"decoder_train_fwd ({dt})", dims)
    decoder_train_fwd.launches += 1
    if dt == torch.bfloat16:
        decoder_train_fwd.launches_bf16 += 1
    return out, cs, mu, var


decoder_train_fwd.launches = 0
decoder_train_fwd.launches_bf16 = 0


def decoder_train_bwd(dout, x, cs, mu, var, w0, wc, gamma, beta, wl,
                      exchange=None) -> Tuple[torch.Tensor, ...]:
    """K3-bwd: (dx, dw0, dwc, dcb, dgamma, dbeta, dwl, dbl), all float32,
    dx summed over the groups.  The inputs all float32, or all bfloat16 but
    mu and var (the bf16 mode).  Plain version on the CPU, kernel on
    CUDA.  ``exchange`` as for ``decoder_train_fwd``: the sums behind BN's
    two column means; the gradients stay local."""
    dev, dt = _check(dout=dout, x=x, cs=cs, mu=mu, var=var, w0=w0, wc=wc,
                     gamma=gamma, beta=beta, wl=wl)
    dims = _shapes(x, w0, wl)
    _expect(*dims, dout=dout, x=x, cs=cs, mu=mu, var=var, w0=w0, wc=wc,
            gamma=gamma, beta=beta, wl=wl)
    if dev.type == "cpu":
        return decoder_train_bwd_plain(dout, x, cs, mu, var, w0, wc, gamma,
                                       beta, wl, exchange)
    if dev.type != "cuda":
        raise ValueError(f"decoder_train_bwd runs on CUDA (or the CPU plain "
                         f"version), got device {dev}")
    B, T, C0, C, Fo, G = dims
    lib = bind(build.load_library("train_decoder"))
    new = dict(device=dev, dtype=torch.float32)
    dx = torch.empty(x.shape, **new)
    dw0, dwc = torch.empty(w0.shape, **new), torch.empty(wc.shape, **new)
    dcb, dg, db = (torch.empty((G, L, C), **new) for _ in range(3))
    dwl = torch.empty(wl.shape, **new)
    dbl = torch.empty((G, 1, Fo), **new)
    h = _scratch(lib, dims, new)
    dh = torch.empty((G, B, T, C), **new)            # d(layer output)
    stats = torch.empty((L, G, 2, C), **new)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _run_stages(
            getattr(lib, f"mixstage_train_decoder_bwd_stage_{_mode(dt)}"),
            _ptrs(dout, x, cs, mu, var, w0, wc, gamma, beta, wl,
                  dx, dw0, dwc, dcb, dg, db, dwl, dbl, h, dh),
            stats, B * T, dims, stream, exchange, lambda s: L - 1 - s)
    _raise_on(lib, err, f"decoder_train_bwd ({dt})", dims)
    decoder_train_bwd.launches += 1
    if dt == torch.bfloat16:
        decoder_train_bwd.launches_bf16 += 1
    return dx, dw0, dwc, dcb, dg, db, dwl, dbl


decoder_train_bwd.launches = 0
decoder_train_bwd.launches_bf16 = 0


class DecoderTrain(torch.autograd.Function):
    """(x, w0, wc, cb, gamma, beta, wl, bl, exchange) → (out, mu, var):
    K3-fwd in the forward, K3-bwd in the backward, both with ``exchange``
    (None: local statistics).  mu / var are not differentiable (the
    JAX custom_vjp drops their cotangents, ``train_decoder.py:373``).  In
    the bf16 mode K3-bwd's float32 gradients are rounded to the inputs'
    bfloat16 by autograd, as JAX's custom_vjp casts them (``:381-384``)."""

    @staticmethod
    def forward(ctx, x, w0, wc, cb, gamma, beta, wl, bl, exchange=None):
        out, cs, mu, var = decoder_train_fwd(x, w0, wc, cb, gamma, beta, wl,
                                             bl, exchange)
        ctx.save_for_backward(x, cs, mu, var, w0, wc, gamma, beta, wl)
        ctx.exchange = exchange
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        x, cs, mu, var, w0, wc, gamma, beta, wl = ctx.saved_tensors
        return decoder_train_bwd(dout.contiguous(), x, cs, mu, var, w0, wc,
                                 gamma, beta, wl, ctx.exchange) + (None,)


# ---------------------------------------------------------------------------
# parameter packing + public entry
# ---------------------------------------------------------------------------


def extract_train_decoder(model) -> Dict[str, torch.Tensor]:
    """The generator's decoder modules in K3's layout (``train_decoder.py:
    416-461``, without the TPU padding).  A differentiable gather: gradients
    of the packed tensors reach the modules' own parameters."""
    G = model.decoder_groups
    layers = model.decoder_layers()

    def taps(conv):                 # (G·C, cin, 3) → (G, 3, cin, C)
        w = conv.weight
        return w.reshape(G, -1, w.shape[1], 3).permute(0, 3, 2, 1)

    def per_layer(get):             # [(G·C,)] * 4 → (G, 4, C)
        return torch.stack([get(m).reshape(G, -1) for m in layers], dim=1)

    lw = model.logits.weight[:, :, 0]                       # (G·F, C)
    packed = {
        "w0": taps(layers[0].conv),
        "wc": torch.stack([taps(m.conv) for m in layers[1:]]),
        "cb": per_layer(lambda m: m.conv.bias),
        "gamma": per_layer(lambda m: m.norm.weight),
        "beta": per_layer(lambda m: m.norm.bias),
        "wl": lw.reshape(G, -1, lw.shape[1]).transpose(1, 2),
        "bl": model.logits.bias.reshape(G, 1, -1),
    }
    return {k: v.contiguous() for k, v in packed.items()}


def fused_decoder_train(x, model, exchange=None):
    """The generator's mixture decoder in training mode through K3:
    x (B, T, C0) shared content⊕style features → (xr (B, T, G·F) per-group
    pose logits, mu, var (G, 4, C) float32 batch statistics for the running
    stats update), G the experts the decoder holds (``decoder_groups``).
    The float32 parameters are cast to ``x.dtype`` inside
    the graph (``train_decoder.py:486-493``): at bfloat16 K3 runs its bf16
    mode and the casts' backward hands float32 gradients to the
    parameters.  ``exchange``: see ``decoder_train_fwd``."""
    p = {k: v.to(x.dtype) for k, v in extract_train_decoder(model).items()}
    B, T, _ = x.shape
    out, mu, var = DecoderTrain.apply(
        x.contiguous(), p["w0"], p["wc"], p["cb"], p["gamma"], p["beta"],
        p["wl"], p["bl"], exchange)
    xr = out.permute(1, 2, 0, 3).reshape(B, T, -1)
    return xr, mu, var
