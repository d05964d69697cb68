"""K1 and K2 on Hopper: the BN-folded Mix-StAGE mixture decoder and the
grouped conv chain, as two modes of one CUDA kernel.

Counterpart of ``mixstage_tpu/ops/pallas/fused_conv.py``: the TPU kernels
``fused_mixstage_decoder`` (K1, ``:177-229``) and ``fused_grouped_conv_chain``
(K2, ``:73-115``) become one hand-written CUDA C++ kernel on the bf16
tensor cores with ``wgmma`` (``csrc/fused_decoder_wgmma.cu``, design and
bounds noted there), bound with ``ctypes``: K1 is its decoder mode, K2 its
chain mode (K1 without layer 0 and the logits).
``fused_mixstage_decoder_plain`` (the counterpart of
``serve.py::folded_decoder_xla``) and ``chain_plain`` (of
``chain_reference``) are the same functions in plain PyTorch: the CPU tests
use them, and ``chip_smoke.py`` holds the kernels against them on the card.

Both run float32 weights in both of the TPU kernels' modes: float32
features, and bfloat16 features with each layer's output (and K1's logits)
rounded to bfloat16 (``fused_conv.py:141-176``, ``_chain_kernel``'s
``astype(x_ref.dtype)``; ``out_shape`` ``x.dtype``); products in float32,
bias and leaky in float32 (slope float32 0.2).  The kernel splits each
float32 weight into three bfloat16 terms that sum to it exactly
(``split_bf16x3``), so a bf16 feature times a weight is exact in three bf16
products; in the float32 mode the kernel splits each feature the same way
and takes a product as the six bf16 products of the two splits whose terms
are largest (f32 accuracy).  The weights' split and the layout the kernel
streams (``pack_decoder_bf16``, ``pack_chain_bf16``) are done once by the
caller where it can (the serving function does for K1); the public
wrappers take them as ``packed=`` or pack per call.  The plain versions
round at the same points, so each is the kernel's twin at either dtype.

Each wrapper validates its arguments, then on a CPU tensor computes the
plain version; on a CUDA tensor it launches the kernel or raises — there is
no fall-back.  ``fused_mixstage_decoder.launches`` (both modes),
``fused_mixstage_decoder.launches_bf16`` (bf16 mode),
``fused_grouped_conv_chain.launches`` (both modes) and
``fused_grouped_conv_chain.launches_bf16`` (bf16 mode) count kernel
launches.  ``fused_mixstage_decoder_op`` is K1 as a registered operator, for
the exported serving program (``export.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mixstage_tpu_torch.ops.cuda import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def fold_bn_into_conv(kernel, bias, bn_scale, bn_bias, bn_mean, bn_var,
                      eps: float = 1e-5):
    """Fold inference BatchNorm into the preceding conv (``fused_conv.py:
    34-46``).  ``kernel`` is (..., Cout); returns (kernel', bias') with
    conv(x, k') + b' == BN(conv(x, k) + b)."""
    inv_std = bn_scale / torch.sqrt(bn_var + eps)
    kernel = kernel * inv_std
    if bias is None:
        bias = torch.zeros_like(bn_bias)
    return kernel, (bias - bn_mean) * inv_std + bn_bias


def fused_mixstage_decoder_plain(x, w0, wc, biases, w_logits, b_logits,
                                 groups: int, negative_slope: float = 0.2):
    """The decoder in plain PyTorch: x (B, T, C0) → (B, T, G·F) in
    ``x.dtype``.  Float32 sums of float32 products; for bfloat16 ``x`` each
    layer's output and the logits are rounded to bfloat16, as the kernel
    rounds them."""
    dt = x.dtype

    def rounded(v):              # at float32 both casts are no-ops
        return v.to(dt).float()

    xt = x.float().transpose(1, 2)                           # (B, C0, T)
    outs = []
    for g in range(groups):
        h = rounded(F.leaky_relu(F.conv1d(xt, w0[g].permute(2, 1, 0),
                                          biases[g, 0], padding=1),
                                 negative_slope))
        for layer in range(wc.shape[0]):
            h = rounded(F.leaky_relu(F.conv1d(
                h, wc[layer, g].permute(2, 1, 0), biases[g, layer + 1],
                padding=1), negative_slope))
        outs.append((h.transpose(1, 2) @ w_logits[g] + b_logits[g]).to(dt))
    return torch.cat(outs, dim=-1)


def _check(x, w0, wc, biases, w_logits, b_logits, groups):
    tensors = dict(x=x, w0=w0, wc=wc, biases=biases, w_logits=w_logits,
                   b_logits=b_logits)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in tensors.items():
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (the weights stay "
                            f"float32 in both modes), got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 3 or w0.ndim != 4 or wc.ndim != 5 or w_logits.ndim != 3:
        raise ValueError("expected x (B, T, C0), w0 (G, 3, C0, C), wc "
                         "(L, G, 3, C, C) and w_logits (G, C, F)")
    B, T, C0 = x.shape
    G, C, L, F_ = groups, w0.shape[-1], wc.shape[0], w_logits.shape[-1]
    want = dict(w0=(G, 3, C0, C), wc=(L, G, 3, C, C), biases=(G, L + 1, C),
                w_logits=(G, C, F_), b_logits=(G, F_))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)},"
                             f" expected {shape} (groups={groups})")
    return B, T, C0, C, L, F_, G


def bind_decoder(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded ``fused_decoder_wgmma`` library
    (K1 and K2, both modes; pointers and the stream as ``c_void_p``, so none
    is cut to 32 bits)."""
    if lib.mixstage_fused_decoder_f32.argtypes is None:
        for mode in ("f32", "bf16"):
            fn = getattr(lib, f"mixstage_fused_decoder_{mode}")
            fn.argtypes = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I,
                                                 ctypes.c_longlong, _P]
            fn.restype = _I
            tile = getattr(lib, f"mixstage_fused_decoder_{mode}_tile")
            tile.argtypes = [_I] * 8 + [ctypes.c_size_t]
            tile.restype = _I
            chain = getattr(lib, f"mixstage_conv_chain_{mode}")
            chain.argtypes = [_P] * 4 + [_I] * 5 + [ctypes.c_float, _I,
                                                    ctypes.c_longlong, _P]
            chain.restype = _I
            tile = getattr(lib, f"mixstage_conv_chain_{mode}_tile")
            tile.argtypes = [_I] * 6 + [ctypes.c_size_t]
            tile.restype = _I
        lib.mixstage_fused_decoder_error_string.argtypes = [_I]
        lib.mixstage_fused_decoder_error_string.restype = ctypes.c_char_p
    return lib


def tile_frames(B: int, T: int, C0: int, C: int, L: int, F: int, G: int,
                sm_count: int, smem_limit: int, act_bytes: int = 4) -> int:
    """The kernel's output frames per CTA for this shape on a card of
    ``sm_count`` SMs and ``smem_limit`` bytes of shared memory per CTA (0 if
    no tile fits): the float32 mode's (``act_bytes`` 4) or the bf16 mode's
    (2).  Both follow ``csrc/launch_common.cuh::cost_tile`` with their own
    shared-memory layout; the launch applies the rule to its own card."""
    lib = bind_decoder(build.load_library("fused_decoder_wgmma"))
    mode = "bf16" if act_bytes == 2 else "f32"
    return getattr(lib, f"mixstage_fused_decoder_{mode}_tile")(
        B, T, C0, C, L, F, G, sm_count, smem_limit)


def device_tile_frames(B: int, T: int, C0: int, C: int, L: int, F: int,
                       G: int, device, act_bytes: int = 4) -> int:
    """``tile_frames`` for the card ``device``: the tile its launch uses."""
    props = torch.cuda.get_device_properties(device)
    return tile_frames(B, T, C0, C, L, F, G, props.multi_processor_count,
                       props.shared_memory_per_block_optin, act_bytes)


def split_bf16x3(w):
    """float32 ``w`` as three bfloat16 terms that sum to it exactly:
    w1 = bf16(w), w2 = bf16(w - w1), w3 = w - w1 - w2 (8 + 8 + 8
    significant bits cover float32's 24; exact unless w3 falls below
    bfloat16's normal range, |w| < 2^-110 or so).  Each difference is exact
    in float32."""
    w1 = w.to(torch.bfloat16)
    r = w - w1.float()
    w2 = r.to(torch.bfloat16)
    return w1, w2, (r - w2.float()).to(torch.bfloat16)


def _pack_layer(w):
    """(G, taps, cin, cout) float32 → (G, taps · ceil(cin/16) · 48 ·
    round64(cout)) bfloat16: per tap and 16 input channels one chunk
    [3 terms][2 halves of 8 channels][cout padded to 64][8 channels], the
    K-major shared-memory image ``wgmma`` reads (``csrc/wgmma.cuh``)."""
    G, taps, cin, cout = w.shape
    nk, mp = -(-cin // 16), -(-cout // 64) * 64
    # (G, taps, 3 terms, cin, cout)
    t = torch.stack(split_bf16x3(w.float()), dim=2)
    t = F.pad(t, (0, mp - cout, 0, 16 * nk - cin))
    t = t.reshape(G, taps, 3, nk, 2, 8, mp).permute(0, 1, 3, 2, 4, 6, 5)
    return t.reshape(G, -1)


def pack_decoder_bf16(fd):
    """K1's weight operand (both modes) for a folded decoder ``fd`` (keys
    ``w0`` (G, 3, C0, C), ``wc`` (L, G, 3, C, C), ``w_logits`` (G, C, F)):
    a (G, n) bfloat16 tensor holding, per group, every layer's chunks in
    the kernel's order (layer 0, chain layers 1..L, the 1x1 logits; each
    by ``_pack_layer``), the three terms of ``split_bf16x3`` padded with
    zeros in K and in the output channels.  Done once per serving
    function, on the weights' device."""
    with torch.no_grad():
        layers = [fd["w0"]] + list(fd["wc"]) + [fd["w_logits"][:, None]]
        return torch.cat([_pack_layer(w) for w in layers], dim=1).contiguous()


def pack_chain_bf16(weights):
    """K2's weight operand (both modes) for chain kernels ``weights`` (L, G,
    3, C, C): a (G, n) bfloat16 tensor holding, per group, the chunks of the
    L layers in order (each by ``_pack_layer``), exactly the chain layers'
    part of ``pack_decoder_bf16``'s image."""
    with torch.no_grad():
        empty = weights.new_empty(weights.shape[1], 0, dtype=torch.bfloat16)
        return torch.cat([empty] + [_pack_layer(w) for w in weights],
                         dim=1).contiguous()


def _layer_elems(taps: int, cin: int, cout: int) -> int:
    return taps * -(-cin // 16) * 48 * (-(-cout // 64) * 64)


def packed_elems(C0: int, C: int, L: int, F: int) -> int:
    """bfloat16 elements of one group in ``pack_decoder_bf16``'s layout."""
    return (_layer_elems(3, C0, C) + L * _layer_elems(3, C, C)
            + _layer_elems(1, C, F))


def chain_packed_elems(C: int, L: int) -> int:
    """bfloat16 elements of one group in ``pack_chain_bf16``'s layout."""
    return L * _layer_elems(3, C, C)


def _check_packed(packed, G: int, gstride: int, x, packer: str) -> None:
    if (packed.dtype != torch.bfloat16 or tuple(packed.shape) != (G, gstride)
            or packed.device != x.device or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"packed must be {packer}'s contiguous, 16-byte "
                         f"aligned ({G}, {gstride}) bfloat16 tensor on "
                         f"{x.device}, got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")


def _launch(x, packed, biases, b_logits, dims, negative_slope):
    """K1 in x's mode on the weights ``packed`` by ``pack_decoder_bf16``."""
    B, T, C0, C, L, F_, G = dims
    gstride = packed_elems(C0, C, L, F_)
    _check_packed(packed, G, gstride, x, "pack_decoder_bf16")
    lib = bind_decoder(build.load_library("fused_decoder_wgmma"))
    launch = (lib.mixstage_fused_decoder_bf16 if x.dtype == torch.bfloat16
              else lib.mixstage_fused_decoder_f32)
    out = torch.empty((B, T, G * F_), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            x.data_ptr(), packed.data_ptr(), biases.data_ptr(),
            b_logits.data_ptr(), out.data_ptr(), B, T, C0, C, L, F_, G,
            float(negative_slope), 0, gstride, stream)
    if err != 0:
        tile = device_tile_frames(B, T, C0, C, L, F_, G, x.device,
                                  x.element_size())
        raise RuntimeError(
            f"fused_mixstage_decoder ({x.dtype}) launch failed: "
            f"{lib.mixstage_fused_decoder_error_string(err).decode()} "
            f"(error {err}; B={B} T={T} C0={C0} C={C} L={L} F={F_} G={G}; "
            f"time tile {tile}, 0 = none fits shared memory)")
    return out


def fused_mixstage_decoder(x, w0, wc, biases, w_logits, b_logits,
                           groups: int, negative_slope: float = 0.2,
                           packed=None):
    """The whole mixture decoder as one kernel launch.

    x (B, T, C0) shared content⊕style features; w0 (G, 3, C0, C) folded
    layer-0 kernels; wc (L, G, 3, C, C) folded chain kernels; biases
    (G, L+1, C), row 0 for layer 0; w_logits (G, C, F), b_logits (G, F) the
    grouped 1×1 output conv.  Returns per-group logits (B, T, G·F), to be
    combined by ``index_select_outputs``.  All float32 and contiguous; C
    and F at most 256.  A bfloat16 ``x`` runs the bf16 mode (float32
    weights) and returns bfloat16 logits.  On CUDA the kernel reads the
    weights as ``packed = pack_decoder_bf16(...)``, packed once by the
    caller, or packed here on each call when ``packed`` is None."""
    dims = _check(x, w0, wc, biases, w_logits, b_logits, groups)
    if x.device.type == "cpu":
        return fused_mixstage_decoder_plain(x, w0, wc, biases, w_logits,
                                            b_logits, groups, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mixstage_decoder runs on CUDA (or the CPU "
                         f"plain version), got device {x.device}")
    if packed is None:
        packed = pack_decoder_bf16(dict(w0=w0, wc=wc, w_logits=w_logits))
    out = _launch(x, packed, biases, b_logits, dims, negative_slope)
    fused_mixstage_decoder.launches += 1
    if x.dtype == torch.bfloat16:
        fused_mixstage_decoder.launches_bf16 += 1
    return out


fused_mixstage_decoder.launches = 0
fused_mixstage_decoder.launches_bf16 = 0


@torch.library.custom_op("mixstage_tpu_torch::fused_mixstage_decoder",
                         mutates_args=())
def _decoder_op(x: torch.Tensor, w0: torch.Tensor, wc: torch.Tensor,
                biases: torch.Tensor, w_logits: torch.Tensor,
                b_logits: torch.Tensor, packed: Optional[torch.Tensor],
                groups: int, negative_slope: float) -> torch.Tensor:
    return fused_mixstage_decoder(x, w0, wc, biases, w_logits, b_logits,
                                  groups, negative_slope, packed=packed)


@_decoder_op.register_fake
def _(x, w0, wc, biases, w_logits, b_logits, packed, groups,
      negative_slope):
    return x.new_empty((x.shape[0], x.shape[1], groups * w_logits.shape[-1]))


def fused_mixstage_decoder_op(x, w0, wc, biases, w_logits, b_logits,
                              groups: int, negative_slope: float = 0.2,
                              packed=None):
    """``fused_mixstage_decoder`` as the registered operator
    ``torch.ops.mixstage_tpu_torch.fused_mixstage_decoder``, which
    ``torch.export`` records in a graph (a ``ctypes`` call cannot be
    traced); its body is the wrapper, launches and counter included, and
    its fake version gives the output's shape and dtype.  Same arguments
    and results as the wrapper."""
    return torch.ops.mixstage_tpu_torch.fused_mixstage_decoder(
        x, w0, wc, biases, w_logits, b_logits, packed, groups,
        float(negative_slope))


def chain_plain(x, weights, biases, groups: int, negative_slope: float = 0.2):
    """The grouped conv chain in plain PyTorch (``chain_reference``,
    ``fused_conv.py:118-133``): x (B, T, G·C) → (B, T, G·C) in ``x.dtype``.
    Float32 sums of float32 products; for bfloat16 ``x`` each layer's output
    is rounded to bfloat16, as the kernel rounds it."""
    dt = x.dtype
    L, G, _, C, _ = weights.shape
    h = x.float().transpose(1, 2)                            # (B, G·C, T)
    for layer in range(L):
        w = weights[layer].permute(0, 3, 2, 1).reshape(G * C, C, 3)
        h = F.leaky_relu(F.conv1d(h, w, biases[layer], padding=1, groups=G),
                         negative_slope).to(dt).float()
    return h.transpose(1, 2).to(dt).contiguous()


def chain_tile_frames(B: int, T: int, C: int, L: int, G: int, device,
                      act_bytes: int = 4) -> int:
    """K2's output frames per CTA on the card ``device`` in the float32
    (``act_bytes`` 4) or bf16 mode (2): the tile its launch uses, 0 if
    none fits."""
    props = torch.cuda.get_device_properties(device)
    lib = bind_decoder(build.load_library("fused_decoder_wgmma"))
    mode = "bf16" if act_bytes == 2 else "f32"
    return getattr(lib, f"mixstage_conv_chain_{mode}_tile")(
        B, T, C, L, G, props.multi_processor_count,
        props.shared_memory_per_block_optin)


def fused_grouped_conv_chain(x, weights, biases, groups: int,
                             negative_slope: float = 0.2, packed=None):
    """L layers of grouped k=3 'same' conv + bias + leaky as one kernel
    launch: x (B, T, G·C), weights (L, G, 3, C, C) (tap, in, out), biases
    (L, G·C); returns (B, T, G·C) in ``x.dtype``.  All contiguous; x float32
    or bfloat16 (the bf16 mode), the weights and biases float32; C at most
    256.  On CUDA the kernel reads the weights as ``packed =
    pack_chain_bf16(weights)``, packed once by the caller, or packed here
    on each call when ``packed`` is None."""
    tensors = dict(x=x, weights=weights, biases=biases)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in tensors.items():
        if name != "x" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (in both modes), got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 3 or weights.ndim != 5:
        raise ValueError("expected x (B, T, G·C) and weights (L, G, 3, C, C)")
    B, T, GC = x.shape
    L, G, K, C, C2 = weights.shape
    if (G, K, C2, G * C, tuple(biases.shape)) != (groups, 3, C, GC,
                                                  (L, GC)):
        raise ValueError(f"x {tuple(x.shape)}, weights "
                         f"{tuple(weights.shape)} and biases "
                         f"{tuple(biases.shape)} do not fit groups={groups}")
    if x.device.type == "cpu":
        return chain_plain(x, weights, biases, groups, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_grouped_conv_chain runs on CUDA (or the CPU "
                         f"plain version), got device {x.device}")
    if packed is None:
        packed = pack_chain_bf16(weights)
    gstride = chain_packed_elems(C, L)
    _check_packed(packed, G, gstride, x, "pack_chain_bf16")
    lib = bind_decoder(build.load_library("fused_decoder_wgmma"))
    bf16 = x.dtype == torch.bfloat16
    launch = lib.mixstage_conv_chain_bf16 if bf16 else \
        lib.mixstage_conv_chain_f32
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            x.data_ptr(), packed.data_ptr(), biases.data_ptr(),
            out.data_ptr(), B, T, C, L, G, float(negative_slope), 0, gstride,
            stream)
    if err != 0:
        tile = chain_tile_frames(B, T, C, L, G, x.device, x.element_size())
        raise RuntimeError(
            f"fused_grouped_conv_chain ({x.dtype}) launch failed: "
            f"{lib.mixstage_fused_decoder_error_string(err).decode()} "
            f"(error {err}; B={B} T={T} C={C} L={L} G={G}; time tile "
            f"{tile}, 0 = none fits shared memory)")
    fused_grouped_conv_chain.launches += 1
    if bf16:
        fused_grouped_conv_chain.launches_bf16 += 1
    return out


fused_grouped_conv_chain.launches = 0
fused_grouped_conv_chain.launches_bf16 = 0
