"""K4 on Hopper: the int8 BN-folded mixture decoder as one CUDA kernel.

Counterpart of ``mixstage_tpu/ops/pallas/quant.py``: post-training symmetric
int8 quantization of the folded decoder (``quantize_folded_decoder``), and
the TPU kernel ``fused_mixstage_decoder_int8`` (``:263-317``, body
``_decoder_kernel_int8`` ``:223-260``) as the hand-written CUDA C++ kernel in
``csrc/decoder_int8.cu`` (design and bound noted there; int8 tensor cores,
``wgmma`` s8 fed by bulk copies), bound with ``ctypes``.
``decoder_int8_plain`` is the same function in plain PyTorch (the
counterpart of ``decoder_int8_xla``): the CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card.

Scheme (as in the JAX package): int8 weights per (group, output channel),
static int8 activation scales per (group, layer, channel) from one f32
calibration pass (``per_channel=False``: per (group, layer)); the input
scale and each layer's input activation scale fold into the f32 weights
before those are quantized, so every layer dequantizes with one f32
multiplier per output channel, adds the bias and applies LeakyReLU in f32,
then requantizes with the reciprocal scales ``rq``.  The 1×1 logits
dequantize to f32.

The kernel reads its weights as the shared-memory images its ``wgmma``s
read (``pack_image``, through ``pack_decoder_int8``, done once when a
serving function is built); the JAX-layout int8 arrays stay in the dict for
the plain version.  The wrapper
validates its arguments, then on a CPU tensor computes the plain version; on
a CUDA tensor it launches the kernel or raises — there is no fall-back.

Like the TPU kernel, it takes float32 or bfloat16 features (the int8 tier
on a bf16 model): a bf16 feature is promoted to float32 exactly and then
quantized by the same float32 division, so the two modes share everything
after the input stage, and the logits are float32 in both.
``fused_mixstage_decoder_int8.launches`` counts kernel launches (both
modes), ``fused_mixstage_decoder_int8.launches_bf16`` those of the bf16
mode.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from mixstage_tpu_torch.ops.cuda import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_INT8_KEYS = ("w0_i8", "wc_i8", "wl_i8")
_F32_KEYS = ("m0", "mc", "ml", "rq", "biases", "b_logits")
_PACKED_KEYS = ("w0_img", "wc_img", "wl_img", "s_vec")
CHUNK_K = 32          # input channels per weight chunk (the kernel's kChunkK)


# a symmetric int8 scale is max |·| / 127, computed as max |·| · f32(1/127):
# the arithmetic XLA compiles ``quant.py``'s in-graph ``/ 127.0`` to, so the
# scales agree with the JAX package's bit for bit
_INV127 = 1.0 / 127.0


def _colmax(w, dims):
    return w.abs().amax(dim=dims).clamp_min(1e-8) * _INV127


def _q(w, scale):
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)


def _leaky(h, negative_slope: float):
    return torch.where(h >= 0, h, negative_slope * h)


def _activation_maxima(fd, x, negative_slope: float, per_channel: bool):
    """max |activation| of the f32 folded chain on ``x`` per (group, layer,
    channel), or per (group, layer): (G, L+1, C) or (G, L+1)."""
    xt = x.transpose(1, 2)                                   # (B, C0, T)
    dims = (0, 2) if per_channel else (0, 1, 2)
    out = []
    for g in range(fd["w0"].shape[0]):
        h = _leaky(F.conv1d(xt, fd["w0"][g].permute(2, 1, 0),
                            fd["biases"][g, 0], padding=1), negative_slope)
        maxes = [h.abs().amax(dim=dims)]
        for layer in range(fd["wc"].shape[0]):
            h = _leaky(F.conv1d(h, fd["wc"][layer, g].permute(2, 1, 0),
                                fd["biases"][g, layer + 1], padding=1),
                       negative_slope)
            maxes.append(h.abs().amax(dim=dims))
        out.append(torch.stack(maxes))
    return torch.stack(out)


@torch.no_grad()
def quantize_folded_decoder(fd: Dict[str, torch.Tensor], x_calib,
                            negative_slope: float = 0.2,
                            per_channel: bool = True) -> Dict:
    """Quantize an ``extract_folded_decoder`` dict against calibration
    features ``x_calib`` (B, T, C0) (``quant.py:47-164``), float32 or the
    bfloat16 features of a bf16 model: those are promoted to float32
    exactly, as JAX's calibration promotes its bf16 × f32 einsums, so the
    input scales are max |x| / 127 in float32 either way.

    Returns int8 ``w0_i8`` (G, 3, C0, C), ``wc_i8`` (L, G, 3, C, C),
    ``wl_i8`` (G, C, F); f32 dequant multipliers ``m0`` (G, C), ``mc``
    (L, G, C), ``ml`` (G, F); requant reciprocals ``rq`` (G, L+1, C); the f32
    ``biases`` and ``b_logits``; and the input scale ``s_in``: a (C0,)
    tensor, or a float when ``per_channel=False``."""
    w0, wc, wl = fd["w0"].float(), fd["wc"].float(), fd["w_logits"].float()
    biases = fd["biases"].float()
    x = torch.as_tensor(x_calib).to(device=w0.device, dtype=torch.float32)
    G, L, C = w0.shape[0], wc.shape[0], w0.shape[-1]
    if per_channel:
        s_in = x.abs().amax(dim=(0, 1)).clamp_min(1e-8) / 127.0   # (C0,)
        w0_fold = w0 * s_in[None, None, :, None]
    else:
        s_in = max(float(x.abs().max()) / 127.0, 1e-8)
        w0_fold = w0
    sw0 = _colmax(w0_fold, (1, 2))                                # (G, C)
    act = _activation_maxima({**fd, "w0": w0, "wc": wc, "biases": biases},
                             x, negative_slope, per_channel)
    a = act.clamp_min(1e-8) * _INV127
    if not per_channel:
        a = a[..., None].expand(G, L + 1, C)
    # each layer's input activation scale folds into its weights (chain
    # layer l consumes the output of layer l-1, the logits that of layer L)
    wc_f = wc * a[:, :L].permute(1, 0, 2)[:, :, None, :, None]
    wl_f = wl * a[:, L][:, :, None]
    swc = _colmax(wc_f, (2, 3))                                   # (L, G, C)
    swl = _colmax(wl_f, (1,))                                     # (G, F)
    if per_channel:
        m0 = sw0
    else:   # s_in · max / 127, the two scalars first (XLA folds them so)
        f32 = dict(dtype=torch.float32, device=w0.device)
        m0 = w0.abs().amax(dim=(1, 2)).clamp_min(1e-8) * (
            torch.tensor(s_in, **f32) * torch.tensor(_INV127, **f32))
    return {"w0_i8": _q(w0_fold, sw0[:, None, None, :]),
            "wc_i8": _q(wc_f, swc[:, :, None, None, :]),
            "wl_i8": _q(wl_f, swl[:, None, :]),
            "m0": m0, "mc": swc, "ml": swl,
            "rq": (1.0 / a).contiguous(),
            "biases": biases.contiguous(),
            "b_logits": fd["b_logits"].float().contiguous(),
            "s_in": s_in}


def quantize_input(x, s_in):
    """``clip(round(x / s_in), ±127)`` as int8; ``s_in`` a float or a
    per-channel (C0,) tensor (``quant.py:176-180``).  A bfloat16 ``x`` is
    promoted to float32 (exactly) before the float32 division, as JAX
    promotes bf16 / f32."""
    s = torch.as_tensor(s_in, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _qconv3(q, w_i8, mult, bias, rq, negative_slope):
    """One int8 k=3 'same' layer on integer-valued float64 ``q`` (B, T, cin):
    the three shifted-view products in float64 (exact: every partial sum is
    an integer below 2**53, at any order), then the f32 epilogue one op at a
    time in the JAX order.  Returns the requantized activations, float64."""
    w = w_i8.double()
    zero = q.new_zeros(q.shape[0], 1, q.shape[2])
    qm = torch.cat([zero, q[:, :-1]], dim=1)
    qp = torch.cat([q[:, 1:], zero], dim=1)
    acc = (qm @ w[0] + q @ w[1] + qp @ w[2]).float()
    y = _leaky(acc * mult + bias, negative_slope)
    return torch.clamp(torch.round(y * rq), -127, 127).double()


def decoder_int8_plain(x, qfd: Dict, groups: int,
                       negative_slope: float = 0.2):
    """The int8 decoder in plain PyTorch (``decoder_int8_xla``,
    ``quant.py:183-220``): x (B, T, C0) f32 or bf16 → (B, T, G·F) f32."""
    q_in = quantize_input(x, qfd["s_in"]).double()
    outs = []
    for g in range(groups):
        q = _qconv3(q_in, qfd["w0_i8"][g], qfd["m0"][g], qfd["biases"][g, 0],
                    qfd["rq"][g, 0], negative_slope)
        for layer in range(qfd["wc_i8"].shape[0]):
            q = _qconv3(q, qfd["wc_i8"][layer, g], qfd["mc"][layer, g],
                        qfd["biases"][g, layer + 1], qfd["rq"][g, layer + 1],
                        negative_slope)
        logits = (q @ qfd["wl_i8"][g].double()).float()
        outs.append(logits * qfd["ml"][g] + qfd["b_logits"][g])
    return torch.cat(outs, dim=-1)


def pack_words(w_i8):
    """(..., cin, cout) int8 → (..., ceil(cin/4), cout) int32: four
    consecutive input channels to a word, channel 4i+j in byte j, output
    channel fastest (the operands of K4's earlier ``mma.sync`` kernel,
    which ``tools/profile_k1.py --parent`` times against the current one);
    zero-padded to a multiple of 4."""
    *lead, cin, cout = w_i8.shape
    pad = -cin % 4
    if w_i8.numel() == 0:                   # no chain layer
        return w_i8.new_zeros(*lead, (cin + pad) // 4, cout,
                              dtype=torch.int32)
    if pad:
        w_i8 = torch.cat([w_i8, w_i8.new_zeros(*lead, pad, cout)], dim=-2)
    w = w_i8.reshape(*lead, (cin + pad) // 4, 4, cout).transpose(-1, -2)
    return w.contiguous().view(torch.int32)[..., 0]


def image_shape(lead, cin: int, cout: int):
    """The shape ``pack_image`` gives a (*lead, cin, cout) weight."""
    return (*lead, -(-cin // CHUNK_K), 2, -(-cout // 64) * 64, 16)


def pack_image(w_i8):
    """(..., cin, cout) int8 → (..., ceil(cin/32), 2, round64(cout), 16)
    int8: per chunk of 32 input channels the K-major image that K4's
    ``wgmma`` reads as its A operand (``csrc/decoder_int8.cu``): two halves
    of 16 input channels, each output channel a 16-byte line of its weights
    (input channel 32k + 16h + i in byte i of line (k, h, c_out)), zero
    past cin and cout.  A chunk is one contiguous bulk copy."""
    *lead, cin, cout = w_i8.shape
    nk, _, mp, _ = image_shape((), cin, cout)
    w = w_i8.new_zeros(*lead, nk * CHUNK_K, mp)
    w[..., :cin, :cout] = w_i8
    return w.reshape(*lead, nk, 2, 16, mp).transpose(-1, -2).contiguous()


def pack_decoder_int8(qfd: Dict) -> Dict:
    """``qfd`` plus the kernel's operands: the int8 weights as ``wgmma``
    images (``w0_img`` (G, 3, ·), ``wc_img`` (L, G, 3, ·), ``wl_img`` (G,
    ·); ``pack_image``) and the input scale as a (C0,) f32 vector ``s_vec``
    (a per-tensor scale repeated)."""
    c0 = qfd["w0_i8"].shape[2]
    s_vec = torch.as_tensor(qfd["s_in"], dtype=torch.float32,
                            device=qfd["m0"].device).expand(c0).contiguous()
    return {**qfd, "w0_img": pack_image(qfd["w0_i8"]),
            "wc_img": pack_image(qfd["wc_i8"]),
            "wl_img": pack_image(qfd["wl_i8"]), "s_vec": s_vec}


def _check(x, qfd, groups):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"x must be (B, T, C0), got shape {tuple(x.shape)}")
    B, T, C0 = x.shape
    L, G, C, F_ = (qfd["wc_i8"].shape[0], groups, qfd["w0_i8"].shape[-1],
                   qfd["wl_i8"].shape[-1])
    want = dict(w0_i8=(G, 3, C0, C), wc_i8=(L, G, 3, C, C), wl_i8=(G, C, F_),
                m0=(G, C), mc=(L, G, C), ml=(G, F_), rq=(G, L + 1, C),
                biases=(G, L + 1, C), b_logits=(G, F_))
    for name, shape in want.items():
        t = qfd[name]
        dtype = torch.int8 if name in _INT8_KEYS else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} (groups={groups}, C0={C0})")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return B, T, C0, C, L, F_, G


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded ``decoder_int8`` library."""
    fn = lib.mixstage_decoder_int8
    if fn.argtypes is None:
        for fn in (lib.mixstage_decoder_int8, lib.mixstage_decoder_int8_bf16):
            fn.argtypes = [_P] * 12 + [_I] * 7 + [ctypes.c_float, _I, _P]
            fn.restype = _I
        tile = lib.mixstage_decoder_int8_tile
        tile.argtypes = [_I] * 8 + [ctypes.c_size_t]
        tile.restype = _I
        lib.mixstage_decoder_int8_error_string.argtypes = [_I]
        lib.mixstage_decoder_int8_error_string.restype = ctypes.c_char_p
    return lib


def device_tile_frames(B: int, T: int, C0: int, C: int, L: int, F: int,
                       G: int, device) -> int:
    """Output frames per CTA of the kernel's launch for this shape on the
    card ``device`` (0 if no tile fits its shared memory)."""
    lib = bind(build.load_library("decoder_int8"))
    props = torch.cuda.get_device_properties(device)
    return lib.mixstage_decoder_int8_tile(
        B, T, C0, C, L, F, G, props.multi_processor_count,
        props.shared_memory_per_block_optin)


def fused_mixstage_decoder_int8(x, qfd: Dict, groups: int,
                                negative_slope: float = 0.2):
    """The whole int8 mixture decoder as one kernel launch.

    x (B, T, C0) f32 or bf16 content⊕style features, quantized inside;
    ``qfd`` from ``quantize_folded_decoder`` (on CUDA: passed through
    ``pack_decoder_int8``).  Returns per-group logits (B, T, G·F) f32, to be
    combined by ``index_select_outputs``.  C and F at most 256."""
    B, T, C0, C, L, F_, G = _check(x, qfd, groups)
    if x.device.type == "cpu":
        return decoder_int8_plain(x, qfd, groups, negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mixstage_decoder_int8 runs on CUDA (or the "
                         f"CPU plain version), got device {x.device}")
    missing = [k for k in _PACKED_KEYS if k not in qfd]
    if missing:
        raise ValueError(f"qfd lacks the kernel's packed operands {missing}: "
                         f"pass it through pack_decoder_int8 first")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    args = [qfd[k] for k in ("s_vec", "w0_img", "wc_img", "wl_img")
            + _F32_KEYS]
    for t in args:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("the packed operands must be contiguous and on "
                             "x's device")
    want = dict(w0_img=image_shape((G, 3), C0, C),
                wc_img=image_shape((L, G, 3), C, C),
                wl_img=image_shape((G,), C, F_))
    for name, shape in want.items():
        if qfd[name].dtype != torch.int8 or tuple(qfd[name].shape) != shape:
            raise ValueError(f"{name} is {qfd[name].dtype} "
                             f"{tuple(qfd[name].shape)}, expected int8 "
                             f"{shape}: pack_decoder_int8 of these weights")
    lib = bind(build.load_library("decoder_int8"))
    bf16 = x.dtype == torch.bfloat16
    launch = lib.mixstage_decoder_int8_bf16 if bf16 else \
        lib.mixstage_decoder_int8
    out = torch.empty((B, T, G * F_), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            x.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(),
            B, T, C0, C, L, F_, G, float(negative_slope), 0, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_mixstage_decoder_int8 ({x.dtype}) launch failed: "
            f"{lib.mixstage_decoder_int8_error_string(err).decode()} (error "
            f"{err}; B={B} T={T} C0={C0} C={C} L={L} F={F_} G={G}; time tile "
            f"{device_tile_frames(B, T, C0, C, L, F_, G, x.device)}, "
            f"0 = none fits shared memory)")
    fused_mixstage_decoder_int8.launches += 1
    if bf16:
        fused_mixstage_decoder_int8.launches_bf16 += 1
    return out


fused_mixstage_decoder_int8.launches = 0
fused_mixstage_decoder_int8.launches_bf16 = 0
