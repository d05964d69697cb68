"""Serving fast path: audio → pose with BatchNorm folded into both conv chains.

Counterpart of ``mixstage_tpu/serve.py:37-422``: one device, or several
devices from one process in the batch, time or expert partition
(``build_serving_fn(devices=..., partition=...)``).  Compared with the
eval forward:

* BatchNorm is folded into the conv weights of the mixture decoder and of
  the cluster-classifier chain (``fold_bn_into_conv``);
* both chains run through kernel K1 (``ops/cuda/fused_conv.py``) when the
  tensors live on CUDA: the classifier as one group, the mixture decoder as
  M groups — two launches per call, on float32 weights split into three
  bfloat16 terms and packed once, when the serving function is built;
* the int8 tier (``quantize_int8=True``) quantizes the mixture decoder
  against calibration features and runs it through kernel K4
  (``ops/cuda/quant.py``) instead: one K1 launch (the classifier) and one
  K4 launch per call;
* the content+style features (audio encoder, UNet, style table) run as
  the model's own PyTorch layers.

The folded weights keep the JAX layout (tap, in, out) but not its 128-lane
padding of C0, which was TPU layout; the kernels mask ragged widths
themselves.  ``ServingProgram`` is the same call as a pure function of
the weights (JAX's ``fn.jitted`` of ``fn.bound_args``), which the exported
artifact (``export.py``) traces.  ``build_waveform_serving_fn`` puts the
log-mel frontend (``data/audio.py::log_mel_spectrogram``) in front, for
raw 16 kHz audio.  Under a ``torch.profiler`` trace each call is a
``serve.call`` span and its backbone a ``serve.features`` one
(``train/profiling.py``); the exported program takes neither.

A model built with ``dtype=torch.bfloat16`` serves at that compute dtype,
as the JAX package's bf16 tier does: audio and style rows are cast to it,
the features and both chains' activations are bfloat16 (K1's bf16 mode),
the folded weights stay float32 (folded from the float32 parameters,
packed for K1 as at float32), and the pose comes back as float32,
an exact upcast.  Its int8 tier
(``serve.py:203-279``) calibrates on the bf16 model's features, hands them
to K4's bf16-feature mode (``decoder_int8_plain`` on the plain route), and
rounds K4's float32 logits to bfloat16 before the mixture, as JAX's
``.astype(x.dtype)`` does.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mixstage_tpu_torch.data.audio import log_mel_spectrogram
from mixstage_tpu_torch.device import resolve_device
from mixstage_tpu_torch.models.layers import softmax
from mixstage_tpu_torch.ops.cuda.fused_conv import (
    fold_bn_into_conv, fused_mixstage_decoder, fused_mixstage_decoder_op,
    fused_mixstage_decoder_plain, pack_decoder_bf16)
from mixstage_tpu_torch.ops.cuda.quant import (decoder_int8_plain,
                                               fused_mixstage_decoder_int8,
                                               pack_decoder_int8,
                                               quantize_folded_decoder)
from mixstage_tpu_torch.ops.mixture import index_select_outputs
from mixstage_tpu_torch.train.profiling import span

_FOLDED_KEYS = ("w0", "wc", "biases", "w_logits", "b_logits")


def _detached(folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Contiguous copies that share no storage or autograd state with the
    model's parameters (the kernel takes contiguous float32 arrays)."""
    return {k: v.detach().clone(memory_format=torch.contiguous_format)
            for k, v in folded.items()}


def _fold(block, eps: float):
    """(kernel (k, Cin/G, Cout), bias (Cout,)) of a ConvNormRelu with its
    BatchNorm folded in."""
    conv, norm = block.conv, block.norm
    return fold_bn_into_conv(conv.weight.permute(2, 1, 0), conv.bias,
                             norm.weight, norm.bias, norm.running_mean,
                             norm.running_var, eps)


@torch.no_grad()
def extract_folded_decoder(model: nn.Module, eps: float = 1e-5
                           ) -> Dict[str, torch.Tensor]:
    """Fold BN into the mixture decoder (``serve.py:37-79``): w0 (G, 3, C0,
    C), wc (L, G, 3, C, C), biases (G, L+1, C), w_logits (G, C, F),
    b_logits (G, F)."""
    G = model.num_clusters
    folded = [_fold(layer, eps) for layer in model.decoder_layers()]

    def per_group(k):            # (3, Cin, G·C) → (G, 3, Cin, C)
        return k.reshape(k.shape[0], k.shape[1], G, -1).permute(2, 0, 1, 3)

    lw = model.logits.weight[:, :, 0]                      # (G·F, C)
    return _detached({
        "w0": per_group(folded[0][0]),
        "wc": torch.stack([per_group(k) for k, _ in folded[1:]]),
        "biases": torch.stack([b.reshape(G, -1) for _, b in folded], dim=1),
        "w_logits": lw.reshape(G, -1, lw.shape[1]).transpose(1, 2),
        "b_logits": model.logits.bias.reshape(G, -1),
    })


@torch.no_grad()
def extract_folded_classify(model: nn.Module, eps: float = 1e-5
                            ) -> Dict[str, torch.Tensor]:
    """Fold BN through the ClusterClassify chain (6 ConvNormRelu + 1×1
    logits, ``serve.py:82-108``) into K1's layout with G=1."""
    cc = model.classify_cluster
    folded = [_fold(getattr(cc.stack, f"conv{i}"), eps)
              for i in range(cc.stack.depth)]
    return _detached({
        "w0": folded[0][0][None],
        "wc": torch.stack([k for k, _ in folded[1:]])[:, None],
        "biases": torch.stack([b for _, b in folded])[None],
        "w_logits": cc.logits.weight[:, :, 0].t()[None],
        "b_logits": cc.logits.bias[None],
    })


def style_weights(style, num_speakers: int, device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) integer ids → one-hot (B, S) rows; (B, S) float rows pass; in
    ``dtype``."""
    style = torch.as_tensor(style, device=device)
    if style.ndim == 1:
        return nn.functional.one_hot(style.long(), num_speakers).to(dtype)
    return style.to(dtype)


def _features_soft(model: nn.Module, audio, sw, fc, packed,
                   use_kernel: bool, k1=fused_mixstage_decoder,
                   traced: bool = False):
    """The content+style features x and the (B, T, G) mixture attention:
    on the kernel route the classifier chain runs through ``k1`` (K1's
    wrapper, or its registered operator in an exported program) on the
    weights ``packed`` by ``pack_decoder_bf16``.  ``traced``: the backbone
    runs in a ``serve.features`` span (the serving function's calls; the
    exported program's graph takes none)."""
    with span("serve.features") if traced else contextlib.nullcontext():
        if use_kernel:
            x = model.features([audio], None, sw)
        else:
            x, _, soft = model.backbone([audio], None, sw)
    if use_kernel:
        scores = k1(x, *(fc[k] for k in _FOLDED_KEYS), groups=1,
                    packed=packed.get("classifier"))
        return x, softmax(scores, dim=-1)
    return x, soft


def _decode(model: nn.Module, x, fd, packed, use_kernel: bool, qfd=None,
            k1=fused_mixstage_decoder):
    """The grouped logits (B, T, groups·F) of the folded decoder ``fd``'s
    groups (all of them, or a device's share under the expert partition),
    in the compute dtype: through ``k1`` or its plain version; ``qfd``
    (the int8 tier) through K4 or ``decoder_int8_plain``."""
    groups = fd["w0"].shape[0]
    if qfd is not None:                # f32 logits, in the compute dtype
        int8 = fused_mixstage_decoder_int8 if use_kernel \
            else decoder_int8_plain
        return int8(x, qfd, groups=groups).to(model.dtype)
    if use_kernel:
        return k1(x, *(fd[k] for k in _FOLDED_KEYS), groups=groups,
                  packed=packed.get("decoder"))
    return fused_mixstage_decoder_plain(x, *(fd[k] for k in _FOLDED_KEYS),
                                        groups=groups)


def _pose(model: nn.Module, audio, sw, fd, fc, packed, use_kernel: bool,
          qfd=None, k1=fused_mixstage_decoder, traced: bool = False):
    """The serving body: audio and (B, T, S) style rows in the compute dtype
    → float32 pose (``_features_soft``, ``_decode``)."""
    x, soft = _features_soft(model, audio, sw, fc, packed, use_kernel, k1,
                             traced)
    logits = _decode(model, x, fd, packed, use_kernel, qfd, k1)
    return index_select_outputs(logits, soft, model.num_clusters).float()


class _Body(nn.Module):
    def __init__(self, model: nn.Module, use_kernel: bool):
        super().__init__()
        self.model, self.use_kernel = model, use_kernel

    def forward(self, audio, sw, fd, fc, packed):
        return _pose(self.model, audio, sw, fd, fc, packed, self.use_kernel,
                     k1=fused_mixstage_decoder_op)


class ServingProgram(nn.Module):
    """The serving call as a pure function of its weights, for
    ``torch.export`` (the counterpart of JAX's ``fn.jitted``):
    ``program(gen, fd, fc, packed, audio (B, T, mel), style_rows (B, S))
    → pose (B, T, F)`` float32, where ``gen`` is the generator's state
    dict, ``fd`` / ``fc`` the folded decoder and classifier, ``packed``
    K1's packed images (``{}`` on the plain route).  The module holds no
    parameter: the model's are swapped for ``gen`` on every call
    (``torch.func.functional_call``), so an exported program takes the
    weights as arguments, as JAX's artifact does.  K1 runs as its
    registered operator (``fused_mixstage_decoder_op``)."""

    def __init__(self, model: nn.Module, use_kernel: bool):
        super().__init__()
        # not a submodule: its weights must not become program constants
        object.__setattr__(self, "_body", _Body(model, use_kernel))

    def forward(self, gen, fd, fc, packed, audio, style_rows):
        dtype = self._body.model.dtype
        audio = audio.to(dtype)
        B, T = audio.shape[:2]
        sw = style_rows.to(dtype)[:, None, :].expand(B, T,
                                                     style_rows.shape[-1])
        return torch.func.functional_call(
            self._body, {f"model.{k}": v for k, v in gen.items()},
            (audio, sw, fd, fc, packed))


PARTITIONS = ("batch", "time", "expert")
TIME_ALIGN = 32          # UNet1D's 2^5 (its length must divide it)


def _conv_reach(conv, scale: int) -> Tuple[int, int]:
    """(input frames a conv's window spans at ``scale`` frames an element,
    the scale after its stride) along time (dim 0 of its kernel)."""
    k, st, d = conv.kernel_size[0], conv.stride[0], conv.dilation[0]
    return (k - 1) * d * scale, scale * st


def time_receptive_field(model: nn.Module) -> int:
    """An upper bound, in input frames, of how far along time one pose
    frame of the eval-mode generator depends on its audio: each conv
    reaches across its whole kernel at its layer's scale; the audio
    encoder's bilinear resize and each nearest upsampling of ``UNet1D``
    one coarse element.  The classifier and the decoder both count."""
    reach, scale = 0, 1
    enc = model.audio_encoder
    for i in range(8):
        r, scale = _conv_reach(getattr(enc, f"conv{i}").conv, scale)
        reach += r
    reach += scale                              # the resize back to T
    unet, scale = model.unet, 1
    for name in ("pre0", "pre1") + tuple(f"down{i}"
                                         for i in range(unet.max_depth)):
        r, scale = _conv_reach(getattr(unet, name).conv, scale)
        reach += r
    for i in range(unet.max_depth):
        reach += scale                          # nearest ×2
        scale //= 2
        reach += _conv_reach(getattr(unet, f"up{i}").conv, scale)[0]
    cc = model.classify_cluster.stack
    for i in range(cc.depth):
        reach += _conv_reach(getattr(cc, f"conv{i}").conv, 1)[0]
    for layer in model.decoder_layers():
        reach += _conv_reach(layer.conv, 1)[0]
    return reach


def time_halo(model: nn.Module) -> int:
    """The frames a time shard reads on either side of its own:
    ``time_receptive_field`` rounded up to ``TIME_ALIGN``, so every window
    starts where the whole clip's strided layers and resize line up."""
    return -(-time_receptive_field(model) // TIME_ALIGN) * TIME_ALIGN


def time_windows(T: int, n: int, halo: int):
    """(window start, window end, shard start, shard end) of ``n`` time
    shards of a clip of T frames: the shards start at multiples of
    ``TIME_ALIGN``; each window adds ``halo`` frames a side, cut at the
    clip's own ends (which it then pads as the whole clip does)."""
    if T % TIME_ALIGN:
        raise ValueError(f"time partitioning: T = {T} must divide "
                         f"{TIME_ALIGN} (the UNet's length)")
    step = -(-T // (n * TIME_ALIGN)) * TIME_ALIGN
    out = []
    for s in range(0, T, step):
        e = min(T, s + step)
        out.append((max(0, s - halo), min(T, e + halo), s, e))
    return out


def _to(tree, device):
    """A dict of tensors (and other leaves) with its tensors on
    ``device``."""
    return {k: _to(v, device) if isinstance(v, dict) else
            (v.to(device) if torch.is_tensor(v) else v)
            for k, v in tree.items()}


def _expert_share(fd: Dict[str, torch.Tensor], i: int, gl: int):
    """Experts ``[i·gl, (i+1)·gl)`` of the folded decoder (its group axis,
    JAX's ``fd_specs``: w0, biases, w_logits, b_logits on axis 0, wc on
    axis 1)."""
    sl = slice(i * gl, (i + 1) * gl)
    return _detached({"w0": fd["w0"][sl], "wc": fd["wc"][:, sl],
                      "biases": fd["biases"][sl],
                      "w_logits": fd["w_logits"][sl],
                      "b_logits": fd["b_logits"][sl]})


def build_serving_fn(model: nn.Module, device=None,
                     use_kernel: Optional[bool] = None,
                     quantize_int8: bool = False, calib=None,
                     devices: Optional[Sequence] = None,
                     partition: str = "batch"):
    """``fn(audio (B, T, mel), style (B,) ids or (B, S) rows) → pose
    (B, T, out_feats)`` on ``device``.

    ``device=None`` is the CUDA card, and raises when there is none.  The
    model is moved to ``device`` in place.  ``use_kernel`` (default: on
    CUDA) runs the classifier chain and the mixture decoder BN-folded through
    K1; ``use_kernel=False`` is the plain path: the model's unfolded
    classifier and the folded decoder in plain PyTorch.

    ``quantize_int8=True`` is the int8 tier: the mixture decoder is
    quantized post-training against the features of ``calib=(audio, style
    ids or (B, S) rows)`` (required) and runs through K4 on the kernel
    route, through ``decoder_int8_plain`` on the plain one.  Its drift
    against the f32 path is a few percent: an opt-in speed tier outside the
    1% contract of the default path.

    The call runs at the model's compute dtype (``model.dtype``), the int8
    tier included; the pose is returned as float32 either way.

    ``devices`` (a list, which may repeat a device: ``["cuda:0"] * 2``, or
    ``["cpu"] * n`` in the tests) serves over several devices from this one
    process, JAX's ``mesh=`` (``serve.py:133-383``), the pose returned on
    the first; ``partition`` picks the layout:

    * ``"batch"``: the weights on every device, the batch split (it must
      divide the device count), each share through K1 (or K4), the poses
      concatenated;
    * ``"time"``: one clip's time axis cut into shards starting at
      multiples of 32, each computed with a halo of ``time_halo`` frames a
      side and trimmed, so the pose is the whole clip's; the plain route
      only (``use_kernel=True`` raises, as JAX's Pallas kernel cannot be
      partitioned over time);
    * ``"expert"``: the folded decoder split on its group axis (the count
      must divide ``num_clusters``), K1 packed per device; each device runs
      the backbone and the classifier, decodes its experts, weighs them
      with its slice of the attention, and the partial sums are added on
      the first device.  The int8 tier is batch-partitioned only.

    Outside the int8 tier and ``devices``, ``fn.program`` (a
    ``ServingProgram``) and ``fn.bound_args`` (``gen, fd, fc, packed``)
    are the same call as a pure function of its weights, which
    ``export.export_serving`` traces; the call itself runs the kernels'
    wrappers directly.
    """
    if partition not in PARTITIONS:
        raise ValueError(f"unknown partition {partition!r}; expected "
                         f"'batch', 'time' or 'expert'")
    if partition != "batch" and not devices:
        raise ValueError(f"partition={partition!r} needs devices")
    if partition == "time":
        if use_kernel:
            raise ValueError(
                "time partitioning requires the plain decoder route: K1 "
                "cannot be partitioned over its time axis")
        use_kernel = False
    if partition == "expert" and quantize_int8:
        raise ValueError("the int8 tier is batch-partitioned only (its "
                         "per-channel scale layout is not expert-sliced)")
    dtype = model.dtype
    if quantize_int8 and calib is None:
        raise ValueError("quantize_int8 needs calib=(audio, style ids or "
                         "(B, S) rows) for the one-shot activation "
                         "calibration pass")
    devices = [resolve_device(d) for d in devices] if devices else None
    device = devices[0] if devices else resolve_device(device)
    G, n = model.num_clusters, len(devices or [device])
    if partition == "expert" and G % n:
        raise ValueError(f"expert serving: the {n} devices must divide "
                         f"num_clusters {G} (whole experts per device)")
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    model = model.to(device).eval()
    fd = extract_folded_decoder(model)
    fc = extract_folded_classify(model)
    S = model.num_speakers

    def inputs(audio, style, dev=device):
        """The audio on ``dev`` and its (B, T, S) style rows, in the
        compute dtype."""
        audio = torch.as_tensor(audio, device=dev).to(dtype)
        B, T = audio.shape[:2]
        return audio, style_weights(style, S, dev, dtype)[:, None, :] \
            .expand(B, T, S)

    qfd = None
    if quantize_int8:
        # JAX calibrates on f32 audio and style rows (``serve.py:203-213``);
        # a bf16 model's first conv and its style table cast them to bf16
        # first, so rounding them here gives the same features
        with torch.inference_mode():
            audio, sw = inputs(*calib)
            qfd = quantize_folded_decoder(fd, model.features([audio], None,
                                                             sw))

    def replica(dev, fd_d):
        """(model, fd, fc, packed, qfd) on ``dev``: the model itself on the
        first device, a copy elsewhere; K1's (and K4's) weights packed once,
        here."""
        m = model if dev == device else copy.deepcopy(model).to(dev)
        fd_d, fc_d = _to(fd_d, dev), _to(fc, dev)
        q = None if qfd is None else _to(qfd, dev)
        packed = {}
        if use_kernel:
            packed["classifier"] = pack_decoder_bf16(fc_d)
            if q is None:
                packed["decoder"] = pack_decoder_bf16(fd_d)
            else:
                q = pack_decoder_int8(q)
        return m, fd_d, fc_d, packed, q

    if partition == "expert":
        gl = G // n
        shards = [replica(dev, _expert_share(fd, i, gl))
                  for i, dev in enumerate(devices)]
    else:
        cache = {}
        shards = [cache.setdefault(dev, replica(dev, fd))
                  for dev in (devices or [device])]
    halo = time_halo(model) if partition == "time" else 0

    def one(i, audio, style):
        m, fd_d, fc_d, packed, q = shards[i]
        dev = fd_d["w0"].device
        return _pose(m, *inputs(audio, style, dev), fd_d, fc_d, packed,
                     use_kernel, q, traced=True)

    @torch.inference_mode()
    def fn(audio, style):
        with span("serve.call"):
            return call(audio, style)

    def call(audio, style):
        if devices is None:
            return one(0, audio, style)
        audio = torch.as_tensor(audio)
        style = torch.as_tensor(style)
        if partition == "batch":
            B = audio.shape[0]
            if B % n:
                raise ValueError(f"batch serving: batch {B} must divide "
                                 f"the {n} devices")
            b = B // n
            return torch.cat([one(i, audio[i * b:(i + 1) * b],
                                  style[i * b:(i + 1) * b]).to(device)
                              for i in range(n)])
        if partition == "time":
            wins = time_windows(audio.shape[1], n, halo)
            return torch.cat([
                one(i % n, audio[:, ws:we], style)[:, s - ws:e - ws]
                .to(device) for i, (ws, we, s, e) in enumerate(wins)], dim=1)
        partials = []
        for i, (m, fd_d, fc_d, packed, _) in enumerate(shards):
            dev = fd_d["w0"].device
            a, sw = inputs(audio, style, dev)
            x, soft = _features_soft(m, a, sw, fc_d, packed, use_kernel,
                                     traced=True)
            part = index_select_outputs(
                _decode(m, x, fd_d, packed, use_kernel),
                soft[..., i * gl:(i + 1) * gl], gl)
            partials.append(part.float().to(device))
        return sum(partials[1:], partials[0])

    fn.device = device
    fn.devices = devices
    fn.partition = partition
    fn.dtype = dtype
    fn.use_kernel = use_kernel
    fn.quantize_int8 = quantize_int8
    fn.program = fn.bound_args = None
    if not quantize_int8 and devices is None:
        fn.program = ServingProgram(model, use_kernel)
        fn.bound_args = ({k: v.detach() for k, v in
                          model.state_dict().items()}, fd, fc,
                         shards[0][3])
    return fn


# the waveform path's framing (``serve.py:386-422``): 4.3 s of log-mel at
# 103 frames/s, every round(103 / 15)-th frame for the 15 fps pose
WAVE_SECONDS, MEL_FS, POSE_FS = 4.3, 103, 15


def build_waveform_serving_fn(model: nn.Module, device=None):
    """``fn(waveform (B, samples) at 16 kHz, style) → pose (B, 64, F)``
    (``serve.py:386-422``): the on-device log-mel frontend over the first
    4.3 s, every 7th mel frame (15 pose frames per second), then
    ``build_serving_fn``.  For generators trained on audio/log_mel_400 (64
    mel bins).  ``fn.n_samples`` is the least number of samples it
    takes."""
    stride = round(MEL_FS / POSE_FS)
    mel_window = int(WAVE_SECONDS * MEL_FS)
    # samples for mel_window STFT frames (n_fft 512, hop 160, no centring)
    n_samples = (mel_window - 1) * 160 + 512
    serve = build_serving_fn(model, device=device)

    @torch.inference_mode()
    def serve_wav(wav, style):
        wav = torch.as_tensor(wav, dtype=torch.float32, device=serve.device)
        if wav.shape[-1] < n_samples:
            raise ValueError(f"need at least {n_samples} samples "
                             f"({WAVE_SECONDS} s at 16 kHz), got "
                             f"{wav.shape[-1]}")
        mel = log_mel_spectrogram(wav[..., :n_samples])
        return serve(mel[..., :mel_window:stride, :], style)

    serve_wav.n_samples = n_samples
    return serve_wav
