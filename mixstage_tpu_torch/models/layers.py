"""PyTorch port of the layer vocabulary of the Mix-StAGE models.

Counterpart of ``mixstage_tpu/models/layers.py``: every layer but the TPU
relowerings of ``audio_lowering`` (``_Conv2DS2DFold``, ``_Conv2DIm2col``,
the same math on the same parameters): ``resolve_audio_lowerings`` takes
every plan the JAX package takes, and ``AudioEncoder`` and
``ConvNormRelu`` run the native conv for any of them.  Forwards take and
return channels-last tensors ``(B, T, C)`` / ``(B, H, W, C)``, as the JAX
package does; each convolution runs on a permuted view in torch's
``(B, C, T)`` / NCHW layout, so a chain of layers permutes without
copying.

Submodule and parameter names follow the flax tree (``conv``/``norm``,
``stack.conv{i}``, ``unet.pre0`` ...), so ``interop/weights.py`` maps every
leaf with one layout rule.  ``module.train()`` / ``.eval()`` is the mode:
BatchNorm normalises with batch statistics and updates its running ones in
training mode, as flax does (see ``BatchNorm``).  Every ``ConvNormRelu``
takes the dropout probability ``p`` (plumbed through the stacks, encoders
and models as the JAX package plumbs it) and applies flax's ``Dropout``
between its conv and its norm in training mode; the masks come from the
generator that ``dropout_rng`` installs (see ``dropout``).

Channel counts are the ACTUAL input widths of each conv (flax infers them
from the data), with ``ConvNormRelu``'s per-group semantics kept: it
multiplies ``in/out_channels`` by ``groups`` like the reference.

Compute dtype: every layer takes ``dtype`` (float32 or bfloat16) with
flax's semantics (``flax/linen/linear.py``, ``normalization.py``): the
parameters and the BatchNorm statistics stay float32; a conv casts its
input and kernel to ``dtype``, convolves (float32 accumulation), rounds,
then adds the bias in ``dtype``; BatchNorm reduces its batch statistics in
float32, normalises in float32 and rounds its output to ``dtype``.  At
float32 the layers compute exactly what they did before ``dtype`` existed.
A module moved to float64 (``module.double()``, the parity mode: the JAX
package's float64 modules keep float64 parameters and statistics) with
``dtype=torch.float64`` computes everything in float64.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mixstage_tpu_torch.parallel.mesh import all_reduce_sum, batch_stats_group

LOWERINGS = ("conv", "einsum", "s2d", "im2col")

# the generator the dropout masks are drawn from (``dropout_rng``)
_DROPOUT_GENERATOR = contextvars.ContextVar("dropout_generator",
                                            default=None)


@contextlib.contextmanager
def dropout_rng(generator: Optional[torch.Generator]):
    """Draw every dropout mask of the forwards run inside from
    ``generator`` (a ``torch.Generator`` on the modules' device), in the
    modules' call order: the steps split one generator per step from
    their ``rng``, as the JAX package splits ``drop_rng``."""
    token = _DROPOUT_GENERATOR.set(generator)
    try:
        yield
    finally:
        _DROPOUT_GENERATOR.reset(token)


def dropout(x, p: float, training: bool):
    """``flax.linen.Dropout(rate=p)``: in training mode each element is
    kept with probability ``1 - p`` and a kept one is divided by ``1 - p``
    (rounded to ``x.dtype``, as JAX casts its weak-typed scalar); in eval
    mode, or at ``p = 0``, ``x`` itself.  The mask is drawn with
    ``torch.rand`` from the generator of ``dropout_rng`` (the default
    generator outside it); ``F.dropout`` takes no generator."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep_prob = float(torch.tensor(1.0 - p, dtype=x.dtype))
    u = torch.rand(x.shape, generator=_DROPOUT_GENERATOR.get(),
                   device=x.device, dtype=torch.float32)
    return torch.where(u < 1.0 - p, x / keep_prob, torch.zeros_like(x))


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pad_amount(kernel_size, stride):
    """Per-dim 'same-ish' padding of the reference: int((k - s) / 2)
    (``mixstage_tpu/models/layers.py:53-66``)."""
    if isinstance(kernel_size, int) and isinstance(stride, int):
        return int((kernel_size - stride) / 2)
    return tuple(int((k - s) / 2)
                 for k, s in zip(_pair(kernel_size), _pair(stride)))


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax's semantics
    (``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``).  The output is
    computed in float32 and rounded to ``dtype``.

    Both modes normalise as ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``.  In eval mode ``mean``/``var`` are the running statistics.  In
    training mode they are the batch statistics over every axis but the
    last, reduced in float32 as ``mean(x)`` and ``max(0, mean(x²) - mean²)``
    (the biased variance), and the running statistics are updated in place,
    under ``no_grad``, as ``ra = 0.9·ra + 0.1·batch``.
    ``torch.nn.BatchNorm*`` is not a drop-in: it stores the UNBIASED batch
    variance in its running var.

    Under data parallelism (``parallel/mesh.py::batch_stats``) the batch is
    the data group's global batch: the per-channel count, sum and sum of
    squares are summed over the group by an autograd-aware all-reduce, so
    the mean, the biased variance, the running statistics and the
    gradients (with their cross-rank terms) are the single-device ones on
    the whole batch.  ``torch.nn.SyncBatchNorm`` stores the unbiased
    variance too.
    """

    MOMENTUM = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            xf = x if x.dtype == torch.float64 else x.float()
            group = batch_stats_group()
            if group is None:
                mean = xf.mean(axes)
                var = ((xf * xf).mean(axes) - mean * mean).clamp_min(0.0)
            else:
                C = x.shape[-1]
                count = xf.new_full((1,), xf.numel() // C)
                sums = all_reduce_sum(torch.cat(
                    [xf.sum(axes), (xf * xf).sum(axes), count]), group)
                mean = sums[:C] / sums[-1]
                var = (sums[C:2 * C] / sums[-1] - mean * mean).clamp_min(0.0)
            self.update_running_stats(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        if self.dtype in (torch.float32, torch.float64):
            return (x - mean) * mul + self.bias
        return ((x.float() - mean) * mul + self.bias).to(self.dtype)

    @torch.no_grad()
    def update_running_stats(self, mean, var):
        """flax's rule: keep 0.9 of the OLD value, blend in 0.1 of the
        batch statistic (``var`` biased)."""
        m = self.MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)


def _cast(t, dtype: torch.dtype):
    """``t`` in the compute ``dtype``; at float32 ``t`` as it is."""
    return t if dtype == torch.float32 else t.to(dtype)


def leaky_relu(x, negative_slope: float = 0.2):
    """``flax.linen.leaky_relu``: ``where(x >= 0, x, slope * x)`` with the
    slope in ``x.dtype`` (JAX casts the Python float to bf16: 0.2 becomes
    0.2001953125), the product rounded to ``x.dtype``."""
    if x.dtype != torch.float32:
        negative_slope = float(torch.tensor(negative_slope, dtype=x.dtype))
    return F.leaky_relu(x, negative_slope)


def softmax(x, dim: int = -1):
    """``jax.nn.softmax``: at float32 ``torch.softmax``; below it, JAX's
    steps each rounded to ``x.dtype`` (shift by the max, exp, sum, divide),
    as the JAX package's bf16 model computes them."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def _conv_channels_last(conv: nn.Module, x,
                        dtype: torch.dtype = torch.float32):
    """Apply an NCW/NCHW torch conv to a channels-last tensor.  Below
    float32, flax's ``nn.Conv``: input and kernel cast to ``dtype``, the
    conv rounded to ``dtype``, then the bias added in ``dtype``."""
    if x.ndim == 3:
        to_first, to_last = (0, 2, 1), (0, 2, 1)
    else:
        to_first, to_last = (0, 3, 1, 2), (0, 2, 3, 1)
    x = x.permute(*to_first)
    if dtype == torch.float32:
        return conv(x).permute(*to_last)
    y = conv._conv_forward(x.to(dtype), conv.weight.to(dtype), None)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype)[(slice(None),) + (None,) * (y.ndim - 2)]
    return y.permute(*to_last)


class ConvNormRelu(nn.Module):
    """Conv → Dropout(p) → BatchNorm → (Leaky)ReLU (``layers.py:69-143``,
    the reference's order).

    ``lowering`` accepts the JAX package's exact-math relowerings
    (``einsum``, ``s2d``, ``im2col``): they compute the same function from
    the same parameters, so the native conv runs for all of them.
    """

    def __init__(self, in_channels: int, out_channels: int, type: str = "1d",
                 leaky: bool = False, downsample: bool = False,
                 kernel_size=None, stride=None, groups: int = 1,
                 lowering: str = "conv", dtype: torch.dtype = torch.float32,
                 p: float = 0.0):
        super().__init__()
        if lowering not in LOWERINGS:
            raise ValueError(f"unknown lowering {lowering!r}; expected one "
                             f"of {LOWERINGS}")
        if type not in ("1d", "2d"):
            raise ValueError(f"unknown conv type {type!r}")
        if kernel_size is None and stride is None:
            kernel_size, stride = (3, 1) if not downsample else (4, 2)
        conv_cls = nn.Conv1d if type == "1d" else nn.Conv2d
        self.conv = conv_cls(in_channels * groups, out_channels * groups,
                             kernel_size, stride,
                             _pad_amount(kernel_size, stride), groups=groups)
        self.norm = BatchNorm(out_channels * groups, dtype=dtype)
        self.leaky = leaky
        self.dtype = dtype
        self.p = p

    def forward(self, x):
        x = dropout(_conv_channels_last(self.conv, x, self.dtype), self.p,
                    self.training)
        x = self.norm(x)
        return leaky_relu(x, 0.2) if self.leaky else F.relu(x)


class UNet1D(nn.Module):
    """1D U-Net with additive skips (``layers.py:151-195``): 2 pre convs,
    ``max_depth`` strided down-convs, ``max_depth`` [nearest-up ×2 + skip +
    conv] stages.  T must be divisible by 2^max_depth."""

    def __init__(self, input_channels: int, output_channels: int,
                 max_depth: int = 5, dtype: torch.dtype = torch.float32,
                 p: float = 0.0):
        super().__init__()
        self.max_depth = max_depth
        common = dict(type="1d", leaky=True, dtype=dtype, p=p)
        self.pre0 = ConvNormRelu(input_channels, output_channels, **common)
        self.pre1 = ConvNormRelu(output_channels, output_channels, **common)
        for i in range(max_depth):
            self.add_module(f"down{i}", ConvNormRelu(
                output_channels, output_channels, downsample=True, **common))
        for i in range(max_depth):
            self.add_module(f"up{i}", ConvNormRelu(
                output_channels, output_channels, **common))

    def forward(self, x):
        T = x.shape[1]
        if T % (2 ** self.max_depth):
            raise ValueError(f"UNet1D input length {T} must be divisible by "
                             f"2^{self.max_depth}")
        x = self.pre1(self.pre0(x))
        residuals = [x]
        for i in range(self.max_depth):
            x = getattr(self, f"down{i}")(x)
            if i < self.max_depth - 1:
                residuals.append(x)
        for i in range(self.max_depth):
            x = x.repeat_interleave(2, dim=1) + residuals[-1 - i]
            x = getattr(self, f"up{i}")(x)
        return x


def _bilinear_axis(x, out_size: int, axis: int):
    """JAX's ``_bilinear_axis`` (``layers.py:178-196``): half-pixel centres,
    no antialiasing, the interpolation weight cast to ``x.dtype`` and the
    blend computed in it."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    pos = torch.float64 if x.dtype == torch.float64 else torch.float32
    src = (torch.arange(out_size, dtype=pos, device=x.device)
           + 0.5) * (in_size / out_size) - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = src.floor().long()
    hi = (lo + 1).clamp_max(in_size - 1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    frac = (src - lo).to(x.dtype).reshape(shape)
    return (x.index_select(axis, lo) * (1 - frac)
            + x.index_select(axis, hi) * frac)


def resize_bilinear_time(x, time_steps: int):
    """(B, H, W, C) → (B, time_steps, C): bilinear resize to
    (time_steps, 1) with half-pixel centres and no antialiasing, then drop W
    (``layers.py:198-224``, the reference's ``F.interpolate``).  Below
    float32 the blend runs in ``x.dtype``, as JAX's does."""
    if x.dtype != torch.float32:
        x = _bilinear_axis(_bilinear_axis(x, time_steps, 1), 1, 2)
        return x[:, :, 0, :]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(time_steps, 1),
                      mode="bilinear", align_corners=False, antialias=False)
    return y[..., 0].permute(0, 2, 1)


# the ``-audio_lowering`` plans' entries: every plan computes the same
# function from the same parameters (``layers.py:227-258``)
AUDIO_LOWERING_ENTRIES = ("conv", "s2d", "im2col")


def resolve_audio_lowerings(spec) -> Optional[Tuple[str, ...]]:
    """The ``-audio_lowering`` flag as an ``AudioEncoder`` plan, by the
    JAX package's rules: None, ``""``, ``"native"``, ``"conv"`` and
    ``"tpu"`` are the native convolutions (None); else 8 entries from
    conv|s2d|im2col, a comma-separated string or a sequence.  Anything
    else raises ``ValueError``.  Every plan runs the native convolution
    here (cuDNN's is the lowering on the card)."""
    if spec is None or (isinstance(spec, str) and
                        spec in ("", "native", "conv", "tpu")):
        return None
    if isinstance(spec, str):
        spec = tuple(s.strip() for s in spec.split(","))
    plan = tuple(spec)
    if len(plan) != 8 or not all(p in AUDIO_LOWERING_ENTRIES for p in plan):
        raise ValueError(
            f"audio_lowering must be 'native', 'tpu', or 8 comma-separated "
            f"entries from conv|s2d|im2col; got {spec!r}")
    return plan


class AudioEncoder(nn.Module):
    """2D conv pyramid over (time, mel) log-spectrogram windows
    (``layers.py:260-308``): (B, T, mel) → (B, time_steps, 256).  With
    ``groups`` G every conv is grouped (``ConvNormRelu``'s per-group
    widths): the input holds ``input_channels · G`` channels, the output
    256 · G."""

    CHANNELS = ((64, False), (64, True), (128, False), (128, True),
                (256, False), (256, True), (256, False))

    def __init__(self, lowerings: Optional[Tuple[str, ...]] = None,
                 dtype: torch.dtype = torch.float32, p: float = 0.0,
                 input_channels: int = 1, groups: int = 1):
        super().__init__()
        if lowerings is not None and (
                len(lowerings) != 8
                or any(lo not in AUDIO_LOWERING_ENTRIES for lo in lowerings)):
            raise ValueError(f"lowerings must be 8 entries from "
                             f"conv|s2d|im2col, got {lowerings!r}")
        common = dict(type="2d", leaky=True, dtype=dtype, p=p, groups=groups)
        cin = input_channels                      # one log-mel channel
        for i, (cout, down) in enumerate(self.CHANNELS):
            self.add_module(f"conv{i}", ConvNormRelu(cin, cout,
                                                     downsample=down, **common))
            cin = cout
        self.conv7 = ConvNormRelu(256, 256, kernel_size=(3, 8), stride=1,
                                  **common)

    def forward(self, x, time_steps: Optional[int] = None):
        if x.ndim == 3:
            x = x[..., None]                      # (B, T, mel, 1)
        if time_steps is None:
            time_steps = x.shape[1]
        for i in range(8):
            x = getattr(self, f"conv{i}")(x)
        return resize_bilinear_time(x, time_steps)


class _Conv1DStack(nn.Module):
    """A stack of 1D leaky ConvNormRelu blocks from a (cin, cout, downsample)
    plan (``layers.py:311-326``), each grouped by ``groups`` (per-group
    widths)."""

    def __init__(self, plan: Sequence[Tuple[int, int, bool]],
                 dtype: torch.dtype = torch.float32, p: float = 0.0,
                 groups: int = 1):
        super().__init__()
        self.depth = len(plan)
        for i, (cin, cout, down) in enumerate(plan):
            self.add_module(f"conv{i}", ConvNormRelu(
                cin, cout, type="1d", leaky=True, downsample=down,
                dtype=dtype, p=p, groups=groups))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
        return x


def _encoder_plan(input_channels: int):
    return [(input_channels, 64, False), (64, 64, False), (64, 128, False),
            (128, 128, False), (128, 256, False), (256, 256, False)]


class PoseEncoder(nn.Module):
    """(B, T, pose_feats) → (B, T, 256) (``layers.py:329-345``); grouped,
    (B, T, pose_feats · G) → (B, T, 256 · G)."""

    def __init__(self, input_channels: int = 96,
                 dtype: torch.dtype = torch.float32, p: float = 0.0,
                 groups: int = 1):
        super().__init__()
        self.stack = _Conv1DStack(_encoder_plan(input_channels), dtype, p,
                                  groups)

    def forward(self, x):
        return self.stack(x)


class PoseStyleEncoder(nn.Module):
    """Pose → speaker logits (``layers.py:348-370``): six downsampling 1D
    ConvNormRelu, then the temporal mean.  (B, T, pose_feats) →
    (B, num_speakers)."""

    def __init__(self, input_channels: int = 96, num_speakers: int = 4,
                 dtype: torch.dtype = torch.float32, p: float = 0.0,
                 groups: int = 1):
        super().__init__()
        self.stack = _Conv1DStack([
            (input_channels, 64, False), (64, 64, True), (64, 128, True),
            (128, 128, True), (128, 256, True), (256, 256, True),
            (256, num_speakers, True)], dtype, p, groups)

    def forward(self, x):
        return self.stack(x).mean(dim=1)


class TextEncoder1D(nn.Module):
    """(B, T, emb) → (B, T, 256) (``layers.py:373-389``)."""

    def __init__(self, input_channels: int = 300,
                 dtype: torch.dtype = torch.float32, p: float = 0.0,
                 groups: int = 1):
        super().__init__()
        self.stack = _Conv1DStack(_encoder_plan(input_channels), dtype, p,
                                  groups)

    def forward(self, x):
        return self.stack(x)


class AudioEncoder1D(nn.Module):
    """1D audio encoder over (B, T, mel) → (B, T, 256)
    (``layers.py:392-408``): PoseEncoder's plan on log-mel frames."""

    def __init__(self, input_channels: int = 128,
                 dtype: torch.dtype = torch.float32, p: float = 0.0,
                 groups: int = 1):
        super().__init__()
        self.stack = _Conv1DStack(_encoder_plan(input_channels), dtype, p,
                                  groups)

    def forward(self, x):
        return self.stack(x)


class LatentEncoder(nn.Module):
    """Four 1D ConvNormRelu, (B, T, in) → (B, T, out)
    (``layers.py:411-428``)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int = 2, dtype: torch.dtype = torch.float32,
                 p: float = 0.0):
        super().__init__()
        h = hidden_channels
        self.stack = _Conv1DStack([(in_channels, h, False), (h, h, False),
                                   (h, h, False), (h, out_channels, False)],
                                  dtype, p)

    def forward(self, x):
        return self.stack(x)


class ClusterClassify(nn.Module):
    """(B, T, C) → per-frame cluster logits (B, T, num_clusters): 6
    ConvNormRelu + 1×1 conv (``layers.py:431-452``)."""

    def __init__(self, num_clusters: int = 8, input_channels: int = 256,
                 dtype: torch.dtype = torch.float32, p: float = 0.0):
        super().__init__()
        plan = [(input_channels, 256, False)] + [(256, 256, False)] * 5
        self.stack = _Conv1DStack(plan, dtype, p)
        self.logits = nn.Conv1d(256, num_clusters, 1)
        self.dtype = dtype

    def forward(self, x):
        return _conv_channels_last(self.logits, self.stack(x), self.dtype)


class GroupedPointwiseConv(nn.Module):
    """1×1 grouped conv as a per-group matmul (``layers.py:597-633``).

    ``weight`` is torch's grouped-conv layout ``(G·F, Cin/G, 1)``: row g·F+f
    multiplies the inputs of group g.  Input, kernel and bias are cast to
    ``dtype`` (flax's ``promote_dtype``)."""

    def __init__(self, in_channels: int, features: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if in_channels % groups or features % groups:
            raise ValueError("in_channels and features must divide groups")
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(features, in_channels // groups, 1))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.normal_(self.weight, std=(in_channels // groups) ** -0.5)

    def forward(self, x):
        G, dt = self.groups, self.dtype
        xg = _cast(x, dt).reshape(x.shape[:-1] + (G, x.shape[-1] // G))
        kg = _cast(self.weight[:, :, 0], dt).reshape(G, -1, xg.shape[-1])
        y = torch.einsum("...gc,gfc->...gf", xg, kg)           # kg (G, F, c)
        return y.reshape(x.shape[:-1] + (self.weight.shape[0],)) + \
            _cast(self.bias, dt)


class EmbLin(nn.Module):
    """The style table (``layers.py:636-654``): in the soft-matmul
    ``'lin'`` mode the generator uses, (..., S) style weights → (...,
    dim); in the hard-index ``'emb'`` mode, (...) integer rows → (...,
    dim)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, embedding_dim))

    def forward(self, x, mode: str = "lin"):
        emb = _cast(self.embedding, self.dtype)
        if mode == "lin":
            return x.to(emb.dtype) @ emb
        if mode == "emb":
            return emb[x.long()]
        raise ValueError(f"unknown EmbLin mode {mode!r}")


def curriculum_value(step, start: float, end: float, num_iters: int):
    """The linear style curriculum (``layers.py:656-661``, the reference's
    ``Curriculum``): ``start + (end - start) · clip(step / num_iters, 0,
    1)`` in float32, a 0-d tensor."""
    if torch.is_tensor(step):
        frac = step.float() / max(num_iters, 1)
    else:
        frac = torch.tensor(step / max(num_iters, 1), dtype=torch.float32)
    return start + (end - start) * frac.clamp(0.0, 1.0)


class PoseDecoder(nn.Module):
    """Grouped pose decoder with per-group style re-injection
    (``layers.py:681-718``): four ConvNormRelu grouped by
    ``num_clusters`` M; after each of the first three, each group's last
    ``style_dim`` input channels are appended to its output again; then a
    grouped 1×1 conv.  (B, T, M·(input_channels + style_dim)) → (B, T,
    M·out_feats)."""

    def __init__(self, input_channels: int = 256, style_dim: int = 10,
                 num_clusters: int = 8, out_feats: int = 96, p: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.style_dim, self.num_clusters, self.dtype = (style_dim,
                                                         num_clusters, dtype)
        for i in range(4):
            self.add_module(f"dec{i}", ConvNormRelu(
                input_channels + style_dim, input_channels, type="1d",
                leaky=True, groups=num_clusters, dtype=dtype, p=p))
        self.pose_logits = nn.Conv1d(input_channels * num_clusters,
                                     out_feats * num_clusters, 1,
                                     groups=num_clusters)

    def forward(self, x):
        B, T, _ = x.shape
        M = self.num_clusters
        style = x.reshape(B, T, M, -1)[..., -self.style_dim:]
        for i in range(4):
            x = getattr(self, f"dec{i}")(x)
            if i < 3:
                x = torch.cat([x.reshape(B, T, M, -1), style],
                              dim=-1).reshape(B, T, -1)
        return _conv_channels_last(self.pose_logits, x, self.dtype)


class StyleDecoder(nn.Module):
    """Two grouped ConvNormRelu and a grouped 1×1 conv
    (``layers.py:721-741``): (B, T, M·input_channels) → (B, T,
    M·out_feats), M = ``num_clusters``."""

    def __init__(self, input_channels: int = 256, num_clusters: int = 10,
                 out_feats: int = 96, p: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i in range(2):
            self.add_module(f"dec{i}", ConvNormRelu(
                input_channels, input_channels, type="1d", leaky=True,
                groups=num_clusters, dtype=dtype, p=p))
        self.pose_logits = nn.Conv1d(input_channels * num_clusters,
                                     out_feats * num_clusters, 1,
                                     groups=num_clusters)

    def forward(self, x):
        return _conv_channels_last(self.pose_logits, self.dec1(self.dec0(x)),
                                   self.dtype)


def confidence_entropy_loss(y, y_cap, confidence, beta: float = 1.0,
                            epsilon: float = 0.5):
    """Gaussian-entropy confidence-weighted loss (``layers.py:664-678``,
    the reference's ``Confidence``), element-wise: each keypoint's
    confidence sets a Gaussian's width, the prediction's probability under
    it a second width, whose entropy is the loss."""
    def get_sigma(c):
        c = torch.where(c < epsilon, epsilon, c)
        return 1.0 / (2.0 * math.pi * c)

    sigma = get_sigma(confidence)
    diff = -((y - y_cap) ** 2)
    prob = torch.exp(diff / (2.0 * sigma ** 2)) / (2.0 * math.pi * sigma)
    sigma_ycap = get_sigma(prob)
    return 0.5 * torch.log(2.0 * math.pi * math.e * (sigma_ycap ** 2)) * beta


@torch.no_grad()
def reset_parameters_(module: nn.Module, generator: torch.Generator,
                      random_bn_stats: bool = False) -> nn.Module:
    """Redraw every parameter from ``generator``, at flax's init scales:
    conv kernels normal with std 1/sqrt(fan_in) (flax: truncated
    lecun-normal), zero biases, unit BN scale, unit-normal style table.
    With ``random_bn_stats`` the running statistics are drawn as a trained
    model would hold them (mean ~ N(0, 0.1²), var ~ U(0.5, 2)), so BN
    folding is far from a no-op.  Initialise on the CPU, then move."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, GroupedPointwiseConv)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                             generator=generator)
            m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if random_bn_stats:
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 2.0, generator=generator)
        elif isinstance(m, EmbLin):
            m.embedding.normal_(generator=generator)
    return module
