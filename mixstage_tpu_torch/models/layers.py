"""PyTorch port of the layer subset the Mix-StAGE generator uses.

Counterpart of ``mixstage_tpu/models/layers.py``.  Forwards take and return
channels-last tensors ``(B, T, C)`` / ``(B, H, W, C)``, as the JAX package
does; each convolution runs on a permuted view in torch's ``(B, C, T)`` /
NCHW layout, so a chain of layers permutes without copying.

Submodule and parameter names follow the flax tree (``conv``/``norm``,
``stack.conv{i}``, ``unet.pre0`` ...), so ``interop/weights.py`` maps every
leaf with one layout rule.  Only the inference forward is ported: BatchNorm
runs on its running statistics (see ``BatchNorm``).

Channel counts are the ACTUAL input widths of each conv (flax infers them
from the data), with ``ConvNormRelu``'s per-group semantics kept: it
multiplies ``in/out_channels`` by ``groups`` like the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LOWERINGS = ("conv", "einsum", "s2d", "im2col")


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
    """Inference BatchNorm over the last (channel) axis, with flax's formula
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    Running statistics only.  ``torch.nn.BatchNorm*`` is NOT a drop-in for
    training this model: torch blends the running average with momentum 0.1
    on the NEW value and stores the unbiased batch variance, while flax keeps
    0.9 of the old value and stores the biased variance
    (``mixstage_tpu/train/steps.py:331-332``).  The training slice adds that.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


def _conv_channels_last(conv: nn.Module, x):
    """Apply an NCW/NCHW torch conv to a channels-last tensor."""
    if x.ndim == 3:
        return conv(x.permute(0, 2, 1)).permute(0, 2, 1)
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNormRelu(nn.Module):
    """Conv → BatchNorm → (Leaky)ReLU (``layers.py:69-143``).

    ``lowering`` accepts the JAX package's exact-math relowerings
    (``einsum``, ``s2d``, ``im2col``): they compute the same function from
    the same parameters, so the native conv runs for all of them.
    """

    def __init__(self, in_channels: int, out_channels: int, type: str = "1d",
                 leaky: bool = False, downsample: bool = False,
                 kernel_size=None, stride=None, groups: int = 1,
                 lowering: str = "conv"):
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
        self.norm = BatchNorm(out_channels * groups)
        self.leaky = leaky

    def forward(self, x):
        x = self.norm(_conv_channels_last(self.conv, x))
        return F.leaky_relu(x, 0.2) if self.leaky else F.relu(x)


class UNet1D(nn.Module):
    """1D U-Net with additive skips (``layers.py:151-195``): 2 pre convs,
    ``max_depth`` strided down-convs, ``max_depth`` [nearest-up ×2 + skip +
    conv] stages.  T must be divisible by 2^max_depth."""

    def __init__(self, input_channels: int, output_channels: int,
                 max_depth: int = 5):
        super().__init__()
        self.max_depth = max_depth
        common = dict(type="1d", leaky=True)
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


def resize_bilinear_time(x, time_steps: int):
    """(B, H, W, C) → (B, time_steps, C): bilinear resize to
    (time_steps, 1) with half-pixel centres and no antialiasing, then drop W
    (``layers.py:198-224``, the reference's ``F.interpolate``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(time_steps, 1),
                      mode="bilinear", align_corners=False, antialias=False)
    return y[..., 0].permute(0, 2, 1)


class AudioEncoder(nn.Module):
    """2D conv pyramid over (time, mel) log-spectrogram windows
    (``layers.py:260-308``): (B, T, mel) → (B, time_steps, 256)."""

    CHANNELS = ((64, False), (64, True), (128, False), (128, True),
                (256, False), (256, True), (256, False))

    def __init__(self, lowerings: Optional[Tuple[str, ...]] = None):
        super().__init__()
        if lowerings is not None and (
                len(lowerings) != 8
                or any(lo not in ("conv", "s2d", "im2col") for lo in lowerings)):
            raise ValueError(f"lowerings must be 8 entries from "
                             f"conv|s2d|im2col, got {lowerings!r}")
        common = dict(type="2d", leaky=True)
        cin = 1                                   # one log-mel channel
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
    plan (``layers.py:311-326``)."""

    def __init__(self, plan: Sequence[Tuple[int, int, bool]]):
        super().__init__()
        self.depth = len(plan)
        for i, (cin, cout, down) in enumerate(plan):
            self.add_module(f"conv{i}", ConvNormRelu(
                cin, cout, type="1d", leaky=True, downsample=down))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
        return x


def _encoder_plan(input_channels: int):
    return [(input_channels, 64, False), (64, 64, False), (64, 128, False),
            (128, 128, False), (128, 256, False), (256, 256, False)]


class PoseEncoder(nn.Module):
    """(B, T, pose_feats) → (B, T, 256) (``layers.py:329-345``)."""

    def __init__(self, input_channels: int = 96):
        super().__init__()
        self.stack = _Conv1DStack(_encoder_plan(input_channels))

    def forward(self, x):
        return self.stack(x)


class TextEncoder1D(nn.Module):
    """(B, T, emb) → (B, T, 256) (``layers.py:373-389``)."""

    def __init__(self, input_channels: int = 300):
        super().__init__()
        self.stack = _Conv1DStack(_encoder_plan(input_channels))

    def forward(self, x):
        return self.stack(x)


class ClusterClassify(nn.Module):
    """(B, T, C) → per-frame cluster logits (B, T, num_clusters): 6
    ConvNormRelu + 1×1 conv (``layers.py:431-452``)."""

    def __init__(self, num_clusters: int = 8, input_channels: int = 256):
        super().__init__()
        plan = [(input_channels, 256, False)] + [(256, 256, False)] * 5
        self.stack = _Conv1DStack(plan)
        self.logits = nn.Conv1d(256, num_clusters, 1)

    def forward(self, x):
        return _conv_channels_last(self.logits, self.stack(x))


class GroupedPointwiseConv(nn.Module):
    """1×1 grouped conv as a per-group matmul (``layers.py:597-633``).

    ``weight`` is torch's grouped-conv layout ``(G·F, Cin/G, 1)``: row g·F+f
    multiplies the inputs of group g."""

    def __init__(self, in_channels: int, features: int, groups: int):
        super().__init__()
        if in_channels % groups or features % groups:
            raise ValueError("in_channels and features must divide groups")
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(features, in_channels // groups, 1))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.normal_(self.weight, std=(in_channels // groups) ** -0.5)

    def forward(self, x):
        G = self.groups
        xg = x.reshape(x.shape[:-1] + (G, x.shape[-1] // G))
        kg = self.weight[:, :, 0].reshape(G, -1, xg.shape[-1])   # (G, F, c)
        y = torch.einsum("...gc,gfc->...gf", xg, kg)
        return y.reshape(x.shape[:-1] + (self.weight.shape[0],)) + self.bias


class EmbLin(nn.Module):
    """Style table in the soft-matmul ('lin') mode the generator uses
    (``layers.py:636-654``): (..., S) style weights → (..., dim)."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, embedding_dim))

    def forward(self, x):
        return x.to(self.embedding.dtype) @ self.embedding


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
