"""Plain PyTorch layers of the Mix-StAGE and Speech2Gesture models.

A frozen copy of the layer equations of the published models (github.com/
chahuja/mix-stage, ``src/model/layers.py``, ``speech2gesture.py``,
``jlcss4.py``) at float32, written with ``torch.nn.functional`` only.
Parameter and buffer names follow the serving program's module tree so
that one set of tensors, made by the benchmark from ``--seed``, loads into
both.  Tensors are channels-last: (B, T, C) and (B, H, W, C).

BatchNorm follows the training framework the port reproduces: momentum
0.9 on the OLD running value, the biased batch variance in the running
update, epsilon 1e-5.  Dropout is absent (the benchmark's configurations
train with p = 0).  Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5
MOMENTUM = 0.9
SLOPE = 0.2


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean
                                        + (1 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var
                                       + (1 - MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + EPS) * self.weight) + self.bias


def conv_last(conv: nn.Module, x):
    """A channels-first conv applied to a channels-last tensor."""
    if x.ndim == 3:
        return conv(x.permute(0, 2, 1)).permute(0, 2, 1)
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _pad(k, s):
    if isinstance(k, int) and isinstance(s, int):
        return int((k - s) / 2)
    k = (k, k) if isinstance(k, int) else k
    s = (s, s) if isinstance(s, int) else s
    return tuple(int((a - b) / 2) for a, b in zip(k, s))


class ConvNormRelu(nn.Module):
    """conv → BatchNorm → leaky ReLU 0.2 (or ReLU); widths per group."""

    def __init__(self, cin, cout, dims=1, leaky=True, downsample=False,
                 kernel_size=None, stride=None, groups=1):
        super().__init__()
        if kernel_size is None:
            kernel_size, stride = (4, 2) if downsample else (3, 1)
        cls = nn.Conv1d if dims == 1 else nn.Conv2d
        self.conv = cls(cin * groups, cout * groups, kernel_size, stride,
                        _pad(kernel_size, stride), groups=groups)
        self.norm = BatchNorm(cout * groups)
        self.leaky = leaky

    def forward(self, x):
        x = self.norm(conv_last(self.conv, x))
        return F.leaky_relu(x, SLOPE) if self.leaky else F.relu(x)


class Stack1D(nn.Module):
    def __init__(self, plan, groups=1):
        super().__init__()
        self.depth = len(plan)
        for i, (cin, cout, down) in enumerate(plan):
            self.add_module(f"conv{i}", ConvNormRelu(cin, cout, 1, True, down,
                                                     groups=groups))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
        return x


def encoder_plan(cin):
    return [(cin, 64, False), (64, 64, False), (64, 128, False),
            (128, 128, False), (128, 256, False), (256, 256, False)]


class PoseEncoder(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.stack = Stack1D(encoder_plan(cin))

    def forward(self, x):
        return self.stack(x)


class PoseStyleEncoder(nn.Module):
    """Pose → speaker logits: seven 1D blocks, then the mean over time."""

    def __init__(self, cin, num_speakers):
        super().__init__()
        self.stack = Stack1D([(cin, 64, False), (64, 64, True),
                              (64, 128, True), (128, 128, True),
                              (128, 256, True), (256, 256, True),
                              (256, num_speakers, True)])

    def forward(self, x):
        return self.stack(x).mean(dim=1)


class UNet1D(nn.Module):
    """Two convs, five strided convs down, five [nearest ×2 + skip + conv]
    up."""

    def __init__(self, cin, c, depth=5):
        super().__init__()
        self.max_depth = depth
        self.pre0 = ConvNormRelu(cin, c)
        self.pre1 = ConvNormRelu(c, c)
        for i in range(depth):
            self.add_module(f"down{i}", ConvNormRelu(c, c, downsample=True))
        for i in range(depth):
            self.add_module(f"up{i}", ConvNormRelu(c, c))

    def forward(self, x):
        x = self.pre1(self.pre0(x))
        skips = [x]
        for i in range(self.max_depth):
            x = getattr(self, f"down{i}")(x)
            if i < self.max_depth - 1:
                skips.append(x)
        for i in range(self.max_depth):
            x = x.repeat_interleave(2, dim=1) + skips[-1 - i]
            x = getattr(self, f"up{i}")(x)
        return x


class AudioEncoder(nn.Module):
    """2D conv pyramid over (time, mel), then a bilinear resize of time to
    the pose's frames (half-pixel centres, no antialiasing)."""

    CHANNELS = ((64, False), (64, True), (128, False), (128, True),
                (256, False), (256, True), (256, False))

    def __init__(self):
        super().__init__()
        cin = 1
        for i, (cout, down) in enumerate(self.CHANNELS):
            self.add_module(f"conv{i}", ConvNormRelu(cin, cout, 2, True,
                                                     down))
            cin = cout
        self.conv7 = ConvNormRelu(256, 256, 2, True, kernel_size=(3, 8),
                                  stride=1)

    def forward(self, x, time_steps):
        x = x[..., None]
        for i in range(8):
            x = getattr(self, f"conv{i}")(x)
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(time_steps, 1),
                          mode="bilinear", align_corners=False)
        return y[..., 0].permute(0, 2, 1)


class ClusterClassify(nn.Module):
    def __init__(self, num_clusters, cin):
        super().__init__()
        self.stack = Stack1D([(cin, 256, False)] + [(256, 256, False)] * 5)
        self.logits = nn.Conv1d(256, num_clusters, 1)

    def forward(self, x):
        return conv_last(self.logits, self.stack(x))


class GroupedPointwiseConv(nn.Module):
    """A 1×1 grouped conv as one matmul per group; weight (G·F, C/G, 1)."""

    def __init__(self, cin, features, groups):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(features, cin // groups, 1))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        G = self.groups
        xg = x.reshape(x.shape[:-1] + (G, x.shape[-1] // G))
        kg = self.weight[:, :, 0].reshape(G, -1, xg.shape[-1])
        y = torch.einsum("...gc,gfc->...gf", xg, kg)
        return y.reshape(x.shape[:-1] + (self.weight.shape[0],)) + self.bias


class EmbLin(nn.Module):
    """The style table: (..., S) style weights @ (S, dim)."""

    def __init__(self, num, dim):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, dim))

    def forward(self, w):
        return w @ self.embedding


def mixture(x, soft, groups: int):
    """(B, T, G·F) grouped outputs weighed by (B, T, G) → (B, T, F)."""
    B, T, C = x.shape
    return torch.einsum("btmf,btm->btf", x.reshape(B, T, groups, C // groups),
                        soft)
