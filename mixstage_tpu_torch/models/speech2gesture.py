"""The pose discriminator every GAN model of the repo trains against.

Counterpart of ``mixstage_tpu/models/speech2gesture.py:62-103``
(``Speech2Gesture_D``): a strided conv stack over (velocity) pose
sequences that scores overlapping patches.  Submodule names follow the flax
tree (``conv1``, ``conv2_{n}``, ``conv3``, ``logits``).  ``dtype`` is the
compute dtype (float32 parameters, see ``layers.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from mixstage_tpu_torch.models.layers import (ConvNormRelu,
                                              _conv_channels_last, leaky_relu)


class Speech2Gesture_D(nn.Module):
    """(B, T, in_channels) → patch scores (B, T') when ``out_shape == 1``,
    else (B, T', out_shape); plus an empty list of internal losses.

    conv1 is k4 s2 pad 1 + leaky 0.2 with no norm; ``conv2_{n}`` are
    downsampling ConvNormRelu; ``conv3`` is a k4 s1 ConvNormRelu; the
    logits are a k4 VALID conv."""

    def __init__(self, in_channels: int = 104, out_channels: int = 64,
                 n_downsampling: int = 2, out_shape: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_shape = out_shape
        self.n_downsampling = n_downsampling
        self.conv1 = nn.Conv1d(in_channels, out_channels, 4, 2, padding=1)
        ch_mul = 1
        for n in range(1, n_downsampling):
            ch_mul_n = min(2 ** n, 8)
            self.add_module(f"conv2_{n - 1}", ConvNormRelu(
                out_channels * ch_mul, out_channels * ch_mul_n, type="1d",
                leaky=True, downsample=True, dtype=dtype))
            ch_mul = ch_mul_n
        self.conv3 = ConvNormRelu(out_channels * ch_mul,
                                  out_channels * min(2 ** n_downsampling, 8),
                                  type="1d", leaky=True, kernel_size=4,
                                  stride=1, dtype=dtype)
        self.logits = nn.Conv1d(out_channels * min(2 ** n_downsampling, 8),
                                out_shape, 4, 1, padding=0)

    def forward(self, x):
        x = leaky_relu(_conv_channels_last(self.conv1, x, self.dtype), 0.2)
        for n in range(1, self.n_downsampling):
            x = getattr(self, f"conv2_{n - 1}")(x)
        x = _conv_channels_last(self.logits, self.conv3(x), self.dtype)
        if self.out_shape == 1:
            x = x[..., 0]
        return x, []
