"""The Speech2Gesture baseline generator and the pose discriminator every
GAN model of the repo trains against.

Counterpart of ``mixstage_tpu/models/speech2gesture.py``:
``Speech2Gesture_G`` (``:24-59``), audio → UNet → four convs → 1×1 logits,
and ``Speech2Gesture_D`` (``:62-103``), a strided conv stack over
(velocity) pose sequences that scores overlapping patches.  Submodule names
follow the flax tree (``audio_encoder``, ``unet``, ``decoder{i}``,
``logits``; ``conv1``, ``conv2_{n}``, ``conv3``, ``logits``).  ``dtype``
is the compute dtype (float32 parameters, see ``layers.py``), ``p`` the
dropout probability of every ``ConvNormRelu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mixstage_tpu_torch.models.layers import (AudioEncoder, ConvNormRelu,
                                              UNet1D, _conv_channels_last,
                                              leaky_relu)

# width of the AudioEncoder output (layers.py:260-308)
AUDIO_FEATS = 256


class Speech2Gesture_G(nn.Module):
    """Audio → UNet → 4 leaky ConvNormRelu → 1×1 logits → pose.

    (B, T_audio, n_mels) → ((B, time_steps, out_feats), []): the pose and
    an empty list of internal losses; ``time_steps=None`` keeps the audio
    encoder's input length."""

    def __init__(self, in_channels: int = 256, out_feats: int = 104,
                 audio_lowerings: Optional[Tuple[str, ...]] = None,
                 dtype: torch.dtype = torch.float32, p: float = 0.0):
        super().__init__()
        self.dtype = dtype
        common = dict(dtype=dtype, p=p)
        self.audio_encoder = AudioEncoder(lowerings=audio_lowerings,
                                          **common)
        self.unet = UNet1D(AUDIO_FEATS, in_channels, **common)
        for i in range(4):
            self.add_module(f"decoder{i}", ConvNormRelu(
                in_channels, in_channels, type="1d", leaky=True, **common))
        self.logits = nn.Conv1d(in_channels, out_feats, 1)

    def forward(self, x, y=None, time_steps: Optional[int] = None):
        x = self.unet(self.audio_encoder(x, time_steps=time_steps))
        for i in range(4):
            x = getattr(self, f"decoder{i}")(x)
        return _conv_channels_last(self.logits, x, self.dtype), []


class Speech2Gesture_D(nn.Module):
    """(B, T, in_channels) → patch scores (B, T') when ``out_shape == 1``,
    else (B, T', out_shape); plus an empty list of internal losses.

    conv1 is k4 s2 pad 1 + leaky 0.2 with no norm; ``conv2_{n}`` are
    downsampling ConvNormRelu; ``conv3`` is a k4 s1 ConvNormRelu; the
    logits are a k4 VALID conv."""

    def __init__(self, in_channels: int = 104, out_channels: int = 64,
                 n_downsampling: int = 2, out_shape: int = 1,
                 dtype: torch.dtype = torch.float32, p: float = 0.0):
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
                leaky=True, downsample=True, dtype=dtype, p=p))
            ch_mul = ch_mul_n
        self.conv3 = ConvNormRelu(out_channels * ch_mul,
                                  out_channels * min(2 ** n_downsampling, 8),
                                  type="1d", leaky=True, kernel_size=4,
                                  stride=1, dtype=dtype, p=p)
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
