"""Speaker style classifier, also the Inception-Score feature network.

Counterpart of ``mixstage_tpu/models/style_classifier.py``
(``StyleClassifier_G``): six stride-2 ``ConvNormRelu`` blocks with plain
ReLU, named ``classifier{i}`` as the flax tree, collapse a 64-frame pose
window to speaker logits.  A frozen trained copy is the feature network of
the style Inception Score (``evaluation/metrics.py::InceptionScoreStyle``,
loaded by the trainer behind ``-pretrained_model_weights``).
"""

from __future__ import annotations

import torch
from torch import nn

from mixstage_tpu_torch.models.layers import ConvNormRelu


class StyleClassifier_G(nn.Module):
    """(B, T, in_channels) pose → ((B, num_speakers) logits, []): the
    temporal mean of the last block (T = 64 collapses to one frame)."""

    def __init__(self, in_channels: int = 256, num_speakers: int = 2,
                 dtype: torch.dtype = torch.float32, p: float = 0.0):
        super().__init__()
        plan = [(in_channels, 64), (64, 128), (128, 128), (128, 256),
                (256, 256), (256, num_speakers)]
        for i, (cin, cout) in enumerate(plan):
            self.add_module(f"classifier{i}", ConvNormRelu(
                cin, cout, type="1d", downsample=True, dtype=dtype, p=p))
        self.depth = len(plan)

    def forward(self, x, y=None):
        for i in range(self.depth):
            x = getattr(self, f"classifier{i}")(x)
        return (x.mean(dim=1) if x.shape[1] > 1 else x[:, 0, :]), []
