"""Plain PyTorch Mix-StAGE generator, Speech2Gesture generator and the
patch discriminator, at float32 (see ``layers.py``).

``MixStageG`` is ``JointLateClusterSoftStyle4_G`` (Ahuja et al., ECCV
2020): audio → UNet → ⊕ style embedding → a cluster classifier's soft
attention over M grouped conv decoders.  ``S2GG`` is ``Speech2Gesture_G``
(Ginosar et al., CVPR 2019): audio → UNet → four convs → 1×1 logits.
``S2GD`` is ``Speech2Gesture_D``, the discriminator both train against.
The modules that the published tree builds but the audio-only forward
never runs (``pose_encoder``, ``concat_encoder``) are built too, so the
parameter set, and with it the optimizer's global norm, is the program's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference.layers import (AudioEncoder, ClusterClassify,
                                         ConvNormRelu, EmbLin,
                                         GroupedPointwiseConv, PoseEncoder,
                                         PoseStyleEncoder, UNet1D, conv_last,
                                         mixture)

CONTENT = 256


class MixStageG(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        C, M, S = cfg["in_channels"], cfg["num_clusters"], cfg["num_speakers"]
        sd, F_ = cfg["style_dim"], cfg["out_feats"]
        self.M = M
        self.audio_encoder = AudioEncoder()
        self.pose_encoder = PoseEncoder(F_)
        self.unet = UNet1D(CONTENT, C)
        self.style_emb = EmbLin(S, sd)
        self.decoder0 = ConvNormRelu(sd + C, C, groups=M)
        for i in range(1, 4):
            self.add_module(f"decoder{i}", ConvNormRelu(C, C, groups=M))
        self.logits = GroupedPointwiseConv(C * M, F_ * M, M)
        self.concat_encoder = ConvNormRelu(2 * CONTENT, CONTENT)
        self.classify_cluster = ClusterClassify(M, sd + C)

    def features(self, audio, style_w):
        x = self.unet(self.audio_encoder(audio, audio.shape[1]))
        return torch.cat([x, self.style_emb(style_w)], dim=-1)

    def decode(self, x):
        x = x.repeat(1, 1, self.M)
        for i in range(4):
            x = getattr(self, f"decoder{i}")(x)
        return self.logits(x)

    def forward(self, audio, style_w):
        """audio (B, T, mel), style weights (B, T, S) → (pose, cluster
        scores)."""
        x = self.features(audio, style_w)
        score = self.classify_cluster(x)
        pose = mixture(self.decode(x), torch.softmax(score, -1), self.M)
        return pose, score


class S2GG(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        C = cfg["in_channels"]
        self.audio_encoder = AudioEncoder()
        self.unet = UNet1D(CONTENT, C)
        for i in range(4):
            self.add_module(f"decoder{i}", ConvNormRelu(C, C))
        self.logits = nn.Conv1d(C, cfg["out_feats"], 1)

    def forward(self, audio):
        x = self.unet(self.audio_encoder(audio, audio.shape[1]))
        for i in range(4):
            x = getattr(self, f"decoder{i}")(x)
        return conv_last(self.logits, x)


class S2GD(nn.Module):
    """(B, T, F) velocity → (B, T') patch scores: k4 s2 conv + leaky, one
    strided block, a k4 s1 block, a k4 VALID conv to one score."""

    def __init__(self, cin: int, ch: int = 64):
        super().__init__()
        self.conv1 = nn.Conv1d(cin, ch, 4, 2, padding=1)
        self.conv2_0 = ConvNormRelu(ch, 2 * ch, downsample=True)
        self.conv3 = ConvNormRelu(2 * ch, 4 * ch, kernel_size=4, stride=1)
        self.logits = nn.Conv1d(4 * ch, 1, 4, 1, padding=0)

    def forward(self, v):
        x = F.leaky_relu(conv_last(self.conv1, v), 0.2)
        x = self.conv3(self.conv2_0(x))
        return conv_last(self.logits, x)[..., 0]


def build(cfg: dict):
    """(gen, psenc or None, disc) of a configuration file's ``model``."""
    if cfg["model"] == "JointLateClusterSoftStyle4_G":
        gen = MixStageG(cfg)
        psenc = PoseStyleEncoder(cfg["out_feats"], cfg["num_speakers"])
    elif cfg["model"] == "Speech2Gesture_G":
        gen, psenc = S2GG(cfg), None
    else:
        raise ValueError(f"no reference for model {cfg['model']!r}")
    return gen, psenc, S2GD(cfg["out_feats"])
