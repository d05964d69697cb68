"""Mix-StAGE generator: content + style → soft mixture of M decoders.

Counterpart of ``mixstage_tpu/models/mix_stage.py:43-200``: audio content
encoding → UNet → style-embedding concat → cluster
classifier soft attention → grouped-conv mixture decoder → soft output
selection.  Submodule names follow the flax tree, including the
``pose_encoder`` and ``concat_encoder`` that flax builds even in audio-only
configs, so the weight bridge round-trips the whole tree.  The mode is
``module.train()`` / ``.eval()`` (BatchNorm on batch or running statistics).
``dtype`` is the compute dtype (float32 or bfloat16, flax's semantics, see
``layers.py``; float64 on a module moved to float64): parameters and BatchNorm statistics stay float32, the
features, the cluster scores and softmax, and the pose are in ``dtype``, as
in the JAX package's ``dtype=bfloat16`` model.

Port scope: one audio stream and the curriculum pose input.  The text
encoder and the ``concat_encoder`` fusion of audio + text come with the
text-modality slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mixstage_tpu_torch.models.layers import (AudioEncoder, ClusterClassify,
                                              ConvNormRelu, EmbLin,
                                              GroupedPointwiseConv,
                                              PoseEncoder, UNet1D, softmax)
from mixstage_tpu_torch.ops.mixture import index_select_outputs

# width of the AudioEncoder / PoseEncoder output (layers.py:260-345)
CONTENT_FEATS = 256


class JointLateClusterSoftStyle4_G(nn.Module):
    """Mix-StAGE generator."""

    def __init__(self, in_channels: int = 256, out_feats: int = 96,
                 num_clusters: int = 8, num_speakers: int = 2,
                 style_dim: int = 10, decoder_lowering: str = "conv",
                 audio_lowerings: Optional[Tuple[str, ...]] = None,
                 dtype: torch.dtype = torch.float32, p: float = 0.0):
        super().__init__()
        self.num_clusters = num_clusters
        self.num_speakers = num_speakers
        self.dtype = dtype
        M = num_clusters
        common = dict(dtype=dtype, p=p)      # every ConvNormRelu drops p
        self.audio_encoder = AudioEncoder(lowerings=audio_lowerings,
                                          **common)
        self.pose_encoder = PoseEncoder(input_channels=out_feats, **common)
        self.unet = UNet1D(CONTENT_FEATS, in_channels, **common)
        self.style_emb = EmbLin(num_speakers, style_dim, dtype=dtype)
        # content mixture decoder: 4 grouped ConvNormRelu (jlcss4.py:69-83)
        self.decoder0 = ConvNormRelu(style_dim + in_channels, in_channels,
                                     type="1d", leaky=True, groups=M,
                                     lowering=decoder_lowering, **common)
        for i in range(1, 4):
            self.add_module(f"decoder{i}", ConvNormRelu(
                in_channels, in_channels, type="1d", leaky=True, groups=M,
                lowering=decoder_lowering, **common))
        self.logits = GroupedPointwiseConv(in_channels * M, out_feats * M,
                                           groups=M, dtype=dtype)
        self.concat_encoder = ConvNormRelu(2 * CONTENT_FEATS, CONTENT_FEATS,
                                           type="1d", leaky=True, **common)
        self.classify_cluster = ClusterClassify(
            num_clusters=M, input_channels=style_dim + in_channels,
            **common)

    def decoder_layers(self):
        return [getattr(self, f"decoder{i}") for i in range(4)]

    def encode_content(self, x_list: Sequence[torch.Tensor], y,
                       input_modalities: Sequence[str],
                       use_pose_input: bool, time_steps: Optional[int]):
        """Curriculum content encoding (``mix_stage.py:105-137``)."""
        if use_pose_input:
            return self.pose_encoder(y)
        kinds = [m.split("/")[0] for m in input_modalities]
        if kinds != ["audio"]:
            raise NotImplementedError(
                f"input modalities {list(input_modalities)!r}: the port "
                f"encodes one audio stream (text and the fusion of several "
                f"streams come with a later slice)")
        return self.audio_encoder(x_list[0], time_steps=time_steps)

    def features(self, x_list: Sequence[torch.Tensor], y, style_weights,
                 input_modalities: Sequence[str] = ("audio/log_mel_512",),
                 use_pose_input: bool = False,
                 time_steps: Optional[int] = None):
        """Content → UNet → style concat: the shared (B, T, in_channels +
        style_dim) features of the classifier and the mixture decoder."""
        x = self.encode_content(x_list, y, input_modalities, use_pose_input,
                                time_steps)
        x = self.unet(x)
        labels_style = self.style_emb(style_weights)
        return torch.cat([x, labels_style], dim=-1)

    def backbone(self, x_list, y, style_weights,
                 input_modalities: Sequence[str] = ("audio/log_mel_512",),
                 use_pose_input: bool = False,
                 time_steps: Optional[int] = None):
        """Everything up to (excluding) the mixture decoder."""
        x = self.features(x_list, y, style_weights, input_modalities,
                          use_pose_input, time_steps)
        labels_score = self.classify_cluster(x)
        return x, labels_score, softmax(labels_score, dim=-1)

    def forward(self, x_list, y, style_weights,
                input_modalities: Sequence[str] = ("audio/log_mel_512",),
                use_pose_input: bool = False,
                time_steps: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Forward: ``style_weights`` (B, T, num_speakers), one-hot for
        hard style ids.  Returns 'pose' (B, T, out_feats), 'labels_score' and
        'labels_cap_soft' (B, T, M)."""
        x, labels_score, labels_cap_soft = self.backbone(
            x_list, y, style_weights, input_modalities, use_pose_input,
            time_steps)
        # replicate the fused content M times: one grouped conv per layer
        xr = x.repeat(1, 1, self.num_clusters)
        for layer in self.decoder_layers():
            xr = layer(xr)
        pose = index_select_outputs(self.logits(xr), labels_cap_soft,
                                    self.num_clusters)
        return {"pose": pose, "labels_score": labels_score,
                "labels_cap_soft": labels_cap_soft}
