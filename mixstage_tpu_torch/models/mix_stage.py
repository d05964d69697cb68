"""Mix-StAGE generator: content + style → soft mixture of M decoders.

Counterpart of ``mixstage_tpu/models/mix_stage.py:43-200``: audio and/or
text content encoding → UNet → style-embedding concat → cluster
classifier soft attention → grouped-conv mixture decoder → soft output
selection.  Submodule names follow the flax tree, including the
``pose_encoder`` and ``concat_encoder`` that flax builds even in audio-only
configs, so the weight bridge round-trips the whole tree.  The mode is
``module.train()`` / ``.eval()`` (BatchNorm on batch or running statistics).
``dtype`` is the compute dtype (float32 or bfloat16, flax's semantics, see
``layers.py``; float64 on a module moved to float64): parameters and BatchNorm statistics stay float32, the
features, the cluster scores and softmax, and the pose are in ``dtype``, as
in the JAX package's ``dtype=bfloat16`` model.

Content streams (``mix_stage.py:105-137``): each input modality goes
through its encoder (``audio/*`` the 2-D ``AudioEncoder``, ``text/*`` the
``TextEncoder1D`` on ``text_channels`` features: 300 for ``text/w2v``, 768
for ``text/bert``), in the order given; two or more streams are
concatenated on the channels and fused by ``concat_encoder`` (512 → 256),
so they must have equal lengths (``repeat_text=0`` text does not).  Flax
creates an encoder's parameters only when its init sees one of its
streams, so the port builds ``audio_encoder`` and ``text_encoder`` for the
``input_modalities`` it is given (one audio stream by default): the
audio-only tree, and every audio-only checkpoint, stay as they were.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from mixstage_tpu_torch.models.layers import (AudioEncoder, ClusterClassify,
                                              ConvNormRelu, EmbLin,
                                              GroupedPointwiseConv,
                                              PoseEncoder, TextEncoder1D,
                                              UNet1D, softmax)
from mixstage_tpu_torch.ops.mixture import index_select_outputs

# width of the AudioEncoder / PoseEncoder output (layers.py:260-345)
CONTENT_FEATS = 256


class JointLateClusterSoftStyle4_G(nn.Module):
    """Mix-StAGE generator."""

    def __init__(self, in_channels: int = 256, out_feats: int = 96,
                 num_clusters: int = 8, num_speakers: int = 2,
                 style_dim: int = 10, decoder_lowering: str = "conv",
                 audio_lowerings: Optional[Tuple[str, ...]] = None,
                 input_modalities: Sequence[str] = ("audio/log_mel_512",),
                 text_channels: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, p: float = 0.0):
        super().__init__()
        self.num_clusters = num_clusters
        self.num_speakers = num_speakers
        self.dtype = dtype
        M = num_clusters
        common = dict(dtype=dtype, p=p)      # every ConvNormRelu drops p
        kinds = {m.split("/")[0] for m in input_modalities}
        if "audio" in kinds:
            self.audio_encoder = AudioEncoder(lowerings=audio_lowerings,
                                              **common)
        if "text" in kinds:
            self.text_encoder = TextEncoder1D(
                input_channels=text_channels or 300, **common)
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

    # (model group, first expert, experts) once the mixture decoder's
    # experts are split over ranks (parallel/mesh.py::shard_state_mixture)
    expert_parallel = None

    def decoder_layers(self):
        return [getattr(self, f"decoder{i}") for i in range(4)]

    @property
    def decoder_groups(self) -> int:
        """The experts this module's decoder holds: all of them, or this
        rank's share under expert parallelism."""
        ep = self.expert_parallel
        return self.num_clusters if ep is None else ep[2]

    def mixture(self, x, labels_cap_soft, decode):
        """``index_select_outputs`` of ``decode(x)`` (the grouped logits of
        the decoder's experts) under the soft attention.  Under expert
        parallelism each rank decodes its experts, weighs them with its
        slice of the attention and the partial sums are all-reduced over
        the model group; x and the attention enter through copies whose
        backward sums their gradients over it."""
        ep = self.expert_parallel
        if ep is None:
            return index_select_outputs(decode(x), labels_cap_soft,
                                        self.num_clusters)
        from mixstage_tpu_torch.parallel.mesh import (copy_to_group,
                                                      reduce_from_group)

        group, start, gl = ep
        x = copy_to_group(x, group)
        soft = copy_to_group(labels_cap_soft, group)[..., start:start + gl]
        return reduce_from_group(index_select_outputs(decode(x), soft, gl),
                                 group)

    def decode(self, x):
        """The grouped logits (B, T, groups·F) of the decoder's experts
        on the shared features x."""
        xr = x.repeat(1, 1, self.decoder_groups)
        for layer in self.decoder_layers():
            xr = layer(xr)
        return self.logits(xr)

    def encode_content(self, x_list: Sequence[torch.Tensor], y,
                       input_modalities: Sequence[str],
                       use_pose_input: bool, time_steps: Optional[int]):
        """Curriculum content encoding (``mix_stage.py:105-137``): the
        pose, or each input stream through its encoder, several fused by
        ``concat_encoder``."""
        if use_pose_input:
            return self.pose_encoder(y)
        encoded = []
        for x, modality in zip(x_list, input_modalities):
            kind = modality.split("/")[0]
            if kind in ("audio", "text") and \
                    not hasattr(self, f"{kind}_encoder"):
                raise ValueError(f"{modality}: the generator was built "
                                 f"without a {kind} stream")
            if kind == "text":
                if x.ndim != 3:
                    # flax's conv stack reads a (B, T) stream as one
                    # unbatched sequence and the fusion fails
                    raise TypeError(f"{modality} of shape {tuple(x.shape)}: "
                                    f"the text encoder takes (B, T, C)")
                encoded.append(self.text_encoder(x))
            elif kind == "audio":
                encoded.append(self.audio_encoder(x, time_steps=time_steps))
            else:
                raise ValueError(f"unknown input modality {modality!r}")
        if len(encoded) == 1:
            return encoded[0]
        lengths = [e.shape[1] for e in encoded]
        if len(set(lengths)) > 1:
            # jnp.concatenate's error (repeat_text=0 gives ragged text)
            raise TypeError(f"cannot concatenate the content streams "
                            f"{list(input_modalities)} of lengths {lengths}")
        return self.concat_encoder(torch.cat(encoded, dim=-1))

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
        pose = self.mixture(x, labels_cap_soft, self.decode)
        return {"pose": pose, "labels_score": labels_score,
                "labels_cap_soft": labels_cap_soft}
