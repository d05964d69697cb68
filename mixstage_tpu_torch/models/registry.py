"""Model registry (counterpart of ``mixstage_tpu/models/registry.py``).

Holds the generator and the discriminator the port has so far; the style
classifier and the simple baselines come with later slices.
"""

from __future__ import annotations

from typing import Dict, Type

from torch import nn

from mixstage_tpu_torch.models.mix_stage import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.models.speech2gesture import Speech2Gesture_D

MODEL_REGISTRY: Dict[str, Type[nn.Module]] = {
    "JointLateClusterSoftStyle4_G": JointLateClusterSoftStyle4_G,
    "Speech2Gesture_D": Speech2Gesture_D,
    # the reference aliases the discriminator (mix_stage.py:203-206)
    "JointLateClusterSoftStyle4_D": Speech2Gesture_D,
}


def get_model_def(name: str) -> Type[nn.Module]:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"model {name!r} not in the port's registry; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def infer_discriminator_name(model_name: str) -> str:
    """'<prefix>_G' → '<prefix>_D' (``registry.py:83-85``)."""
    return "_".join(model_name.split("_")[:-1] + ["D"])
