"""Model registry (counterpart of ``mixstage_tpu/models/registry.py``).

Holds the generators the port has so far; the discriminators and the style
classifier come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Type

from torch import nn

from mixstage_tpu_torch.models.mix_stage import JointLateClusterSoftStyle4_G

MODEL_REGISTRY: Dict[str, Type[nn.Module]] = {
    "JointLateClusterSoftStyle4_G": JointLateClusterSoftStyle4_G,
}


def get_model_def(name: str) -> Type[nn.Module]:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"model {name!r} not in the port's registry; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]
