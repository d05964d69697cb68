"""Model registry (counterpart of ``mixstage_tpu/models/registry.py``).

Every model of the JAX package's registry: the Mix-StAGE generator, the
Speech2Gesture baseline, the style classifier and the discriminator.  Each
class takes the compute ``dtype`` and the dropout probability ``p`` as
keywords, as the JAX package's modules take them.  ``register_model`` adds
an extension model (a Disentangle generator) by name.
"""

from __future__ import annotations

from typing import Dict, Type

from torch import nn

from mixstage_tpu_torch.models.mix_stage import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.models.speech2gesture import (Speech2Gesture_D,
                                                      Speech2Gesture_G)
from mixstage_tpu_torch.models.style_classifier import StyleClassifier_G

MODEL_REGISTRY: Dict[str, Type[nn.Module]] = {
    "Speech2Gesture_G": Speech2Gesture_G,
    "Speech2Gesture_D": Speech2Gesture_D,
    "JointLateClusterSoftStyle4_G": JointLateClusterSoftStyle4_G,
    # the reference aliases the discriminator (mix_stage.py:203-206)
    "JointLateClusterSoftStyle4_D": Speech2Gesture_D,
    "StyleClassifier_G": StyleClassifier_G,
}


def register_model(name: str, cls: Type[nn.Module]) -> None:
    """Register an extension model under ``name`` (``registry.py:46-58``:
    the reference selects any importable class with ``eval(args.model)``;
    this is the explicit equivalent)."""
    MODEL_REGISTRY[name] = cls


def get_model_def(name: str) -> Type[nn.Module]:
    if name not in MODEL_REGISTRY:
        if "Disentangle" in name:
            raise NotImplementedError(
                f"model {name!r}: the reference ships no Disentangle "
                f"generator (its trainer composition names one that "
                f"eval(args.model) cannot find); register_model() one that "
                f"emits the Disentangle internal losses.  The port's "
                f"trainer plumbing for those losses comes later (ROADMAP "
                f"queue 1 item 4)")
        raise KeyError(f"model {name!r} not in the port's registry; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def infer_discriminator_name(model_name: str) -> str:
    """'<prefix>_G' → '<prefix>_D' (``registry.py:83-85``)."""
    return "_".join(model_name.split("_")[:-1] + ["D"])
