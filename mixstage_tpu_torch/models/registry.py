"""Model registry (counterpart of ``mixstage_tpu/models/registry.py``).

Every model of the JAX package's registry: the Mix-StAGE generator, the
Speech2Gesture baseline, the style classifier and the discriminator.  Each
class takes the compute ``dtype`` and the dropout probability ``p`` as
keywords, as the JAX package's modules take them.  ``register_model`` adds
an extension model (a Disentangle generator) by name.

A Disentangle generator (a name holding ``Disentangle``) follows the
Mix-StAGE generator's signature, takes the ``-style_losses`` weights as its
``style_losses`` keyword (the steps forward them) and returns
``internal_losses``: scalar losses named after ``DISENTANGLE_INTERNAL_LOSSES``,
which join the G total and, detached, the D total.  The reference ships no
such generator, so an unregistered one raises.
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

# The Disentangle trainer's loss vocabulary (``registry.py:61-69``): the
# display order of the running-loss slots, G branch, D branch, then the
# generator's internal losses.
DISENTANGLE_LOSS_KINDS = ["pose", "G_gan", "real_D", "fake_D", "con_+",
                          "con_-", "id_a", "id_p", "c_a", "c_p", "st_a",
                          "st_p", "rec_a", "rec_p", "H"]

# The internal losses a Disentangle generator emits, in slot order: the
# ``-style_losses`` keys plus the unweighted entropy ``H``
# (``registry.py:71-79``).
DISENTANGLE_INTERNAL_LOSSES = ["content_+", "content_-", "id_a", "id_p",
                               "cluster_a", "cluster_p", "style_a", "style_p",
                               "rec_a", "rec_p", "H"]


def register_model(name: str, cls: Type[nn.Module]) -> None:
    """Register an extension model under ``name`` (``registry.py:46-58``:
    the reference selects any importable class with ``eval(args.model)``;
    this is the explicit equivalent)."""
    MODEL_REGISTRY[name] = cls


def get_model_def(name: str) -> Type[nn.Module]:
    if name not in MODEL_REGISTRY:
        if "Disentangle" in name:
            raise NotImplementedError(
                f"model {name!r}: the Disentangle trainer composition is "
                "upstream-incomplete — the reference defines "
                "TrainerLateClusterStyleDisentangleGAN with the extended "
                "loss list (reference trainer.py:1419-1474) but ships no "
                "Disentangle generator model (eval(args.model) would "
                "NameError upstream too).  The trainer-side plumbing is "
                "implemented: register_model() a generator emitting the "
                f"internal losses {DISENTANGLE_INTERNAL_LOSSES} to use it.")
        raise KeyError(f"model {name!r} not in the port's registry; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def infer_discriminator_name(model_name: str) -> str:
    """'<prefix>_G' → '<prefix>_D' (``registry.py:83-85``)."""
    return "_".join(model_name.split("_")[:-1] + ["D"])
