from mixstage_tpu_torch.models.mix_stage import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.models.registry import (get_model_def,
                                                infer_discriminator_name,
                                                register_model)
from mixstage_tpu_torch.models.speech2gesture import (Speech2Gesture_D,
                                                      Speech2Gesture_G)
from mixstage_tpu_torch.models.style_classifier import StyleClassifier_G

__all__ = ["JointLateClusterSoftStyle4_G", "Speech2Gesture_D",
           "Speech2Gesture_G", "StyleClassifier_G", "get_model_def",
           "infer_discriminator_name", "register_model"]
