from mixstage_tpu_torch.models.mix_stage import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.models.registry import (get_model_def,
                                                infer_discriminator_name)
from mixstage_tpu_torch.models.speech2gesture import Speech2Gesture_D

__all__ = ["JointLateClusterSoftStyle4_G", "Speech2Gesture_D",
           "get_model_def", "infer_discriminator_name"]
