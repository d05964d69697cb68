from mixstage_tpu_torch.models.mix_stage import JointLateClusterSoftStyle4_G
from mixstage_tpu_torch.models.registry import get_model_def

__all__ = ["JointLateClusterSoftStyle4_G", "get_model_def"]
