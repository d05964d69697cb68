"""GAN training of the Mix-StAGE generator (counterpart of
``mixstage_tpu/train``): losses, the train state and optimizer, the steps."""

from mixstage_tpu_torch.train.state import TrainState
from mixstage_tpu_torch.train.steps import StepConfig, StepFactory

__all__ = ["StepConfig", "StepFactory", "TrainState"]
