"""The metric suite (counterpart of ``mixstage_tpu/evaluation``)."""

from mixstage_tpu_torch.evaluation.metrics import (FID, PCK, W1,  # noqa: F401
                                                   AverageMeter, Diversity,
                                                   Expressiveness, F1,
                                                   InceptionScoreStyle, L1,
                                                   Stack, VelL1)
