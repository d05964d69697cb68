from mixstage_tpu_torch.serving.client import PoseClient, PoseStream
from mixstage_tpu_torch.serving.server import (DynamicBatcher, Overloaded,
                                               PoseService, start_http_server)

__all__ = ["DynamicBatcher", "Overloaded", "PoseClient", "PoseService",
           "PoseStream", "start_http_server"]
