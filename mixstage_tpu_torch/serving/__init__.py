from mixstage_tpu_torch.serving.client import PoseClient
from mixstage_tpu_torch.serving.server import (DynamicBatcher, Overloaded,
                                               PoseService, start_http_server)

__all__ = ["DynamicBatcher", "Overloaded", "PoseClient", "PoseService",
           "start_http_server"]
