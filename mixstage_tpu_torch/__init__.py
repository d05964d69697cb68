"""PyTorch/CUDA port of mixstage_tpu for NVIDIA Hopper (H100).

The JAX package ``mixstage_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find, and imports nothing of it
(nor JAX).  Public functions keep the JAX layout, channels-last ``(B, T, C)``.

Ported so far: the BN-folded serving path of ``JointLateClusterSoftStyle4_G``
(``serve.build_serving_fn``) with the fused mixture decoder as a hand-written
CUDA kernel (``ops/cuda``), the flax weight bridge (``interop/weights.py``),
the HTTP micro-batcher (``serving/``), and the GAN train steps against
``Speech2Gesture_D`` (``train/``) with the training decoder's forward and
backward as hand-written CUDA kernels.
"""

from mixstage_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
