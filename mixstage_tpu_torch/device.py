"""Device resolution and the float32 precision policy of the port.

Entry points run on the card unless the caller names another device: a
missing CUDA device is an error, never a quiet fall-back to the CPU.

Precision (the one place it is set): the f32 serving path must hold the
repo's 1% BN-fold drift contract, so cuDNN convolutions run in full float32
(``cudnn.allow_tf32 = False``; TF32 keeps ~3 decimal digits) and matmuls keep
``"highest"`` precision.  The bfloat16 compute dtype takes flax's products:
bf16 operands, float32 accumulation, so cuBLAS may not reduce bf16 GEMMs in
reduced precision (``allow_bf16_reduced_precision_reduction = False``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def set_f32_precision() -> None:
    """Full-float32 convolutions and matmuls on the card (no TF32), and
    bf16 matmuls that accumulate in float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → the CUDA card; raises when the named device is a CUDA
    device and none is present.  Applies ``set_f32_precision`` for CUDA."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' explicitly to run on the CPU")
        set_f32_precision()
    return device
