"""One CUDA graph capture, shared by the train steps' graphs
(``train/graphs.py``) and the serving function's (``serve.py``).

``CapturedGraph`` captures ``fn()``'s device work once and replays it.
The port's kernels count their launches (``.launches``,
``.launches_bf16``); a capture launches nothing that runs, so it puts the
counters back as they were, and each replay adds what the capture
launched, as an op-by-op call would.

One capture runs at a time in the process (``CAPTURE_LOCK``): two
serving functions' workers (the pose and the waveform batcher) may reach
their captures together.  While a capture is under way PyTorch holds the
card's default random generator for it, so a draw from that generator on
the card by any other thread raises; nothing the serving path runs draws
at random.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

CAPTURE_LOCK = threading.Lock()


def launch_counts() -> Dict[Tuple, int]:
    """The launch counters of the port's kernels: K1, K2, K3 and K4."""
    from mixstage_tpu_torch.ops.cuda import fused_conv, quant
    from mixstage_tpu_torch.ops.cuda import train_decoder as td
    return {(fn, c): getattr(fn, c)
            for fn in (fused_conv.fused_mixstage_decoder,
                       fused_conv.fused_grouped_conv_chain,
                       quant.fused_mixstage_decoder_int8,
                       td.decoder_train_fwd, td.decoder_train_bwd)
            for c in ("launches", "launches_bf16")}


class CapturedGraph:
    """``fn()``'s device work captured as one CUDA graph: ``replay()``
    runs it again and returns the tensors ``fn`` returned, rewritten.
    ``capture`` goes to ``torch.cuda.graph`` (``pool``,
    ``capture_error_mode``)."""

    def __init__(self, fn, **capture):
        with CAPTURE_LOCK:
            before = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, **capture):
                self.outputs = fn()
            after = launch_counts()
        self.launches = {k: after[k] - n for k, n in before.items()
                         if after[k] != n}
        for (fn_, c), n in before.items():      # a capture runs nothing
            setattr(fn_, c, n)

    def replay(self):
        self.graph.replay()
        for (fn, c), n in self.launches.items():
            setattr(fn, c, getattr(fn, c) + n)
        return self.outputs
