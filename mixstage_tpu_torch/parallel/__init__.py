"""Parallel helpers (counterpart of ``mixstage_tpu/parallel``): the
host-side thread map (``parallel.py``), the device layouts (``mesh.py``:
data parallelism, data × expert) and the multi-process set-up
(``multihost.py``)."""

from mixstage_tpu_torch.parallel.parallel import parallel  # noqa: F401
