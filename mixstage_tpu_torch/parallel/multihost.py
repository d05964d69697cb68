"""Multi-process set-up: the port's counterpart of
``mixstage_tpu/parallel/multihost.py``.

JAX runs one controller a host and ``jax.distributed.initialize`` wires
the runtime; here every rank is a process of its own in one
``torch.distributed`` process group.  ``torchrun --nproc_per_node N``
starts the processes and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; ``setup`` reads
them, or takes the same facts as arguments (``init_method`` a
``tcp://host:port`` or ``file://path`` rendezvous).

The backend follows the layout, chosen up front and logged: NCCL when
every rank has a card of its own, gloo on the CPU and when ranks share a
card (NCCL refuses two ranks on one device).  A failed NCCL set-up raises;
it is never retried on gloo.

    from mixstage_tpu_torch.parallel import multihost
    multihost.setup()                    # no-op in a single process
    intervals = multihost.shard_for_process(all_intervals)
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")

# every collective of a rank waits at most this long for its peers
TIMEOUT_S = 600


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``; the
    global rank without torchrun)."""
    return _env_int("LOCAL_RANK", process_index())


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)``, so ranks
    beyond the card count share cards; the CPU for ``"cpu"``."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", local_rank() % max(torch.cuda.device_count(),
                                                   1))


def choose_backend(device_type: str, ranks_on_host: int) -> str:
    """NCCL when every one of the host's ``ranks_on_host`` ranks has a card
    of its own, else gloo (the CPU, or ranks sharing a card)."""
    if device_type == "cuda" and dist.is_nccl_available() and \
            ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def setup(init_method: Optional[str] = None,
          world_size: Optional[int] = None, rank: Optional[int] = None,
          device_type: Optional[str] = None,
          timeout_s: float = TIMEOUT_S) -> int:
    """Join the process group of ``world_size`` ranks as ``rank`` (default:
    torchrun's environment; ``init_method`` default ``env://``).  A world
    of one, or a group already joined, is left as it is.  Returns the world
    size.  ``device_type`` ("cuda" or "cpu", default: "cuda" when a card is
    present) picks the backend through ``choose_backend``."""
    if dist.is_initialized():
        return dist.get_world_size()
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else int(world_size)
    if world_size <= 1:
        return 1
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    on_host = _env_int("LOCAL_WORLD_SIZE", world_size)
    backend = choose_backend(device_type, on_host)
    print(f"multihost: rank {rank} of {world_size} on backend {backend} "
          f"({on_host} ranks on this host, "
          f"{torch.cuda.device_count() if device_type == 'cuda' else 0} "
          f"cards)", flush=True)
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return world_size


def teardown() -> None:
    """Leave the process group (after a barrier), if one was joined."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_for_process(items: Sequence[T]) -> List[T]:
    """Round-robin shard of a host-side work list (e.g. interval ids) for
    this process: each process loads only its slice of the data."""
    return list(items)[process_index()::process_count()]
