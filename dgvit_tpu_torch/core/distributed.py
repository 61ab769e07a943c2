"""Process-group initialisation: one process per rank.

Counterpart of `dgvit_tpu/core/distributed.py`. The JAX package drives
every device of a host from one process and joins hosts with
`jax.distributed.initialize`; the port runs one process per rank (as
`torchrun` starts them) and the `data` mesh axis is the process group
(`core/mesh.py`).

    torchrun --nproc_per_node N your_script.py   # NCCL, one rank a card

`initialize()` reads torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or the JAX package's
(COORDINATOR_ADDRESS 'host:port', NUM_PROCESSES, PROCESS_ID); with
neither it is a no-op (one process). The backend is NCCL when every rank
of the host has a card of its own, gloo without a card. Ranks that share
one card must name gloo: NCCL refuses two ranks on one device. A failed
initialisation raises; nothing switches backend or device after it.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

log = logging.getLogger("dgvit.distributed")


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        if os.environ.get(n) not in (None, ""):
            return int(os.environ[n])
    return None


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """LOCAL_RANK, else the rank."""
    lr = _env_int("LOCAL_RANK")
    return rank() if lr is None else lr


def rank_device(device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The rank's device: cuda:{LOCAL_RANK % device_count} unless the
    caller names another (the CPU for the tests). Without a card a CUDA
    device raises, as `core/device.resolve_device` does."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def default_backend(local_world: int) -> str:
    """NCCL when each of the host's `local_world` ranks has a card of its
    own, gloo on a host without a card; ranks that share a card raise:
    they must name gloo."""
    if not torch.cuda.is_available():
        return "gloo"
    if local_world > torch.cuda.device_count():
        raise ValueError(
            f"{local_world} ranks share {torch.cuda.device_count()} "
            "card(s): NCCL refuses two ranks on one device; pass "
            "backend='gloo'")
    return "nccl"


def initialize(backend: Optional[str] = None,
               coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 600.0) -> bool:
    """Join the process group from the launcher's variables; False (and
    nothing done) in a single process, True once joined (or already)."""
    if dist.is_initialized():
        return True
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if addr is None:
        return False
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE", "NUM_PROCESSES")
    rk = process_id if process_id is not None else _env_int(
        "RANK", "PROCESS_ID")
    if world is None or rk is None:
        raise ValueError(f"process group at {addr}: the world size and "
                         "the rank are needed (WORLD_SIZE/NUM_PROCESSES, "
                         "RANK/PROCESS_ID)")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    if backend is None:
        backend = default_backend(local_world)
    elif backend == "nccl":
        default_backend(local_world)     # raises for a shared card
    os.environ.setdefault("LOCAL_RANK", str(rk % local_world))
    device = (rank_device() if torch.cuda.is_available()
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=int(world), rank=int(rk),
                            timeout=timedelta(seconds=timeout_s))
    log.info("rank %d of %d joined over %s on %s", rk, world, backend,
             device)
    return True


def local_batch_slice(global_batch: int) -> slice:
    """This rank's rows of a global batch: rank-major, global_batch //
    world each (the data axis's layout, `core/mesh.py`)."""
    per = global_batch // world_size()
    start = rank() * per
    return slice(start, start + per)
