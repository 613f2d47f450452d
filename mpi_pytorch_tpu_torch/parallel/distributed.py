"""The process world (``mpi_pytorch_tpu/parallel/distributed.py``): one
process per GPU, as ``torchrun`` starts them, joined by
``torch.distributed``.

The reference's world is ``mpiexec -n N``; the JAX package's is one
process per host calling ``jax.distributed.initialize()``. Here it is
``torchrun --nproc-per-node N -m mpi_pytorch_tpu_torch.train``: torchrun
sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` in each process, and :func:`maybe_initialize_distributed`
joins them into one process group — NCCL when the rank's device is a
card, gloo on the CPU (``MPT_PLATFORM=cpu``). A plain ``python -m ...``
sets none of them and stays one process, as before.

Nothing falls back: a rendezvous that fails raises, and a rank asking for
a card it does not have raises (``hardware.resolve_device``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from mpi_pytorch_tpu_torch.hardware import resolve_device

# Seconds the rendezvous (and any one collective) may take before it raises.
TIMEOUT_S = 600.0


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


def requested() -> bool:
    """Whether the environment asks for a process group: ``WORLD_SIZE`` > 1,
    or a launcher's rendezvous (``WORLD_SIZE`` with ``MASTER_ADDR`` and
    ``MASTER_PORT``, as torchrun sets them even for one process)."""
    if "WORLD_SIZE" not in os.environ:
        return False
    rendezvous = bool(os.environ.get("MASTER_ADDR")) and bool(os.environ.get("MASTER_PORT"))
    return _env_int("WORLD_SIZE", 1) > 1 or rendezvous


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the world (0 for one process)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """Processes in the world (1 for one process)."""
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``; 0 for one process)."""
    return _env_int("LOCAL_RANK", 0)


def backend() -> str | None:
    """The process group's backend (``"nccl"`` or ``"gloo"``), None
    without one."""
    return dist.get_backend() if is_initialized() else None


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """The device this rank runs on: ``device`` when given; else
    ``cuda:LOCAL_RANK`` under a launcher, the CPU under
    ``MPT_PLATFORM=cpu``, and ``cuda`` for one process. Goes through
    ``resolve_device``, the one gate: a card that is not there raises."""
    if device is None and requested() and os.environ.get("MPT_PLATFORM", "").lower() != "cpu":
        device = f"cuda:{local_rank()}"
    return resolve_device(device)


def maybe_initialize_distributed(device: torch.device, backend_name: str | None = None) -> bool:
    """Join the world the environment describes (see :func:`requested`).

    Returns True when a process group exists after the call (made now or
    before: idempotent), False for one process. The backend is
    ``backend_name`` when given, else NCCL for a CUDA ``device`` and gloo
    on the CPU; on a card the process's current device becomes
    ``device``. A failed rendezvous raises after :data:`TIMEOUT_S`."""
    if is_initialized():
        return True
    if not requested():
        return False
    world, rnk = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise RuntimeError(
            f"WORLD_SIZE={world} but MASTER_ADDR/MASTER_PORT are not set: launch with "
            "torchrun, or set the rendezvous address yourself"
        )
    if not 0 <= rnk < world:
        raise RuntimeError(f"RANK={rnk} outside WORLD_SIZE={world}")
    if backend_name is None:
        backend_name = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_name, init_method=f"tcp://{addr}:{port}", world_size=world, rank=rnk,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return True


def barrier() -> None:
    """Wait for every rank (nothing for one process)."""
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the world (nothing for one process)."""
    if is_initialized():
        dist.destroy_process_group()
