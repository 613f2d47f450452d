"""Collectives over the process world (``mpi_pytorch_tpu/parallel/
collectives.py``): the subset the data-parallel trainer and the evaluate
CLI use.

The reference's ``mpi_tools.py`` stack (``mpi_avg_grads``,
``mpi_broadcast``, ``sync_params``, ``comm.allgather``) over
``torch.distributed``. Each function is the identity when the world has
one process, as the JAX ones are on one device, and every rank must call
it at the same point. ``avg_grads`` is one coalesced all-reduce over
every gradient: the port's counterpart of the JAX spmd step's single
``pmean`` (``mpi_pytorch_tpu/train/step.py`` ``per_shard``).

Each call is a ``torch.profiler`` range (``collectives.<name>``), so a
trace of a step shows where its collectives went.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from mpi_pytorch_tpu_torch.parallel import distributed

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def num_processes() -> int:
    """World size — the ranks (≙ MPI ranks)."""
    return distributed.world_size()


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the ranks (``op``: sum, mean, max or min), as a
    new tensor (≙ ``mpi_all_reduce``/``mpi_sum``); ``mean`` is the sum
    divided by the world size."""
    n = num_processes()
    if n == 1:
        return x
    if op not in (*_OPS, "mean"):
        raise ValueError(f"op must be sum|mean|max|min, got {op!r}")
    with record_function("collectives.all_reduce"):
        out = x.clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS.get(op, "SUM")))
    return out / n if op == "mean" else out


class _SumOverRanks(torch.autograd.Function):
    """The all-reduce (SUM) with autograd: its backward sums every rank's
    gradient of the result, since each rank's result feeds its own share
    of a loss that is the sum over ranks."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        with record_function("collectives.sum_over_ranks_backward"):
            grad = grad.contiguous().clone()
            dist.all_reduce(grad)
        return grad


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks with autograd attached (the semantics of
    ``torch.distributed.nn.functional.all_reduce``): the gradient reaching
    ``x`` is the sum of every rank's gradient of the result. The identity
    for one process."""
    if num_processes() == 1:
        return x
    with record_function("collectives.sum_over_ranks"):
        return _SumOverRanks.apply(x)


def all_reduce_(
    tensors: Sequence[torch.Tensor], op: str = "sum", name: str = "collectives.all_reduce"
) -> None:
    """Reduce each of ``tensors`` over the ranks in place, through ONE
    all-reduce of their concatenation per dtype (``sum`` or ``mean``); the
    profiler range is ``name``."""
    if num_processes() == 1 or not tensors:
        return
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be sum|mean, got {op!r}")
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with record_function(name):
        for group in by_dtype.values():
            flat = _flat(group)
            dist.all_reduce(flat)
            if op == "mean":
                flat /= num_processes()
            _unflat_into(flat, group)


def _grads(params: Iterable[torch.Tensor]) -> list[torch.Tensor]:
    return [p.grad for p in params if p.grad is not None]


def sum_grads(model: nn.Module) -> None:
    """Every gradient of ``model`` summed over the ranks, in place (one
    all-reduce): the gradient of a global loss that each rank holds its
    share of (the auto-mode step)."""
    all_reduce_(_grads(model.parameters()), "sum", "collectives.sum_grads")


def avg_grads(model: nn.Module) -> None:
    """Every gradient of ``model`` averaged over the ranks, in place — the
    whole ``mpi_avg_grads`` stack (``mpi_tools.py:30-37``) as one coalesced
    all-reduce, divided by the world size however many valid rows each
    rank held (the spmd-mode step)."""
    all_reduce_(_grads(model.parameters()), "mean", "collectives.avg_grads")


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``[n, ...]`` on each rank → the concatenated ``[P·n, ...]`` on every
    rank, rank order (≙ MPI Allgather on device data). Every rank's ``x``
    has the same shape."""
    n = num_processes()
    if n == 1:
        return x
    with record_function("collectives.all_gather"):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def broadcast_from(tensors: Sequence[torch.Tensor], root: int = 0) -> None:
    """Root's values into ``tensors`` on every rank, in place (≙
    ``mpi_broadcast``, ``mpi_tools.py:40-44``)."""
    if num_processes() == 1:
        return
    with record_function("collectives.broadcast"):
        for t in tensors:
            dist.broadcast(t.data, src=root)


@torch.no_grad()
def sync_params(model: nn.Module, root: int = 0) -> None:
    """Make every rank hold root's parameters and buffers (≙
    ``sync_params``, ``mpi_tools.py:47-53``): the start of training and
    after a resume, as the JAX trainer places its state on the mesh."""
    broadcast_from([*model.parameters(), *model.buffers()], root)


def host_allgather(values) -> np.ndarray:
    """A small per-rank f32 vector ``[k]`` → ``[P, k]`` on every rank, row
    ``p`` rank ``p``'s (≙ ``comm.allgather``); one process gives it a
    leading axis."""
    vals = np.atleast_1d(np.asarray(values, np.float32))
    n = num_processes()
    if n == 1:
        return vals[None]
    dev = torch.device("cuda", torch.cuda.current_device()) if distributed.backend() == "nccl" \
        else torch.device("cpu")
    with record_function("collectives.host_allgather"):
        parts = [torch.empty(vals.shape, dtype=torch.float32, device=dev) for _ in range(n)]
        dist.all_gather(parts, torch.from_numpy(vals).to(dev))
    return np.stack([p.cpu().numpy() for p in parts])
