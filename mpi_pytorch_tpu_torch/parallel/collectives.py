"""Collectives over the process world (``mpi_pytorch_tpu/parallel/
collectives.py``): the subset the data-parallel trainer and the evaluate
CLI use.

The reference's ``mpi_tools.py`` stack (``mpi_avg_grads``,
``mpi_broadcast``, ``sync_params``, ``comm.allgather``) over
``torch.distributed``. Each function is the identity when its axis has
one rank, as the JAX ones are on one device, and every rank of the axis
must call it at the same point. ``avg_grads`` is one coalesced all-reduce
over every gradient: the port's counterpart of the JAX spmd step's single
``pmean`` (``mpi_pytorch_tpu/train/step.py`` ``per_shard``).

Beyond the reference's surface, the spmd step's levers
(``train/step.py``): ``reduce_scatter_mean`` and the slice all-gather, the
two halves of the ZeRO-sharded update, and the two-phase hierarchical
collectives of the nested (pod, ici) layout (``parallel/mesh.py``) —
``hier_reduce_scatter_mean``, ``hier_all_gather``, ``hier_psum``,
``hier_pmean`` — which reduce within the pod first, across the pods with
only the 1/ici-sized partial, and gather back within the pod. A function
that takes an ``axis`` (a ``mesh.Axis``) reduces over that axis's process
group; without one, over the world.

Every gradient and statistics collective books its per-rank bytes in the
per-axis :data:`LEDGER` as it is issued (ring cost model), ``dcn`` when
its axis is ``pod`` and ``ici`` otherwise, as the JAX ledger books them at
trace time: reset it, run one step, and its snapshot is that step's
traffic. Scalar sums (``all_reduce``, the metrics) book nothing, as the
JAX step's raw ``psum``s.

gloo takes the reduce-scatter and the all-gather on host tensors only: a
card's tensor goes through host memory there (:func:`host_staged`, chosen
by the group's backend); NCCL reduces in place on the card.

Each call is a ``torch.profiler`` range (``collectives.<name>``), so a
trace of a step shows where its collectives went.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.parallel.mesh import POD_AXIS, Axis


class TrafficLedger:
    """Byte and op counts per axis kind ("ici" / "dcn"), with the
    collective's name kept so a snapshot says where the bytes come from
    (JAX ``TrafficLedger``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[tuple[str, str], dict] = {}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def add(self, kind: str, op: str, nbytes: float) -> None:
        with self._lock:
            e = self._entries.setdefault((kind, op), {"bytes": 0.0, "ops": 0})
            e["bytes"] += float(nbytes)
            e["ops"] += 1

    def snapshot(self) -> dict:
        """``{"ici": {"bytes", "ops", "by_op": {op: bytes}}, "dcn": {...}}``
        — both kinds always present (a flat layout reads ``dcn.bytes ==
        0``)."""
        out = {k: {"bytes": 0, "ops": 0, "by_op": {}} for k in ("ici", "dcn")}
        with self._lock:
            for (kind, op), e in self._entries.items():
                bucket = out.setdefault(kind, {"bytes": 0, "ops": 0, "by_op": {}})
                bucket["bytes"] = int(bucket["bytes"] + e["bytes"])
                bucket["ops"] += e["ops"]
                bucket["by_op"][op] = int(bucket["by_op"].get(op, 0) + e["bytes"])
        return out


LEDGER = TrafficLedger()

# Per-rank egress of one collective over P ranks, as a multiple of its
# full payload n (the ring algorithm): an all-reduce moves 2n(P-1)/P, a
# reduce-scatter or an all-gather n(P-1)/P.
RING_FACTORS: dict[str, Callable[[int], float]] = {
    "all_reduce": lambda p: 2.0 * (p - 1) / p,
    "reduce_scatter": lambda p: (p - 1) / p,
    "all_gather": lambda p: (p - 1) / p,
}


def axis_kind(axis) -> str:
    """Which fabric a collective over ``axis`` (an ``Axis``, a name, or a
    tuple of them) rides: anything touching ``pod`` crosses pods (dcn),
    everything else stays within one (ici), a flat layout's data axis
    included."""
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    names = {a.name if isinstance(a, Axis) else a for a in axes}
    return "dcn" if POD_AXIS in names else "ici"


def _account(op: str, axis: Axis, payload_bytes: float) -> None:
    """Book one collective's per-rank egress: ``payload_bytes`` is the
    full logical vector's size n (nothing for an axis of one rank)."""
    if axis.size > 1:
        LEDGER.add(axis_kind(axis), op, payload_bytes * RING_FACTORS[op](axis.size))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def world_axis() -> Axis:
    """The whole world as one axis (a flat layout's ``data`` axis)."""
    return Axis("data", distributed.world_size(), distributed.rank())


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


def all_reduce(x: torch.Tensor, op: str = "sum", axis: Axis | None = None) -> torch.Tensor:
    """``x`` reduced over the ranks of ``axis`` (the world by default;
    ``op``: sum, mean, max or min), as a new tensor (≙
    ``mpi_all_reduce``/``mpi_sum``); ``mean`` is the sum divided by the
    axis size. A scalar sum: no ledger entry."""
    n = axis.size if axis is not None else num_processes()
    if n == 1:
        return x
    if op not in (*_OPS, "mean"):
        raise ValueError(f"op must be sum|mean|max|min, got {op!r}")
    with record_function("collectives.all_reduce"):
        out = x.clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS.get(op, "SUM")),
                        group=None if axis is None else axis.group)
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
    """Reduce each of ``tensors`` over the world's ranks in place, through
    ONE all-reduce of their concatenation per dtype (``sum`` or ``mean``),
    booked in the ledger on the data axis; the profiler range is
    ``name``."""
    if num_processes() == 1 or not tensors:
        return
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be sum|mean, got {op!r}")
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    axis = world_axis()
    with record_function(name):
        for group in by_dtype.values():
            flat = _flat(group)
            _account("all_reduce", axis, _nbytes(flat))
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


# ---------------------------------------------------------------------------
# The spmd levers' collectives: one collective in flight (``Pending``), the
# flatten-pad slice layout of ``train/state.zero_shard_spec``, and the
# phases of each sync as a generator (``Chain``) that the step's bucket
# hooks advance while the backward runs.
# ---------------------------------------------------------------------------

# The single-tensor forms (``all_gather_into_tensor`` and
# ``reduce_scatter_tensor`` under their newer names where torch has them).
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def host_staged(t: torch.Tensor, axis: Axis) -> bool:
    """Whether a reduce-scatter or all-gather of ``t`` over ``axis`` goes
    through host memory: a card's tensor under gloo, whose reduce-scatter
    and all-gather take host tensors. All-reduces never are."""
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


class Pending:
    """One collective in flight (``async_op``): :meth:`wait` returns its
    result. ``done_at`` is the ``time.perf_counter()`` at which it was
    first seen complete — by :meth:`poll` or at the end of :meth:`wait`
    (gloo's works have no future to call back)."""

    def __init__(self, work, result: torch.Tensor, device: torch.device | None = None):
        self._work, self._result, self._device = work, result, device
        self.done_at: float | None = time.perf_counter() if work is None else None

    def poll(self) -> None:
        if self.done_at is None and self._work.is_completed():
            self.done_at = time.perf_counter()

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            if self.done_at is None:
                self.done_at = time.perf_counter()
        if self._device is not None:  # host-staged: back onto the card
            return self._result.to(self._device)
        return self._result


def start_all_reduce(flat: torch.Tensor, axis: Axis) -> Pending:
    """Sum ``flat`` over ``axis`` in place, asynchronously."""
    if axis.size == 1:
        return Pending(None, flat)
    return Pending(dist.all_reduce(flat, group=axis.group, async_op=True), flat)


def start_reduce_scatter(stacked: torch.Tensor, axis: Axis) -> Pending:
    """``stacked`` [P, k] summed over ``axis``; this rank receives its row
    (index ``axis.index``), [k], asynchronously."""
    if axis.size == 1:
        return Pending(None, stacked.reshape(-1))
    device = stacked.device if host_staged(stacked, axis) else None
    src = stacked.reshape(-1) if device is None else stacked.reshape(-1).cpu()
    out = torch.empty(stacked.shape[1], dtype=stacked.dtype, device=src.device)
    return Pending(_reduce_scatter_into(out, src, group=axis.group, async_op=True), out, device)


def start_all_gather(sl: torch.Tensor, axis: Axis) -> Pending:
    """Every rank's [k] ``sl`` over ``axis`` → [P, k] in rank order,
    asynchronously."""
    if axis.size == 1:
        return Pending(None, sl.reshape(1, -1))
    device = sl.device if host_staged(sl, axis) else None
    src = sl if device is None else sl.cpu()
    out = torch.empty(axis.size * sl.numel(), dtype=sl.dtype, device=src.device)
    work = _all_gather_into(out, src.reshape(-1).contiguous(), group=axis.group, async_op=True)
    return Pending(work, out.view(axis.size, -1), device)


def zero_chunk(numel: int, n_shards: int) -> int:
    """Elements a shard owns of a flattened ``numel``-element tensor
    (``train/state.zero_shard_spec``: ⌈numel / P⌉)."""
    return -(-numel // n_shards)


def stack_slices(tensors: Sequence[torch.Tensor], n: int) -> tuple[torch.Tensor, list[int]]:
    """The flatten-pad layout of ``tensors`` over ``n`` shards: each
    flattened, zero-padded to ``chunk·n`` and viewed [n, chunk], then the
    leaves side by side — [n, Σ chunk]. Row k is shard k's owned slice of
    every leaf. Returns (stacked, chunks)."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one collective takes one dtype, got {sorted(map(str, dtypes))}")
    chunks = [zero_chunk(t.numel(), n) for t in tensors]
    rows = [torch.nn.functional.pad(t.reshape(-1), (0, c * n - t.numel())).view(n, c)
            for t, c in zip(tensors, chunks)]
    return torch.cat(rows, dim=1), chunks


def _unstack_full(full: torch.Tensor, chunks: list[int], like: Sequence[torch.Tensor]):
    """[n, Σ chunk] gathered rows → each leaf of ``like``'s shape, its
    padding stripped."""
    return [part.reshape(-1)[:t.numel()].view(t.shape)
            for part, t in zip(full.split(chunks, dim=1), like)]


def mean_chain(tensors: Sequence[torch.Tensor], axis: Axis):
    """Phases of the mean of ``tensors`` over ``axis``: one all-reduce of
    their concatenation, divided by the axis size (a bucket's ``pmean``).
    Returns the means in ``tensors``' shapes."""
    flat = _flat(tensors)
    _account("all_reduce", axis, _nbytes(flat))
    pending = start_all_reduce(flat, axis)
    yield pending
    mean = pending.wait() / axis.size
    return [part.view(t.shape) for part, t in zip(mean.split([t.numel() for t in tensors]),
                                                   tensors)]


def reduce_scatter_chain(tensors: Sequence[torch.Tensor], axis: Axis):
    """Phases of the mean of ``tensors`` over ``axis``, this rank keeping
    its owned slice of each (``stack_slices``): one reduce-scatter of the
    stacked layout, divided by the axis size. Returns the [chunk] slices."""
    stacked, chunks = stack_slices(tensors, axis.size)
    _account("reduce_scatter", axis, _nbytes(stacked))
    pending = start_reduce_scatter(stacked, axis)
    yield pending
    return list((pending.wait() / axis.size).split(chunks))


def hier_reduce_scatter_chain(tensors: Sequence[torch.Tensor], ici: Axis, pod: Axis,
                              mean: bool = True):
    """Phases 1 and 2 of the hierarchical sync: a reduce-scatter of the
    stacked layout over ``ici`` (every pod's rank i receives slice i of its
    pod's sum), then an all-reduce of that slice over ``pod`` — the only
    bytes that leave a pod, 1/ici of the payload. Returns the [chunk]
    slices of the global sum (the mean with ``mean``), pod-replicated."""
    stacked, chunks = stack_slices(tensors, ici.size)
    _account("reduce_scatter", ici, _nbytes(stacked))
    pending = start_reduce_scatter(stacked, ici)
    yield pending
    sl = pending.wait()
    _account("all_reduce", pod, _nbytes(sl))
    pending = start_all_reduce(sl, pod)
    yield pending
    sl = pending.wait()
    if mean:
        sl = sl / (ici.size * pod.size)
    return list(sl.split(chunks))


def hier_psum_chain(tensors: Sequence[torch.Tensor], ici: Axis, pod: Axis, mean: bool = False):
    """The three phases of the hierarchical all-reduce: phases 1 and 2
    (:func:`hier_reduce_scatter_chain`), then an all-gather of the slices
    over ``ici`` (phase 3). Returns every leaf's global sum (or mean) in
    its shape."""
    slices = yield from hier_reduce_scatter_chain(tensors, ici, pod, mean)
    sl = torch.cat(slices)
    _account("all_gather", ici, _nbytes(sl) * ici.size)
    pending = start_all_gather(sl, ici)
    yield pending
    return _unstack_full(pending.wait(), [s.numel() for s in slices], tensors)


class Chain:
    """A sync of one or more collective phases, driven from outside: the
    generator (one of the ``*_chain`` functions) issues a phase and yields
    its ``Pending``; :meth:`advance` waits for the phase in flight and
    issues the next; :meth:`finish` runs it to its result. Creating it
    issues the first phase. ``issued_at`` and :attr:`done_at` time it
    (``time.perf_counter()``; done when its last phase was first seen
    complete, see :meth:`poll`)."""

    def __init__(self, gen, phases: int):
        self.phases = phases
        self.issued = 0
        self.issued_at = time.perf_counter()
        self._gen, self._pending = gen, None
        self._done, self._result = False, None
        self.advance()

    def advance(self) -> None:
        try:
            self._pending = next(self._gen)
            self.issued += 1
        except StopIteration as stop:
            self._done, self._result = True, stop.value

    def finish(self):
        while not self._done:
            self.advance()
        return self._result

    def poll(self) -> None:
        """Stamp the phase in flight's ``done_at`` if it has completed."""
        if self._pending is not None:
            self._pending.poll()

    @property
    def done_at(self) -> float | None:
        """When its last collective completed."""
        return None if self._pending is None else self._pending.done_at


def run_chain(gen):
    """A ``*_chain`` generator run to its result."""
    return Chain(gen, phases=0).finish()


def reduce_scatter_mean(x: torch.Tensor, axis: Axis | None = None) -> torch.Tensor:
    """The cross-rank MEAN of ``x`` over ``axis`` (the world by default),
    this rank receiving block ``axis.index`` of it along the leading
    dimension, which the axis size must divide (JAX ``psum_scatter / P``:
    slice k of what ``pmean`` would give every rank, at 1/P of its egress
    bytes)."""
    axis = axis or world_axis()
    n = axis.size
    if x.shape[0] % n:
        raise ValueError(f"leading dimension {x.shape[0]} not divisible by the {n} ranks")
    if n == 1:
        return x
    _account("reduce_scatter", axis, _nbytes(x))
    with record_function("collectives.reduce_scatter_mean"):
        out = start_reduce_scatter(x.reshape(n, -1), axis).wait() / n
    return out.view(x.shape[0] // n, *x.shape[1:])


def all_gather_slices(slices: Sequence[torch.Tensor], axis: Axis) -> list[torch.Tensor]:
    """Every rank's [chunk] slice of each leaf over ``axis`` → each leaf's
    [P·chunk] flattened, padded whole (one all-gather of the
    concatenation): the reassembly half of the ZeRO update. Strip the
    padding with ``[:numel]``."""
    sl = torch.cat([s.reshape(-1) for s in slices])
    _account("all_gather", axis, _nbytes(sl) * axis.size)
    with record_function("collectives.all_gather_slices"):
        full = start_all_gather(sl, axis).wait()
    return [part.reshape(-1) for part in full.split([s.numel() for s in slices], dim=1)]


def hier_reduce_scatter_mean(tensors: Sequence[torch.Tensor], ici: Axis,
                             pod: Axis) -> list[torch.Tensor]:
    """Rank (p, i) receives slice ``i`` of the GLOBAL mean of each of
    ``tensors``, pod-replicated, in the ``zero_shard_spec`` layout: ici
    carries the full payload once, the pods only 1/ici of it. The
    hierarchical ZeRO gradient path."""
    with record_function("collectives.hier_reduce_scatter_mean"):
        return run_chain(hier_reduce_scatter_chain(tensors, ici, pod, mean=True))


def hier_all_gather(slices: Sequence[torch.Tensor], ici: Axis) -> list[torch.Tensor]:
    """:func:`all_gather_slices` over the ``ici`` axis only (phase 3): the
    ZeRO shard index is the ici position, so every pod holds every slice
    and reassembling the parameters moves no byte across pods."""
    with record_function("collectives.hier_all_gather"):
        return all_gather_slices(slices, ici)


def hier_psum(tensors: Sequence[torch.Tensor], ici: Axis, pod: Axis,
              mean: bool = False) -> list[torch.Tensor]:
    """Each of ``tensors`` summed (or averaged) over every rank of the
    nested layout, full shape on every rank, in three phases
    (:func:`hier_psum_chain`) — what one all-reduce over the world
    computes, with 1/ici of the bytes crossing pods."""
    with record_function("collectives.hier_psum"):
        return run_chain(hier_psum_chain(tensors, ici, pod, mean))


def hier_pmean(tensors: Sequence[torch.Tensor], ici: Axis, pod: Axis) -> list[torch.Tensor]:
    """:func:`hier_psum` with the global mean: the hierarchical twin of
    ``avg_grads``."""
    return hier_psum(tensors, ici, pod, mean=True)
