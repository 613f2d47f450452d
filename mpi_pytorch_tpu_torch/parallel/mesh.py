"""The data-parallel rank layout (``mpi_pytorch_tpu/parallel/mesh.py``): the
flat data axis over the world, or with ``mesh.pods > 1`` (``--mesh-pods``)
the nested (pod, ici) pair that the spmd step's hierarchical gradient
sync reduces over.

The JAX mesh is an array of devices with named axes; a collective names
the axis it reduces over. Here an axis is a ``torch.distributed`` process
group: the ranks along it, this rank's position on it and its size
(:class:`Axis`). The nested layout is pod-major, as the JAX package's
``np.asarray(devices).reshape(pods, ici, 1)``: rank ``p·ici + i`` is pod
``p``, ici position ``i``. Each pod's ranks form one ``ici`` group (the
fast, within-pod fabric), and the ranks holding one ici position across
the pods form one ``pod`` group (the cross-pod fabric, JAX's DCN).

:func:`create_mesh` makes every group of the layout with every rank
calling ``torch.distributed.new_group`` for every group in the same
order, as ``new_group`` requires (a rank that skipped one would hang the
world). A flat mesh makes no group: its axis is the whole world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch.distributed as dist

from mpi_pytorch_tpu_torch.config import MeshConfig
from mpi_pytorch_tpu_torch.parallel import distributed

# The nested axes' names are fixed, as in the JAX package: the traffic
# ledger books a collective over ``pod`` as cross-pod (DCN) bytes.
POD_AXIS, ICI_AXIS = "pod", "ici"


@dataclass(frozen=True)
class Axis:
    """One axis of the layout: its name, its size, this rank's position on
    it, and the process group of the ranks along it (None: the world)."""

    name: str
    size: int
    index: int
    group: Any = None


@dataclass(frozen=True)
class Mesh:
    """The data axes, major → minor: ``(data,)`` flat, ``(pod, ici)``
    nested."""

    axes: tuple[Axis, ...]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"mesh has no axis {name!r} (axes {self.axis_names})")


def create_mesh(cfg: MeshConfig | None = None) -> Mesh:
    """The layout of ``cfg`` over the current world (one rank for one
    process). Every rank must call it at the same point: a nested layout
    creates its process groups collectively."""
    cfg = cfg or MeshConfig()
    world, rank = distributed.world_size(), distributed.rank()
    cfg.check_world(world)
    if cfg.pods == 1:
        return Mesh((Axis(cfg.data_axis, world, rank),))
    ici = world // cfg.pods
    pod_of, ici_of = divmod(rank, ici)
    ici_group = pod_group = None
    # Every rank creates every group, in one order: the pods' ici groups,
    # then the ici positions' pod groups.
    for p in range(cfg.pods):
        group = dist.new_group(list(range(p * ici, (p + 1) * ici)))
        if p == pod_of:
            ici_group = group
    for i in range(ici):
        group = dist.new_group([p * ici + i for p in range(cfg.pods)])
        if i == ici_of:
            pod_group = group
    return Mesh((Axis(POD_AXIS, cfg.pods, pod_of, pod_group),
                 Axis(ICI_AXIS, ici, ici_of, ici_group)))


def is_hierarchical(mesh: Mesh) -> bool:
    """Whether ``mesh`` carries the nested (pod, ici) data factoring."""
    return POD_AXIS in mesh.axis_names and ICI_AXIS in mesh.axis_names


def data_axis_size(mesh: Mesh) -> int:
    """Total data-parallel rank count (pods × ici on a nested mesh)."""
    size = 1
    for a in mesh.axes:
        size *= a.size
    return size


def pod_shape(mesh: Mesh) -> tuple[int, int]:
    """``(pods, ici)`` — ``(1, data size)`` on a flat mesh, so callers can
    treat every mesh as one pod."""
    if is_hierarchical(mesh):
        return mesh.axis(POD_AXIS).size, mesh.axis(ICI_AXIS).size
    return 1, data_axis_size(mesh)


def zero_shard_axis(mesh: Mesh) -> tuple[Axis, int]:
    """``(axis, n_shards)`` the ZeRO optimizer-state partition keys on: the
    ``ici`` axis on a nested mesh — each pod holds every slice, so the
    all-gather that reassembles the parameters never leaves the pod — and
    the whole data axis on a flat one. On a nested mesh the shard index is
    the ici position alone."""
    axis = mesh.axis(ICI_AXIS) if is_hierarchical(mesh) else mesh.axes[0]
    return axis, axis.size
