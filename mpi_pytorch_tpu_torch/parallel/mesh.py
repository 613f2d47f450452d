"""The rank layout (``mpi_pytorch_tpu/parallel/mesh.py``): the data axis
over the world — flat, or with ``mesh.pods > 1`` (``--mesh-pods``) the
nested (pod, ici) pair that the spmd step's hierarchical gradient sync
reduces over — and, with ``mesh.model_parallel > 1``
(``--mesh.model-parallel``), a model axis beside it; and the placement
rule of the auto step's levers (:func:`param_specs`).

The JAX mesh is an array of devices with named axes; a collective names
the axis it reduces over. Here an axis is a ``torch.distributed`` process
group: the ranks along it, this rank's position on it and its size
(:class:`Axis`). The nested layout is pod-major, as the JAX package's
``np.asarray(devices).reshape(pods, ici, 1)``: rank ``p·ici + i`` is pod
``p``, ici position ``i``. Each pod's ranks form one ``ici`` group (the
fast, within-pod fabric), and the ranks holding one ici position across
the pods form one ``pod`` group (the cross-pod fabric, JAX's DCN). The
(data, model) layout is data-major, as ``np.asarray(devices).reshape(dp,
mp)``: rank ``d·mp + m`` is data index ``d``, model index ``m``. The ranks
of one model index across the data axis form one data group, and the
ranks of one data index one model group; the ranks of a model group hold
the same rows. ``pods > 1`` is spmd-only and the model axis auto-only, so
the two layouts never meet.

:func:`create_mesh` makes every group of the layout with every rank
calling ``torch.distributed.new_group`` for every group in the same
order, as ``new_group`` requires (a rank that skipped one would hang the
world). A flat mesh without a model axis makes no group: its data axis is
the whole world.
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
DATA_AXIS, MODEL_AXIS = "data", "model"


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
    nested; and the model axis (size 1 without ``model_parallel``)."""

    axes: tuple[Axis, ...]
    model: Axis = Axis(MODEL_AXIS, 1, 0)

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
    mp = cfg.model_parallel
    if mp > 1:
        dp = world // mp
        d, m = divmod(rank, mp)
        data_group = model_group = None
        # Every rank creates every group, in one order: the model indices'
        # data groups, then the data indices' model groups.
        for mi in range(mp):
            group = dist.new_group([di * mp + mi for di in range(dp)])
            if mi == m:
                data_group = group
        for di in range(dp):
            group = dist.new_group([di * mp + mi for mi in range(mp)])
            if di == d:
                model_group = group
        return Mesh((Axis(cfg.data_axis, dp, d, data_group),),
                    Axis(cfg.model_axis, mp, m, model_group))
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


def data_axis(mesh: Mesh) -> Axis:
    """The whole data axis as one axis: a flat mesh's, or on a nested one
    the world (whose ranks are all data ranks: the pods are spmd-only)."""
    if is_hierarchical(mesh):
        return Axis(DATA_AXIS, data_axis_size(mesh), distributed.rank())
    return mesh.axes[0]


def data_coords(model_parallel: int = 1) -> tuple[int, int]:
    """``(data size, this rank's data index)`` of the (data, model) layout
    over the current world: the shard of the rows this rank loads (every
    rank of a model group loads the same rows)."""
    world, rank = distributed.world_size(), distributed.rank()
    return world // model_parallel, rank // model_parallel


# ---------------------------------------------------------------------------
# The placement rule of the auto step's levers (JAX ``param_specs``).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardSpec:
    """Where one parameter (or its moments) lives: split into equal blocks
    along dimension ``dim`` over the ranks of axis ``axis`` (``"data"`` or
    ``"model"``), or replicated (both None)."""

    axis: str | None = None
    dim: int | None = None

    @property
    def sharded(self) -> bool:
        return self.axis is not None


REPLICATED = ShardSpec()


def shard_first_divisible(shape, size: int) -> int | None:
    """The ZeRO shard-selection rule (JAX ``shard_first_divisible``), shared
    by FSDP parameter placement and the ZeRO-1 moment placement: the FIRST
    dimension that divides evenly by the axis size; None (replicate) when
    none does."""
    for i, dim in enumerate(shape):
        if dim > 0 and dim % size == 0:
            return i
    return None


def is_head_param(name: str) -> tuple[bool, bool]:
    """(is_head_param, is_kernel) for a parameter name (JAX
    ``is_head_kernel``): every ported model's head is ``fc``."""
    return name.split(".")[0] == "fc", name.endswith(".weight")


def param_specs(shapes: dict[str, tuple], data_size: int, model_size: int,
                fsdp: bool = False) -> dict[str, ShardSpec]:
    """Each parameter's :class:`ShardSpec` (JAX ``param_specs``): the head's
    weight and bias over ``model`` by class rows when the model axis has
    more than one rank and divides the class count, else replicated; under
    ``fsdp`` every other parameter over ``data`` on its first evenly
    divisible dimension, else replicated.

    The port's tensors are laid out ``[out, in, kh, kw]`` where JAX's are
    ``[kh, kw, in, out]``. The head's class dimension is the port's dim 0
    (JAX's last). Under FSDP the port shards its OWN first divisible
    dimension — the output dimension wherever it divides, so a shard is a
    contiguous block of rows — where JAX may pick the input one: a shape
    has a divisible dimension in either order or in neither, so the set of
    sharded parameters and each rank's bytes are JAX's."""
    specs = {}
    for name, shape in shapes.items():
        is_head, is_kernel = is_head_param(name)
        if not is_head or model_size == 1:
            dim = shard_first_divisible(shape, data_size) if fsdp and data_size > 1 else None
            specs[name] = REPLICATED if dim is None else ShardSpec(DATA_AXIS, dim)
        elif shape[0] % model_size == 0 and (is_kernel or len(shape) == 1):
            specs[name] = ShardSpec(MODEL_AXIS, 0)
        else:
            specs[name] = REPLICATED
    return specs
