"""Train state and the optimizer factory (``mpi_pytorch_tpu/train/state.py``).

The JAX state is one immutable pytree (params, batch stats, optimizer
state, step, rng). Here the model module holds the parameters and the
batchnorm running statistics, the torch optimizer holds the moments, and
the state adds the step counter and a generator (the JAX ``rng``): the
train-mode masks of dropout and stochastic depth come from it, re-seeded
each step from ``rng_seed``, the data shard and the step (:func:`step_seed`,
the JAX step's ``fold_in(rng, step)``), one stream a data shard: the ranks
of a model group (``--mesh.model-parallel``) hold the same rows and draw
the same masks.

``make_optimizer`` reproduces ``optax.adam`` / ``sgd(momentum=0.9)`` /
``adamw`` and optax's schedule functions: the learning rate of step ``t``
(0-based, counted before the update, as optax's ``schedule(count)``) is
``schedule(t)``, set on the param groups before each update. Frozen
parameters (``feature_extract``) are left out of the optimizer, so they
get no update at all — ``optax.set_to_zero`` — and no weight decay.

ZeRO optimizer-state sharding (``--zero-opt-state``, spmd mode; JAX
``zero_shard_spec``, ``zero_shard_opt_state``, ``zero_unshard_opt_state``):
:class:`ZeroOptimizer` is the same torch optimizer over this rank's owned
``[chunk]`` slice of every trainable parameter, flattened and zero-padded
to ``chunk·P``, so each rank holds 1/P of the moments. Adam, SGD and AdamW
are elementwise, so updating the slices and all-gathering them gives the
replicated update; the scalars (Adam's step count) stay replicated, as JAX
keeps its count. Its ``state_dict`` gathers the moments back into the
unsharded ``torch.optim`` layout (gather-on-save), and ``load_state_dict``
takes that layout at any world size.

Placement (the auto step's levers; JAX ``place_state_on_mesh``):
:func:`place_model` lays the model out on the (data, model) mesh by
``parallel.mesh.param_specs`` — the head's class rows over ``model``
(``--mesh.model-parallel``), under ``--fsdp`` every other parameter held
as its block over ``data`` at rest — and returns the :class:`Placement`,
which also says where each parameter's moments live: with the parameter
when it is sharded (the TP head's keep the model sharding, as JAX's
``sharding.spec == P()`` guard keeps them), and under
``--zero-optimizer`` a replicated parameter's over ``data`` by the same
rule. The optimizer is then a :class:`ZeroOptimizer` whose second slicing
rule (:class:`Slicing`) splits along a dimension beside the spmd step's
flatten-pad. Batchnorm statistics and scalars stay replicated.
:func:`full_state_dict` gathers the model back into the unsharded
``state_dict`` (gather-on-save) and :func:`load_full_state_dict` takes one
into any layout.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn
from torch.nn.utils import parametrize

from mpi_pytorch_tpu_torch.models.common import GatheredShard, VocabParallelDense
from mpi_pytorch_tpu_torch.models.convert import block_of, shard_state_dict
from mpi_pytorch_tpu_torch.parallel import collectives
from mpi_pytorch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    REPLICATED,
    Axis,
    Mesh,
    ShardSpec,
    data_axis,
    param_specs,
    shard_first_divisible,
)

Schedule = Callable[[int], float]


def _polynomial(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (power 1, transition_begin 0)."""

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return schedule


def make_schedule(
    learning_rate: float,
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    total_steps: int | None = None,
) -> Schedule:
    """The learning rate of each step: ``constant``; ``cosine`` (decay to 0
    over ``total_steps``); ``warmup_cosine`` (linear from 0 over
    ``warmup_steps``, then cosine to 0 at ``total_steps``), as optax's
    ``warmup_cosine_decay_schedule`` joins them."""
    if lr_schedule == "constant":
        return lambda count: learning_rate
    if lr_schedule not in ("cosine", "warmup_cosine"):
        raise ValueError(
            f"lr_schedule must be constant|cosine|warmup_cosine, got {lr_schedule!r}"
        )
    if not total_steps or total_steps <= 0:
        raise ValueError(f"lr_schedule={lr_schedule!r} requires total_steps > 0")
    warmup = warmup_steps if lr_schedule == "warmup_cosine" else 0
    if warmup < 0:
        raise ValueError(f"warmup_steps must be >= 0, got {warmup}")
    if warmup >= total_steps:
        raise ValueError(
            f"warmup_steps ({warmup}) must be < the run's total step count "
            f"({total_steps}); shorten the warmup or train longer"
        )
    if warmup == 0:
        return _cosine(learning_rate, total_steps)
    ramp = _polynomial(0.0, learning_rate, warmup)
    decay = _cosine(learning_rate, total_steps - warmup)
    return lambda count: ramp(count) if count < warmup else decay(count - warmup)


def make_optimizer(
    model: nn.Module,
    learning_rate: float,
    trainable_mask: dict[str, bool] | None = None,
    *,
    optimizer: str = "adam",
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    total_steps: int | None = None,
    weight_decay: float = 0.0,
    zero_axis: Axis | None = None,
    placement: "Placement | None" = None,
) -> tuple[torch.optim.Optimizer, Schedule]:
    """(torch optimizer over the trainable parameters, schedule). Defaults
    reproduce the reference: Adam(lr) at a constant rate. With
    ``zero_axis`` the optimizer is a :class:`ZeroOptimizer` sharded over
    that axis.

    - ``adam``: β = (0.9, 0.999), ε = 1e-8, no weight decay;
    - ``sgd``: momentum 0.9 (optax's trace: ``t = g + 0.9·t``);
    - ``adamw``: Adam with decoupled ``weight_decay``.

    ``trainable_mask`` maps parameter names to whether they train; None
    trains all. With a ``placement`` (:func:`place_model`) the optimizer
    steps the tensors this rank holds, in the unsharded model's parameter
    order (so its ``state_dict`` indices are an unsharded run's), and is a
    :class:`ZeroOptimizer` when anything is sharded."""
    schedule = make_schedule(learning_rate, lr_schedule, warmup_steps, total_steps)
    if placement is not None:
        names = [n for n in placement.names if trainable_mask is None or trainable_mask[n]]
        params = [placement.held[n] for n in names]
    else:
        params = [
            p for name, p in model.named_parameters()
            if trainable_mask is None or trainable_mask[name]
        ]
    lr = schedule(0)
    if optimizer == "adam":
        build = functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "sgd":
        build = functools.partial(torch.optim.SGD, lr=lr, momentum=0.9)
    elif optimizer == "adamw":
        build = functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    else:
        raise ValueError(f"optimizer must be adam|sgd|adamw, got {optimizer!r}")
    if zero_axis is not None:
        return ZeroOptimizer(params, build, zero_axis), schedule
    if placement is not None and placement.sharded:
        return ZeroOptimizer(params, build, [placement.slicing(n) for n in names]), schedule
    return build(params), schedule


def zero_shard_spec(shape: Sequence[int], n_shards: int) -> tuple[int, int] | None:
    """The ZeRO partition rule for one optimizer-state tensor: ``(chunk,
    padded)`` with ``chunk = ⌈size / P⌉`` and ``padded = chunk·P`` (the
    flat length after zero padding), or None for a scalar (replicated)."""
    if not tuple(shape):
        return None
    size = math.prod(shape)
    chunk = -(-size // n_shards)
    return chunk, chunk * n_shards


def owned_slice(t: torch.Tensor, n_shards: int, index: int) -> torch.Tensor:
    """Shard ``index``'s [chunk] of ``t`` flattened (logical order) and
    zero-padded to ``chunk·n_shards``: row ``index`` of
    ``collectives.stack_slices([t], n_shards)``."""
    flat = t.reshape(-1)
    chunk = collectives.zero_chunk(flat.numel(), n_shards)
    part = flat[index * chunk:(index + 1) * chunk]
    return torch.nn.functional.pad(part, (0, chunk - part.numel()))


@dataclass(frozen=True)
class Slicing:
    """How a :class:`ZeroOptimizer` holds one parameter's moments: whole
    (no ``axis``), or split over ``axis`` — flattened and zero-padded
    (``dim`` None: the spmd step's ``--zero-opt-state`` rule) or
    in equal blocks along ``dim`` (the auto step's placement). ``held``:
    the parameter tensor this rank holds is already its block (FSDP, the
    TP head), so the moments follow it and the inner optimizer steps it
    directly."""

    axis: Axis | None = None
    dim: int | None = None
    held: bool = False

    def own(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole-shaped tensor (a view for a block)."""
        if self.axis is None:
            return whole
        if self.dim is None:
            return owned_slice(whole, self.axis.size, self.axis.index)
        return block_of(whole, self.axis.size, self.axis.index, self.dim)

    def gather(self, part: torch.Tensor, shape: torch.Size) -> torch.Tensor:
        """The whole ``shape``-d tensor from every rank's part of a split
        one (a collective over ``axis``)."""
        if self.dim is None:
            return collectives.all_gather_slices([part], self.axis)[0][:math.prod(shape)] \
                .view(shape)
        return collectives.gather_dim(part, self.axis, self.dim)


class ZeroOptimizer:
    """A torch optimizer over this rank's part of each of ``params`` (the
    trainable parameters, in their order): ``build(slices)`` makes the
    inner optimizer (``torch.optim.Adam`` and the like) over one tensor a
    parameter, each held as its :class:`Slicing` says — ``slicing`` is one
    a parameter, or an ``Axis``: every parameter flattened and zero-padded
    into [chunk] slices over it (``zero_shard_spec``; shard index
    ``axis.index`` — the ici position on a nested layout), the spmd
    step's layout, which keeps 1/P of the moments.

    :meth:`step` takes this rank's slices of the synced gradients (the
    spmd step's reduce-scatter), or without them cuts them from the
    parameters' ``.grad`` (the auto step); it loads the owned parts of the
    current parameters, runs the inner update on the parts and all-gathers
    them back into the parameters (one collective a rule; a part that is
    the parameter itself is updated in place). ``param_groups`` are the
    inner optimizer's, so the schedule sets the rate as on any optimizer.

    :meth:`state_dict` and :meth:`load_state_dict` speak the unsharded
    ``torch.optim`` layout: ``state_dict`` all-gathers each moment over
    its axis (a collective: every rank calls it at the same point) and
    returns the keys, parameter order and shapes an unsharded optimizer
    over the whole parameters would; ``load_state_dict`` takes that
    layout, from a run at any world size, and keeps this rank's parts."""

    def __init__(self, params: Sequence[torch.Tensor], build: Callable,
                 slicing: Axis | Sequence[Slicing]):
        self.params = list(params)
        self.axis = slicing if isinstance(slicing, Axis) else None
        self.slicings = ([Slicing(slicing)] * len(self.params) if isinstance(slicing, Axis)
                         else list(slicing))
        # The whole shape of each parameter (a held block's is its own
        # with the split dimension times the axis size).
        self.shapes = [
            torch.Size(d * sl.axis.size if i == sl.dim else d for i, d in enumerate(p.shape))
            if sl.held else p.shape for p, sl in zip(self.params, self.slicings)
        ]
        self.slices = [p if self._in_place(sl) else sl.own(p.detach()).clone()
                       for p, sl in zip(self.params, self.slicings)]
        self.inner = build(self.slices)

    @staticmethod
    def _in_place(sl: Slicing) -> bool:
        return sl.axis is None or sl.held

    @property
    def param_groups(self) -> list[dict]:
        return self.inner.param_groups

    def step(self, grad_slices: Sequence[torch.Tensor] | None = None) -> None:
        """One update from ``grad_slices`` (this rank's part of each
        parameter's synced gradient, in ``params`` order), or from the
        parameters' ``.grad``."""
        with torch.no_grad():
            for i, (s, p, sl) in enumerate(zip(self.slices, self.params, self.slicings)):
                g = (grad_slices[i] if grad_slices is not None
                     else p.grad if p.grad is not None else torch.zeros_like(p))
                if s is p:
                    p.grad = g
                    continue
                s.copy_(sl.own(p))
                s.grad = g if grad_slices is not None else sl.own(g)
            self.inner.step()
            flat = [i for i, sl in enumerate(self.slicings)
                    if not self._in_place(sl) and sl.dim is None]
            blocks = [i for i, sl in enumerate(self.slicings)
                      if not self._in_place(sl) and sl.dim is not None]
            for i in flat + blocks:
                self.slices[i].grad = None
            if flat:
                axis = self.slicings[flat[0]].axis
                wholes = collectives.all_gather_slices([self.slices[i] for i in flat], axis)
                for i, whole in zip(flat, wholes):
                    p = self.params[i]
                    p.copy_(whole[:p.numel()].view(p.shape))
            if blocks:
                axis = self.slicings[blocks[0]].axis
                wholes = collectives.gather_blocks([self.slices[i] for i in blocks],
                                                   [self.slicings[i].dim for i in blocks], axis)
                for i, whole in zip(blocks, wholes):
                    self.params[i].copy_(whole)

    def state_dict(self) -> dict:
        return zero_unshard_opt_state(self)

    def load_state_dict(self, state_dict: dict) -> None:
        self.inner.load_state_dict(zero_shard_opt_state(state_dict, self))


def zero_unshard_opt_state(opt: ZeroOptimizer) -> dict:
    """The inverse of the sharding (JAX ``zero_unshard_opt_state``): the
    unsharded ``torch.optim`` ``state_dict`` of ``opt`` — the keys,
    parameter order and shapes an unsharded optimizer over the whole
    parameters has — each split moment all-gathered over its axis,
    stripped of any padding and moved to the host one at a time (the
    device holds one gathered moment at once). A collective: every rank
    calls it."""
    inner = opt.inner.state_dict()
    state = {}
    for i, st in inner["state"].items():
        sl, shape = opt.slicings[i], opt.shapes[i]
        state[i] = {
            k: (sl.gather(v, shape).cpu() if sl.axis is not None else v)
            if torch.is_tensor(v) and v.dim() > 0 else v
            for k, v in st.items()
        }
    return {"state": state, "param_groups": inner["param_groups"]}


def zero_shard_opt_state(state_dict: dict, opt: ZeroOptimizer) -> dict:
    """An unsharded ``torch.optim`` ``state_dict`` (from a run at any world
    size, sharded or not) as ``opt``'s inner state: each moment's owned
    part on this rank, the scalars as they are."""
    state = {}
    for i, st in state_dict["state"].items():
        p, sl, shape = opt.params[int(i)], opt.slicings[int(i)], opt.shapes[int(i)]
        state[i] = {}
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                if tuple(v.shape) != tuple(shape):
                    raise ValueError(f"optimizer state {i}.{k}: shape {tuple(v.shape)}, "
                                     f"parameter {tuple(shape)}")
                v = sl.own(v.to(p.device)).clone()
            state[i][k] = v
    return {"state": state, "param_groups": state_dict["param_groups"]}


def moment_bytes(optimizer) -> int:
    """Bytes of an optimizer's moment tensors on this rank: its non-scalar
    state (Adam's two moments, SGD's momentum), sharded or not."""
    inner = optimizer.inner if isinstance(optimizer, ZeroOptimizer) else optimizer
    return sum(v.numel() * v.element_size() for st in inner.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0)


@dataclass
class Placement:
    """The auto step's layout of a model on a mesh (:func:`place_model`):
    the unsharded model's parameter ``names`` (in order) and
    ``state_keys``, where each parameter lives (``specs``) and its moments
    (``moments``), and the tensor this rank holds of each (``held``: its
    block, or the whole)."""

    mesh: Mesh
    names: list[str]
    state_keys: list[str]
    specs: dict[str, ShardSpec]
    moments: dict[str, ShardSpec]
    held: dict[str, torch.Tensor]

    @property
    def sharded(self) -> bool:
        """Whether any parameter or moment is split over an axis."""
        return any(s.sharded for s in (*self.specs.values(), *self.moments.values()))

    def axis(self, spec: ShardSpec) -> Axis:
        """The mesh axis ``spec`` splits over."""
        return self.mesh.model if spec.axis == MODEL_AXIS else data_axis(self.mesh)

    def slicing(self, name: str) -> Slicing:
        """The :class:`ZeroOptimizer` rule of ``name``'s moments."""
        mom = self.moments[name]
        if not mom.sharded:
            return Slicing()
        return Slicing(self.axis(mom), mom.dim, held=self.specs[name].sharded)

    def by_axis(self, axis_name: str | None) -> list[str]:
        """The names of the parameters split over ``axis_name`` (None:
        the replicated ones), in order."""
        return [n for n in self.names if self.specs[n].axis == axis_name]


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def _held(model: nn.Module, name: str) -> torch.Tensor:
    module, attr = _owner(model, name)
    if parametrize.is_parametrized(module, attr):
        return module.parametrizations[attr].original
    return module._parameters[attr]


def place_model(model: nn.Module, mesh: Mesh, *, fsdp: bool = False,
                zero: bool = False) -> Placement:
    """Lay ``model`` (whole, on its device, every rank alike) out on
    ``mesh`` in place — the counterpart of JAX ``place_state_on_mesh``:

    - ``parallel.mesh.param_specs``: with a model axis of more than one
      rank that divides the classes, the head ``fc`` becomes this rank's
      :class:`~mpi_pytorch_tpu_torch.models.common.VocabParallelDense`
      block; under ``fsdp`` every other parameter with an evenly divisible
      dimension is held as its block over the data axis, read whole
      through a :class:`~mpi_pytorch_tpu_torch.models.common.GatheredShard`
      parametrization;
    - the moments: with their parameter when it is split; under ``zero``
      a replicated parameter's over the data axis on its first evenly
      divisible dimension (``shard_first_divisible``; whole when none
      divides, or on a data axis of one rank), as JAX's ZeRO-1 placement;
    - buffers (batchnorm statistics) stay replicated.

    Returns the :class:`Placement` (:func:`make_optimizer` takes it)."""
    data = data_axis(mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    state_keys = list(model.state_dict())
    specs = param_specs(shapes, data.size, mesh.model.size, fsdp)
    moments = {}
    for n, shape in shapes.items():
        dim = shard_first_divisible(shape, data.size) if zero and data.size > 1 else None
        moments[n] = (specs[n] if specs[n].sharded
                      else ShardSpec(DATA_AXIS, dim) if dim is not None else REPLICATED)
    others = [n for n, sp in specs.items() if sp.axis == MODEL_AXIS and not n.startswith("fc.")]
    if others:
        raise NotImplementedError(
            f"the vocab-sharded head is ported for the dense head fc only; {', '.join(others)} "
            "is not ported yet (ROADMAP A9)"
        )
    if specs.get("fc.weight", REPLICATED).axis == MODEL_AXIS:
        model.fc = VocabParallelDense.from_dense(model.fc, mesh.model)
    for n, spec in specs.items():
        if spec.axis == DATA_AXIS:
            module, attr = _owner(model, n)
            parametrize.register_parametrization(module, attr, GatheredShard(data, spec.dim),
                                                 unsafe=True)
    return Placement(mesh=mesh, names=list(shapes), state_keys=state_keys, specs=specs,
                     moments=moments, held={n: _held(model, n) for n in shapes})


@torch.no_grad()
def full_state_dict(model: nn.Module, placement: Placement | None) -> dict[str, torch.Tensor]:
    """The unsharded model's ``state_dict`` (its keys, order and shapes)
    from a placed one — gather-on-save: each split parameter all-gathered
    over its axis and moved to the host one at a time. A collective:
    every rank calls it. Without a placement, ``model.state_dict()``."""
    if placement is None:
        return model.state_dict()
    local = model.state_dict()
    out = {}
    for key in placement.state_keys:
        spec = placement.specs.get(key)
        if spec is None:
            out[key] = local[key]
        elif spec.sharded:
            out[key] = collectives.gather_dim(placement.held[key].detach(),
                                              placement.axis(spec), spec.dim).cpu()
        else:
            out[key] = placement.held[key].detach()
    return out


@torch.no_grad()
def load_full_state_dict(model: nn.Module, placement: Placement | None,
                         state_dict: dict[str, torch.Tensor]) -> None:
    """An unsharded ``state_dict`` (any run's) into a placed model: each
    split parameter takes its block, the rest as they are. Without a
    placement, ``model.load_state_dict``."""
    if placement is None:
        model.load_state_dict(state_dict)
        return
    if set(state_dict) != set(placement.state_keys):
        raise KeyError(f"state_dict keys differ from the model's: "
                       f"{sorted(set(state_dict) ^ set(placement.state_keys))}")
    data, model_axis = data_axis(placement.mesh), placement.mesh.model
    mine = shard_state_dict(state_dict, placement.specs, {
        DATA_AXIS: (data.size, data.index), MODEL_AXIS: (model_axis.size, model_axis.index)})
    buffers = dict(model.named_buffers())
    for key in placement.state_keys:
        (placement.held[key] if key in placement.specs else buffers[key]).copy_(mine[key])


def step_seed(seed: int, shard: int, step: int) -> int:
    """The seed of step ``step``'s masks on data shard ``shard`` of a run
    seeded ``seed``: distinct for each (shard, step) of a run."""
    return ((seed * 1_000_003 + shard) * 1_000_003 + step) % (1 << 63)


@dataclass
class TrainState:
    """Everything one train step reads and advances. ``step`` counts the
    applied updates (a skipped bad step does not count). ``placement`` is
    the auto step's layout of the model (:func:`place_model`), None for a
    replicated model."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    generator: torch.Generator | None = None
    placement: Placement | None = None
    # The seed of the train-mode masks (see :meth:`masks_generator`).
    rng_seed: int | None = None
    # The bad-step rollback's learning-rate backoff, applied to every rate
    # the schedule gives (``--rollback-lr-backoff``, compounded per rollback).
    lr_scale: float = 1.0

    def masks_generator(self, shard: int) -> torch.Generator | None:
        """The generator this step's dropout and stochastic-depth masks
        come from: ``generator`` re-seeded with ``step_seed(rng_seed, shard,
        step)`` (when ``rng_seed`` is set), so step t of data shard s draws
        the same masks in a resumed run as in an unbroken one, and each
        shard its own."""
        if self.generator is not None and self.rng_seed is not None:
            self.generator.manual_seed(step_seed(self.rng_seed, shard, self.step))
        return self.generator

    def set_learning_rate(self) -> None:
        """The schedule's rate for this step, times ``lr_scale``, onto
        every param group."""
        lr = self.schedule(self.step) * self.lr_scale
        for group in self.optimizer.param_groups:
            group["lr"] = lr


def sync_state(state: TrainState) -> None:
    """Rank 0's parameters and buffers on every rank (``collectives.
    sync_params``), for a placed model along its axes: each block from
    the rank holding it at index 0 of the other axis (a data-split block
    across its model group, a model-split one across its data group),
    the replicated parameters and the buffers from rank 0 of the world."""
    placement = state.placement
    if placement is None:
        collectives.sync_params(state.model)
        return
    held = placement.held
    collectives.broadcast_from([held[n] for n in placement.by_axis(None)]
                               + list(state.model.buffers()))
    collectives.broadcast_from([held[n] for n in placement.by_axis(DATA_AXIS)],
                               axis=placement.mesh.model)
    collectives.broadcast_from([held[n] for n in placement.by_axis(MODEL_AXIS)],
                               axis=data_axis(placement.mesh))


def placed_bytes(state: TrainState) -> tuple[int, int]:
    """(parameter bytes, moment bytes) this rank holds."""
    params = (state.placement.held.values() if state.placement is not None
              else state.model.parameters())
    return sum(p.numel() * p.element_size() for p in params), moment_bytes(state.optimizer)
