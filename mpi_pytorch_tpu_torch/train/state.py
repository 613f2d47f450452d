"""Train state and the optimizer factory (``mpi_pytorch_tpu/train/state.py``).

The JAX state is one immutable pytree (params, batch stats, optimizer
state, step, rng). Here the model module holds the parameters and the
batchnorm running statistics, the torch optimizer holds the moments, and
the state adds the step counter and a generator (the JAX ``rng``; the
ported models draw no random numbers in training).

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
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch import nn

from mpi_pytorch_tpu_torch.parallel import collectives
from mpi_pytorch_tpu_torch.parallel.mesh import Axis

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
) -> tuple[torch.optim.Optimizer, Schedule]:
    """(torch optimizer over the trainable parameters, schedule). Defaults
    reproduce the reference: Adam(lr) at a constant rate. With
    ``zero_axis`` the optimizer is a :class:`ZeroOptimizer` sharded over
    that axis.

    - ``adam``: β = (0.9, 0.999), ε = 1e-8, no weight decay;
    - ``sgd``: momentum 0.9 (optax's trace: ``t = g + 0.9·t``);
    - ``adamw``: Adam with decoupled ``weight_decay``.

    ``trainable_mask`` maps parameter names to whether they train; None
    trains all."""
    schedule = make_schedule(learning_rate, lr_schedule, warmup_steps, total_steps)
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


class ZeroOptimizer:
    """A torch optimizer over this rank's owned slice of each of
    ``params`` (the trainable parameters, in their order): ``build(slices)``
    makes the inner optimizer (``torch.optim.Adam`` and the like) over
    [chunk] tensors, one a parameter, in the flatten-pad layout over
    ``axis`` (``zero_shard_spec``; shard index ``axis.index`` — the ici
    position on a nested layout). It keeps 1/P of the moments.

    :meth:`step` takes this rank's slices of the synced mean gradients,
    loads the owned slices of the current parameters, runs the inner
    update on the slices and all-gathers them back into the parameters
    (over ``axis`` alone). ``param_groups`` are the inner optimizer's, so
    the schedule sets the rate as on any optimizer.

    :meth:`state_dict` and :meth:`load_state_dict` speak the unsharded
    ``torch.optim`` layout: ``state_dict`` all-gathers each moment (a
    collective: every rank of the axis calls it at the same point) and
    returns the keys, parameter order and shapes an unsharded optimizer
    over ``params`` would; ``load_state_dict`` takes that layout, from a run
    at any world size, and keeps this rank's slices."""

    def __init__(self, params: Sequence[torch.Tensor], build: Callable, axis: Axis):
        self.params = list(params)
        self.axis = axis
        self.slices = [owned_slice(p.detach(), axis.size, axis.index) for p in self.params]
        self.inner = build(self.slices)

    @property
    def param_groups(self) -> list[dict]:
        return self.inner.param_groups

    def step(self, grad_slices: Sequence[torch.Tensor]) -> None:
        """One update from ``grad_slices`` (this rank's [chunk] slice of
        each parameter's mean gradient, in ``params`` order)."""
        with torch.no_grad():
            for s, p, g in zip(self.slices, self.params, grad_slices):
                s.copy_(owned_slice(p, self.axis.size, self.axis.index))
                s.grad = g
            self.inner.step()
            for s in self.slices:
                s.grad = None
            for p, full in zip(self.params, collectives.all_gather_slices(self.slices, self.axis)):
                p.copy_(full[:p.numel()].view(p.shape))

    def state_dict(self) -> dict:
        return zero_unshard_opt_state(self)

    def load_state_dict(self, state_dict: dict) -> None:
        self.inner.load_state_dict(zero_shard_opt_state(state_dict, self))


def zero_unshard_opt_state(opt: ZeroOptimizer) -> dict:
    """The inverse of the sharding (JAX ``zero_unshard_opt_state``): the
    unsharded ``torch.optim`` ``state_dict`` of ``opt`` — the keys,
    parameter order and shapes an unsharded optimizer over ``opt.params``
    has — each moment all-gathered over ``opt.axis``, stripped of its
    padding and moved to the host one at a time (the device holds one
    gathered moment at once). A collective: every rank calls it."""
    inner = opt.inner.state_dict()
    state = {}
    for i, st in inner["state"].items():
        p = opt.params[i]
        state[i] = {
            k: (collectives.all_gather_slices([v], opt.axis)[0][:p.numel()].view(p.shape).cpu()
                if torch.is_tensor(v) and v.dim() > 0 else v)
            for k, v in st.items()
        }
    return {"state": state, "param_groups": inner["param_groups"]}


def zero_shard_opt_state(state_dict: dict, opt: ZeroOptimizer) -> dict:
    """An unsharded ``torch.optim`` ``state_dict`` (from a run at any world
    size, sharded or not) as ``opt``'s inner state: each moment's owned
    slice on this rank, the scalars as they are."""
    state = {}
    for i, st in state_dict["state"].items():
        p = opt.params[int(i)]
        state[i] = {}
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0:
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"optimizer state {i}.{k}: shape {tuple(v.shape)}, "
                                     f"parameter {tuple(p.shape)}")
                v = owned_slice(v.to(p.device), opt.axis.size, opt.axis.index)
            state[i][k] = v
    return {"state": state, "param_groups": state_dict["param_groups"]}


def moment_bytes(optimizer) -> int:
    """Bytes of an optimizer's moment tensors on this rank: its non-scalar
    state (Adam's two moments, SGD's momentum), sharded or not."""
    inner = optimizer.inner if isinstance(optimizer, ZeroOptimizer) else optimizer
    return sum(v.numel() * v.element_size() for st in inner.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim() > 0)


@dataclass
class TrainState:
    """Everything one train step reads and advances. ``step`` counts the
    applied updates (a skipped bad step does not count)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0
    generator: torch.Generator | None = None

    def set_learning_rate(self) -> None:
        """The schedule's rate for this step onto every param group."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
