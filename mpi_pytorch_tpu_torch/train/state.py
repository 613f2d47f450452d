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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

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
) -> tuple[torch.optim.Optimizer, Schedule]:
    """(torch optimizer over the trainable parameters, schedule). Defaults
    reproduce the reference: Adam(lr) at a constant rate.

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
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    elif optimizer == "adamw":
        opt = torch.optim.AdamW(
            params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
    else:
        raise ValueError(f"optimizer must be adam|sgd|adamw, got {optimizer!r}")
    return opt, schedule


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
