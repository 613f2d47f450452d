"""Per-step training-health records and the non-finite-loss sentinel
(``mpi_pytorch_tpu/obs/health.py``).

With ``step_metrics`` each step writes one ``kind="step"`` record: loss,
global gradient norm, the host's wait for the batch and the step's wall
time (ms), and the live device bytes (``torch.cuda.memory_allocated``;
null on the CPU, which has no such counter). Those records cost one host
sync a step, so they default off. The sentinel defaults on: a non-finite
loss writes a ``kind="anomaly"`` diagnostic record and raises
:class:`NonFiniteLossError` instead of training on garbage.

The JAX records also count XLA compiles since the epoch began
(``recompiles``). The port compiles nothing at run time — its kernels are
built once, before training — so it has no such counter, and its records
carry ``recompiles: null``, which the schema allows (an optional integer)
and which says "not counted" rather than a confident zero.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch


def device_bytes_in_use() -> int | None:
    """Bytes allocated on this process's current card, or None without a
    card (the record carries null rather than a fake zero)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_allocated())


class NonFiniteLossError(RuntimeError):
    """A training step produced a non-finite loss (or gradient norm): raised
    by the sentinel after its diagnostic record is written, and by the
    trainer under ``bad_step_policy=abort`` or after ``max_skipped_steps``
    consecutive skips."""


class StepHealth:
    """Per-step health records (``kind="step"``) and the non-finite
    sentinel. :meth:`on_step` does nothing unless ``step_metrics`` is on;
    :meth:`check_epoch` runs regardless (the epoch loss is a host float)."""

    def __init__(self, metrics, *, step_metrics: bool = False, nan_sentinel: bool = True):
        self.metrics = metrics
        self.enabled = bool(step_metrics)
        self.nan_sentinel = bool(nan_sentinel)
        # Consecutive steps whose gradient norm was non-finite — the signal
        # the preemption watchdog (train/elastic.py) can act on. Advances
        # only with step telemetry on.
        self.nonfinite_grad_streak = 0

    def on_step(
        self,
        epoch: int,
        step: int,
        m: Mapping[str, Any],
        data_wait_s: float | None = None,
        step_s: float | None = None,
        skipped: int | None = None,
        steps_skipped: int | None = None,
    ) -> None:
        if not self.enabled:
            return
        loss = float(m["loss"])
        grad_norm = float(m["grad_norm"]) if "grad_norm" in m else None
        record = {
            "kind": "step",
            "epoch": epoch,
            "step": step,
            "loss": loss,
            "grad_norm": grad_norm,
            "data_wait_ms": None if data_wait_s is None else round(data_wait_s * 1e3, 3),
            "step_ms": None if step_s is None else round(step_s * 1e3, 3),
            "recompiles": None,
            "hbm_bytes": device_bytes_in_use(),
        }
        # The bad-step fields, with --bad-step-policy skip only.
        if skipped is not None:
            record["skipped"] = int(skipped)
        if steps_skipped is not None:
            record["steps_skipped"] = int(steps_skipped)
        self.metrics.write(record)
        if grad_norm is not None:
            self.nonfinite_grad_streak = (
                0 if math.isfinite(grad_norm) else self.nonfinite_grad_streak + 1
            )
        self._sentinel(epoch, step, loss, grad_norm)

    def check_epoch(self, epoch: int, loss: float) -> None:
        """The epoch-granularity sentinel every run gets for free."""
        self._sentinel(epoch, None, float(loss), None)

    def _sentinel(self, epoch: int, step: int | None, loss: float,
                  grad_norm: float | None) -> None:
        if not self.nan_sentinel or math.isfinite(loss):
            return
        self.metrics.write({
            "kind": "anomaly",
            "reason": "nonfinite_loss",
            "epoch": epoch,
            "step": step,
            "loss": loss,
            "grad_norm": grad_norm,
        })
        from mpi_pytorch_tpu_torch.utils.logging import run_logger

        where = f"epoch {epoch}" + ("" if step is None else f" step {step}")
        run_logger().error(
            "non-finite loss (%s) at %s — aborting instead of training on "
            "garbage (diagnostic kind='anomaly' record written; disable via "
            "--nan-sentinel false)", loss, where,
        )
        raise NonFiniteLossError(
            f"non-finite loss {loss} at {where}; see the kind='anomaly' "
            "metrics record for diagnostics"
        )
