"""The ranks' step-time heartbeat with straggler flagging
(``mpi_pytorch_tpu/obs/heartbeat.py``).

Every step is a collective, so one slow rank sets the pace for all, and
from rank 0's epoch numbers a straggler is invisible. Every N steps the
ranks exchange their mean step time (``parallel/collectives.host_allgather``:
a small f32 row each) and rank 0's metrics stream gains a
``kind="heartbeat"`` record with every rank's row and the ranks slower
than ``straggler_threshold × median``. The exchange is a collective, so
it runs at the same step on every rank (the trainer's steps are in step);
every rank computes the same flags. One process: one row, never a
straggler.
"""

from __future__ import annotations

import numpy as np


def flag_stragglers(per_host_ms, threshold: float) -> list[int]:
    """Indices (ranks) slower than ``threshold × median``; a non-finite or
    zero median flags nothing (no baseline to be slow against)."""
    a = np.asarray(per_host_ms, np.float64)
    if a.size < 2:
        return []
    med = float(np.median(a))
    if not np.isfinite(med) or med <= 0:
        return []
    return [int(i) for i in np.nonzero(a > threshold * med)[0]]


class Heartbeat:
    """Periodic per-rank step-time aggregation into the metrics stream."""

    def __init__(self, metrics, *, every_steps: int = 0, threshold: float = 1.5,
                 batch_images: int = 0, gather=None):
        self.metrics = metrics
        self.every = int(every_steps)
        self.enabled = self.every > 0
        self.threshold = float(threshold)
        self.batch_images = int(batch_images)
        if gather is None:
            from mpi_pytorch_tpu_torch.parallel.collectives import host_allgather

            gather = host_allgather
        self._gather = gather
        self._window: list[float] = []
        # Consecutive beats that flagged a straggler — the persistent slow
        # rank the preemption watchdog (train/elastic.py) can stop on. Not
        # reset at an epoch: a real straggler outlives epoch boundaries.
        self.straggler_streak = 0

    def start_epoch(self) -> None:
        """Drop samples left when an epoch's step count is not a multiple
        of ``every``: a beat never averages across an epoch boundary."""
        self._window.clear()

    def on_step(self, epoch: int, step: int, step_s: float) -> None:
        """Accumulate this step's wall time; every ``every`` steps, exchange
        and record. Every rank calls it at every step."""
        if not self.enabled:
            return
        self._window.append(step_s)
        if (step + 1) % self.every != 0:
            return
        local_ms = 1e3 * sum(self._window) / len(self._window)
        self._window.clear()
        per_host = np.asarray(self._gather(np.asarray([local_ms], np.float32)))
        per_host_ms = [round(float(v), 3) for v in per_host[:, 0]]
        stragglers = flag_stragglers(per_host_ms, self.threshold)
        self.straggler_streak = self.straggler_streak + 1 if stragglers else 0
        record = {
            "kind": "heartbeat",
            "epoch": epoch,
            "step": step,
            "step_ms": per_host_ms,
            "median_step_ms": round(float(np.median(per_host_ms)), 3),
            "stragglers": stragglers,
            "threshold": self.threshold,
        }
        if self.batch_images:
            # The slowest rank sets the pace of a collective step.
            record["images_per_sec"] = round(self.batch_images / (max(per_host_ms) / 1e3), 1)
        self.metrics.write(record)
        if stragglers:
            from mpi_pytorch_tpu_torch.utils.logging import run_logger

            run_logger().warning(
                "straggler host(s) %s: step time %s ms vs median %.1f ms "
                "(threshold %.2fx) at epoch %d step %d",
                stragglers, [per_host_ms[i] for i in stragglers],
                float(np.median(per_host_ms)), self.threshold, epoch, step,
            )
