"""Dynamic request batcher: bounded queue → bucket-coalesced flushes
(``mpi_pytorch_tpu/serve/batcher.py`` without the fleet-only parts).

Single-image requests coalesce into the next batch, padded up to a fixed
*bucket* from a small configured set, so the server runs one of a handful
of warmed shapes.

Flush policy:

- a flush happens when the largest bucket's worth of requests is pending
  (throughput bound), or
- ``max_wait`` seconds after the oldest pending request arrived (latency
  bound).

Backpressure is typed and immediate: a full queue rejects ``submit`` with
``QueueFullError`` and a closed server rejects with ``ServerClosedError``.
``close()`` drains: queued requests still flush before the server exits.

The batcher owns no threads and never touches torch: the server's batch
loop drives ``next_flush()``.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from typing import Any, Sequence


class ServeError(RuntimeError):
    """Base class for serving errors."""


class QueueFullError(ServeError):
    """Backpressure: the bounded request queue is full — retry later or
    shed the request. ``retry_after_ms`` estimates, from the queue's
    observed drain rate, how long until the backlog has room again."""

    def __init__(self, message: str, retry_after_ms: float | None = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class ServerClosedError(ServeError):
    """The server is closed (or closing) and accepts no new requests."""


class PreprocessError(ServeError):
    """A preprocess worker raised an unexpected non-ServeError while
    preparing this request; the batch goes on without it."""


def parse_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """Sorted, deduped, validated bucket sizes."""
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return out


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that fits ``n`` requests, or the largest bucket
    when ``n`` exceeds them all (a flush holds at most ``buckets[-1]``)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class PendingRequest:
    """One queued request: the (possibly still-preprocessing) payload plus
    the future the caller is waiting on."""

    payload: Any  # np image, or a concurrent Future resolving to one
    future: Any  # concurrent.futures.Future -> np int32 [topk]
    t_submit: float = field(default_factory=time.monotonic)


class DynamicBatcher:
    """Bounded request queue with bucket-coalescing flush semantics."""

    def __init__(
        self,
        buckets: Sequence[int],
        max_wait_s: float,
        max_queue: int,
        poll_s: float = 0.05,
    ):
        self.buckets = parse_buckets(buckets)
        self.max_wait_s = float(max_wait_s)
        # poll cap so close() is noticed promptly even on an idle queue.
        self._poll_s = poll_s
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._closed = False
        # Drain-rate EWMA (requests leaving the queue per second), the
        # denominator of the retry_after_ms hint.
        self._drain_rate: float | None = None
        self._drain_t: float | None = None

    def qsize(self) -> int:
        return self._q.qsize()

    def _note_drain(self, n: int) -> None:
        now = time.monotonic()
        if self._drain_t is not None:
            inst = n / max(now - self._drain_t, 1e-6)
            self._drain_rate = (
                inst if self._drain_rate is None
                else 0.7 * self._drain_rate + 0.3 * inst
            )
        self._drain_t = now

    def retry_after_ms(self) -> float:
        """How long until the current backlog has drained at the observed
        rate; twice the flush deadline before any drain was observed."""
        backlog = self._q.qsize() + 1
        if not self._drain_rate or self._drain_rate <= 0:
            return max(10.0, 2.0 * self.max_wait_s * 1e3)
        return round(min(max(1e3 * backlog / self._drain_rate, 1.0), 6e4), 3)

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, item: PendingRequest) -> None:
        """Enqueue or reject — never blocks the caller."""
        if self._closed:
            raise ServerClosedError("server is shut down")
        try:
            self._q.put_nowait(item)
        except queue.Full:
            raise QueueFullError(
                f"request queue full ({self._q.maxsize}); shed or retry",
                retry_after_ms=self.retry_after_ms(),
            ) from None

    def close(self) -> None:
        """Stop admissions. ``next_flush`` keeps returning batches until
        the queue is empty, then returns None."""
        self._closed = True

    def drain_ready(self, limit: int) -> list[PendingRequest]:
        """Up to ``limit`` already-queued requests, without waiting: the
        server tops a flush up with what arrived while it was being
        preprocessed, so late arrivals ride now."""
        out: list[PendingRequest] = []
        while len(out) < limit:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        if out:
            self._note_drain(len(out))
        return out

    def next_flush(self) -> list[PendingRequest] | None:
        """Block until the next flush is due and return it (1..largest
        bucket requests), or None once closed and drained."""
        pending: list[PendingRequest] = []
        max_b = self.buckets[-1]
        while True:
            # Greedy drain first: under backlog the oldest request is past
            # its deadline the moment it is dequeued, and without the drain
            # each flush would carry one overdue request (batch-1 forwards).
            while len(pending) < max_b:
                try:
                    pending.append(self._q.get_nowait())
                except queue.Empty:
                    break
            now = time.monotonic()
            if pending:
                deadline = pending[0].t_submit + self.max_wait_s
                if len(pending) >= max_b or now >= deadline or self._closed:
                    self._note_drain(len(pending))
                    return pending
                timeout = min(deadline - now, self._poll_s)
            else:
                if self._closed:
                    return None
                timeout = self._poll_s
            try:
                pending.append(self._q.get(timeout=max(timeout, 1e-4)))
            except queue.Empty:
                continue
