"""The online inference server (``mpi_pytorch_tpu/serve/server.py``, core
only): shape-bucketed dynamic batching over one eval-mode model on one
device.

    submit(image) → preprocess pool → DynamicBatcher → bucket predict step
    (on the device) → completion loop → Future[np.int32 [topk]]

Pipeline overlap comes from two threads: the batch loop coalesces,
preprocesses, copies to the device and launches flush n+1 while the
completion loop waits for flush n. On CUDA the host→device copy and the
launch go on the current stream, the predictions are copied back into
pinned memory on the same stream, and the completion loop waits on a
``torch.cuda.Event`` recorded after them: only the int32 predictions come
back. The in-flight queue has depth 2, so the batch loop runs at most one
flush ahead.

Padded rows get label −1 and are sliced off before any response.
Observability, SLOs, HTTP, fleets and int8 serving are not ported yet.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.data.pipeline import (
    decode_image,
    decode_image_uint8,
    normalize_image,
)
from mpi_pytorch_tpu_torch.evaluate import build_inference
from mpi_pytorch_tpu_torch.hardware import resolve_device
from mpi_pytorch_tpu_torch.serve.batcher import (
    DynamicBatcher,
    PendingRequest,
    PreprocessError,
    QueueFullError,
    ServeError,
    ServerClosedError,
    pick_bucket,
)
from mpi_pytorch_tpu_torch.serve.executables import BucketExecutables
from mpi_pytorch_tpu_torch.utils.logging import run_logger


@dataclass
class _InFlight:
    requests: list  # PendingRequest, real rows only
    preds: Any  # host tensor [bucket] or [bucket, k]; valid once `done` fired
    done: Any  # torch.cuda.Event recorded after the readback; None on CPU
    bucket: int
    buffer: np.ndarray  # the pooled host batch, recycled after `done`


class _BufferPool:
    """Reusable host batch buffers per (bucket, dtype); pinned memory on
    CUDA so the host→device copy is asynchronous. A buffer returns to the
    pool only after its flush's completion event, so reuse never races a
    copy still in flight."""

    def __init__(self, image_hw: tuple[int, int], pinned: bool, cap_per_key: int = 4):
        self._hw = tuple(image_hw)
        self._pinned = pinned
        self._cap = cap_per_key
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._lock = threading.Lock()

    def acquire(self, bucket: int, dtype: np.dtype) -> np.ndarray:
        key = (bucket, np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            if free:
                return free.pop()
        shape = (bucket, *self._hw, 3)
        if self._pinned:
            t = torch.empty(shape, dtype=_TORCH_DTYPES[np.dtype(dtype)], pin_memory=True)
            return t.numpy()
        return np.empty(shape, dtype)

    def release(self, buf: np.ndarray) -> None:
        key = (buf.shape[0], buf.dtype.str)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self._cap:
                free.append(buf)


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float32): torch.float32}


class InferenceServer:
    """Shape-bucketed dynamic-batching predict server on one device.

    ``submit(image) -> Future[np.int32 [topk]]``: ``image`` is a file path
    (decoded and resized on the worker pool), an ``(H, W, 3)`` uint8 array
    of raw pixels, or an ``(H, W, 3)`` float array that is already
    normalized. ``predict_batch`` is the synchronous wrapper. ``close()``
    drains gracefully.

    ``device`` defaults to cuda (``MPT_PLATFORM=cpu`` selects the CPU);
    weights come from ``state_dict`` or a seeded init from ``cfg.seed``.
    """

    def __init__(
        self,
        cfg: Config,
        *,
        device: str | torch.device | None = None,
        state_dict: dict[str, torch.Tensor] | None = None,
    ):
        self.cfg = cfg
        self._logger = run_logger()
        self.device = resolve_device(device)
        self.model = build_inference(cfg, self.device, state_dict)
        self._exe = BucketExecutables(cfg, self.model, self.device, logger=self._logger)
        self.buckets = self._exe.buckets
        self.topk = self._exe.topk
        self._batcher = DynamicBatcher(
            self.buckets, cfg.serve_max_wait_ms / 1e3, cfg.serve_queue_depth
        )
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, cfg.loader_workers), thread_name_prefix="serve-prep"
        )
        self._bufpool = _BufferPool(cfg.image_size, pinned=self.device.type == "cuda")
        # Depth 2: the batch loop may run one flush ahead of the completion
        # loop, no further.
        self._inflight: queue.Queue = queue.Queue(maxsize=2)
        self._abandon = False
        self._close_started = False
        self._lock = threading.Lock()
        self._stats = {
            "served": 0, "failed": 0, "rejected": 0, "batches": 0,
            "padded_rows": 0, "preprocess_failures": 0,
            "by_bucket": {b: 0 for b in self.buckets},
        }
        # The batch thread warms every bucket before it serves: cuDNN's
        # handles and its autotuned-algorithm cache are per thread, so a
        # warmup on any other thread would leave the first flushes to
        # autotune again.
        self._warm = threading.Event()
        self._warm_error: BaseException | None = None
        self._batch_thread = threading.Thread(
            target=self._warm_then_serve, name="serve-batch", daemon=True
        )
        self._batch_thread.start()
        self._warm.wait()
        if self._warm_error is not None:
            self._batch_thread.join()
            self._pool.shutdown(wait=False)
            raise self._warm_error
        self._completion_thread = threading.Thread(
            target=self._completion_loop, name="serve-fetch", daemon=True
        )
        self._completion_thread.start()
        self._logger.info(
            "serve: %s on %s, buckets %s warm (topk=%d, fused_stem=%s, "
            "fused_head=%s, max_wait=%.1f ms, queue=%d)",
            cfg.model_name, self.device, list(self.buckets), self.topk,
            cfg.fused_stem, self._exe.fused_head, cfg.serve_max_wait_ms,
            cfg.serve_queue_depth,
        )

    # ------------------------------------------------------------ request path

    def submit(self, image) -> Future:
        """Enqueue one request; the future resolves to the top-k class
        indices (np.int32, shape [topk]). Raises ``QueueFullError`` under
        backpressure and ``ServerClosedError`` after ``close()``."""
        if self._batcher.closed:
            raise ServerClosedError("server is shut down")
        fut: Future = Future()
        try:
            payload = self._pool.submit(self._preprocess, image)
        except RuntimeError:  # the pool refuses work once close() shut it
            raise ServerClosedError("server is shut down") from None
        try:
            self._batcher.submit(PendingRequest(payload=payload, future=fut))
        except QueueFullError:
            with self._lock:
                self._stats["rejected"] += 1
            payload.cancel()
            raise
        return fut

    def predict_batch(self, images, timeout: float | None = None) -> np.ndarray:
        """Synchronous convenience: submit all, wait, stack → [n, topk]."""
        futs = [self.submit(im) for im in images]
        return np.stack([f.result(timeout=timeout) for f in futs])

    def _preprocess(self, image) -> np.ndarray:
        """Request payload → one model-ready (H, W, 3) row: float rows are
        normalized on the host, uint8 rows ship raw pixels (device
        normalize)."""
        size = self.cfg.image_size
        raw = self._exe.image_dtype == np.uint8
        if isinstance(image, (str, os.PathLike)):
            if raw:
                return decode_image_uint8(os.fspath(image), size)
            return normalize_image(decode_image(os.fspath(image), size))
        img = np.asarray(image)
        if img.shape != (*size, 3):
            raise ServeError(
                f"request image shape {img.shape} != expected {(*size, 3)} "
                "(pass a path to have the server decode+resize)"
            )
        if img.dtype == np.uint8:
            return img if raw else normalize_image(img.astype(np.float32) / 255.0)
        if raw:
            raise ServeError(
                "input_dtype='uint8' serving takes raw uint8 pixels or a "
                f"path, got dtype {img.dtype}"
            )
        return img  # float input: already normalized by contract

    # ------------------------------------------------------------- batch loop

    def _resolve(self, reqs, rows: list, good: list) -> None:
        """Collect each request's preprocessed row; a failed request fails
        its own future only."""
        for req in reqs:
            try:
                rows.append(req.payload.result())
                good.append(req)
            except Exception as e:  # noqa: BLE001 — typed to this caller
                if not isinstance(e, ServeError):
                    e = PreprocessError(
                        f"preprocess worker crashed on this request "
                        f"({type(e).__name__}: {e})"
                    )
                with self._lock:
                    self._stats["preprocess_failures"] += 1
                self._fail([req], e)

    def _warm_then_serve(self) -> None:
        try:
            self._exe.warmup()
        except BaseException as e:  # noqa: BLE001 — re-raised by __init__
            self._warm_error = e
            return
        finally:
            self._warm.set()
        self._batch_loop()

    def _batch_loop(self) -> None:
        while True:
            flush = self._batcher.next_flush()
            if flush is None:
                self._inflight.put(None)  # stops the completion loop too
                return
            if self._abandon:
                self._fail(flush, ServerClosedError("server closed without drain"))
                continue
            members = list(flush)
            try:
                rows: list[np.ndarray] = []
                good: list[PendingRequest] = []
                self._resolve(flush, rows, good)
                # Top up with what arrived while this flush was formed.
                extra = self._batcher.drain_ready(self.buckets[-1] - len(good))
                members += extra
                self._resolve(extra, rows, good)
                if not good:
                    continue
                exe = self._exe
                bucket = pick_bucket(len(good), self.buckets)
                images = self._bufpool.acquire(bucket, exe.image_dtype)
                for i, row in enumerate(rows):
                    np.copyto(images[i], row, casting="unsafe")
                # Filler rows are never answered; zeroed so a recycled
                # buffer's stale rows never reach the device.
                images[len(rows):] = 0
                labels = np.full((bucket,), -1, np.int32)
                preds = exe(bucket, exe.place(images, labels))
                done = None
                if preds.device.type == "cuda":
                    host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
                    host.copy_(preds, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(preds.device))
                    preds = host
                self._inflight.put(
                    _InFlight(requests=good, preds=preds, done=done, bucket=bucket, buffer=images)
                )
            except Exception as e:  # noqa: BLE001 — keep serving
                self._logger.error("serve batch loop error: %s", e)
                self._fail(members, e)

    def _completion_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            try:
                if item.done is not None:
                    item.done.synchronize()
                rows = item.preds.numpy().reshape(item.bucket, -1)
                n = len(item.requests)
                with self._lock:
                    self._stats["served"] += n
                    self._stats["batches"] += 1
                    self._stats["by_bucket"][item.bucket] += 1
                    self._stats["padded_rows"] += item.bucket - n
                self._bufpool.release(item.buffer)
                for i, req in enumerate(item.requests):
                    if not req.future.done():
                        req.future.set_result(rows[i].astype(np.int32, copy=True))
            except Exception as e:  # noqa: BLE001 — keep serving
                self._logger.error("serve completion loop error: %s", e)
                self._fail(item.requests, e)

    def _fail(self, requests, exc: BaseException) -> None:
        """Fail every request not already answered (or cancelled)."""
        failed = 0
        for req in requests:
            if not req.future.done():
                req.future.set_exception(exc)
                failed += 1
        with self._lock:
            self._stats["failed"] += failed

    # --------------------------------------------------------------- lifecycle

    def stats(self) -> dict:
        """Counters: served / failed / rejected requests, batches, padded
        rows, flushes per bucket, and the current queue depth."""
        with self._lock:
            out = dict(self._stats, by_bucket=dict(self._stats["by_bucket"]))
        out["queue_depth"] = self._batcher.qsize()
        out["topk"] = self.topk
        out["buckets"] = list(self.buckets)
        out["fused_head"] = self._exe.fused_head
        return out

    def close(self, drain: bool = True) -> None:
        """Stop admissions and shut down. ``drain=True`` (default) serves
        every queued request before returning; ``False`` fails them with
        ``ServerClosedError``. A second call is a no-op."""
        with self._lock:
            if self._close_started:
                return
            self._close_started = True
        if not drain:
            self._abandon = True
        self._batcher.close()
        self._batch_thread.join()
        self._completion_thread.join()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
