"""Checkpoint save and restore (``mpi_pytorch_tpu/checkpoint.py``).

One file per epoch, ``ckpt_{epoch:05d}.pt``, holding ``{epoch, step, loss,
model, optimizer, generator}`` (the model's and the optimizer's
``state_dict``, the generator's state). It is written atomically — to a
temporary file, then ``os.replace`` — so a crash mid-write never corrupts
the resume path (a ``.tmp`` left by a kill is never a checkpoint); the
last ``keep`` checkpoints are kept, and :func:`latest_checkpoint` resolves
the newest. ``best.json`` (``{epoch, accuracy, checkpoint}``, written by
the trainer's ``track_best``) names the best-validation checkpoint, which
retention never deletes and ``evaluate --use-best`` loads;
:func:`load_for_eval` reads a checkpoint's model weights alone.

Two sidecars share a checkpoint's life, and retention removes them with
it: the topology manifest ``<ckpt>.manifest.json`` (:func:`write_manifest`:
the writer's world shape, ZeRO layout and exact-step data cursor,
``train/elastic.topology_manifest``), written atomically BEFORE the
payload's rename, so a loadable payload always has its manifest; and the
``.dirty`` marker, written after the rename when the state carries a
partial epoch's updates (a mid-epoch preemption save) and cleared by a
clean overwrite. A file that exists but does not load — truncated, garbage
bytes, a missing key — raises :class:`CheckpointCorruptError`, which
``train/elastic.restore_latest`` walks back past; an ``OSError`` or
``MemoryError`` is the caller's and is raised unchanged.

:class:`AsyncCheckpointer` is the trainer's writer: the snapshot — every
tensor copied to the host — is taken on the caller's thread, so the next
step's in-place update cannot reach it, and a worker thread serializes
and writes it. With ``moments_bf16`` (``--ckpt-bf16-moments``) the large
f32 optimizer moments are stored in bf16 and cast back to f32 on restore.

Under data parallelism every rank calls the writers at the same point:
rank 0 alone writes the checkpoint, its sidecars, ``best.json`` and the
retention (the JAX package's process-0 writes). The synchronous writers
end in a barrier, so no rank reads a file before it is there; the async
one's callers drain it and meet at a barrier where another rank reads
(``AsyncCheckpointer.drain``). Every rank restores.

Gather-on-save (JAX ``trainer._saveable``, ``checkpoint._gather_to_host``):
every rank takes the model's and the optimizer's state before rank 0
writes, since for a sharded run each is a collective. The auto step's
placed model (``train/state.place_model``) gathers the TP head's blocks
over the model axis and the FSDP parameters over the data axis
(``train/state.full_state_dict``), and a sharded optimizer
(``train/state.ZeroOptimizer``: ZeRO-1 and spmd ZeRO moments, and the
moments that follow FSDP and TP blocks) its moments; each large tensor is
gathered and moved to the host alone, so a rank's card holds one
gathered tensor at a time. So a sharded run writes the file an unsharded
run writes, and any file loads into any layout and lever set, at any
world size (``train/state.load_full_state_dict``).

The converter to and from the JAX package's msgpack checkpoints is not
ported yet.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

import torch

from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.train.state import TrainState, full_state_dict, load_full_state_dict
from mpi_pytorch_tpu_torch.utils.logging import run_logger

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")
_BEST = "best.json"
# The payload layout's version, stamped into the topology sidecar.
PAYLOAD_SCHEMA = 1
# Sidecars that ride a checkpoint and share its lifecycle.
_SIDECARS = (".dirty", ".manifest.json")
_PAYLOAD_KEYS = ("epoch", "step", "loss", "model", "optimizer", "generator")
# Optimizer-state tensors of at least this many elements are stored in
# bf16 under moments_bf16; scalars (Adam's step) stay exact.
_MOMENT_CAST_MIN_SIZE = 4096


class CheckpointCorruptError(RuntimeError):
    """The checkpoint file exists but cannot be restored (a truncated
    write, garbage bytes, or a payload that no longer matches the state).
    ``train/elastic.restore_latest`` falls back to the previous one."""


def _ckpt_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{epoch:05d}.pt")


def checkpoint_epoch(path: str) -> int | None:
    """The epoch a checkpoint file is filed under, from its name."""
    m = _CKPT_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def checkpoint_paths(ckpt_dir: str) -> list[str]:
    """Every checkpoint in ``ckpt_dir``, oldest → newest (an elastic
    restore walks them newest first)."""
    if not os.path.isdir(ckpt_dir):
        return []
    ckpts = sorted(
        (int(m.group(1)), name) for name in os.listdir(ckpt_dir) if (m := _CKPT_RE.search(name))
    )
    return [os.path.join(ckpt_dir, name) for _, name in ckpts]


def latest_checkpoint(ckpt_dir: str) -> str | None:
    paths = checkpoint_paths(ckpt_dir)
    return paths[-1] if paths else None


def _cleanup(ckpt_dir: str, keep: int) -> None:
    """Keep the newest ``keep`` checkpoints (``keep <= 0`` keeps all) and
    the one ``best.json`` names, however old it is; a removed checkpoint's
    sidecars go with it."""
    if keep <= 0:
        return
    best = best_marker(ckpt_dir)
    pinned = os.path.basename(best["checkpoint"]) if best else None
    for path in checkpoint_paths(ckpt_dir)[:-keep]:
        if os.path.basename(path) != pinned:
            os.remove(path)
            for suffix in _SIDECARS:
                if os.path.exists(path + suffix):
                    os.remove(path + suffix)


def best_marker(ckpt_dir: str) -> dict | None:
    """``best.json`` (``{epoch, accuracy, checkpoint}``), if present."""
    path = os.path.join(ckpt_dir, _BEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_best_file(ckpt_dir: str, *, epoch: int, accuracy: float, ckpt_path: str) -> None:
    """Point ``best.json`` at ``ckpt_path`` atomically (the file name
    only, so the directory can move). This process writes: the async
    writer's ``on_durable`` on rank 0."""
    path = os.path.join(ckpt_dir, _BEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": epoch, "accuracy": accuracy,
                   "checkpoint": os.path.basename(ckpt_path)}, f)
    os.replace(tmp, path)


def write_best_marker(ckpt_dir: str, *, epoch: int, accuracy: float, ckpt_path: str) -> None:
    """Point ``best.json`` at ``ckpt_path``: rank 0 writes, every rank
    waits for it."""
    if distributed.rank() == 0:
        write_best_file(ckpt_dir, epoch=epoch, accuracy=accuracy, ckpt_path=ckpt_path)
    distributed.barrier()


def write_manifest(ckpt_path: str, manifest: dict | None) -> None:
    """Atomically (re)write the topology sidecar of ``ckpt_path`` (None
    clears it: an overwrite by a manifest-less writer must not leave a
    stale topology next to a new payload)."""
    sidecar = ckpt_path + ".manifest.json"
    if manifest is None:
        if os.path.exists(sidecar):
            os.remove(sidecar)
        return
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, sidecar)


def read_manifest(ckpt_path: str) -> dict | None:
    """The topology sidecar of ``ckpt_path``, or None for a checkpoint
    without one (an unreadable sidecar too: the payload can still serve
    the resume)."""
    sidecar = ckpt_path + ".manifest.json"
    if not os.path.exists(sidecar):
        return None
    try:
        with open(sidecar) as f:
            return json.load(f)
    except (OSError, ValueError):
        run_logger().warning("unreadable checkpoint manifest %s (treating as legacy)", sidecar)
        return None


def _to_host(obj, cast_moments: bool = False):
    """``obj`` with every tensor copied to the host — a copy even of a
    host tensor, so a later in-place update of the live one cannot reach
    it; with ``cast_moments`` f32 tensors of at least
    ``_MOMENT_CAST_MIN_SIZE`` elements become bf16."""
    if torch.is_tensor(obj):
        t = obj.detach().to("cpu", copy=True)
        if cast_moments and t.dtype == torch.float32 and t.numel() >= _MOMENT_CAST_MIN_SIZE:
            t = t.to(torch.bfloat16)
        return t
    if isinstance(obj, dict):
        return {k: _to_host(v, cast_moments) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v, cast_moments) for v in obj]
    return obj


def snapshot(state: TrainState, *, moments_bf16: bool = False) -> dict | None:
    """The state's checkpoint content on the host — ``{step, model,
    optimizer, generator}``, every tensor a copy — on rank 0, None on the
    others. Every rank calls it: a sharded model's and optimizer's
    ``state_dict`` are collectives."""
    model = full_state_dict(state.model, state.placement)
    optimizer = state.optimizer.state_dict()
    if distributed.rank() != 0:
        return None
    return {
        "step": state.step,
        "model": _to_host(model),
        "optimizer": _to_host(optimizer, cast_moments=moments_bf16),
        "generator": None if state.generator is None else state.generator.get_state(),
    }


def _write(ckpt_dir: str, path: str, payload: dict, keep: int, dirty: bool = False,
                  manifest: dict | None = None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    # The sidecar before the payload's rename: a loadable payload always
    # has its manifest (a crash in between leaves an orphan sidecar, which
    # the next save of that epoch overwrites).
    write_manifest(path, manifest)
    os.replace(tmp, path)
    # Dirty: the state carries a partial epoch's updates beyond the epoch
    # it is filed under. After the rename, so a marker never outlives a
    # failed write; a clean overwrite of the same epoch clears it.
    marker = path + ".dirty"
    if dirty:
        with open(marker, "w") as f:
            f.write("partial-epoch state: resume replays the interrupted epoch\n")
    elif os.path.exists(marker):
        os.remove(marker)
    _cleanup(ckpt_dir, keep)


def _payload(snap: dict, epoch: int, loss: float) -> dict:
    return {"epoch": epoch, "loss": float(loss), **snap}


def save_checkpoint(
    ckpt_dir: str, *, epoch: int, state: TrainState, loss: float, keep: int = 3,
    dirty: bool = False, manifest: dict | None = None, moments_bf16: bool = False,
) -> str:
    """Write epoch ``epoch``'s checkpoint now (rank 0; every rank waits
    for it) with its sidecars, and apply retention; returns its path on
    every rank. The trainer uses :class:`AsyncCheckpointer`; this writer
    keeps the JAX package's public name and call for a caller that writes
    one checkpoint and reads it at once (a test, a script's rank), where
    a worker thread would only add a wait."""
    path = _ckpt_path(ckpt_dir, epoch)
    snap = snapshot(state, moments_bf16=moments_bf16)
    if snap is not None:
        _write(ckpt_dir, path, _payload(snap, epoch, loss), keep, dirty, manifest)
    distributed.barrier()
    return path


class AsyncCheckpointer:
    """The snapshot on the caller's thread, the write on a worker thread.

    :meth:`save` waits for the previous write, takes the snapshot (every
    rank: gathers; rank 0: a host copy of each tensor, so the training
    loop may update the live tensors in place at once) and starts the
    worker on rank 0, which writes the payload and its sidecars
    atomically, applies retention and then calls ``on_durable(path)``.
    :meth:`wait` joins the worker and raises its error on the caller's
    thread: a failed write fails the run. :meth:`drain` also meets the
    other ranks, for a point where another rank reads the file."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # Each write's seconds on the worker (what the loop did not wait for).
        self.write_s: list[float] = []

    def save(self, ckpt_dir: str, *, epoch: int, state: TrainState, loss: float,
             keep: int = 3, on_durable=None, dirty: bool = False,
             moments_bf16: bool = False, manifest: dict | None = None) -> str:
        """Snapshot now, write in the background; returns the path that
        exists once the write lands (on every rank). Every rank calls it."""
        self.wait()
        path = _ckpt_path(ckpt_dir, epoch)
        snap = snapshot(state, moments_bf16=moments_bf16)
        if snap is None:
            return path
        payload = _payload(snap, epoch, loss)

        def worker() -> None:
            try:
                t0 = time.perf_counter()
                _write(ckpt_dir, path, payload, keep, dirty, manifest)
                self.write_s.append(time.perf_counter() - t0)
                if on_durable is not None:
                    # After the rename: what the callback publishes (the
                    # best.json marker) never names a file not there yet.
                    on_durable(path)
            except BaseException as e:  # raised by the next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=worker, name="async-checkpoint", daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Block until the write in flight (if any) has landed; raise a
        writer error on the caller's thread."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def drain(self) -> None:
        """:meth:`wait`, then a barrier: every rank sees rank 0's files."""
        self.wait()
        distributed.barrier()


def _expected_keys(state: TrainState) -> list[str]:
    if state.placement is not None:
        return list(state.placement.state_keys)
    return list(state.model.state_dict())


def load_checkpoint(path: str, state: TrainState) -> tuple[dict, int, float]:
    """``(payload, epoch, loss)`` of ``path``, read on the CPU and checked
    against ``state``'s layout (its model keys), the state untouched —
    :func:`apply_checkpoint` loads it. A payload that does not load
    raises :class:`CheckpointCorruptError`; bf16 moments come back as f32
    (the parameters' dtype). A DIRTY checkpoint is announced."""
    if os.path.exists(path + ".dirty"):
        epoch = checkpoint_epoch(path)
        run_logger().warning(
            "resuming from a DIRTY checkpoint (%s): it was saved after a "
            "mid-epoch preemption, so the state already carries part of epoch "
            "%s+1's updates. When the saved data cursor validates, the "
            "trainer continues EXACTLY at the interrupted step (no replayed "
            "updates); otherwise that epoch is replayed, double-applying "
            "those batches' steps (trajectory may differ from an "
            "uninterrupted run)",
            path, "the filed epoch" if epoch is None else epoch,
        )
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        missing = [k for k in _PAYLOAD_KEYS if k not in payload]
        if missing:
            raise KeyError(f"payload lacks {missing}")
        if set(payload["model"]) != set(_expected_keys(state)):
            raise KeyError(f"model keys differ from the state's: "
                           f"{sorted(set(payload['model']) ^ set(_expected_keys(state)))}")
        for st in payload["optimizer"]["state"].values():
            for k, v in st.items():
                if torch.is_tensor(v) and v.dtype == torch.bfloat16:
                    st[k] = v.float()
        epoch, loss = int(payload["epoch"]), float(payload["loss"])
    except OSError:
        raise  # a vanished file is the caller's, not corruption
    except MemoryError:
        # Host memory pressure, not damage on disk: an older checkpoint
        # would fail the same way after discarding good progress.
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed to restore ({type(e).__name__}: {e})"
        ) from e
    return payload, epoch, loss


def apply_checkpoint(payload: dict, state: TrainState) -> None:
    """Load a :func:`load_checkpoint` payload into ``state`` in place
    (model, optimizer, step, generator), onto the model's device, each
    rank keeping its blocks of a placed state."""
    load_full_state_dict(state.model, state.placement, payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if state.generator is not None and payload["generator"] is not None:
        state.generator.set_state(payload["generator"].cpu())


def restore_checkpoint(path: str, state: TrainState) -> tuple[int, float]:
    """Load ``path`` into ``state`` in place; returns ``(epoch, loss)``."""
    payload, epoch, loss = load_checkpoint(path, state)
    apply_checkpoint(payload, state)
    return epoch, loss


def load_for_eval(path: str) -> tuple[dict[str, torch.Tensor], int, float]:
    """``(model state_dict, epoch, loss)`` of ``path`` on the CPU — the
    weights alone, no optimizer moments — for ``evaluate.build_inference``
    to load into the f32 model before it casts to the compute dtype."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["model"], int(payload["epoch"]), float(payload["loss"])
