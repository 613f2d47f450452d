"""Checkpoint save and restore (``mpi_pytorch_tpu/checkpoint.py``).

One file per epoch, ``ckpt_{epoch:05d}.pt``, holding ``{epoch, step, loss,
model, optimizer, generator}`` (the model's and the optimizer's
``state_dict``, the generator's state). It is written atomically — to a
temporary file, then ``os.replace`` — so a crash mid-write never corrupts
the resume path; the last ``keep`` checkpoints are kept, and
:func:`latest_checkpoint` resolves the newest for ``from_checkpoint``.
``best.json`` (``{epoch, accuracy, checkpoint}``, written by the trainer's
``track_best``) names the best-validation checkpoint, which retention never
deletes and ``evaluate --use-best`` loads; :func:`load_for_eval` reads a
checkpoint's model weights alone. The converter to and from the JAX
package's msgpack checkpoints and the topology sidecar are not ported yet.

Under data parallelism every rank calls the writers at the same point:
rank 0 alone writes the checkpoint, ``best.json`` and the retention
(the JAX package's process-0 writes), and a barrier follows, so no rank
reads a file before it is there. Every rank restores.

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
"""

from __future__ import annotations

import json
import os
import re

import torch

from mpi_pytorch_tpu_torch.parallel import distributed
from mpi_pytorch_tpu_torch.train.state import TrainState, full_state_dict, load_full_state_dict

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")
_BEST = "best.json"


def _ckpt_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{epoch:05d}.pt")


def checkpoint_epoch(path: str) -> int | None:
    """The epoch a checkpoint file is filed under, from its name."""
    m = _CKPT_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def checkpoint_paths(ckpt_dir: str) -> list[str]:
    """Every checkpoint in ``ckpt_dir``, oldest → newest."""
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
    the one ``best.json`` names, however old it is."""
    if keep <= 0:
        return
    best = best_marker(ckpt_dir)
    pinned = os.path.basename(best["checkpoint"]) if best else None
    for path in checkpoint_paths(ckpt_dir)[:-keep]:
        if os.path.basename(path) != pinned:
            os.remove(path)


def best_marker(ckpt_dir: str) -> dict | None:
    """``best.json`` (``{epoch, accuracy, checkpoint}``), if present."""
    path = os.path.join(ckpt_dir, _BEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_best_marker(ckpt_dir: str, *, epoch: int, accuracy: float, ckpt_path: str) -> None:
    """Point ``best.json`` at ``ckpt_path`` atomically (the file name only,
    so the directory can move); rank 0 writes, every rank waits for it."""
    if distributed.rank() == 0:
        path = os.path.join(ckpt_dir, _BEST)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "accuracy": accuracy,
                       "checkpoint": os.path.basename(ckpt_path)}, f)
        os.replace(tmp, path)
    distributed.barrier()


def save_checkpoint(
    ckpt_dir: str, *, epoch: int, state: TrainState, loss: float, keep: int = 3
) -> str:
    """Write epoch ``epoch``'s checkpoint atomically (rank 0; every rank
    waits for it) and apply retention; returns its path on every rank."""
    path = _ckpt_path(ckpt_dir, epoch)
    # Every rank: the gathers of a sharded model and optimizer.
    model = full_state_dict(state.model, state.placement)
    optimizer = state.optimizer.state_dict()
    if distributed.rank() == 0:
        _write(ckpt_dir, path, epoch, state, loss, keep, model, optimizer)
    distributed.barrier()
    return path


def _write(ckpt_dir: str, path: str, epoch: int, state: TrainState, loss: float,
           keep: int, model: dict, optimizer: dict) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "epoch": epoch,
        "step": state.step,
        "loss": float(loss),
        "model": model,
        "optimizer": optimizer,
        "generator": None if state.generator is None else state.generator.get_state(),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    _cleanup(ckpt_dir, keep)


def restore_checkpoint(path: str, state: TrainState) -> tuple[int, float]:
    """Load ``path`` into ``state`` (model, optimizer, step, generator) in
    place, onto the model's device, each rank keeping its blocks of a
    placed state; returns ``(epoch, loss)``."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    load_full_state_dict(state.model, state.placement, payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if state.generator is not None and payload["generator"] is not None:
        state.generator.set_state(payload["generator"].cpu())
    return int(payload["epoch"]), float(payload["loss"])


def load_for_eval(path: str) -> tuple[dict[str, torch.Tensor], int, float]:
    """``(model state_dict, epoch, loss)`` of ``path`` on the CPU — the
    weights alone, no optimizer moments — for ``evaluate.build_inference``
    to load into the f32 model before it casts to the compute dtype."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["model"], int(payload["epoch"]), float(payload["loss"])
