"""Elastic training (``mpi_pytorch_tpu/train/elastic.py``): resume across
world-size and layout changes, the preemption watchdog, bad-step rollback
and the in-process halves of the fault-injection gates.

- **Topology manifest** (:func:`topology_manifest`): every checkpoint is
  stamped with the writer's world shape (rank counts, the mesh's axes),
  the payload's schema and, for a ``--zero-opt-state`` run, the ZeRO
  ``[chunk, padded]`` layout of every optimizer tensor
  (``train/state.zero_shard_spec``), as the JSON sidecar
  ``checkpoint.write_manifest`` writes, so a restore knows what it
  reshards from without trusting the payload.
- **Reshard on load** (:func:`restore_latest`): the payload is always the
  gathered, unsharded layout (gather-on-save), so a checkpoint written in
  one layout loads into any other: each rank cuts its blocks and its
  ZeRO slices from the host tensors (``train/state.load_full_state_dict``,
  ``ZeroOptimizer.load_state_dict``). A corrupt newest checkpoint writes a
  ``kind="anomaly"`` record and falls back to the previous one; if every
  checkpoint fails, the resume raises instead of starting afresh over them.
- **Preemption watchdog** (:class:`PreemptionWatchdog`): SIGTERM/SIGINT
  (the trainer's ``PreemptionGuard``), the ``MPT_PREEMPT_FILE`` sentinel,
  the injected-preempt gate and repeated health signals (straggler beats,
  non-finite gradient norms) stop the run at the same safe boundary, each
  writing one ``kind="fault"`` record naming the reason.
- **Bounded retry with backoff** (:func:`with_retries`) around the resume
  side's mesh build and state placement (:func:`checked_place`).
- **Bad-step rollback** (:class:`RollbackPolicy`): when to restore the last
  good checkpoint in-process (the trainer restores).
- **Fault injection** (:class:`FaultInjector`, the ``MPT_FAULT_*`` gates
  of ``utils/env.py``): deterministic kills, preemptions, NaN batches and
  fake stragglers, so every recovery path above runs end to end.
"""

from __future__ import annotations

import math
import os
import signal
import time

import numpy as np
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.parallel.distributed import rank as process_index
from mpi_pytorch_tpu_torch.parallel.mesh import (
    Mesh,
    describe_topology,
    mesh_topology,
    zero_shard_axis,
)
from mpi_pytorch_tpu_torch.train.state import TrainState, ZeroOptimizer, zero_shard_spec
from mpi_pytorch_tpu_torch.utils.env import env_int, fault_countdown
from mpi_pytorch_tpu_torch.utils.logging import run_logger

MANIFEST_VERSION = 1
# A moment tensor over this many bytes names the resume's strategy
# "chunked-redistribute" (JAX's bounded-HBM cap).
_BOUNDED_LEAF_BYTES = 4 * 1024 * 1024
# The state tensors each torch optimizer keeps a parameter (its
# ``state_dict`` keys); Adam's ``step`` is a scalar, held whole.
_OPTIMIZER_STATE_KEYS = {
    torch.optim.Adam: ("step", "exp_avg", "exp_avg_sq"),
    torch.optim.AdamW: ("step", "exp_avg", "exp_avg_sq"),
    torch.optim.SGD: ("momentum_buffer",),
}


# ---------------------------------------------------------------------------
# Topology manifest
# ---------------------------------------------------------------------------


def zero_shard_layout(optimizer: ZeroOptimizer, n_shards: int) -> dict:
    """The ZeRO partition table for the manifest: ``state.{i}.{key}`` →
    ``[chunk, padded]`` (``zero_shard_spec`` of the tensor's whole shape),
    or None for a scalar — every state tensor the optimizer holds for
    parameter ``i``, whether or not it exists yet (Adam's are made at the
    first step)."""
    keys = _OPTIMIZER_STATE_KEYS[type(optimizer.inner)]
    layout = {}
    for i, shape in enumerate(optimizer.shapes):
        for key in keys:
            spec = None if key == "step" else zero_shard_spec(tuple(shape), n_shards)
            layout[f"state.{i}.{key}"] = None if spec is None else list(spec)
    return layout


def topology_manifest(mesh: Mesh, *, zero_opt_state: bool = False, spmd_mode: bool = False,
                      optimizer=None) -> dict:
    """The JSON stamp every checkpoint of this run carries: the world
    shape, the payload schema and, for a ``--zero-opt-state`` run, the
    shard count and (given its ``optimizer``) the per-tensor layout."""
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "payload_schema": ckpt.PAYLOAD_SCHEMA,
        **mesh_topology(mesh),
        "zero_opt_state": bool(zero_opt_state),
        "spmd_mode": bool(spmd_mode),
    }
    if zero_opt_state:
        # The ZeRO axis: the ici one on a nested mesh, as the optimizer
        # shards (parallel/mesh.zero_shard_axis).
        _, n_shards = zero_shard_axis(mesh)
        manifest["zero_shards"] = n_shards
        if optimizer is not None:
            manifest["zero_shard_layout"] = zero_shard_layout(optimizer, n_shards)
    return manifest


# ---------------------------------------------------------------------------
# Reshard-on-load restore with corruption fallback
# ---------------------------------------------------------------------------


def restore_latest(ckpt_dir: str, state: TrainState, mesh: Mesh, *, metrics=None,
                   logger=None, zero_shards_to: int = 0):
    """The newest LOADABLE checkpoint in ``ckpt_dir``, read and checked
    against ``state``'s layout, walking back past corrupt files (each one a
    ``kind="anomaly"`` ``corrupt_checkpoint`` record), and the
    ``kind="resume"`` record of the topology change.

    Returns ``(payload, epoch, loss, info)``, or None when there is no
    checkpoint (a fresh start); ``info`` holds the path, the writer's
    manifest (None without a sidecar) and the corrupt files skipped. The
    caller loads the payload into the state (:func:`checked_place`).
    ``zero_shards_to``: the ZeRO shard count the caller's optimizer holds
    (0: no ZeRO). Raises :class:`checkpoint.CheckpointCorruptError` when
    checkpoints exist and none loads."""
    log = logger or run_logger()
    corrupt = 0
    paths = ckpt.checkpoint_paths(ckpt_dir)
    for path in reversed(paths):
        try:
            payload, epoch, loss = ckpt.load_checkpoint(path, state)
        except ckpt.CheckpointCorruptError as e:
            corrupt += 1
            log.error("corrupt checkpoint %s (%s) — falling back to the previous one", path, e)
            if metrics is not None:
                file_epoch = ckpt.checkpoint_epoch(path)
                metrics.write({
                    "kind": "anomaly", "reason": "corrupt_checkpoint",
                    "epoch": file_epoch if file_epoch is not None else -1, "path": path,
                })
            continue
        manifest = ckpt.read_manifest(path)
        _write_resume_record(metrics, epoch, path, manifest, mesh, zero_shards_to, corrupt,
                             payload)
        if manifest is not None and manifest.get("payload_schema", 1) > ckpt.PAYLOAD_SCHEMA:
            log.warning(
                "checkpoint %s was written by a NEWER payload schema (%s > %s); "
                "restore proceeded but fields beyond this build's schema are lost",
                path, manifest.get("payload_schema"), ckpt.PAYLOAD_SCHEMA,
            )
        topo = mesh_topology(mesh)
        if manifest is None or manifest.get("mesh_shape") != topo["mesh_shape"]:
            log.info(
                "elastic resume: checkpoint topology %s → current %s (reshard-on-load%s)",
                describe_topology(manifest), describe_topology(topo),
                f"; ZeRO opt-state re-chunked to P={zero_shards_to}" if zero_shards_to else "",
            )
        return payload, epoch, loss, {"path": path, "manifest": manifest,
                                      "corrupt_skipped": corrupt}
    if corrupt:
        # Every file failing alike is the signature of a changed model or
        # optimizer config, not of damage on disk: starting afresh would
        # exit 0 and let retention delete the checkpoints. Abort instead.
        raise ckpt.CheckpointCorruptError(
            f"all {len(paths)} checkpoint(s) in {ckpt_dir} failed to "
            "restore — refusing to fresh-start over them (a changed "
            "model/optimizer config on resume fails exactly like this; "
            "fix the config, or clear the checkpoint dir / drop "
            "--from-checkpoint to deliberately start over)"
        )
    return None


def _write_resume_record(metrics, epoch: int, path: str, manifest: dict | None, mesh: Mesh,
                         zero_shards_to: int, corrupt: int, payload: dict) -> None:
    if metrics is None:
        return
    topo = mesh_topology(mesh)
    record: dict = {
        "kind": "resume",
        "epoch": epoch,
        "to_devices": topo["device_count"],
        "to_mesh": ",".join(f"{a}={s}" for a, s in topo["mesh_shape"].items()),
        "path": path,
        "corrupt_skipped": corrupt,
        "strategy": _reshard_strategy(payload, zero_shards_to),
    }
    if manifest is not None:
        record["from_devices"] = int(manifest.get("device_count", 0))
        record["from_mesh"] = ",".join(
            f"{a}={s}" for a, s in manifest.get("mesh_shape", {}).items())
        record["zero_shards_from"] = int(manifest.get("zero_shards", 0))
        cursor = manifest.get("data_cursor")
        if isinstance(cursor, dict):
            # The exact-step data cursor the writer stamped: where the run
            # continues if the trainer validates it.
            record["cursor_epoch"] = int(cursor.get("epoch", 0))
            record["cursor_step"] = int(cursor.get("step_in_epoch", 0))
    if zero_shards_to:
        record["zero_shards_to"] = int(zero_shards_to)
    metrics.write(record)


def _reshard_strategy(payload: dict, zero_shards_to: int) -> str:
    """How the restored moments are placed, in the JAX package's words:
    replicated (no ZeRO), or each rank cutting its slices from the host
    tensors one at a time — "host-reshard", or "chunked-redistribute" once
    any moment tensor exceeds the bounded-memory cap (4 MiB)."""
    if not zero_shards_to:
        return "replicate"
    big = any(
        torch.is_tensor(v) and v.numel() * v.element_size() > _BOUNDED_LEAF_BYTES
        for st in payload["optimizer"]["state"].values() for v in st.values()
    )
    return "chunked-redistribute" if big else "host-reshard"


# ---------------------------------------------------------------------------
# Bounded retry + backoff (resume side)
# ---------------------------------------------------------------------------


def with_retries(fn, *, what: str, retries: int = 3, backoff_s: float = 0.5, logger=None):
    """``fn()`` with up to ``retries`` retries on an Exception, sleeping
    ``backoff_s · 2^attempt`` between attempts; the last failure is raised
    unchanged."""
    log = logger or run_logger()
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            log.warning("%s failed (attempt %d/%d: %s) — retrying in %.1f s",
                        what, attempt + 1, retries + 1, e, delay)
            time.sleep(delay)


def checked_place(state: TrainState, payload: dict) -> None:
    """The resume side's state placement — the payload loaded into the
    placed state (``checkpoint.apply_checkpoint``: each rank's blocks and
    ZeRO slices onto its card) — behind the ``MPT_FAULT_DEVICE_PUT_N``
    gate. Idempotent, so :func:`with_retries` may repeat it."""
    if fault_countdown("MPT_FAULT_DEVICE_PUT_N"):
        raise RuntimeError("injected fault: device_put failed (MPT_FAULT_DEVICE_PUT_N)")
    ckpt.apply_checkpoint(payload, state)


# ---------------------------------------------------------------------------
# Preemption watchdog
# ---------------------------------------------------------------------------


class PreemptionWatchdog:
    """The trainer's one stop-signal poll: SIGTERM/SIGINT (the
    ``PreemptionGuard``), the ``MPT_PREEMPT_FILE`` sentinel, the
    injected-preempt gate, and repeated health signals (straggler-beat and
    non-finite-grad streaks), in that order. The first reason observed
    writes ONE ``kind="fault"`` record and latches; the trainer then stops
    at the next safe boundary as for a SIGTERM. A streak threshold of 0
    disables its trigger."""

    def __init__(self, guard, *, preempt_file: str = "", straggler_beats: int = 0,
                 nonfinite_steps: int = 0, heartbeat=None, health=None, metrics=None,
                 logger=None, injector=None):
        self.guard = guard
        self.preempt_file = preempt_file or os.environ.get("MPT_PREEMPT_FILE", "")
        self.straggler_beats = int(straggler_beats)
        self.nonfinite_steps = int(nonfinite_steps)
        self.heartbeat = heartbeat
        self.health = health
        self.metrics = metrics
        self.log = logger or run_logger()
        self.injector = injector
        self.fired_reason: str | None = None
        self.fired_detail: str = ""
        self.fired_streak: int | None = None

    def _poll(self) -> tuple[str, str, int | None] | None:
        if self.guard is not None and self.guard.triggered:
            return "sigterm", "preemption signal received", None
        if self.preempt_file and os.path.exists(self.preempt_file):
            return "preempt_file", f"sentinel {self.preempt_file} exists", None
        if self.injector is not None and self.injector.preempt_fired:
            return ("injected_preempt",
                    f"MPT_FAULT_PREEMPT_AT_STEP={self.injector.preempt_at_step}", None)
        streak = getattr(self.heartbeat, "straggler_streak", 0)
        if self.straggler_beats > 0 and self.heartbeat is not None \
                and streak >= self.straggler_beats:
            return "straggler_streak", f"{streak} consecutive straggler beats", streak
        streak = getattr(self.health, "nonfinite_grad_streak", 0)
        if self.nonfinite_steps > 0 and self.health is not None \
                and streak >= self.nonfinite_steps:
            return "nonfinite_grads", f"{streak} consecutive non-finite grad norms", streak
        return None

    def should_stop(self, epoch: int | None = None, step: int | None = None) -> bool:
        """Poll every trigger; on the first firing record, warn and latch."""
        if self.fired_reason is not None:
            return True
        hit = self._poll()
        if hit is None:
            return False
        self.fired_reason, self.fired_detail, self.fired_streak = hit
        record: dict = {"kind": "fault", "reason": self.fired_reason, "detail": self.fired_detail}
        if epoch is not None:
            record["epoch"] = epoch
        if step is not None:
            record["step"] = step
        if self.fired_streak is not None:
            record["streak"] = self.fired_streak
        if self.metrics is not None:
            self.metrics.write(record)
        self.log.warning(
            "preemption watchdog: %s (%s) — stopping at the next safe "
            "boundary, saving, and exiting cleanly for auto-resume",
            self.fired_reason, self.fired_detail,
        )
        return True


# ---------------------------------------------------------------------------
# Bad-step rollback policy (--bad-step-policy rollback)
# ---------------------------------------------------------------------------


class RollbackLimitError(RuntimeError):
    """A rollback was asked for past ``--max-rollbacks``, or with no
    checkpoint to restore: the run aborts with the ``kind="rollback"``
    trail in its metrics stream."""


class RollbackPolicy:
    """When ``--bad-step-policy rollback`` restores the last good
    checkpoint (the trainer restores, in-process). Both triggers read the
    globally reduced loss and gradient norm, so every rank reaches the
    same verdict at the same step:

    - ``nonfinite_steps`` consecutive steps with a non-finite loss or
      gradient norm;
    - ``loss_drift`` > 0: a loss over ``loss_drift`` × the mean of the
      first ``drift_warmup`` finite losses (the run's own baseline).
    """

    def __init__(self, *, nonfinite_steps: int = 2, loss_drift: float = 0.0,
                 drift_warmup: int = 5):
        self.nonfinite_steps = max(1, int(nonfinite_steps))
        self.loss_drift = float(loss_drift)
        self.drift_warmup = max(1, int(drift_warmup))
        self.nonfinite_streak = 0
        self.baseline: list[float] = []

    def observe(self, loss: float, grad_norm: float | None) -> str | None:
        """One step's host-read metrics → ``"nonfinite_streak"``,
        ``"loss_drift"`` or None."""
        finite = math.isfinite(loss) and (grad_norm is None or math.isfinite(grad_norm))
        if not finite:
            self.nonfinite_streak += 1
            if self.nonfinite_streak >= self.nonfinite_steps:
                return "nonfinite_streak"
            return None
        self.nonfinite_streak = 0
        if self.loss_drift > 0:
            if len(self.baseline) < self.drift_warmup:
                # The first observations are the baseline: the policy
                # judges once the run has defined its normal.
                self.baseline.append(loss)
                return None
            base = sum(self.baseline) / len(self.baseline)
            if base > 0 and loss / base > self.loss_drift:
                return "loss_drift"
        return None

    def after_rollback(self) -> None:
        """Re-arm after a restore: the streak resets; the warmup baseline
        stays (a rollback does not change the run's normal)."""
        self.nonfinite_streak = 0


# ---------------------------------------------------------------------------
# In-process fault injection
# ---------------------------------------------------------------------------


class FaultInjector:
    """Deterministic in-process chaos, armed by the ``MPT_FAULT_*`` gates
    (``utils/env.py FAULT_GATES``), inert otherwise:

    - ``MPT_FAULT_KILL_AT_STEP=n``: SIGKILL this process right after its
      n-th completed train step — a hard crash, the async checkpoint
      writer possibly mid-write;
    - ``MPT_FAULT_DELAY_STEP_MS=m`` (``MPT_FAULT_DELAY_PROCESS=k``,
      ``MPT_FAULT_DELAY_AFTER_STEP=j``): sleep m ms inside every timed step
      (on rank k only, if set; after the first j steps, if set) — a fake
      straggler;
    - ``MPT_FAULT_DCN_DELAY_MS=m``: the same on hierarchical
      (``--mesh-pods > 1``) runs only, a slow cross-pod link;
    - ``MPT_FAULT_NONFINITE_AT_STEP=n``: NaN-poison the n-th train batch
      (1-based, across epochs), announced with a ``kind="fault"`` record
      before the step runs; the streaming float-input path only (uint8
      cannot carry a NaN; the device cache feeds indices);
    - ``MPT_FAULT_PREEMPT_AT_STEP=n``: a preemption notice right after the
      n-th completed step, which the watchdog polls — a deterministic
      mid-epoch stop.
    """

    def __init__(self, metrics=None):
        self.kill_at_step = env_int("MPT_FAULT_KILL_AT_STEP", 0)
        self.delay_ms = env_int("MPT_FAULT_DELAY_STEP_MS", 0)
        self.delay_process = env_int("MPT_FAULT_DELAY_PROCESS", -1)
        self.delay_after = env_int("MPT_FAULT_DELAY_AFTER_STEP", 0)
        self.dcn_delay_ms = env_int("MPT_FAULT_DCN_DELAY_MS", 0)
        self.nonfinite_at_step = env_int("MPT_FAULT_NONFINITE_AT_STEP", 0)
        self.preempt_at_step = env_int("MPT_FAULT_PREEMPT_AT_STEP", 0)
        self.preempt_fired = False
        self.metrics = metrics
        self._steps = 0
        self._delay_calls = 0
        self._batches = 0

    @property
    def active(self) -> bool:
        return bool(self.kill_at_step or self.delay_ms or self.dcn_delay_ms
                    or self.nonfinite_at_step or self.preempt_at_step)

    def poison_batches(self, batches, epoch: int | None = None):
        """Wrap a host-batch iterator, NaN-poisoning the images of the
        armed batch (counted across epochs: the injector carries the count);
        the fault record comes before the poisoned batch."""
        for images, labels in batches:
            self._batches += 1
            if self._batches == self.nonfinite_at_step:
                if self.metrics is not None:
                    self.metrics.write({
                        "kind": "fault", "reason": "injected_nonfinite",
                        "detail": f"MPT_FAULT_NONFINITE_AT_STEP={self.nonfinite_at_step}",
                        **({"epoch": epoch} if epoch is not None else {}),
                    })
                run_logger().warning(
                    "fault injection: NaN-poisoning train batch %d "
                    "(MPT_FAULT_NONFINITE_AT_STEP)", self._batches,
                )
                images = np.full_like(images, np.nan)
            yield images, labels

    def after_step(self, epoch: int, step: int) -> None:
        """Count completed steps and fire the armed step-count gate: the
        preempt gate latches a flag; the kill gate writes its record and
        SIGKILLs — the crash, not a shutdown."""
        if not (self.kill_at_step or self.preempt_at_step):
            return
        self._steps += 1
        if self.preempt_at_step and not self.preempt_fired \
                and self._steps >= self.preempt_at_step:
            self.preempt_fired = True
            run_logger().warning(
                "fault injection: simulated preemption notice after train "
                "step %d (epoch %d step %d)", self._steps, epoch, step,
            )
        if not self.kill_at_step or self._steps < self.kill_at_step:
            return
        if self.metrics is not None:
            self.metrics.write({
                "kind": "fault", "reason": "injected_kill", "epoch": epoch, "step": step,
                "detail": f"MPT_FAULT_KILL_AT_STEP={self.kill_at_step}",
            })
        run_logger().warning("fault injection: SIGKILL at train step %d (epoch %d step %d)",
                             self._steps, epoch, step)
        os.kill(os.getpid(), signal.SIGKILL)

    def maybe_delay(self) -> None:
        """The straggler fake, inside the step's timed region."""
        if self.delay_ms <= 0:
            return
        self._delay_calls += 1
        if self._delay_calls <= self.delay_after:
            return
        if self.delay_process < 0 or process_index() == self.delay_process:
            time.sleep(self.delay_ms / 1e3)

    def maybe_dcn_delay(self, hierarchical: bool) -> None:
        """The slow cross-pod link fake: hierarchical runs only (a flat
        mesh has no cross-pod phase to slow down)."""
        if self.dcn_delay_ms <= 0 or not hierarchical:
            return
        time.sleep(self.dcn_delay_ms / 1e3)

