"""The trainer (``mpi_pytorch_tpu/train/trainer.py``), one process per
GPU.

Stage by stage, as the JAX trainer (and the reference ``main.py:49-189``):
manifests (``load_manifests``) → this rank's shard of the train manifest
→ ``DataLoader`` → model and optimizer (``create_model_bundle`` +
``make_optimizer``) → ``from_checkpoint`` resume → rank 0's parameters on
every rank (``sync_params``) → the epoch loop of train steps → one
checkpoint per epoch (rank 0 writes) → sharded validation (and, with
``track_best``, ``best.json`` naming the best epoch's checkpoint).

Data parallelism: under ``torchrun --nproc-per-node N`` each rank takes
``np.array_split`` shard ``rank`` of the train manifest and
``batch_size // N`` rows a step (``batch_size`` is the global batch, as in
the JAX package); every rank runs the same number of steps
(:func:`global_step_count`, :func:`synchronized_batches`), and the step
syncs them (``train/step.py``: auto mode, or ``spmd_mode``). Logs and
metrics files are rank 0's. One process is the world of one.

The rank layout (``parallel.mesh.create_mesh``) is made before the
model. Under ``--mesh.model-parallel`` it is (data, model): each rank
loads the rows of its data index — ``np.array_split`` shard ``d`` of
``dp`` and ``batch_size // dp`` rows a step — so the ranks of a model
group load the same rows, and validation is sharded over the data axis
the same way.

spmd mode's levers (``--zero-opt-state``, ``--grad-sync-buckets``,
``--mesh-pods``): the ZeRO optimizer shards over the mesh's ZeRO axis,
and the step syncs over it (``make_spmd_train_step``). The log names the
bucket plan at the start; after the run's first step, the ledger's bytes
of that step (``collectives.LEDGER``, reset just before it) and each
rank's moment MB go into the log and into one ``grad_sync`` metrics
record.

The auto step's levers (``--mesh.model-parallel``, ``--zero-optimizer``,
``--fsdp``, ``--accum-steps``): the model is laid out on the mesh
(``train/state.place_model``) before its optimizer is made, and the step
runs over the mesh's data axis with ``accum_steps`` microbatches
(``make_train_step``). After the run's first step the log and one
``placement`` metrics record give the mesh shape, the ZeRO and FSDP
shard counts and this rank's parameter and moment MB.

The device cache (``--device-cache``): the train split decoded once into
device memory, each rank holding a contiguous 1/N of its rows
(:func:`build_device_cache`), and each step gathering its batch by index
(``train/step.py`` ``make_cached_train_step``) in the order of
:func:`cached_index_batches`; with ``--scan-epoch`` the host reads no
step's metrics until the epoch ends (``make_scanned_epoch``); with
``val_on_train`` validation comes from the cache too
(:func:`evaluate_cached`).

Robust training (``train/elastic.py``; JAX ``_train_impl``): every
checkpoint carries the topology sidecar with the exact-step data cursor
(:func:`data_cursor`) and is written by ``checkpoint.AsyncCheckpointer``
every ``checkpoint_every_epochs``; ``from_checkpoint`` resumes through
``elastic.restore_latest`` (walking back past corrupt files, resharding
onto this run's layout, the mesh build and the placement retried with
backoff) and continues at the cursor's step when :func:`validate_cursor`
accepts it, replaying the epoch otherwise. ``PreemptionGuard`` and the
watchdog (SIGTERM, the sentinel file, the straggler and non-finite
streaks, the injected gates) stop the run at a safe boundary — the next
step in a world of one, the next epoch, agreed by every rank
(:func:`_stop_agreed`), in a larger one — and save what it would lose;
``bad_step_policy="rollback"`` restores the last good checkpoint
in-process. ``obs/health.py`` and ``obs/heartbeat.py`` write the per-step
and heartbeat records. The host cache and the rest of the run telemetry
of the JAX trainer (its tracer, live registry, SLO monitor and flight
recorder) are not ported yet.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.data.manifest import Manifest, load_manifests, manifest_fingerprint
from mpi_pytorch_tpu_torch.data.pipeline import DataLoader, epoch_order
from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.obs.health import NonFiniteLossError, StepHealth
from mpi_pytorch_tpu_torch.obs.heartbeat import Heartbeat
from mpi_pytorch_tpu_torch.ops._build import launch_counts
from mpi_pytorch_tpu_torch.parallel import collectives, distributed
from mpi_pytorch_tpu_torch.parallel.mesh import (
    Axis,
    Mesh,
    create_mesh,
    data_axis,
    data_coords,
    is_hierarchical,
    pod_shape,
    zero_shard_axis,
)
from mpi_pytorch_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    moment_bytes,
    place_model,
    placed_bytes,
    sync_state,
)
from mpi_pytorch_tpu_torch.train.step import (
    COMPUTE_DTYPES,
    bucket_overlap_frac,
    grad_bucket_plan,
    make_cached_eval_step,
    make_cached_train_step,
    make_eval_step,
    make_scanned_epoch,
    make_spmd_train_step,
    make_train_step,
    synced_params,
)
from mpi_pytorch_tpu_torch.train import elastic
from mpi_pytorch_tpu_torch.utils.logging import MetricsWriter, init_logger

@dataclass
class TrainSummary:
    epochs_run: int = 0
    final_loss: float = float("nan")
    val_accuracy: float | None = None
    epoch_times: list = field(default_factory=list)
    images_per_sec: float = 0.0
    checkpoint_path: str | None = None
    epoch_losses: list = field(default_factory=list)
    # Every step's loss in run order (skipped steps included, as NaN).
    step_losses: list = field(default_factory=list)
    best_accuracy: float | None = None  # track_best: best val acc this run
    cache_build_s: float | None = None  # device_cache: seconds to build it
    preempted: bool = False  # stopped by the watchdog, progress saved


class PreemptionGuard:
    """Graceful SIGTERM/SIGINT: the FIRST signal only sets a flag the
    train loop polls (through the watchdog), so the run stops at the next
    safe boundary, saves what it would lose, drains the checkpoint writer
    and returns with ``summary.preempted`` (exit code 0). A SECOND signal
    restores the previous handler and re-raises — the escape hatch if the
    drain itself wedges. Installed only from the main thread (Python allows
    ``signal.signal`` nowhere else); elsewhere it is inert."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self) -> None:
        self.triggered = False
        self._previous: dict[int, Any] = {}

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handle(self, signum, frame) -> None:
        if self.triggered:  # the second signal: the original behavior
            prev = self._previous.get(signum)
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self.triggered = True


def _global_max(value: float, device: torch.device) -> float:
    """The max of every rank's ``value`` (one process: itself) — the one
    all-reduce the host-side decisions that gate a collective go through."""
    if distributed.world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float32, device=device)
    return float(collectives.all_reduce(t, "max")[0])


def _stop_agreed(stop: bool, device: torch.device) -> bool:
    """The epoch-boundary stop: every rank stops or none does (a rank that
    stops alone leaves the others waiting in the next collective).
    ``stop`` is this rank's watchdog verdict."""
    return _global_max(1.0 if stop else 0.0, device) > 0.0


def data_cursor(cfg: Config, fingerprint: str, n_steps: int, next_epoch: int,
                step_in_epoch: int) -> dict:
    """The exact-step resume cursor stamped into every checkpoint's
    sidecar: where the run continues — ``(epoch, step_in_epoch)`` of the
    deterministic global walk — and what must still hold for that offset
    to mean the same samples: the shuffle (seed, shuffle), the global batch
    and the epoch's step count, the rank count (each rank's shard derives
    from it) and the global train manifest's fingerprint.
    :func:`validate_cursor` checks each field."""
    return {
        "epoch": int(next_epoch),
        "step_in_epoch": int(step_in_epoch),
        "seed": int(cfg.seed),
        "shuffle": bool(cfg.shuffle),
        "global_batch": int(cfg.batch_size),
        "drop_remainder": bool(cfg.drop_remainder),
        "processes": int(distributed.world_size()),
        "steps_per_epoch": int(n_steps),
        "manifest_fingerprint": fingerprint,
    }


def validate_cursor(cursor, *, cfg: Config, fingerprint: str, n_steps: int,
                    start_epoch: int) -> tuple[int, str | None]:
    """``(start_step, None)`` when ``cursor`` still describes this run's
    walk, else ``(0, why)``: the caller records why and replays the epoch,
    never misaligning silently."""
    if not isinstance(cursor, dict):
        return 0, "no data cursor in the checkpoint's topology manifest"
    expected = {
        "epoch": start_epoch,
        "seed": int(cfg.seed),
        "shuffle": bool(cfg.shuffle),
        "global_batch": int(cfg.batch_size),
        "drop_remainder": bool(cfg.drop_remainder),
        "processes": int(distributed.world_size()),
        "steps_per_epoch": int(n_steps),
        "manifest_fingerprint": fingerprint,
    }
    for key, want in expected.items():
        got = cursor.get(key)
        if got != want:
            return 0, f"cursor {key}={got!r} != current {want!r}"
    step = int(cursor.get("step_in_epoch", 0))
    if not 0 <= step < max(n_steps, 1):
        return 0, f"cursor step_in_epoch={step} outside 0..{n_steps - 1}"
    if step and cfg.scan_epoch:
        # A scanned epoch runs whole: it never stops mid-way itself, and a
        # partial one is replayed.
        return 0, "mid-epoch cursor with scan_epoch=True (scan is all-or-nothing)"
    return step, None


def pad_batch(images: np.ndarray, labels: np.ndarray, target: int):
    """Pad a tail batch to ``target`` rows: the padding rows repeat real rows
    (batchnorm statistics span them, and zero rows would skew them) with
    label −1, which the loss and metrics mask out."""
    pad = target - images.shape[0]
    if pad <= 0:
        return images, labels
    images = np.concatenate([images, _cyclic_fill(images, pad)])
    labels = np.concatenate([labels, np.full(pad, -1, labels.dtype)])
    return images, labels


def _cyclic_fill(images: np.ndarray, n: int) -> np.ndarray:
    """``n`` rows repeating ``images`` cyclically (zeros only when there
    are no rows at all)."""
    if images.shape[0] == 0:
        return np.zeros((n, *images.shape[1:]), images.dtype)
    return images[np.resize(np.arange(images.shape[0]), n)]


def global_step_count(total_examples: int, host_batch: int, drop_remainder: bool,
                      shards: int | None = None) -> int:
    """Steps EVERY rank runs per epoch over ``total_examples`` split into
    ``shards`` ``np.array_split`` shards (one a data index; the world size
    by default) in batches of ``host_batch``: a rank running one step more
    than its peers would hang the collective. With ``drop_remainder`` the
    smallest shard's count (larger shards truncate); without, the largest
    shard's (exhausted shards feed all-padding batches)."""
    procs = shards or distributed.world_size()
    if drop_remainder:
        return (total_examples // procs) // host_batch
    largest = -(-total_examples // procs)
    return -(-largest // host_batch)


def synchronized_batches(loader: DataLoader, epoch: int, n_steps: int, start_step: int = 0):
    """Exactly ``n_steps - start_step`` (images, labels) batches from
    ``loader`` — steps ``start_step..n_steps-1`` of the epoch — padding with
    filler batches once the rank's shard is exhausted and truncating any
    surplus, so every rank runs the same number of steps.

    Filler batches repeat the images of the last REAL batch with every
    label −1: the loss masks them, but batchnorm statistics span whatever
    images the step sees, so filler is real image content, not zeros."""
    it = iter(loader.epoch(epoch, start_batch=start_step))
    all_pad = np.full((loader.batch_size,), -1, np.int32)
    last_images = None
    try:
        for _ in range(start_step, n_steps):
            batch = next(it, None)
            if batch is not None:
                last_images = batch[0]
                yield batch
            else:
                if last_images is None:  # an empty shard: no real rows exist
                    last_images = np.zeros((0, *loader.image_size, 3), loader.image_dtype)
                yield _cyclic_fill(last_images, loader.batch_size), all_pad
    finally:
        it.close()  # stops the producer thread on truncation


def to_device(images: np.ndarray, labels: np.ndarray, device: torch.device):
    """A host batch on ``device``: through pinned memory, so the copy to a
    card is queued without blocking the host."""
    img, lbl = torch.from_numpy(images), torch.from_numpy(labels.astype(np.int32, copy=False))
    if device.type == "cuda":
        img, lbl = img.pin_memory(), lbl.pin_memory()
    return img.to(device, non_blocking=True), lbl.to(device, non_blocking=True)


def host_batch(cfg: Config) -> int:
    """This rank's rows a step: the global ``batch_size`` over the data
    axis (``validate_world`` checks that it divides)."""
    return cfg.batch_size // data_coords(cfg.mesh.model_parallel)[0]


def validate_world(cfg: Config) -> None:
    """Raise unless the configuration fits the world (the JAX trainer's
    checks): the layout fits the rank count (``MeshConfig.check_world``),
    the global batch divides by the data axis, and with ``accum_steps``
    so does each microbatch."""
    world = distributed.world_size()
    cfg.mesh.check_world(world)
    dp = cfg.mesh.data_size(world)
    if cfg.batch_size % dp:
        raise ValueError(
            f"global batch {cfg.batch_size} not divisible by data-parallel size {dp}; "
            "sharding the batch over the 'data' axis requires even division"
        )
    if cfg.accum_steps > 1 and (cfg.batch_size // cfg.accum_steps) % dp:
        raise ValueError(
            f"microbatch {cfg.batch_size}/{cfg.accum_steps} not divisible by "
            f"data-parallel size {dp}"
        )


def cached_index_batches(
    cfg: Config, n: int, batch: int, epoch: int, n_steps: int,
    shuffle: bool | None = None, start_step: int = 0,
):
    """Steps ``start_step..n_steps-1`` of an epoch over the device cache,
    as (idx [batch] int32, valid [batch] bool) — JAX
    ``cached_index_batches``. The order is ``epoch_order(seed, epoch)``,
    the loader's, so a cached run and a streaming one walk the rows alike;
    a short tail is filled cyclically from its own rows (the
    ``pad_batch`` policy) with ``valid=False``. ``shuffle=False`` is the
    ordered walk of validation."""
    order = epoch_order(cfg.seed, epoch, n, cfg.shuffle if shuffle is None else shuffle)
    for step_i in range(start_step, n_steps):
        idx = order[step_i * batch:(step_i + 1) * batch]
        valid = np.ones(len(idx), bool)
        pad = batch - len(idx)
        if pad > 0:
            fill = np.resize(idx, pad) if len(idx) else np.zeros(pad, order.dtype)
            idx = np.concatenate([idx, fill])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        yield idx.astype(np.int32), valid


def epoch_indices(cfg: Config, n: int, epoch: int, n_steps: int, device: torch.device,
                  shuffle: bool | None = None):
    """The epoch's :func:`cached_index_batches` over the global batch
    (``cfg.batch_size``) as ``[n_steps, B]`` int32 and bool tensors on
    ``device``: one copy an epoch."""
    steps = list(cached_index_batches(cfg, n, cfg.batch_size, epoch, n_steps, shuffle))
    idx = np.array([i for i, _ in steps], np.int32).reshape(-1, cfg.batch_size)
    valid = np.array([v for _, v in steps], bool).reshape(-1, cfg.batch_size)
    return torch.from_numpy(idx).to(device), torch.from_numpy(valid).to(device)


def build_device_cache(cfg: Config, manifest: Manifest, loader: DataLoader,
                       device: torch.device):
    """(dataset, labels): the train split on ``device`` — JAX
    ``build_device_cache``. ``manifest`` is the GLOBAL train manifest, so
    global row i is cache row i on every rank. Its rows are split into
    contiguous ranges, one a data index (the ranks of a model group hold
    the same range): the row count is padded up to a multiple of the data
    size and data index d holds rows ``[d·P, (d+1)·P)``, P = ⌈n / dp⌉;
    padding rows (zeros) sit past the real count and are never indexed.
    One rank holds every row. Each rank decodes its own range once, in
    order (shuffle and drop_remainder off), in the loader's dtype
    (normalized f32 or raw uint8), into one tensor on ``device``. The
    labels stay real-length and are replicated: int32 [n] on every
    rank."""
    parts, index = data_coords(cfg.mesh.model_parallel)
    n = len(manifest)
    per = -(-n // parts)
    lo, hi = index * per, min((index + 1) * per, n)
    local = np.zeros((per, *loader.image_size, 3), loader.image_dtype)
    if hi > lo:
        ordered = DataLoader(
            manifest.select(np.arange(lo, hi)), batch_size=loader.batch_size,
            image_size=loader.image_size, shuffle=False, drop_remainder=False,
            synthetic=loader.synthetic, num_workers=loader.num_workers,
            prefetch=loader.prefetch, image_dtype=str(loader.image_dtype),
        )
        row = 0
        for images, _ in ordered.epoch(0):
            local[row:row + len(images)] = images
            row += len(images)
        if row != hi - lo:
            raise RuntimeError(f"device cache: decoded {row} rows of {hi - lo}")
    dataset = torch.from_numpy(local).to(device)
    labels = torch.from_numpy(manifest.labels.astype(np.int32)).to(device)
    return dataset, labels


def make_loader(cfg: Config, manifest: Manifest, *, train: bool) -> DataLoader:
    """The train loader (shuffled, ``drop_remainder`` as configured) or an
    eval loader (in order, every row) over ``manifest`` — this rank's
    shard — in batches of :func:`host_batch` rows."""
    return DataLoader(
        manifest,
        batch_size=host_batch(cfg),
        image_size=(cfg.height, cfg.width),
        shuffle=cfg.shuffle if train else False,
        seed=cfg.seed,
        drop_remainder=cfg.drop_remainder if train else False,
        synthetic=cfg.synthetic_data,
        num_workers=cfg.loader_workers,
        prefetch=cfg.prefetch_batches,
        image_dtype=cfg.input_dtype,
    )


def make_eval_loader(cfg: Config, manifest: Manifest) -> DataLoader:
    """The validation/evaluation loader over this rank's shard of
    ``manifest`` (its data index's)."""
    shard = manifest.shard(*data_coords(cfg.mesh.model_parallel))
    return make_loader(cfg, shard, train=False)


def auto_levers(cfg: Config) -> bool:
    """Whether the auto step's state is laid out on the mesh
    (``train/state.place_model``): a model axis, ZeRO-1 or FSDP."""
    return not cfg.spmd_mode and (cfg.mesh.model_parallel > 1 or cfg.zero_optimizer
                                  or cfg.fsdp)


def build_training(cfg: Config, device: torch.device, mesh: Mesh | None = None):
    """(state, (train_manifest, test_manifest, train_loader)): the model
    with seeded weights prepared for training on ``device`` (its
    batchnorms over the global batch — over ``mesh``'s data axis — in auto
    mode, or with ``sync_batchnorm``), laid out on ``mesh`` with the auto
    step's levers (``place_model``), its optimizer and schedule over the
    run's total step count (with ``zero_opt_state``, sharded over
    ``mesh``'s ZeRO axis), and the loader over this rank's shard of the
    train manifest (its data index's). ``mesh`` defaults to the layout of
    ``cfg.mesh``."""
    cfg.validate_config()
    validate_world(cfg)
    mesh = mesh or create_mesh(cfg.mesh)
    zero_axis = zero_shard_axis(mesh)[0] if cfg.zero_opt_state else None
    train_manifest, test_manifest = load_manifests(cfg)
    # Per-data-index shard ≙ the reference's rank-0 scatter (main.py:84-91).
    shard = train_manifest.shard(*data_coords(cfg.mesh.model_parallel))
    loader = make_loader(cfg, shard, train=True)
    bundle = create_model_bundle(
        cfg.model_name, cfg.num_classes, cfg.feature_extract,
        seed=cfg.seed, image_size=cfg.image_size, fused_stem=cfg.fused_stem,
        attn_impl=cfg.attn_impl, qkv_fused=cfg.qkv_fused,
    )
    model = prepare_for_training(bundle.model, device)
    set_batchnorm_sync(model, not cfg.spmd_mode or cfg.sync_batchnorm,
                       data_axis(mesh) if mesh.model.size > 1 else None)
    placement = (place_model(model, mesh, fsdp=cfg.fsdp, zero=cfg.zero_optimizer)
                 if auto_levers(cfg) else None)
    total_steps = (
        global_step_count(len(train_manifest), host_batch(cfg), cfg.drop_remainder,
                          data_coords(cfg.mesh.model_parallel)[0])
        * cfg.num_epochs
    )
    optimizer, schedule = make_optimizer(
        model, cfg.learning_rate, bundle.trainable_mask,
        optimizer=cfg.optimizer, lr_schedule=cfg.lr_schedule,
        warmup_steps=cfg.warmup_steps, total_steps=total_steps,
        weight_decay=cfg.weight_decay, zero_axis=zero_axis, placement=placement,
    )
    state = TrainState(
        model=model, optimizer=optimizer, schedule=schedule,
        generator=torch.Generator(device=device).manual_seed(cfg.seed + 1),
        placement=placement, rng_seed=cfg.seed + 1,
    )
    return state, (train_manifest, test_manifest, loader)


def evaluate_manifest(
    cfg: Config, model: torch.nn.Module, manifest: Manifest, loader: DataLoader | None = None,
    data: Axis | None = None,
) -> tuple[float, float]:
    """Batched eval over ``manifest`` → (accuracy, mean loss), sharded over
    the data axis ``data`` (the world by default; ≙ the reference's rank-0
    validation loop, ``main.py:173-185``, using every rank): each rank
    walks its data index's shard (``loader``, from :func:`make_eval_loader`
    to reuse one across epochs) in the same number of batches, each padded
    to :func:`host_batch` rows (label −1 rows count nowhere), and the sums
    are all-reduced over the data axis once at the end. The model runs in
    eval mode and returns to the mode it was in."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(COMPUTE_DTYPES[cfg.compute_dtype])
    loader = loader or make_eval_loader(cfg, manifest)
    n_steps = global_step_count(len(manifest), host_batch(cfg), drop_remainder=False,
                                shards=data_coords(cfg.mesh.model_parallel)[0])
    correct = total = 0
    loss_sum = 0.0
    was_training = model.training
    model.eval()
    try:
        for images, labels in synchronized_batches(loader, 0, n_steps):
            images, labels = pad_batch(images, labels, host_batch(cfg))
            m = eval_step(model, *to_device(images, labels, device))
            correct += int(m["correct"])
            total += int(m["count"])
            loss_sum += float(m["loss"])
    finally:
        model.train(was_training)
    sums = collectives.all_reduce(
        torch.tensor([correct, total, loss_sum], dtype=torch.float64, device=device), "sum", data)
    correct, total, loss_sum = int(sums[0]), int(sums[1]), float(sums[2])
    if total == 0:
        return 0.0, float("nan")
    return correct / total, loss_sum / total


def evaluate_cached(cfg: Config, model: torch.nn.Module, dataset: torch.Tensor,
                    labels: torch.Tensor, data: Axis | None = None) -> tuple[float, float]:
    """(accuracy, mean loss) over the device cache — JAX
    ``evaluate_cached``: :func:`evaluate_manifest`'s accounting, with no
    decode and no host→device copy of pixels. The rows are walked in
    order in global batches (``cfg.batch_size``, the tail filled and
    masked), each rank evaluating its slice; ``correct``, ``count`` and
    the loss are summed on the device in float64 (as the streaming path
    sums on the host), all-reduced and read once at the end. The real row
    count is the labels' (the cache's rows carry the data axis's padding). The rows
    and the sums go over the data axis ``data`` (the world by default)."""
    device = dataset.device
    eval_step = make_cached_eval_step(COMPUTE_DTYPES[cfg.compute_dtype], data)
    n = int(labels.shape[0])
    idx_all, valid_all = epoch_indices(cfg, n, 0, -(-n // cfg.batch_size), device, shuffle=False)
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    was_training = model.training
    model.eval()
    try:
        for idx, valid in zip(idx_all, valid_all):
            m = eval_step(model, dataset, labels, idx, valid)
            sums += torch.stack([m[k].double() for k in ("correct", "count", "loss")])
    finally:
        model.train(was_training)
    correct, total, loss_sum = collectives.all_reduce(sums, "sum", data).tolist()
    if total == 0:
        return 0.0, float("nan")
    return int(correct) / int(total), loss_sum / total


def train(cfg: Config, device: str | torch.device | None = None) -> TrainSummary:
    """Train ``cfg.num_epochs`` epochs (from the latest loadable checkpoint
    with ``from_checkpoint``) on ``device`` (default: this rank's card,
    ``distributed.rank_device``); see the module docstring. Joins the
    world the environment describes first (torchrun's). On a card, cuDNN
    picks its algorithms by measuring (``torch.backends.cudnn.benchmark``):
    every step has the same shapes."""
    dev = distributed.rank_device(device)
    distributed.maybe_initialize_distributed(dev)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    logger = init_logger("MPT", cfg.log_file)
    metrics = MetricsWriter(cfg.metrics_file)
    # Run telemetry (obs/), inert unless its knobs are set. Under a
    # bad-step policy the policy answers a non-finite step, not the
    # sentinel's abort.
    health = StepHealth(metrics, step_metrics=cfg.step_metrics,
                        nan_sentinel=cfg.nan_sentinel and cfg.bad_step_policy == "abort")
    heartbeat = Heartbeat(metrics, every_steps=cfg.heartbeat_every_steps,
                          threshold=cfg.straggler_threshold, batch_images=cfg.batch_size)
    if heartbeat.enabled and cfg.device_cache and cfg.scan_epoch:
        logger.warning(
            "heartbeat_every_steps=%d has no effect with scan_epoch=True "
            "(the epoch is one device-side scan; no per-step host "
            "boundaries to exchange step times at)", cfg.heartbeat_every_steps,
        )
        heartbeat.enabled = False
    try:
        return _train(cfg, dev, logger, metrics, health, heartbeat)
    finally:
        metrics.close()


def _log_bucket_plan(cfg: Config, state: TrainState, mesh: Mesh, logger) -> dict:
    """The bucket plan's line (JAX ``trainer.py``'s words) and its numbers
    for the ``grad_sync`` record."""
    params = synced_params(state.model)
    plan = grad_bucket_plan(params, cfg.grad_sync_buckets)
    overlap = bucket_overlap_frac(params, plan)
    logger.info(
        "grad-sync buckets: %d × ~%.0f MiB (reverse-topo issue order), "
        "%.0f%% of sync bytes overlap-eligible%s%s",
        len(plan), cfg.grad_sync_buckets, 100.0 * overlap,
        ", reduce-scatter (ZeRO slices)" if cfg.zero_opt_state else "",
        ", two-phase ICI/DCN (per-bucket cross-pod stage overlapped)"
        if is_hierarchical(mesh) else "",
    )
    return {"buckets": len(plan), "overlap_frac": overlap}


def _log_grad_sync(cfg: Config, state: TrainState, mesh: Mesh, logger, metrics: MetricsWriter,
                   plan: dict, epoch: int, step_i: int) -> None:
    """After the run's first step: its ledger bytes (the ledger was reset
    just before it), the ZeRO shards and this rank's moment MB, in the log
    and in one ``grad_sync`` metrics record."""
    traffic = collectives.LEDGER.snapshot()
    record = {
        "kind": "grad_sync", "epoch": epoch, "step": step_i,
        "ici_bytes_per_step": traffic["ici"]["bytes"],
        "dcn_bytes_per_step": traffic["dcn"]["bytes"],
        "ici_by_op": traffic["ici"]["by_op"], "dcn_by_op": traffic["dcn"]["by_op"],
        "moment_mb_per_rank": moment_bytes(state.optimizer) / 1e6, **plan,
    }
    hier = is_hierarchical(mesh)
    if cfg.zero_opt_state:
        axis, record["zero_shards"] = zero_shard_axis(mesh)
        logger.info(
            "ZeRO opt-state sharding: moments partitioned 1/%d over '%s'%s (%.1f MB/rank)",
            axis.size, axis.name,
            " (within-pod: the param all_gather never crosses the DCN)" if hier else "",
            record["moment_mb_per_rank"],
        )
    if hier:
        pods, ici = pod_shape(mesh)
        logger.info(
            "hierarchical sync (%d pod(s) × %d ici): %.2f MB/step ICI, %.3f MB/step DCN per "
            "rank (cross-pod payload 1/%d of the gradient)",
            pods, ici, traffic["ici"]["bytes"] / 1e6, traffic["dcn"]["bytes"] / 1e6, ici,
        )
    else:
        logger.info("gradient sync: %.2f MB/step per rank (ledger)", traffic["ici"]["bytes"] / 1e6)
    metrics.write(record)


def _log_placement(cfg: Config, state: TrainState, mesh: Mesh, logger,
                   metrics: MetricsWriter, epoch: int, step_i: int) -> None:
    """After the run's first step (the moments exist): the mesh shape, the
    ZeRO and FSDP shard counts and this rank's parameter and moment MB, in
    the log and in one ``placement`` metrics record."""
    param_b, moment_b = placed_bytes(state)
    dp = data_axis(mesh).size
    record = {
        "kind": "placement", "epoch": epoch, "step": step_i,
        "mesh": {"data": dp, "model": mesh.model.size},
        "zero_shards": dp if cfg.zero_optimizer else 1, "fsdp_shards": dp if cfg.fsdp else 1,
        "accum_steps": cfg.accum_steps,
        "param_mb_per_rank": param_b / 1e6, "moment_mb_per_rank": moment_b / 1e6,
    }
    logger.info(
        "placement: mesh data %d × model %d%s%s%s; %.2f MB parameters, %.2f MB moments a rank",
        dp, mesh.model.size,
        ", TP head (classes split 1/%d over 'model')" % mesh.model.size
        if mesh.model.size > 1 else "",
        f", ZeRO-1 moments 1/{dp} over 'data'" if cfg.zero_optimizer else "",
        f", FSDP parameters 1/{dp} over 'data'" if cfg.fsdp else "",
        record["param_mb_per_rank"], record["moment_mb_per_rank"],
    )
    metrics.write(record)


def _cursor_start(cfg: Config, info: dict, *, fingerprint: str, n_steps: int, epoch: int,
                  metrics: MetricsWriter, logger, rollback: bool = False) -> int:
    """The step a resumed (or rolled-back) run continues epoch ``epoch``
    at: the restored checkpoint's data cursor when it validates, else 0 —
    a ``kind="anomaly"`` ``cursor_mismatch`` record where the checkpoint
    had a cursor or was dirty (JAX ``trainer.py:1078-1100``)."""
    cursor = (info.get("manifest") or {}).get("data_cursor")
    dirty = os.path.exists(info["path"] + ".dirty")
    step, why = validate_cursor(cursor, cfg=cfg, fingerprint=fingerprint, n_steps=n_steps,
                                start_epoch=epoch)
    if why is not None and (cursor is not None or dirty):
        metrics.write({"kind": "anomaly", "reason": "cursor_mismatch", "epoch": epoch,
                       "detail": why})
        if rollback:
            logger.warning("rollback cursor unavailable (%s) — replaying epoch %d from step 0",
                           why, epoch)
        else:
            logger.warning(
                "exact-step resume unavailable (%s) — replaying epoch %d from step 0%s",
                why, epoch, " (DIRTY checkpoint: the replay double-applies the partial "
                "epoch's updates)" if dirty else "",
            )
    elif step and not rollback:
        logger.info(
            "exact-step resume: continuing epoch %d at step %d (fast-forwarding %d "
            "consumed batch(es) without decoding)", epoch, step, step,
        )
    return step


@dataclass
class _Run:
    """The epoch loop's state (the JAX ``_train_impl``'s locals) and the
    parts of the loop that read or move it: a save with its sidecar, the
    in-process rollback, a step's bookkeeping and the preemption save.
    The cursor (``epoch``, ``next_start_step``: an exact-step resume
    enters its first epoch mid-way, a rollback jumps back) rewinds with
    ``last_completed_epoch`` and ``last_saved_epoch``."""

    cfg: Config
    state: TrainState
    mesh: Mesh
    logger: Any
    metrics: MetricsWriter
    health: StepHealth
    summary: TrainSummary
    fingerprint: str
    n_steps: int
    zero_shards_to: int
    topology: dict
    rollback_policy: elastic.RollbackPolicy | None
    start_epoch: int
    epoch: int
    next_start_step: int
    # A lambda: this module loads while ``checkpoint`` is still loading.
    checkpointer: ckpt.AsyncCheckpointer = field(default_factory=lambda: ckpt.AsyncCheckpointer())
    last_completed_epoch: int = -1
    last_saved_epoch: int = -1
    epoch_loss: float = float("nan")
    rollbacks_done: int = 0
    # Consecutive skipped steps, carried across epochs as the JAX trainer
    # carries them, and the run's total.
    skip_streak: int = 0
    steps_skipped_total: int = 0
    # The epoch's kept steps: their losses and valid-row counts.
    losses: list = field(default_factory=list)
    counts: list = field(default_factory=list)

    def save(self, at_epoch: int, loss: float, cursor: tuple[int, int], *,
             dirty: bool = False, on_durable=None) -> str:
        """Dispatch epoch ``at_epoch``'s checkpoint with the topology
        sidecar and ``cursor`` — (the epoch, the step) the run continues
        at — as its data cursor."""
        cfg = self.cfg
        t_save = time.perf_counter()
        path = self.checkpointer.save(
            cfg.checkpoint_dir, epoch=at_epoch, state=self.state, loss=loss,
            keep=cfg.keep_checkpoints, on_durable=on_durable, dirty=dirty,
            moments_bf16=cfg.ckpt_bf16_moments,
            manifest=dict(self.topology, data_cursor=data_cursor(
                cfg, self.fingerprint, self.n_steps, *cursor)),
        )
        self.summary.checkpoint_path = path
        self.logger.info("checkpoint dispatched: %s (%.2f s stall%s)", path,
                         time.perf_counter() - t_save, ", dirty" if dirty else "")
        return path

    def rollback(self, at_epoch: int, at_step: int, reason: str) -> None:
        """``--bad-step-policy rollback``: drain the writer, restore the
        newest loadable checkpoint in-process (``restore_latest`` and the
        placement, as a restart would), scale the learning rate by
        ``rollback_lr_backoff``, and move the cursor to the restored one.
        Every rank calls it at the same step: the trigger reads globally
        reduced values."""
        cfg, metrics = self.cfg, self.metrics
        self.checkpointer.drain()
        if self.rollbacks_done >= cfg.max_rollbacks:
            metrics.write({
                "kind": "anomaly", "reason": "rollback_limit", "epoch": at_epoch,
                "step": at_step,
                "detail": f"{self.rollbacks_done} rollbacks hit "
                          f"max_rollbacks={cfg.max_rollbacks}",
            })
            raise elastic.RollbackLimitError(
                f"bad-step rollback requested ({reason} at epoch {at_epoch} "
                f"step {at_step}) but {self.rollbacks_done} rollback(s) already "
                f"hit --max-rollbacks={cfg.max_rollbacks}; aborting — see "
                "the kind='rollback' trail in the metrics stream"
            )
        self.rollbacks_done += 1
        res = elastic.restore_latest(cfg.checkpoint_dir, self.state, self.mesh,
                                     metrics=metrics, logger=self.logger,
                                     zero_shards_to=self.zero_shards_to)
        if res is None:
            raise elastic.RollbackLimitError(
                f"bad-step rollback requested ({reason} at epoch {at_epoch} "
                f"step {at_step}) but no checkpoint exists in "
                f"{cfg.checkpoint_dir} to restore"
            )
        payload, ckpt_epoch, _, info = res
        elastic.with_retries(
            lambda: elastic.checked_place(self.state, payload),
            what="rollback state placement (device_put)", retries=cfg.resume_retries,
            backoff_s=cfg.resume_backoff_s, logger=self.logger)
        # The scale multiplies every rate the schedule gives from here on.
        self.state.lr_scale *= cfg.rollback_lr_backoff
        self.rollback_policy.after_rollback()
        # The epoch bookkeeping rewinds with the state.
        self.last_completed_epoch = self.last_saved_epoch = ckpt_epoch
        self.epoch = ckpt_epoch + 1
        self.next_start_step = _cursor_start(
            cfg, info, fingerprint=self.fingerprint, n_steps=self.n_steps, epoch=self.epoch,
            metrics=metrics, logger=self.logger, rollback=True)
        metrics.write({
            "kind": "rollback", "epoch": at_epoch, "step": at_step, "reason": reason,
            "restored_epoch": ckpt_epoch, "rollbacks": self.rollbacks_done,
            "lr_scale": round(self.state.lr_scale, 6), "path": info["path"],
        })
        self.logger.warning(
            "bad-step rollback #%d/%d (%s at epoch %d step %d): restored "
            "%s in-process, continuing at epoch %d step %d%s",
            self.rollbacks_done, cfg.max_rollbacks, reason, at_epoch, at_step,
            info["path"], self.epoch, self.next_start_step,
            f", LR scaled to {self.state.lr_scale:g}x" if cfg.rollback_lr_backoff != 1.0 else "",
        )

    def settle(self, step_i: int, m: dict, data_wait_s: float | None = None,
               step_s: float | None = None) -> None:
        """Step ``step_i`` of the current epoch read back: its record, the
        skip policy's streak, the sentinel, and the epoch's loss terms."""
        cfg, epoch = self.cfg, self.epoch
        skip = cfg.bad_step_policy == "skip"
        loss, count = float(m["loss"]), int(m["count"])
        grad_norm = float(m["grad_norm"])
        skipped = bool(m["skipped"]) if skip else False
        self.steps_skipped_total += int(skipped)
        self.summary.step_losses.append(loss)
        if self.health.enabled:
            self.health.on_step(epoch, step_i, {"loss": loss, "grad_norm": grad_norm},
                                data_wait_s, step_s,
                                skipped=int(skipped) if skip else None,
                                steps_skipped=self.steps_skipped_total if skip else None)
        else:
            record = {"kind": "step", "epoch": epoch, "step": step_i, "loss": loss,
                      "grad_norm": grad_norm}
            if skip:
                record["skipped"] = int(skipped)
            self.metrics.write(record)
        if skipped:
            self.skip_streak += 1
            self.logger.warning(
                "bad step skipped (non-finite update) at epoch %d step %d — "
                "state unchanged, %d consecutive", epoch, step_i, self.skip_streak,
            )
            if self.skip_streak >= cfg.max_skipped_steps:
                raise NonFiniteLossError(
                    f"{self.skip_streak} consecutive non-finite steps were skipped "
                    f"(epoch {epoch}) — hit max_skipped_steps={cfg.max_skipped_steps}"
                )
            return
        self.skip_streak = 0
        if self.rollback_policy is None and cfg.nan_sentinel \
                and not (np.isfinite(loss) and np.isfinite(grad_norm)):
            raise NonFiniteLossError(
                f"non-finite step at epoch {epoch} step {step_i}: loss {loss}, "
                f"grad_norm {grad_norm} (bad_step_policy=abort)"
            )
        self.losses.append(loss)
        self.counts.append(count)
        if cfg.log_every_steps and (step_i + 1) % cfg.log_every_steps == 0:
            self.logger.info("epoch %d step %d loss %.4f", epoch, step_i + 1, loss)

    def preemption_save(self, interrupted: tuple[int, int, int, int] | None) -> None:
        """Save what a preemption would lose (JAX ``trainer.py:1822-1896``):
        stopped mid-epoch after running steps (``interrupted``: the epoch,
        the next step, the steps run in it this session, its start step),
        the state DIRTY under the last completed epoch with the interrupted
        step's cursor (nothing when no epoch completed, or when that file is
        the one ``best.json`` pins: its integrity outranks the partial
        steps); stopped at an epoch boundary, the completed epochs not saved
        yet. A stop before any new step saves nothing: the checkpoint on
        disk already holds this state."""
        cfg, completed = self.cfg, self.last_completed_epoch
        best = ckpt.best_marker(cfg.checkpoint_dir) if cfg.track_best else None
        best_is_target = bool(
            best and completed >= 0
            and best.get("checkpoint") == os.path.basename(ckpt._ckpt_path(cfg.checkpoint_dir,
                                                                           completed)))
        if interrupted is not None and interrupted[2] > 0 and completed >= 0 \
                and not best_is_target:
            int_epoch, int_step, _, _ = interrupted
            path = self.save(completed, self.epoch_loss, (int_epoch, int_step), dirty=True)
            self.logger.info("preemption checkpoint dispatched: %s (dirty; cursor epoch %d "
                             "step %d)", path, int_epoch, int_step)
        elif (completed >= self.start_epoch and completed != self.last_saved_epoch
              and (interrupted is None or interrupted[3] == 0)):
            path = self.save(completed, self.epoch_loss, (completed + 1, 0))
            self.logger.info("preemption checkpoint dispatched: %s", path)


def _train(cfg: Config, dev: torch.device, logger, metrics: MetricsWriter, health: StepHealth,
           heartbeat: Heartbeat) -> TrainSummary:
    # The rank layout before the model: a nested or (data, model) one
    # makes its process groups collectively, and the levers shard over it.
    # On the resume side its build is retried with backoff: a transiently
    # wedged backend costs attempts, not the resume.
    if cfg.from_checkpoint:
        mesh = elastic.with_retries(
            lambda: create_mesh(cfg.mesh), what="backend init (mesh build)",
            retries=cfg.resume_retries, backoff_s=cfg.resume_backoff_s, logger=logger)
    else:
        mesh = create_mesh(cfg.mesh)
    state, (train_manifest, test_manifest, loader) = build_training(cfg, dev, mesh)
    world, rank = distributed.world_size(), distributed.rank()
    data = data_axis(mesh)
    logger.info(
        "model %s | %d classes | batch %d | %d train images | %s on %s",
        cfg.model_name, cfg.num_classes, cfg.batch_size, len(train_manifest),
        cfg.compute_dtype, dev,
    )
    layout = [*mesh.axes, mesh.model] if mesh.model.size > 1 else mesh.axes
    logger.info(
        "data-parallel world %d (process group backend %s), rank %d: %d-row shard, "
        "%d rows a step, %s mode%s%s", world, distributed.backend(), rank,
        len(loader.manifest), loader.batch_size,
        "spmd" if cfg.spmd_mode else "auto",
        f", {' × '.join(f'{a.name} {a.size}' for a in layout)}"
        if cfg.spmd_mode or mesh.model.size > 1 else "",
        f", {cfg.accum_steps} microbatches a step" if cfg.accum_steps > 1 else "",
    )
    # The exact-step cursor lives in the global walk's sample space: the
    # GLOBAL train manifest's fingerprint.
    fingerprint = manifest_fingerprint(train_manifest)
    summary = TrainSummary()
    # The ZeRO shard count of a --zero-opt-state run (the ici size on a
    # nested mesh), the resume record's zero_shards_to.
    zero_shards_to = zero_shard_axis(mesh)[1] if cfg.spmd_mode and cfg.zero_opt_state else 0
    start_epoch = 0
    resume_info = None
    if cfg.from_checkpoint:
        # The newest LOADABLE checkpoint (a corrupt one falls back to the
        # previous), resharded onto this layout, the placement retried.
        res = elastic.restore_latest(cfg.checkpoint_dir, state, mesh, metrics=metrics,
                                     logger=logger, zero_shards_to=zero_shards_to)
        if res is None:
            logger.info("from_checkpoint=True but no checkpoint found; fresh start")
        else:
            payload, epoch, last_loss, resume_info = res
            elastic.with_retries(
                lambda: elastic.checked_place(state, payload),
                what="state placement (device_put)", retries=cfg.resume_retries,
                backoff_s=cfg.resume_backoff_s, logger=logger)
            start_epoch = epoch + 1
            logger.info("resumed from %s (epoch %d, loss %.4f)", resume_info["path"],
                        start_epoch, last_loss)
    # Rank 0's parameters and buffers on every rank, fresh or resumed
    # (≙ the JAX trainer placing its state on the mesh).
    sync_state(state)

    # A resumed run never demotes a stored best: best.json outlives the run
    # (no marker: any first accuracy wins).
    best_accuracy = float("-inf")
    if cfg.track_best:
        marker = ckpt.best_marker(cfg.checkpoint_dir)
        if marker is not None:
            best_accuracy = marker["accuracy"]

    skip = cfg.bad_step_policy == "skip"
    dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    if cfg.device_cache:
        t_cache = time.perf_counter()
        dataset, labels_all = build_device_cache(cfg, train_manifest, loader, dev)
        summary.cache_build_s = time.perf_counter() - t_cache
        logger.info(
            "device cache: %d images, rows sharded over %d rank(s) (%.1f MB/rank %s), "
            "built in %.2f s", len(train_manifest), data.size,
            dataset.numel() * dataset.element_size() / 1e6, str(dataset.dtype).split(".")[-1],
            summary.cache_build_s,
        )
        # The global walk's step count: cached batches are global rows.
        n_cache = len(train_manifest)
        n_steps = n_cache // cfg.batch_size if cfg.drop_remainder else -(-n_cache // cfg.batch_size)
        train_step = make_cached_train_step(dtype, bad_step_skip=skip, mesh=mesh)
        epoch_fn = (make_scanned_epoch(dtype, bad_step_skip=skip, mesh=mesh)
                    if cfg.scan_epoch else None)
    else:
        if cfg.spmd_mode:
            train_step = make_spmd_train_step(
                dtype, bad_step_skip=skip, zero_opt_state=cfg.zero_opt_state,
                grad_bucket_mb=cfg.grad_sync_buckets, mesh=mesh)
        else:
            train_step = make_train_step(dtype, bad_step_skip=skip, mesh=mesh,
                                         accum_steps=cfg.accum_steps)
        epoch_fn = None
        n_steps = global_step_count(len(train_manifest), loader.batch_size, cfg.drop_remainder,
                                    data.size)
    # Exact-step resume: the restored cursor, validated against this walk.
    start_step = 0
    if resume_info is not None:
        start_step = _cursor_start(cfg, resume_info, fingerprint=fingerprint, n_steps=n_steps,
                                   epoch=start_epoch, metrics=metrics, logger=logger)
    plan = (_log_bucket_plan(cfg, state, mesh, logger)
            if cfg.spmd_mode and cfg.grad_sync_buckets > 0 else {})
    if heartbeat.enabled and heartbeat.every > n_steps:
        logger.warning(
            "heartbeat_every_steps=%d exceeds the %d step(s) per epoch — no "
            "heartbeat will ever fire (beats never span epoch boundaries); "
            "lower it to at most the per-epoch step count", heartbeat.every, n_steps,
        )
    # The first step's collective traffic is read from the ledger (spmd);
    # the placement is logged after it (the auto levers).
    ledger_pending = cfg.spmd_mode
    placement_pending = auto_levers(cfg)
    val_loader = None
    total_images = 0
    total_time = 0.0
    # The guard stays installed through the preemption save and the final
    # drain: a first signal then is absorbed, a second one falls through.
    guard = PreemptionGuard()
    faults = elastic.FaultInjector(metrics=metrics)
    if faults.active:
        logger.warning(
            "fault injection armed: kill_at_step=%d delay_step_ms=%d "
            "dcn_delay_ms=%d nonfinite_at_step=%d preempt_at_step=%d "
            "(MPT_FAULT_* gates)", faults.kill_at_step, faults.delay_ms,
            faults.dcn_delay_ms, faults.nonfinite_at_step, faults.preempt_at_step,
        )
    poison = bool(faults.nonfinite_at_step) and not cfg.device_cache \
        and loader.image_dtype != np.uint8
    if faults.nonfinite_at_step and not poison:
        logger.warning(
            "MPT_FAULT_NONFINITE_AT_STEP has no effect on this run: the "
            "gate NaN-poisons streaming float batches, and this run feeds "
            "%s", "device-cache indices" if cfg.device_cache else "uint8 pixels",
        )
    hier = is_hierarchical(mesh)
    if faults.dcn_delay_ms and not hier:
        logger.warning(
            "MPT_FAULT_DCN_DELAY_MS has no effect on this run: a flat mesh "
            "has no cross-pod phase to slow down (set --mesh-pods > 1)"
        )
    watchdog = elastic.PreemptionWatchdog(
        guard, preempt_file=cfg.preempt_file, straggler_beats=cfg.preempt_straggler_beats,
        nonfinite_steps=cfg.preempt_nonfinite_steps, heartbeat=heartbeat, health=health,
        metrics=metrics, logger=logger, injector=faults,
    )
    if cfg.bad_step_policy != "abort":
        logger.info(
            "bad-step policy '%s': the NaN sentinel's hard abort is "
            "replaced by the policy (per-step host sync enabled to observe "
            "loss/grad norm)", cfg.bad_step_policy,
        )
    rollback_policy = (
        elastic.RollbackPolicy(nonfinite_steps=cfg.rollback_nonfinite_steps,
                               loss_drift=cfg.rollback_loss_drift,
                               drift_warmup=cfg.rollback_drift_warmup)
        if cfg.bad_step_policy == "rollback" else None
    )
    # The per-step telemetry and the rollback read each step's values as
    # it completes (one host sync a step); otherwise a step's metrics are
    # read one step late, so the host queues step i+1 before waiting.
    sync_each = health.enabled or heartbeat.enabled or rollback_policy is not None
    run = _Run(
        cfg=cfg, state=state, mesh=mesh, logger=logger, metrics=metrics, health=health,
        summary=summary, fingerprint=fingerprint, n_steps=n_steps,
        zero_shards_to=zero_shards_to, rollback_policy=rollback_policy,
        # The topology stamp of every checkpoint this run writes.
        topology=elastic.topology_manifest(
            mesh, zero_opt_state=bool(zero_shards_to), spmd_mode=cfg.spmd_mode,
            optimizer=state.optimizer if zero_shards_to else None),
        start_epoch=start_epoch, epoch=start_epoch, next_start_step=start_step,
        last_completed_epoch=start_epoch - 1,
    )
    checkpointer = run.checkpointer
    # (epoch, next step, steps run in it this session, its start step) of
    # a mid-epoch stop.
    interrupted = None
    with guard:
        try:
            while run.epoch < cfg.num_epochs:
                epoch = run.epoch
                if _stop_agreed(watchdog.should_stop(epoch=epoch), dev):
                    summary.preempted = True
                    logger.info(
                        "preemption signal: stopping before epoch %d "
                        "(progress saved; auto-resume continues from the latest "
                        "checkpoint)", epoch,
                    )
                    break
                start_step_this, run.next_start_step = run.next_start_step, 0
                t0 = time.perf_counter()
                launches0 = launch_counts()
                heartbeat.start_epoch()  # beats never span epoch boundaries
                run.losses, run.counts = [], []
                rollback_trigger = None
                stopped_mid_epoch = False
                if cfg.device_cache:
                    idx_all, valid_all = epoch_indices(cfg, n_cache, epoch, n_steps, dev)
                if epoch_fn is not None:
                    # The scanned epoch: the whole epoch queued, its [n_steps]
                    # metrics read once, then checked and recorded step by step
                    # as the per-step path would have (JAX: trainer.py:1440-1500);
                    # a cursor never enters it mid-way (validate_cursor).
                    if n_steps:
                        arrays = epoch_fn(state, dataset, labels_all, idx_all, valid_all)
                        if placement_pending:
                            placement_pending = False
                            _log_placement(cfg, state, mesh, logger, metrics, epoch, 0)
                        host = {k: v.tolist() for k, v in arrays.items()}
                        for step_i in range(n_steps):
                            run.settle(step_i, {k: v[step_i] for k, v in host.items()})
                else:
                    if cfg.device_cache:
                        step_args = ((dataset, labels_all, i, v) for i, v in
                                     zip(idx_all[start_step_this:], valid_all[start_step_this:]))
                    else:
                        batches = synchronized_batches(loader, epoch, n_steps,
                                                       start_step=start_step_this)
                        if poison:
                            batches = faults.poison_batches(batches, epoch)
                        step_args = (to_device(*pad_batch(images, labels, loader.batch_size), dev)
                                     for images, labels in batches)
                    pending = None
                    step_i = start_step_this - 1
                    try:
                        while True:
                            t_ingest = time.perf_counter()
                            args = next(step_args, None)
                            if args is None:
                                break
                            data_wait_s = time.perf_counter() - t_ingest
                            step_i += 1
                            # A world of one stops at this step boundary; a
                            # larger one only at the agreed epoch boundary (a
                            # rank breaking alone would strand the others).
                            if watchdog.should_stop(epoch=epoch, step=step_i) and world == 1:
                                stopped_mid_epoch = True
                                break
                            if ledger_pending:
                                collectives.LEDGER.reset()
                            t_step = time.perf_counter()
                            m = train_step(state, *args)
                            if sync_each and dev.type == "cuda":
                                torch.cuda.synchronize(dev)
                            # Inside the timed region: a faked straggler's
                            # delay lands in the step time the heartbeat reads.
                            faults.maybe_delay()
                            faults.maybe_dcn_delay(hier)
                            step_s = time.perf_counter() - t_step
                            if ledger_pending:
                                ledger_pending = False
                                _log_grad_sync(cfg, state, mesh, logger, metrics, plan, epoch,
                                               step_i)
                            if placement_pending:
                                placement_pending = False
                                _log_placement(cfg, state, mesh, logger, metrics, epoch, step_i)
                            if sync_each:
                                run.settle(step_i, m, data_wait_s, step_s)
                                heartbeat.on_step(epoch, step_i, step_s)
                                if rollback_policy is not None:
                                    reason = rollback_policy.observe(float(m["loss"]),
                                                                     float(m["grad_norm"]))
                                    if reason is not None:
                                        rollback_trigger = (reason, step_i)
                                        break
                            else:
                                if pending is not None:
                                    run.settle(*pending)
                                pending = (step_i, m)
                            faults.after_step(epoch, step_i)
                    finally:
                        step_args.close()  # stops the loader's producer thread
                    if pending is not None:
                        run.settle(*pending)
                if rollback_trigger is not None:
                    # Restore the last good checkpoint in-process and jump the
                    # cursor back to it; the partial epoch's bookkeeping goes
                    # with the poisoned state.
                    reason, at_step = rollback_trigger
                    run.rollback(epoch, at_step, reason)
                    continue
                if stopped_mid_epoch:
                    summary.preempted = True
                    interrupted = (epoch, step_i, step_i - start_step_this, start_step_this)
                    logger.info(
                        "preemption signal: stopping mid-epoch %d at step "
                        "boundary %d (partial-epoch state — saved dirty with an "
                        "exact-step data cursor; resume continues at step %d "
                        "when the cursor validates, replaying zero optimizer "
                        "steps)", epoch, step_i, step_i,
                    )
                    break
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                n_valid = float(sum(run.counts))
                run.epoch_loss = epoch_loss = (
                    float(np.dot(run.losses, run.counts) / n_valid) if n_valid else float("nan")
                )
                ips = n_valid / dt if dt > 0 else 0.0
                total_images += int(n_valid)
                total_time += dt
                logger.info("Epoch: %d, Loss: %.6f, Time: %.2f s, %.1f img/s", epoch, epoch_loss,
                            dt, ips)
                metrics.write({"kind": "epoch", "epoch": epoch, "loss": epoch_loss, "time_s": dt,
                               "images_per_sec": ips, **launches_since(launches0)})
                if run.losses and n_valid:
                    health.check_epoch(epoch, epoch_loss)
                summary.epoch_times.append(dt)
                summary.epoch_losses.append(epoch_loss)
                summary.epochs_run += 1
                summary.final_loss = epoch_loss

                path = None
                if cfg.checkpoint_every_epochs and (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                    # A clean epoch-E save resumes at (E+1, step 0).
                    path = run.save(epoch, epoch_loss, (epoch + 1, 0))
                    run.last_saved_epoch = epoch

                if cfg.validate:
                    # The reference validates on the TRAIN split (main.py:104-112);
                    # val_on_train=False validates on the test split.
                    val_manifest = train_manifest if cfg.val_on_train else test_manifest
                    launches0 = launch_counts()
                    if cfg.device_cache and cfg.val_on_train:
                        # The cached train set is the validation set.
                        acc, vloss = evaluate_cached(cfg, state.model, dataset, labels_all, data)
                    else:
                        if val_loader is None:
                            val_loader = make_eval_loader(cfg, val_manifest)
                        acc, vloss = evaluate_manifest(cfg, state.model, val_manifest, val_loader,
                                                       data)
                    summary.val_accuracy = acc
                    logger.info("Accuracy of the network: %.4f (val_on_train=%s)", acc,
                                cfg.val_on_train)
                    metrics.write({"kind": "val", "epoch": epoch, "accuracy": acc, "loss": vloss,
                                   **launches_since(launches0)})
                    if cfg.track_best and acc > best_accuracy:
                        # best.json is published only once the file it names
                        # is durable: after this epoch's write in flight, or
                        # by the writer itself after a save made for it.
                        best_accuracy = summary.best_accuracy = acc
                        if run.last_saved_epoch == epoch:
                            checkpointer.wait()
                            ckpt.write_best_marker(cfg.checkpoint_dir, epoch=epoch, accuracy=acc,
                                                   ckpt_path=path)
                        else:
                            path = run.save(
                                epoch, epoch_loss, (epoch + 1, 0),
                                on_durable=lambda p, _e=epoch, _a=acc: ckpt.write_best_file(
                                    cfg.checkpoint_dir, epoch=_e, accuracy=_a, ckpt_path=p))
                            run.last_saved_epoch = epoch
                        logger.info("best checkpoint so far: %s (val acc %.4f)", path, acc)
                run.last_completed_epoch = epoch
                run.epoch = epoch + 1
        except BaseException:
            # Drain the write in flight on the failure path too, but never
            # let a writer error replace the error the user needs to see.
            try:
                checkpointer.wait()
            except BaseException as werr:
                logger.warning("background checkpoint write also failed: %s", werr)
            raise
        if summary.preempted and cfg.checkpoint_every_epochs:
            run.preemption_save(interrupted)
        # The last write lands before a caller reads the file, and a writer
        # error fails the run; then every rank may read rank 0's files.
        checkpointer.drain()
    if checkpointer.write_s:
        logger.info("checkpoint writes: %d, %.2f s on the writer thread",
                    len(checkpointer.write_s), sum(checkpointer.write_s))
    summary.images_per_sec = total_images / total_time if total_time > 0 else 0.0
    return summary


def launches_since(before: dict[str, int]) -> dict:
    """``{"launches": {counter: launches since before}}`` for a metrics
    record, or nothing when no kernel launched (the CPU's plain versions)."""
    moved = {k: v - before.get(k, 0) for k, v in launch_counts().items()
             if v != before.get(k, 0)}
    return {"launches": moved} if moved else {}


def main(argv=None) -> TrainSummary:
    """``python -m mpi_pytorch_tpu_torch.train``: one process, or one rank
    of a ``torchrun`` world, which it leaves at the end."""
    from mpi_pytorch_tpu_torch.config import parse_config

    try:
        return train(parse_config(argv))
    finally:
        distributed.shutdown()
