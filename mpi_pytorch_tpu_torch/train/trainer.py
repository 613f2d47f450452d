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

Elastic resume, rollback, preemption, the host cache and the run
telemetry of the JAX trainer are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.data.manifest import Manifest, load_manifests
from mpi_pytorch_tpu_torch.data.pipeline import DataLoader, epoch_order
from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
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
from mpi_pytorch_tpu_torch.utils.logging import MetricsWriter, init_logger


class NonFiniteLossError(RuntimeError):
    """A training step produced a non-finite loss or gradient norm (under
    ``bad_step_policy=abort``, or after ``max_skipped_steps`` consecutive
    skips)."""


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
        generator=torch.Generator().manual_seed(cfg.seed + 1), placement=placement,
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
    """Train ``cfg.num_epochs`` epochs (from the latest checkpoint with
    ``from_checkpoint``) on ``device`` (default: this rank's card,
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
    try:
        return _train(cfg, dev, logger, metrics)
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


def _train(cfg: Config, dev: torch.device, logger, metrics: MetricsWriter) -> TrainSummary:
    # The rank layout before the model: a nested or (data, model) one
    # makes its process groups collectively, and the levers shard over it.
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
    summary = TrainSummary()
    start_epoch = 0
    if cfg.from_checkpoint:
        path = ckpt.latest_checkpoint(cfg.checkpoint_dir)
        if path is None:
            logger.info("from_checkpoint=True but no checkpoint found; fresh start")
        else:
            epoch, last_loss = ckpt.restore_checkpoint(path, state)
            start_epoch = epoch + 1
            logger.info("resumed from %s (epoch %d, loss %.4f)", path, start_epoch, last_loss)
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
    plan = (_log_bucket_plan(cfg, state, mesh, logger)
            if cfg.spmd_mode and cfg.grad_sync_buckets > 0 else {})
    # The first step's collective traffic is read from the ledger (spmd);
    # the placement is logged after it (the auto levers).
    ledger_pending = cfg.spmd_mode
    placement_pending = auto_levers(cfg)
    val_loader = None
    total_images = 0
    total_time = 0.0
    # Consecutive skipped steps, carried across epochs as the JAX
    # trainer carries them.
    skip_streak = 0
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.perf_counter()
        launches0 = launch_counts()
        losses, counts = [], []
        # A step's metrics are read on the host one step late, so the
        # host queues step i+1 before waiting for step i.
        pending = None

        def settle(step_i: int, m: dict) -> None:
            nonlocal skip_streak
            loss, count = float(m["loss"]), int(m["count"])
            skipped = bool(m["skipped"]) if skip else False
            summary.step_losses.append(loss)
            record = {"kind": "step", "epoch": epoch, "step": step_i, "loss": loss,
                      "grad_norm": float(m["grad_norm"])}
            if skip:
                record["skipped"] = int(skipped)
            metrics.write(record)
            if skipped:
                skip_streak += 1
                logger.warning(
                    "bad step skipped (non-finite update) at epoch %d step %d — "
                    "state unchanged, %d consecutive", epoch, step_i, skip_streak,
                )
                if skip_streak >= cfg.max_skipped_steps:
                    raise NonFiniteLossError(
                        f"{skip_streak} consecutive non-finite steps were skipped "
                        f"(epoch {epoch}) — hit max_skipped_steps={cfg.max_skipped_steps}"
                    )
                return
            skip_streak = 0
            if not (np.isfinite(loss) and np.isfinite(record["grad_norm"])):
                raise NonFiniteLossError(
                    f"non-finite step at epoch {epoch} step {step_i}: loss {loss}, "
                    f"grad_norm {record['grad_norm']} (bad_step_policy=abort)"
                )
            losses.append(loss)
            counts.append(count)
            if cfg.log_every_steps and (step_i + 1) % cfg.log_every_steps == 0:
                logger.info("epoch %d step %d loss %.4f", epoch, step_i + 1, loss)

        if cfg.device_cache:
            idx_all, valid_all = epoch_indices(cfg, n_cache, epoch, n_steps, dev)
        if epoch_fn is not None:
            # The scanned epoch: the whole epoch queued, its [n_steps]
            # metrics read once, then checked and recorded step by step
            # as the per-step path would have (JAX: trainer.py:1440-1500).
            if n_steps:
                arrays = epoch_fn(state, dataset, labels_all, idx_all, valid_all)
                if placement_pending:
                    placement_pending = False
                    _log_placement(cfg, state, mesh, logger, metrics, epoch, 0)
                host = {k: v.tolist() for k, v in arrays.items()}
                for step_i in range(n_steps):
                    settle(step_i, {k: v[step_i] for k, v in host.items()})
        else:
            if cfg.device_cache:
                step_args = ((dataset, labels_all, i, v) for i, v in zip(idx_all, valid_all))
            else:
                step_args = (
                    to_device(*pad_batch(images, labels, loader.batch_size), dev)
                    for images, labels in synchronized_batches(loader, epoch, n_steps))
            for step_i, args in enumerate(step_args):
                if ledger_pending:
                    collectives.LEDGER.reset()
                m = train_step(state, *args)
                if ledger_pending:
                    ledger_pending = False
                    _log_grad_sync(cfg, state, mesh, logger, metrics, plan, epoch, step_i)
                if placement_pending:
                    placement_pending = False
                    _log_placement(cfg, state, mesh, logger, metrics, epoch, step_i)
                if pending is not None:
                    settle(*pending)
                pending = (step_i, m)
            if pending is not None:
                settle(*pending)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        n_valid = float(sum(counts))
        epoch_loss = (
            float(np.dot(losses, counts) / n_valid) if n_valid else float("nan")
        )
        ips = n_valid / dt if dt > 0 else 0.0
        total_images += int(n_valid)
        total_time += dt
        logger.info("Epoch: %d, Loss: %.6f, Time: %.2f s, %.1f img/s", epoch, epoch_loss, dt, ips)
        metrics.write({"kind": "epoch", "epoch": epoch, "loss": epoch_loss, "time_s": dt,
                       "images_per_sec": ips, **launches_since(launches0)})
        summary.epoch_times.append(dt)
        summary.epoch_losses.append(epoch_loss)
        summary.epochs_run += 1
        summary.final_loss = epoch_loss

        path = ckpt.save_checkpoint(
            cfg.checkpoint_dir, epoch=epoch, state=state, loss=epoch_loss,
            keep=cfg.keep_checkpoints,
        )
        summary.checkpoint_path = path
        logger.info("checkpoint written: %s", path)

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
                acc, vloss = evaluate_manifest(cfg, state.model, val_manifest, val_loader, data)
            summary.val_accuracy = acc
            logger.info("Accuracy of the network: %.4f (val_on_train=%s)", acc, cfg.val_on_train)
            metrics.write({"kind": "val", "epoch": epoch, "accuracy": acc, "loss": vloss,
                           **launches_since(launches0)})
            if cfg.track_best and acc > best_accuracy:
                # The epoch's checkpoint was saved (synchronously) above,
                # so the marker never names a file that is not there.
                best_accuracy = summary.best_accuracy = acc
                ckpt.write_best_marker(cfg.checkpoint_dir, epoch=epoch, accuracy=acc,
                                       ckpt_path=path)
                logger.info("best checkpoint so far: %s (val acc %.4f)", path, acc)
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
