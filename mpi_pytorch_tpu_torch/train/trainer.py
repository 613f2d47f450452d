"""Training driver on one device (``mpi_pytorch_tpu/train/trainer.py``).

Stage by stage, as the JAX trainer (and the reference ``main.py:49-189``):
manifests (``load_manifests``) → ``DataLoader`` → model and optimizer
(``create_model_bundle`` + ``make_optimizer``) → ``from_checkpoint`` resume
→ the epoch loop of train steps → one checkpoint per epoch → validation
(and, with ``track_best``, ``best.json`` naming the best epoch's checkpoint).

One process on one device: the data-parallel mesh, elastic resume,
rollback, preemption, the device/host caches and the run telemetry of the
JAX trainer are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config
from mpi_pytorch_tpu_torch.data.manifest import Manifest, load_manifests
from mpi_pytorch_tpu_torch.data.pipeline import DataLoader
from mpi_pytorch_tpu_torch.hardware import resolve_device
from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer
from mpi_pytorch_tpu_torch.train.step import COMPUTE_DTYPES, make_eval_step, make_train_step
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


def global_step_count(total_examples: int, host_batch: int, drop_remainder: bool) -> int:
    """Steps per epoch over ``total_examples`` in batches of
    ``host_batch`` (one process: the shard is the whole manifest)."""
    if drop_remainder:
        return total_examples // host_batch
    return -(-total_examples // host_batch)


def to_device(images: np.ndarray, labels: np.ndarray, device: torch.device):
    """A host batch on ``device``: through pinned memory, so the copy to a
    card is queued without blocking the host."""
    img, lbl = torch.from_numpy(images), torch.from_numpy(labels.astype(np.int32, copy=False))
    if device.type == "cuda":
        img, lbl = img.pin_memory(), lbl.pin_memory()
    return img.to(device, non_blocking=True), lbl.to(device, non_blocking=True)


def make_loader(cfg: Config, manifest: Manifest, *, train: bool) -> DataLoader:
    """The train loader (shuffled, ``drop_remainder`` as configured) or an
    eval loader (in order, every row)."""
    return DataLoader(
        manifest,
        batch_size=cfg.batch_size,
        image_size=(cfg.height, cfg.width),
        shuffle=cfg.shuffle if train else False,
        seed=cfg.seed,
        drop_remainder=cfg.drop_remainder if train else False,
        synthetic=cfg.synthetic_data,
        num_workers=cfg.loader_workers,
        prefetch=cfg.prefetch_batches,
        image_dtype=cfg.input_dtype,
    )


def build_training(cfg: Config, device: torch.device):
    """(state, (train_manifest, test_manifest, train_loader)): the model
    with seeded weights prepared for training on ``device``, its optimizer
    and schedule over the run's total step count."""
    cfg.validate_config()
    train_manifest, test_manifest = load_manifests(cfg)
    loader = make_loader(cfg, train_manifest, train=True)
    bundle = create_model_bundle(
        cfg.model_name, cfg.num_classes, cfg.feature_extract,
        seed=cfg.seed, image_size=cfg.image_size, fused_stem=cfg.fused_stem,
        attn_impl=cfg.attn_impl, qkv_fused=cfg.qkv_fused,
    )
    model = prepare_for_training(bundle.model, device)
    total_steps = (
        global_step_count(len(train_manifest), cfg.batch_size, cfg.drop_remainder)
        * cfg.num_epochs
    )
    optimizer, schedule = make_optimizer(
        model, cfg.learning_rate, bundle.trainable_mask,
        optimizer=cfg.optimizer, lr_schedule=cfg.lr_schedule,
        warmup_steps=cfg.warmup_steps, total_steps=total_steps,
        weight_decay=cfg.weight_decay,
    )
    state = TrainState(
        model=model, optimizer=optimizer, schedule=schedule,
        generator=torch.Generator().manual_seed(cfg.seed + 1),
    )
    return state, (train_manifest, test_manifest, loader)


def evaluate_manifest(
    cfg: Config, model: torch.nn.Module, manifest: Manifest, loader: DataLoader | None = None
) -> tuple[float, float]:
    """Batched eval over ``manifest`` → (accuracy, mean loss). The tail
    batch is padded to the batch size (label −1 rows count nowhere); the
    model runs in eval mode and returns to the mode it was in."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(COMPUTE_DTYPES[cfg.compute_dtype])
    loader = loader or make_loader(cfg, manifest, train=False)
    correct = total = 0
    loss_sum = 0.0
    was_training = model.training
    model.eval()
    try:
        for images, labels in loader.epoch(0):
            images, labels = pad_batch(images, labels, cfg.batch_size)
            m = eval_step(model, *to_device(images, labels, device))
            correct += int(m["correct"])
            total += int(m["count"])
            loss_sum += float(m["loss"])
    finally:
        model.train(was_training)
    if total == 0:
        return 0.0, float("nan")
    return correct / total, loss_sum / total


def train(cfg: Config, device: str | torch.device | None = None) -> TrainSummary:
    """Train ``cfg.num_epochs`` epochs (from the latest checkpoint with
    ``from_checkpoint``) on ``device`` (default cuda); see the module
    docstring. On a card, cuDNN picks its algorithms by measuring
    (``torch.backends.cudnn.benchmark``): every step has the same shapes."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    logger = init_logger("MPT", cfg.log_file)
    metrics = MetricsWriter(cfg.metrics_file)
    try:
        return _train(cfg, dev, logger, metrics)
    finally:
        metrics.close()


def _train(cfg: Config, dev: torch.device, logger, metrics: MetricsWriter) -> TrainSummary:
    state, (train_manifest, test_manifest, loader) = build_training(cfg, dev)
    logger.info(
        "model %s | %d classes | batch %d | %d train images | %s on %s",
        cfg.model_name, cfg.num_classes, cfg.batch_size, len(train_manifest),
        cfg.compute_dtype, dev,
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

    # A resumed run never demotes a stored best: best.json outlives the run
    # (no marker: any first accuracy wins).
    best_accuracy = float("-inf")
    if cfg.track_best:
        marker = ckpt.best_marker(cfg.checkpoint_dir)
        if marker is not None:
            best_accuracy = marker["accuracy"]

    skip = cfg.bad_step_policy == "skip"
    train_step = make_train_step(COMPUTE_DTYPES[cfg.compute_dtype], bad_step_skip=skip)
    val_loader = None
    total_images = 0
    total_time = 0.0
    for epoch in range(start_epoch, cfg.num_epochs):
        t0 = time.perf_counter()
        losses, counts = [], []
        skip_streak = 0
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

        for step_i, (images, labels) in enumerate(loader.epoch(epoch)):
            images, labels = pad_batch(images, labels, cfg.batch_size)
            m = train_step(state, *to_device(images, labels, dev))
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
                       "images_per_sec": ips})
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
            if val_loader is None:
                val_loader = make_loader(cfg, val_manifest, train=False)
            acc, vloss = evaluate_manifest(cfg, state.model, val_manifest, val_loader)
            summary.val_accuracy = acc
            logger.info("Accuracy of the network: %.4f (val_on_train=%s)", acc, cfg.val_on_train)
            metrics.write({"kind": "val", "epoch": epoch, "accuracy": acc, "loss": vloss})
            if cfg.track_best and acc > best_accuracy:
                # The epoch's checkpoint was saved (synchronously) above,
                # so the marker never names a file that is not there.
                best_accuracy = summary.best_accuracy = acc
                ckpt.write_best_marker(cfg.checkpoint_dir, epoch=epoch, accuracy=acc,
                                       ckpt_path=path)
                logger.info("best checkpoint so far: %s (val acc %.4f)", path, acc)
    summary.images_per_sec = total_images / total_time if total_time > 0 else 0.0
    return summary


def main(argv=None) -> TrainSummary:
    from mpi_pytorch_tpu_torch.config import parse_config

    return train(parse_config(argv))
