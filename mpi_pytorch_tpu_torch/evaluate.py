"""Evaluation from the command line, inference construction and the
batched predict step (``mpi_pytorch_tpu/evaluate.py``).

``python -m mpi_pytorch_tpu_torch.evaluate [--flags]`` → :func:`main`:
``parse_config``, then :func:`quantize_eval_report` (``--quantize-eval``)
or :func:`evaluate`, on the card (``MPT_PLATFORM=cpu`` for the CPU).
:func:`evaluate` loads the checkpoint (``--use-best``: the one
``best.json`` names; else the latest; else the seeded init) and makes one
pass over the test manifest: the metrics alone (the trainer's
``evaluate_manifest``), or with ``--predictions-file`` the metrics and the
predictions CSV from the same forward (:func:`evaluate_with_predictions`).
Under ``torchrun --nproc-per-node N`` each rank evaluates its
``np.array_split`` shard of the test manifest in lock-step batches; the
metrics are summed over the ranks and the predictions all-gathered, and
rank 0 writes the one CSV in manifest order (the JAX ``evaluate``'s
multi-host gather). Under ``--mesh.model-parallel`` the shards, the sums
and the gather run over the data axis (the ranks of a model group
evaluate the same rows), and every rank holds the whole head, as JAX's
``head_predict`` gathers a TP-sharded one: the checkpoint is the unsharded
file, so K4 and the plain predict step run on the whole W.
``--quantize-eval`` runs on every rank, as the JAX package runs it on
every process.

One predict step yields both the eval metrics and the per-image
predictions from the same forward. Two paths:

- plain: the model's logits, recast to f32, then argmax (``topk == 1``)
  or the top-k class indices, best first, equal logits in index order as
  ``jax.lax.top_k`` gives them (``ops.losses.topk_indices``);
- fused (``--fused-head-eval``): the model runs up to the pooled [B, D]
  features (``model.features``; the dense head is ``model.fc``), and
  ``ops.fused_head_ce.head_predict`` streams the head's weights
  computing per-row loss and argmax without the [B, V] logits. A model
  whose head is not a dense layer (squeezenet1_0's 1×1 convolution) takes
  the plain path with a warning (:func:`fused_head_applies`), as the JAX
  predict step falls back when its head never matches.
  It streams argmax only, so ``topk > 1`` with the fused head raises.
  With ``int8_head`` (a model quantized by ``ops.quantize.quantize_model``
  with the head kept int8) the head is ``ops.quantize.head_predict_int8``.

The int8 predict sets quantize from the f32 weights
(:func:`float_state_dict`, taken before :func:`build_inference` casts), and
:func:`build_int8_inference` builds the quantized model from them.

Images come in NHWC (the JAX package's layout, and the server's host
batch layout); ``ingest_images`` normalizes uint8 pixels on the device and
the permute to NCHW is a view in channels_last memory.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from mpi_pytorch_tpu_torch import checkpoint as ckpt
from mpi_pytorch_tpu_torch.config import Config, parse_config
from mpi_pytorch_tpu_torch.data.manifest import Manifest, load_manifests
from mpi_pytorch_tpu_torch.hardware import resolve_device
from mpi_pytorch_tpu_torch.ops._build import launch_counts
from mpi_pytorch_tpu_torch.models.registry import (
    init_weights,
    initialize_model,
    prepare_for_inference,
)
from mpi_pytorch_tpu_torch.ops.fused_head_ce import head_predict
from mpi_pytorch_tpu_torch.ops.losses import topk_indices
from mpi_pytorch_tpu_torch.ops.quantize import (
    calibrate_head_act_scale,
    calibration_batch,
    head_module,
    head_predict_int8,
    int8_head_operands,
    max_logit_drift,
    parity_probe,
    quantize_model,
)
from mpi_pytorch_tpu_torch.parallel import collectives, distributed
from mpi_pytorch_tpu_torch.parallel.mesh import Axis, create_mesh, data_axis
from mpi_pytorch_tpu_torch.train.step import COMPUTE_DTYPES, ingest_images, metrics_from_logits
from mpi_pytorch_tpu_torch.train.trainer import (
    evaluate_manifest,
    global_step_count,
    host_batch,
    launches_since,
    make_eval_loader,
    pad_batch,
    synchronized_batches,
    to_device,
    validate_world,
)
from mpi_pytorch_tpu_torch.utils.logging import MetricsWriter, init_logger


@dataclass
class EvalSummary:
    accuracy: float
    mean_loss: float
    num_images: int
    wall_s: float
    images_per_sec: float


def _f32_model(cfg: Config, state_dict: dict[str, torch.Tensor] | None) -> nn.Module:
    """The model on the CPU with its f32 weights: ``state_dict``, else a
    seeded random init from ``cfg.seed``."""
    model, _ = initialize_model(
        cfg.model_name, cfg.num_classes, fused_stem=cfg.fused_stem, attn_impl=cfg.attn_impl,
        qkv_fused=cfg.qkv_fused, image_size=cfg.image_size,
    )
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(state_dict)
    return model


def float_state_dict(
    cfg: Config, state_dict: dict[str, torch.Tensor] | None = None
) -> dict[str, torch.Tensor]:
    """The model's f32 weights on the CPU, before any cast to the compute
    dtype — ``state_dict`` in f32, else the seeded init of ``cfg.seed`` —
    which an int8 set quantizes and :func:`build_inference` can load."""
    return _f32_model(cfg, state_dict).state_dict()


def build_inference(
    cfg: Config,
    device: str | torch.device | None = None,
    state_dict: dict[str, torch.Tensor] | None = None,
) -> nn.Module:
    """The eval-mode model on ``device`` (default cuda): weights from
    ``state_dict`` (e.g. ``models.convert.from_flax_variables``), else a
    seeded random init from ``cfg.seed``."""
    cfg.validate_config()
    dev = resolve_device(device)
    return prepare_for_inference(_f32_model(cfg, state_dict), dev, COMPUTE_DTYPES[cfg.compute_dtype])


def build_int8_inference(
    cfg: Config,
    f32_state: dict[str, torch.Tensor],
    device: str | torch.device | None = None,
    *,
    keep_head_int8: bool,
    act_scale: float = 1.0,
) -> nn.Module:
    """The post-training int8 eval-mode model on ``device``, quantized from
    the f32 weights ``f32_state`` (``quantize_model``), then prepared: int8
    weights resident, batchnorm and biases f32."""
    cfg.validate_config()
    dev = resolve_device(device)
    model = quantize_model(_f32_model(cfg, f32_state), keep_head_int8=keep_head_int8,
                           act_scale=act_scale)
    return prepare_for_inference(model, dev, COMPUTE_DTYPES[cfg.compute_dtype])


def fused_head_applies(cfg: Config, model: nn.Module, logger=None) -> bool:
    """Whether ``--fused-head-eval`` runs the fused head on ``model``: the
    flag is set and the model's last layer is a dense head. A set flag on a
    model without one (squeezenet1_0) warns once a call that the plain
    predict step runs instead."""
    if not cfg.fused_head_eval:
        return False
    if head_module(model) is not None:
        return True
    if logger is not None:
        logger.warning(
            "--fused-head-eval requested but falling back to the plain predict step: "
            "%s's head is a 1×1 convolution, not a dense layer (metrics are identical, "
            "but the [B, num_classes] logits are materialized)", cfg.model_name,
        )
    return False


def head_weights(model: nn.Module, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The head's (W [V, D] in ``dtype``, b f32 [V]) as the streaming head
    takes them: the kernel matmuls in the feature dtype, so a bf16 model
    gets one bf16 copy of W. Cut once by the caller and reused per call."""
    fc = model.fc
    return (
        fc.weight.detach().to(dtype).contiguous(),
        fc.bias.detach().to(torch.float32).contiguous(),
    )


def _fused_metrics(loss: torch.Tensor, preds: torch.Tensor, labels: torch.Tensor):
    valid = labels >= 0
    return {
        "loss": torch.sum(loss),  # the head zeroes padding rows
        "correct": torch.sum((preds == labels) & valid),
        "count": torch.sum(valid.to(torch.int32)),
    }


def make_predict_step(
    compute_dtype: torch.dtype, fused_head: bool = False, topk: int = 1,
    int8_head: bool = False,
) -> Callable:
    """``predict(model, images, labels[, head]) -> (metrics, preds)``.

    ``images`` NHWC (uint8 raw pixels or normalized floats), ``labels``
    int32 with −1 on padding rows. ``preds`` is int32 [B] (``topk == 1``)
    or [B, topk]. The fused step takes an optional prepared ``head`` from
    :func:`head_weights` (or ``ops.quantize.int8_head_operands`` with
    ``int8_head``); without it the head's operands are cut per call."""
    if fused_head and topk > 1:
        raise ValueError(
            "the fused head (head_predict) streams argmax only; top-k needs "
            "the plain predict path"
        )
    if int8_head and not fused_head:
        raise ValueError(
            "int8_head selects the fused int8 kernel variant and requires "
            "fused_head=True; the plain int8 path is just the plain predict "
            "step over a quantized model (ops/quantize.quantize_model)"
        )

    def model_input(images: torch.Tensor) -> torch.Tensor:
        return ingest_images(images, compute_dtype).permute(0, 3, 1, 2)

    if not fused_head:

        @torch.no_grad()
        def predict(model, images, labels):
            logits = model(model_input(images)).float()
            if topk > 1:
                preds = topk_indices(logits, topk)
            else:
                preds = torch.argmax(logits, dim=-1).to(torch.int32)
            return metrics_from_logits(logits, labels), preds

        return predict

    if int8_head:

        @torch.no_grad()
        def predict_fused_int8(model, images, labels, head=None):
            feats = model.features(model_input(images)).contiguous()
            h = head if head is not None else int8_head_operands(model)
            loss, preds = head_predict_int8(feats, h.w_q, h.b, labels, None, h.act_scale, h.scale_v)
            return _fused_metrics(loss, preds, labels), preds

        return predict_fused_int8

    @torch.no_grad()
    def predict_fused(model, images, labels, head=None):
        feats = model.features(model_input(images)).contiguous()
        w, b = head if head is not None else head_weights(model, feats.dtype)
        loss, preds = head_predict(feats, w, b, labels)
        return _fused_metrics(loss, preds, labels), preds

    return predict_fused


def _eval_checkpoint(cfg: Config, logger) -> str | None:
    """The checkpoint to evaluate: with ``use_best`` the one ``best.json``
    names (``FileNotFoundError`` without it), else the latest, else None."""
    if not cfg.use_best:
        return ckpt.latest_checkpoint(cfg.checkpoint_dir)
    marker = ckpt.best_marker(cfg.checkpoint_dir)
    if marker is None:
        raise FileNotFoundError(
            f"use_best=True but no best.json in {cfg.checkpoint_dir} "
            "(train with --track-best true --validate true)"
        )
    logger.info("best checkpoint: epoch %d, val acc %.4f", marker["epoch"], marker["accuracy"])
    return os.path.join(cfg.checkpoint_dir, marker["checkpoint"])


def _load_weights(cfg: Config, logger, what: str) -> dict[str, torch.Tensor] | None:
    """The f32 weights of :func:`_eval_checkpoint`'s file (None: the
    seeded init), logged."""
    path = _eval_checkpoint(cfg, logger)
    if path is None:
        logger.info("%s: no checkpoint in %s — evaluating fresh init", what, cfg.checkpoint_dir)
        return None
    state_dict, epoch, _ = ckpt.load_for_eval(path)
    logger.info("%s: loaded checkpoint %s (epoch %d)", what, path, epoch)
    return state_dict


def evaluate(cfg: Config, device: str | torch.device | None = None) -> EvalSummary:
    """Evaluate the checkpoint on the test manifest (see the module
    docstring) on ``device`` (default: this rank's card,
    ``distributed.rank_device``), in the world the environment describes;
    logs to ``eval_log_file``, writes a ``{"kind": "eval"}`` record to
    ``metrics_file`` (rank 0)."""
    cfg.validate_config()
    dev = distributed.rank_device(device)
    distributed.maybe_initialize_distributed(dev)
    validate_world(cfg)
    data = data_axis(create_mesh(cfg.mesh))
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    logger = init_logger("MPT_EVAL", cfg.eval_log_file)
    train_manifest, test_manifest = load_manifests(cfg)
    model = build_inference(cfg, dev, _load_weights(cfg, logger, "evaluate"))

    t0 = time.perf_counter()
    launches0 = launch_counts()
    if cfg.predictions_file:
        # One pass gives both the metrics and the predictions CSV.
        acc, mean_loss = evaluate_with_predictions(cfg, model, train_manifest, test_manifest,
                                                   logger, data)
    else:
        if cfg.fused_head_eval:
            # A flag that does nothing on this pass must not look as if it did.
            logger.warning(
                "--fused-head-eval requested but the plain predict step runs: metrics-only "
                "evaluation runs the shared eval step; the fused head belongs to the "
                "predictions pass (add --predictions-file)"
            )
        acc, mean_loss = evaluate_manifest(cfg, model, test_manifest, data=data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    n = len(test_manifest)
    logger.info("Accuracy of the network: %.4f (%d images, %.2f s)", acc, n, wall)
    writer = MetricsWriter(cfg.metrics_file)
    writer.write({"kind": "eval", "accuracy": acc, "loss": mean_loss, "images": n,
                  "time_s": wall, **launches_since(launches0)})
    writer.close()
    return EvalSummary(accuracy=acc, mean_loss=mean_loss, num_images=n, wall_s=wall,
                       images_per_sec=n / wall if wall > 0 else 0.0)


def evaluate_with_predictions(
    cfg: Config, model: nn.Module, train_manifest: Manifest, test_manifest: Manifest, logger,
    data: Axis | None = None,
) -> tuple[float, float]:
    """One pass over the test manifest → (accuracy, mean loss), and the
    predictions CSV ``file_name,predicted_label,predicted_category_id`` in
    manifest order, written atomically to ``cfg.predictions_file`` by
    rank 0.

    Each rank walks its data index's shard (``make_eval_loader``) in the
    same number of batches, each padded to ``host_batch`` rows (label −1
    rows count nowhere and their predictions are dropped). The shards'
    predictions, padded to the largest shard, are all-gathered over the
    data axis ``data`` (the world by default) as one ``[P, max]`` int32
    exchange, and the metrics summed over it. With ``fused_head_eval`` the
    head is the streaming kernel (``head_predict``, its operands cut
    once); a label maps to its raw category id through both splits, −1
    for one in neither."""
    dev = next(model.parameters()).device
    compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    fused = fused_head_applies(cfg, model, logger)
    predict = make_predict_step(compute_dtype, fused_head=fused)
    head = head_weights(model, compute_dtype) if fused else None
    data = data or collectives.world_axis()
    n_proc = data.size
    rows = host_batch(cfg)
    loader = make_eval_loader(cfg, test_manifest)
    local_n = len(loader.manifest)
    n_steps = global_step_count(len(test_manifest), rows, drop_remainder=False, shards=n_proc)
    losses, corrects, counts, preds = [], [], [], []
    for images, labels in synchronized_batches(loader, 0, n_steps):
        x, y = to_device(*pad_batch(images, labels, rows), dev)
        m, p = predict(model, x, y, head) if fused else predict(model, x, y)
        losses.append(m["loss"])
        corrects.append(m["correct"])
        counts.append(m["count"])
        preds.append(p)
    # One read-back for the whole pass; each batch's f32 loss sum is added
    # up in float64, as the per-batch host reads of the JAX ``evaluate`` do.
    sums = torch.stack([
        torch.stack(losses).double().sum(), torch.stack(corrects).double().sum(),
        torch.stack(counts).double().sum(),
    ]) if losses else torch.zeros(3, dtype=torch.float64, device=dev)
    sums = collectives.all_reduce(sums, "sum", data)
    loss_sum, correct, count = float(sums[0]), int(sums[1]), int(sums[2])
    local = torch.cat(preds)[:local_n] if preds else torch.zeros(0, dtype=torch.int32, device=dev)
    if n_proc > 1:
        # array_split sizes are the same on every rank: pad to the largest.
        sizes = [len(part) for part in np.array_split(np.arange(len(test_manifest)), n_proc)]
        buf = torch.full((max(sizes),), -1, dtype=torch.int32, device=dev)
        buf[:local_n] = local
        gathered = collectives.all_gather(buf[None], data).cpu().numpy()
        labels_pred = np.concatenate([gathered[r, : sizes[r]] for r in range(n_proc)])
    else:
        labels_pred = local.cpu().numpy()
    assert len(labels_pred) == len(test_manifest), (len(labels_pred), len(test_manifest))

    if distributed.rank() == 0:
        label_to_cat: dict[int, int] = {}
        for man in (train_manifest, test_manifest):
            label_to_cat.update(zip(man.labels.tolist(), man.category_ids.tolist()))
        tmp = cfg.predictions_file + ".tmp"
        with open(tmp, "w") as f:
            f.write("file_name,predicted_label,predicted_category_id\n")
            for fname, p in zip(test_manifest.filenames, labels_pred.tolist()):
                f.write(f"{fname},{p},{label_to_cat.get(p, -1)}\n")
        os.replace(tmp, cfg.predictions_file)
        logger.info("predictions written: %s (%d rows)", cfg.predictions_file, len(labels_pred))
    distributed.barrier()
    acc = correct / count if count else 0.0
    return acc, (loss_sum / count if count else float("nan"))


def quantize_eval_report(cfg: Config, device: str | torch.device | None = None) -> dict:
    """``--quantize-eval``: the int8-against-float parity report on the
    checkpoint a server would load. The seeded calibration batch
    (``quantize_calib`` images of ``seed``) goes through the float model
    and the int8 one as the server runs it — the fused int8 head (K7,
    top-1) under ``fused_head_eval``, else the plain predict step over the
    dequantized model (top ``min(serve_topk, num_classes)``) — giving top-1
    and top-5 agreement and the max logit drift of the plain int8 model.
    Written as a ``{"kind": "quant_parity"}`` record (rank 0) and
    returned. Every rank of a world runs the same report on its own
    device, as every JAX process does."""
    cfg.validate_config()
    dev = distributed.rank_device(device)
    distributed.maybe_initialize_distributed(dev)
    logger = init_logger("MPT_EVAL", cfg.eval_log_file)
    f32_state = float_state_dict(cfg, _load_weights(cfg, logger, "quantize-eval"))
    model = build_inference(cfg, dev, f32_state)
    compute_dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    # The serve executables' gate and calibration batch, so the report
    # measures the contract the server runs.
    fused = fused_head_applies(cfg, model, logger)
    images = calibration_batch(cfg)
    act_scale = calibrate_head_act_scale(model, images, compute_dtype)
    q_plain = build_int8_inference(cfg, f32_state, dev, keep_head_int8=False, act_scale=act_scale)
    drift = max_logit_drift(model, q_plain, images, compute_dtype)
    if fused:
        qmodel = build_int8_inference(cfg, f32_state, dev, keep_head_int8=True,
                                      act_scale=act_scale)
        topk = 1  # the fused heads stream argmax only
    else:
        qmodel, topk = q_plain, min(cfg.serve_topk, cfg.num_classes)
    probe = parity_probe(model, qmodel, compute_dtype, images, topk=topk, fused_head=fused)
    report = {
        "kind": "quant_parity", "precision": "int8", "model": cfg.model_name,
        "max_logit_drift": round(drift, 6), **probe,
    }
    logger.info(
        "quantize-eval parity: top1 %.4f, top5 %s, max logit drift %.4g over %d samples "
        "(%s path)", report["top1_agree"],
        "-" if report["top5_agree"] is None else f"{report['top5_agree']:.4f}",
        drift, report["samples"], "fused int8" if fused else "plain int8",
    )
    writer = MetricsWriter(cfg.metrics_file)
    writer.write(dict(report))
    writer.close()
    return report


def main(argv=None):
    """``python -m mpi_pytorch_tpu_torch.evaluate``: one process, or one
    rank of a ``torchrun`` world, which it leaves at the end."""
    cfg = parse_config(argv)
    try:
        if cfg.quantize_eval:
            return quantize_eval_report(cfg)
        return evaluate(cfg)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
