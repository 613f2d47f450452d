"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build its CUDA kernels,
hold each against its plain PyTorch version, serve resnet18 and vit_s16
and train them at full width through the kernels.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the kernel library from ``mpi_pytorch_tpu_torch/csrc`` (nvcc,
   sm_90a) into the git-ignored ``build/kernels``;
3. each kernel against its plain version on the card, at its path's
   shapes, then timed — the card's busy time per call (``torch.profiler``,
   the kernels line's ``ms``) and CUDA events around back-to-back calls —
   beside its plain version, a one-call PyTorch yardstick where one
   exists, and its roofline bound: the stem's eval
   forward (K1), training forward with the window index (K2: bitwise the
   plain version on random, tie-heavy and all-relu-zero inputs and at
   edge shapes) and index backward (K3), the predict head in bf16 (K4:
   B = 1, 8, 512 at D = 512, B = 128 at vit_s16's D = 384, B = 128 and
   512 at vit_b16's D = 768)
   and f32 (K4 f32: B = 8, 64, 512, with the float64 gap of its six-pair
   logits beside the three-pair control), exact argmax ties at the
   tensor-core heads' tile, split, quad-lane, warpgroup and ragged-tile
   boundaries (K4 bf16 and f32 and K7, with one and with two consumer
   warpgroups a CTA), the int8 predict head (K7:
   predictions equal on every row, B = 1, 8, 512, each timed), the heads'
   two calls bitwise equal, the training cross-entropy head's forward
   (K5) and backward (K6) at batch 8, 128 and 512 (timed at 128, K6 also
   kernel by kernel), the plain predict step's top-k on logits with
   planted ties against a stable descending sort (ROADMAP C4), the tiny-S
   attention forward (K9) and backward (K10) at vit_s16's 128 px shape
   (and S = 50, 65, 128, causal; the f32 forward also at D = 40, 128; K10
   also at D = 32, 128, and in bf16 at the padded head dims D = 40, 36, 8,
   120, on rows 8-byte and 2-byte aligned, S = 50, 65 and causal), and the
   flash forward (K8) at its 224 px shape and a longer causal S (f32 also
   at D = 40, 128; bf16 also at D = 40, 36, 8, 120 and on rows 8-byte and
   2-byte aligned) — each on its routes (the bf16 tensor-core kernels, at
   every D % 4 == 0 for K8 and K10, the f32 tensor-core kernels, K9's FFMA
   kernel for its bf16 inference and its bf16 D = 40), each on its route's
   counter only, two calls bitwise
   equal; the f32 tensor-core kernels also against float64 attention (and
   its gradients) on their timed inputs, within a limit
   (``attention_split_numerics.F64_REL``) that their six-pair torch
   emulation keeps and the three-pair control breaks; no measured time
   may read below its bound; and the flash backward's yardstick line (the
   blocked torch backward beside SDPA's backward);
4. the serving path: ``InferenceServer`` with resnet18, 64 500 classes,
   128 px, bf16, uint8 input, fused stem and fused head, buckets
   1,8,32,128,512, seeded random weights. A flood of seeded images, then
   requests one at a time; every answer is checked against the plain path
   (same weights, plain stem and plain head: ≥ 99 % equal, and equal on
   every row not within ``E2E_GAP`` of a tie) and both kernels' launch
   counts must have risen during the run;
5. the same server in f32 (the f32 head kernel's path), checked the same
   way against the plain f32 path; the same server in int8
   (``serve_precision="int8"``: K1 and K7 must launch), a flood and singles
   checked the same way against the plain int8 path (same quantized
   weights, plain stem, the int8 head's plain version); a ``"both"``
   server, its start-up parity logged, floods in turns (bf16, int8, int8,
   bf16) across ``set_precision`` switches that build nothing, and both
   sets' resident bytes; then vit_s16 at
   128 px with the tiny-S attention and the fused head, a flood checked the
   same way (K9's tensor-core kernel and K4 must launch);
5b. the training cross-entropy op: a few Adam steps of the 64 500-class
   head on fixed features through ``fused_head_ce`` (K5 and K6 must launch
   every step, the loss must fall);
6. training: ``train.trainer.train`` (what ``python -m
   mpi_pytorch_tpu_torch.train`` runs) on resnet18, 64 500 classes, 128 px,
   batch 128, bf16, Adam 4e-4, fused stem, synthetic data, the DEBUG
   sample of 3 200 rows (20 steps an epoch), two epochs, validation, one
   checkpoint kept (the fused run with ``track_best``: the last checkpoint
   and the one ``best.json`` names): K2 and K3 must launch on every step
   and the loss must fall; then the same run with the plain stem (step-1
   loss within 1e-3);
6b. evaluation, the end of the main path: ``evaluate.evaluate`` (what
   ``python -m mpi_pytorch_tpu_torch.evaluate`` runs) over the fused run's
   checkpoint at full width, fused stem and fused head, writing the
   predictions CSV: K1 and K4 launch once a batch, the CSV holds every test
   row in order and reproduces the reported accuracy, and its labels agree
   with the plain stem's and plain head's on the same rows by the serving
   rule (``E2E_GAP``); then ``use_best`` loads the file ``best.json``
   names, and ``--quantize-eval`` with the fused head launches K7;
6b2. the device-resident training set (``train_resnet18_cached``): the
   fused run's configuration through ``trainer.train`` with
   ``device_cache``, and with ``device_cache`` and ``scan_epoch``, in turns
   (cached, scanned, scanned, cached): the cache holds the 2 560 train
   rows in f32 (503.3 MB), K2 and K3 launch once a step and K1 once a
   validation batch (validation from the cache), each run's step-1 loss
   within 1e-3 of the streaming run's, the losses fall, epoch 0's first
   three gathered batches and its last ``torch.equal`` to the loader's,
   validation from the cache gives the streaming validation's accuracy on
   the same weights; logged: the second epoch's img/s of the streaming
   run and of each cached and scanned run, the cache's build seconds, a
   cached step's enqueue time against its busy time;
6c. data parallelism (``data_parallel``): ``torchrun --standalone
   --nproc-per-node 1 -m mpi_pytorch_tpu_torch.train`` — the real entry
   point as a world of one over NCCL — on the fused run's configuration
   for one epoch, then ``-m mpi_pytorch_tpu_torch.evaluate
   --predictions-file`` with the fused head on its checkpoint, loading the
   kernels this script built: NCCL in the log, K2 and K3 once a step, K1
   once a validation batch, K1 and K4 once an eval batch (the metrics
   records' launches), one checkpoint, the step-1 loss within 1e-3 of the
   one-process run's, the CSV in manifest order; then two ranks on the one
   card over gloo (``parallel.launch.run_world``): three auto-mode f32
   steps against one process on the whole batches (losses and step-1
   grad norm rtol 1e-4, ``bn1``'s running statistics rtol 1e-5, K2 and
   K3 once a step on each rank), the share of a step the collectives
   take, and one spmd-mode step on an uneven batch (the ranks' running
   statistics bitwise equal, the loss the count-weighted mean); then each
   rank's device cache (half the train rows, uint8 and f32) and three
   cached auto steps: its gathered slices byte-identical to this
   process's rows of the same batches, K2 and K3 once a step, the losses
   rtol 1e-4 against one process (``_dp_cached_check``);
6d. the spmd step's gradient-sync levers (``grad_sync_levers``): the
   train CLI with ``--spmd-mode true --zero-opt-state true
   --grad-sync-buckets 25`` under ``torchrun --nproc-per-node 1`` (a NCCL
   world of one; K2 and K3 once a step; its checkpoint through the
   evaluate CLI); two gloo ranks on the card, resnet18 at full width in
   f32, SGD, three steps each of the baseline, ZeRO, 25 and 4 MiB buckets,
   and ZeRO with buckets (losses, parameters and statistics rtol 1e-6
   against the baseline; K2 and K3 once a step on each rank; each rank's
   moment bytes the formula's; the plans and a timed step's share of the
   bucket collectives before the backward's end); four gloo ranks as 2
   pods × 2, the hierarchical sync alone and with ZeRO and buckets,
   against the flat four-rank step (rtol 1e-5), the ledger's ici and dcn
   bytes (the dcn payload half the flat step's), the card's memory before
   the four ranks;
6e. the auto step's levers (``auto_levers``): the train CLI with
   ``--zero-optimizer true --fsdp true --accum-steps 4`` under ``torchrun
   --nproc-per-node 1`` (a NCCL world of one; K2 and K3 four times a
   step; its checkpoint through the evaluate CLI with the fused head);
   two gloo ranks on the card, resnet18 at full width in f32, SGD, three
   steps each of the auto baseline, ZeRO-1, FSDP, 2 microbatches, FSDP
   with 2 microbatches and the TP head as 1 × 2 (ZeRO-1 and FSDP rtol 1e-6
   against the baseline; TP rtol 1e-5 against one process on the same
   rows; accumulation against its one-process twin; K2 and K3 once a
   microbatch on each rank; each rank's parameter and moment MB against
   the prediction; the model group's replicas bit-identical); four gloo
   ranks as 2 × 2 with FSDP and 2 microbatches against the 2 × 1 run
   (rtol 1e-5), then ``evaluate`` on the 2 × 2 layout with the fused
   head (K4 on the gathered head), its CSV against a world of one's by the
   f32 serving rule (equal on every row not within ``E2E_GAP_F32`` of a
   tie);
7. the same for vit_s16 at full width and depth, two epochs each:
   ``--attn-impl fused-small`` at 128 px (K9's tensor-core kernel in every
   block's forward, K10's in every block's backward) and ``flash`` at 224 px
   (K8's tensor-core kernel), each with its launches counted exactly (K9's
   FFMA forward in validation only) and its step-1 loss within 1e-3 of an
   ``attn_impl="full"`` twin's;
8. K2/K3 inside the real train step, f32 (TF32 off), same weights and
   batches: against the stem's plain versions, losses, step-1 stem
   gradients and ``bn1`` after three steps rtol 1e-4; against the plain
   stem, losses rtol 1e-4; and the device time of one bf16 train step on
   a resident batch, fused and plain, in turns; then K8, K9 and K10
   (their f32 tensor-core kernels, counted) inside the f32 vit_s16 step
   the same way
   (losses rtol 1e-4, step-1 gradients within ``VIT_GRAD_GAP``);
9. where a training step's time goes, for resnet18 and both vit_s16
   configurations: the host loader alone, the host's enqueue time against
   the card's, and a ``torch.profiler`` breakdown of the card's busy time.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits 2 and prints
no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

V, D = 64500, 512  # the headline head: 64 500 classes over 512 features
STEM_SHAPE = (512, 64, 64, 64)  # conv1 output at bucket 512, 128 px, NHWC
STEM_TRAIN_SHAPE = (128, 64, 64, 64)  # conv1 output at the training batch, NHWC
FLOOD, SINGLES = 1000, 16
# A served answer must equal the plain path's wherever the plain top-2 gap
# exceeds this share of |max|: a little above one bf16 rounding step
# (2^-7 = 7.8e-3 relative), the resolution the activations carry.
E2E_GAP = 1e-2
# The f32 path's answers carry f32 rounding only (TF32 off): a much finer
# gap separates a real disagreement from a near tie.
E2E_GAP_F32 = 1e-4
F32_SERVE_IMAGES = 72
IMG = 128  # pixels a side, serving and training
TRAIN_BATCH = 128
LR = 4e-4
TRAIN_ROWS = 3200  # DEBUG sample: 2 560 train rows = 20 steps of 128
TRAIN_STEPS_PER_EPOCH = 20
# Two epochs: the DEBUG sample's 2 560 train rows hold 2 337 classes, so in
# a first epoch nearly every batch brings classes never seen and the step
# loss only hovers near ln(64 500); the second epoch revisits them.
TRAIN_EPOCHS = 2
SEED = 0
REPO = Path(__file__).resolve().parent
# vit_s16's attention at the training batch, [B, S, H, Dh]: 128 px gives
# S = 64 tokens (the tiny-S kernels), 224 px S = 196 (flash: two k-blocks
# of 128, the second padded); a longer causal S for flash's recurrence.
ATTN_SMALL_SHAPE = (128, 64, 6, 64)
FLASH_SHAPE = (128, 196, 6, 64)
FLASH_LONG_SHAPE = (4, 1024, 6, 64)
# attn_impl → image size of each vit_s16 training configuration.
VIT_RUNS = {"fused-small": 128, "flash": 224}
VIT_BLOCKS = 12
# Two epochs, as for resnet18: the first pays the synthetic rows' making,
# so the second gives the steady img/s.
VIT_EPOCHS = 2
VIT_FLOOD = 256
# Step-1 gradient gap (relative L2) allowed between the attention kernels
# and their plain versions inside the f32 vit train step: ten times the
# largest gap the H100 showed (1.0e-6, patch_embed at 128 px).
VIT_GRAD_GAP = 1e-5
# Adam steps of the training cross-entropy op's path.
HEAD_STEPS = 5
# Batches the training cross-entropy op's kernels are checked at: below one
# 64-row chunk of the backward's first pass, the path's batch, and four
# 128-row chunks; the timed rows run at TRAIN_BATCH.
HEAD_CE_BATCHES = (8, TRAIN_BATCH, 512)
# The plain predict step's top-k on the card (ROADMAP C4): k, and rows of
# bf16-rounded logits over V classes with planted ties.
TOPK, TOPK_ROWS = 5, 512


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol (the
    ``<length><name>`` that ends in ``_kernel``), as ptxas reports it."""
    end = mangled.find("_kernel") + len("_kernel")
    for i in range(end):
        n = re.match(r"\d+", mangled[i:])
        if n and i + len(n.group()) + int(n.group()) == end:
            args = re.match(r"I.*?EE", mangled[end:])
            return mangled[i + len(n.group()):end] + (args.group() if args else "")
    return mangled


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    calls after a short warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """The card's busy time for one call: the device time of every kernel
    ``iters`` calls launch (``torch.profiler``), over ``iters``, after a
    short warmup. Unlike :func:`time_ms` it does not grow when the host
    enqueues the calls more slowly than the card runs them. A trace that
    lost kernels (one of them seen fewer than ``iters`` times: on the H100
    the profiler has returned a fifth of K10's and two thirds of SDPA's) is
    taken again, up to three times; if every trace lost some, the fullest
    one gives each kernel's mean time, counted max(1, round(seen / iters))
    times a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    fullest = None
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if kernels and all(e.count >= iters for e in kernels):
            return sum(e.self_device_time_total for e in kernels) / iters / 1e3
        log({"device_ms_retake": {"attempt": attempt, "counts": {e.key[:60]: e.count for e in kernels}}})
        if fullest is None or sum(e.count for e in kernels) > sum(e.count for e in fullest):
            fullest = kernels
    busy_us = sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
                  for e in fullest if e.count)
    return busy_us / 1e3


def device_ms_by_kernel(fn, iters: int) -> dict:
    """The card's busy time a call of each kernel ``fn`` launches (name cut
    to 60 characters → ms), from one ``torch.profiler`` trace of ``iters``
    calls after a short warmup: where a kernel of several launches spends
    its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _ulp_check(got, ref, what: str) -> float:
    """Within one bf16 ulp (2^-7 relative) plus 1e-6 absolute, NaN where
    the plain version has NaN; returns the max abs error on finite values."""
    g, r = got.float(), ref.float()
    if not torch.equal(torch.isnan(g), torch.isnan(r)):
        raise AssertionError(f"{what}: NaN positions differ from the plain version")
    fin = ~torch.isnan(r)
    err = (g[fin] - r[fin]).abs()
    tol = 2.0**-7 * torch.maximum(g[fin].abs(), r[fin].abs()) + 1e-6
    if bool((err > tol).any()):
        raise AssertionError(
            f"{what}: {int((err > tol).sum())} values beyond one bf16 ulp, "
            f"max err {float(err.max())}"
        )
    return float(err.max()) if err.numel() else 0.0


def check_ingest(dev) -> None:
    """The device-side uint8 normalize gives the CPU's bits for every pixel
    value in every channel (its divisions correctly rounded, as JAX's)."""
    from mpi_pytorch_tpu_torch.train.step import ingest_images

    px = torch.arange(256, dtype=torch.uint8).view(1, 16, 16, 1).expand(1, 16, 16, 3).contiguous()
    got = ingest_images(px.to(dev), torch.float32).cpu()
    if not torch.equal(got, ingest_images(px, torch.float32)):
        raise AssertionError("uint8 ingest on the card differs from the CPU's bits")


def check_stem(dev, gen) -> dict:
    """K1 against its plain version: within one bf16 ulp (2^-7 relative),
    plus 1e-6 absolute for values the f32 FMA-vs-mul+add gap moves across
    zero; NaN where the plain version has NaN."""
    from mpi_pytorch_tpu_torch.hardware import H100_PEAK_F32_FLOPS, bound_ms
    from mpi_pytorch_tpu_torch.ops import fused_stem as fs

    c = STEM_SHAPE[-1]
    a = (0.5 + torch.rand(c, generator=gen)).to(dev)
    b = (0.5 * torch.randn(c, generator=gen)).to(dev)
    y = torch.randn(STEM_SHAPE, generator=gen).to(dev, torch.bfloat16)
    ties = torch.randint(-2, 3, (64, 64, 64, 64), generator=gen).to(dev, torch.bfloat16)
    ties[0, 5, 7, 3] = float("nan")
    max_err = 0.0
    for name, inp in (("random", y), ("tie_heavy_nan", ties)):
        got = fs.stem_affine_relu_pool(inp, a, b)
        torch.cuda.synchronize()
        ref = fs.stem_affine_relu_pool_reference(inp, a, b)
        max_err = max(max_err, _ulp_check(got, ref, f"fused stem ({name})"))
    n_in, n_out = y.numel(), y.numel() // 4
    moved = 2 * n_in + 2 * n_out + 8 * c  # bf16 y read, bf16 out written, f32 a, b
    ops = 3 * n_in + 8 * n_out  # fma + relu per input, 8 max per window
    bound, by = bound_ms(moved, (ops, H100_PEAK_F32_FLOPS))
    row = {
        "name": "stem_affine_relu_pool", "route": "cuda",
        "source": "mpi_pytorch_tpu_torch/csrc/fused_stem.cu",
        "replaces": "mpi_pytorch_tpu/ops/fused_stem.py:275",
        "shape": list(STEM_SHAPE), "dtype": "bfloat16",
        "max_abs_err": max_err,
        "kernel_ms": time_ms(lambda: fs.stem_affine_relu_pool(y, a, b), 50),
        "device_ms": device_ms(lambda: fs.stem_affine_relu_pool(y, a, b), 50),
        "plain_ms": time_ms(lambda: fs.stem_affine_relu_pool_reference(y, a, b), 20),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None,  # no one PyTorch call computes pool(relu(affine))
    }
    log({"kernel_check": row})
    return row


def _stem_train_inputs(dev, gen):
    """(a, b, random y, tie-heavy y with a NaN) at the training shape."""
    c = STEM_TRAIN_SHAPE[-1]
    a = (0.5 + torch.rand(c, generator=gen)).to(dev)
    b = (0.5 * torch.randn(c, generator=gen)).to(dev)
    y = torch.randn(STEM_TRAIN_SHAPE, generator=gen).to(dev, torch.bfloat16)
    ties = torch.randint(-2, 3, STEM_TRAIN_SHAPE, generator=gen).to(dev, torch.bfloat16)
    ties[0, 5, 7, 3] = float("nan")
    return a, b, y, ties


# K2's inputs beyond the training shape: K3's edge shapes (below), the
# 224 px conv1 output, H/2 = 35 (a short last band of the kernel's
# two-row bands), C = 24 (three channel groups, so a warp's column runs
# are not a power of two) and W/2 = 260 in f32 (column blocks of one
# channel group); each random and all-relu-zero.
STEM_ARGMAX_EDGES = (((16, 2, 2, 64), torch.bfloat16), ((8, 6, 10, 64), torch.bfloat16),
                     ((4, 16, 16, 256), torch.float32), ((32, 112, 112, 64), torch.bfloat16),
                     ((4, 70, 64, 64), torch.bfloat16), ((4, 10, 14, 24), torch.bfloat16),
                     ((2, 6, 520, 8), torch.float32))


def stem_argmax_input(shape, dtype, kind: str, dev, gen):
    """(y, a, b) for K2: y normal, or coarse integers with a NaN
    ("tie_heavy_nan": most windows tie); a in [0.5, 1.5); b normal·0.5, or
    −1e3 everywhere ("all_relu_zero": every window ties at 0)."""
    c = shape[-1]
    a = (0.5 + torch.rand(c, generator=gen)).to(dev)
    b = (0.5 * torch.randn(c, generator=gen)).to(dev)
    if kind == "all_relu_zero":
        b = torch.full((c,), -1e3, device=dev)
    if kind == "tie_heavy_nan":
        y = torch.randint(-2, 3, shape, generator=gen).to(dev, dtype)
        y[0, shape[1] // 2, shape[2] - 1, 3] = float("nan")
    else:
        y = torch.randn(shape, generator=gen).to(dev, dtype)
    return y, a, b


def check_stem_argmax_equal(pooled, k, ref_p, ref_k, what: str) -> float:
    """K2's outputs against another run's: pooled bitwise (NaN in the same
    places), k equal on every window whose max is finite. Returns the max
    abs difference of pooled on finite values (0.0 once it passes)."""
    nan = torch.isnan(ref_p.float())
    if not torch.equal(torch.isnan(pooled.float()), nan):
        raise AssertionError(f"{what}: NaN positions differ")
    if not torch.equal(pooled[~nan], ref_p[~nan]):
        raise AssertionError(f"{what}: pooled differs on {int((pooled[~nan] != ref_p[~nan]).sum())} values")
    if not torch.equal(k[~nan], ref_k[~nan]):
        raise AssertionError(f"{what}: k differs on {int((k[~nan] != ref_k[~nan]).sum())} finite windows")
    diff = (pooled[~nan].float() - ref_p[~nan].float()).abs()
    return float(diff.max()) if diff.numel() else 0.0


def check_stem_argmax(dev, gen) -> dict:
    """K2 against its plain version at the training shape, on random,
    tie-heavy (with a NaN) and all-relu-zero inputs, and at
    ``STEM_ARGMAX_EDGES``: pooled bitwise the plain version's (both round
    the product and the sum of the affine separately), NaN in the same
    places, and k equal on every window whose max is finite
    (``check_stem_argmax_equal``). The all-relu-zero and edge inputs draw
    from a generator of their own, so the later checks' inputs are those
    of earlier runs. Then timed at the training shape; raises when its
    busy time reads below its bound."""
    from mpi_pytorch_tpu_torch.hardware import H100_PEAK_F32_FLOPS, bound_ms
    from mpi_pytorch_tpu_torch.ops import fused_stem as fs

    a, b, y, ties = _stem_train_inputs(dev, gen)
    edge_gen = torch.Generator().manual_seed(SEED + 13)
    cases = [("random", y, a, b), ("tie_heavy_nan", ties, a, b),
             ("all_relu_zero", *stem_argmax_input(STEM_TRAIN_SHAPE, torch.bfloat16, "all_relu_zero",
                                                  dev, edge_gen))]
    for shape, dtype in STEM_ARGMAX_EDGES:
        for kind in ("random", "all_relu_zero"):
            cases.append((f"{list(shape)} {dtype} {kind}",
                          *stem_argmax_input(shape, dtype, kind, dev, edge_gen)))
    max_err = 0.0
    for name, inp, a_c, b_c in cases:
        pooled, k = fs.stem_pool_argmax(inp, a_c, b_c)
        torch.cuda.synchronize()
        max_err = max(max_err, check_stem_argmax_equal(
            pooled, k, *fs.stem_pool_argmax_reference(inp, a_c, b_c), f"stem argmax ({name})"))
    n_in, n_out = y.numel(), y.numel() // 4
    c = y.shape[-1]
    moved = 2 * n_in + 2 * n_out + n_out + 8 * c  # y, pooled (bf16), k (int8), a, b
    ops = 3 * n_in + 16 * n_out  # mul, add, relu per input; max + index per window
    bound, by = bound_ms(moved, (ops, H100_PEAK_F32_FLOPS))
    row = {
        "name": "stem_pool_argmax", "route": "cuda",
        "source": "mpi_pytorch_tpu_torch/csrc/fused_stem.cu",
        "replaces": "mpi_pytorch_tpu/ops/fused_stem.py:257",
        "shape": list(STEM_TRAIN_SHAPE), "dtype": "bfloat16",
        "max_abs_err": max_err, "cases": len(cases),
        "kernel_ms": time_ms(lambda: fs.stem_pool_argmax(y, a, b), 50),
        "device_ms": device_ms(lambda: fs.stem_pool_argmax(y, a, b), 50),
        "plain_ms": time_ms(lambda: fs.stem_pool_argmax_reference(y, a, b), 10),
        "bound_ms": bound, "bound_by": by,
        # No one PyTorch call gives (pooled, k) from y, a, b.
        "library_ms": None,
    }
    log({"kernel_check": row})
    if row["device_ms"] < bound:
        raise AssertionError(f"stem_pool_argmax: device_ms {row['device_ms']} below its bound {bound} ms")
    return row


# K3's edge shapes, (B, H, W, C) and dtype: one window a row and column
# (H = W = 2: no window right of or below any quad), odd window counts
# (H/2 = 3, W/2 = 5), and f32 at the widest C the kernel takes.
STEM_BWD_EDGES = (((16, 2, 2, 64), torch.bfloat16), ((8, 6, 10, 64), torch.bfloat16),
                  ((4, 16, 16, 256), torch.float32))


def _check_stem_backward_once(fs, g, k, pooled, y, a, what: str) -> float:
    """K3 against its plain version on one input: dy within one bf16 ulp,
    da and db rtol 1e-3 plus 1e-3 absolute (sums of up to 2^19 terms per
    channel, taken in another order), and two calls bitwise equal (no
    atomics). Returns the max abs error."""
    dy, da, db = fs.stem_pool_backward(g, k, pooled, y, a)
    dy2, da2, db2 = fs.stem_pool_backward(g, k, pooled, y, a)
    torch.cuda.synchronize()
    if not (torch.equal(dy, dy2) and torch.equal(da, da2) and torch.equal(db, db2)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    ref_dy, ref_da, ref_db = fs.stem_pool_backward_reference(g, k, pooled, y, a)
    max_err = _ulp_check(dy, ref_dy, f"{what} dy")
    for name, got, ref in (("da", da, ref_da), ("db", db, ref_db)):
        if not torch.allclose(got, ref, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{what} {name}: off by {float((got - ref).abs().max())}")
        max_err = max(max_err, float((got - ref).abs().max()))
    return max_err


def check_stem_backward(dev, gen) -> dict:
    """K3 against its plain version (``_check_stem_backward_once``) on the
    same (g, k, pooled, y, a) at the training shape, random and tie-heavy,
    and at ``STEM_BWD_EDGES``, where the windows right of or
    below a quad fall off the grid; then timed at the training shape.
    Raises when its busy time reads below its bound."""
    from mpi_pytorch_tpu_torch.hardware import H100_PEAK_F32_FLOPS, bound_ms
    from mpi_pytorch_tpu_torch.ops import fused_stem as fs

    def case(y, a, b, what):
        pooled, k = fs.stem_pool_argmax(y, a, b)
        g = torch.randn(pooled.shape, generator=gen).to(dev, y.dtype)
        return (g, k, pooled, y, a), _check_stem_backward_once(fs, g, k, pooled, y, a, what)

    a, b, y, ties = _stem_train_inputs(dev, gen)
    args, max_err = case(y, a, b, "stem backward")
    # Tie-heavy, its NaN zeroed: a NaN in y makes da NaN, which no check compares.
    max_err = max(max_err, case(torch.nan_to_num(ties), a, b, "stem backward (tie_heavy)")[1])
    for shape, dtype in STEM_BWD_EDGES:
        c = shape[-1]
        a_e = (0.5 + torch.rand(c, generator=gen)).to(dev)
        b_e = (0.5 * torch.randn(c, generator=gen)).to(dev)
        y_e = torch.randn(shape, generator=gen).to(dev, dtype)
        max_err = max(max_err, case(y_e, a_e, b_e, f"stem backward {list(shape)} {dtype}")[1])
    g, k, pooled, y, a = args
    n_in, n_out = y.numel(), y.numel() // 4
    c = y.shape[-1]
    # g, pooled (bf16) and k (int8) read; y read and dy written (bf16); a
    # read, da and db written (f32).
    moved = 2 * n_out + 2 * n_out + n_out + 2 * n_in + 2 * n_in + 4 * c + 8 * c
    ops = 4 * n_out + 5 * n_in  # mask + route per window; du·a, du·y + sum, sum du
    bound, by = bound_ms(moved, (ops, H100_PEAK_F32_FLOPS))
    row = {
        "name": "stem_pool_backward", "route": "cuda",
        "source": "mpi_pytorch_tpu_torch/csrc/fused_stem.cu",
        "replaces": "mpi_pytorch_tpu/ops/fused_stem.py:279",
        "shape": list(STEM_TRAIN_SHAPE), "dtype": "bfloat16", "max_abs_err": max_err,
        "kernel_ms": time_ms(lambda: fs.stem_pool_backward(g, k, pooled, y, a), 50),
        "device_ms": device_ms(lambda: fs.stem_pool_backward(g, k, pooled, y, a), 50),
        "plain_ms": time_ms(lambda: fs.stem_pool_backward_reference(g, k, pooled, y, a), 10),
        "bound_ms": bound, "bound_by": by,
        # No one PyTorch call gives (dy, da, db) from (g, k, pooled, y, a).
        "library_ms": None,
    }
    log({"kernel_check": row})
    if row["device_ms"] < bound:
        raise AssertionError(f"stem_pool_backward: device_ms {row['device_ms']} below its bound {bound} ms")
    return row


# Per head dtype: (batch, D) cases, loss rtol, the top-2 gap (share of
# |max|) above which argmax must agree, the least share of rows agreeing
# overall, the peak its operations are bounded by, the kernel row's name and
# source. bf16 adds vit_s16's head width, D = 384, at its training batch,
# and vit_b16's, D = 768, where a CTA keeps one consumer warpgroup's feats
# tile (64 rows) at every batch. f32 runs at the f32 serving path's buckets
# (8, 64) and at 512; its products are priced as the f32 attention rows
# price theirs (``_attn_work``): each f32 product three TF32 products, the
# tensor-core time of the six bf16 products the kernel takes.
HEAD_CHECKS = {
    torch.bfloat16: (((1, D), (8, D), (512, D), (128, 384), (128, 768), (512, 768)), 1e-3,
                     1e-3, 0.99, "bf16", "head_predict", "head_predict_tc.cu"),
    torch.float32: (((8, D), (64, D), (512, D)), 1e-5, 1e-5, 1.0, "tf32x3", "head_predict_f32",
                    "head_predict_tc.cu"),
}


def _in_turns(kernel, plain, iters: int, plain_iters: int) -> dict:
    """The kernel's busy time and its plain version's event time, taken in
    turns (kernel, plain, plain, kernel) in this call; means and each."""
    k1 = device_ms(kernel, iters)
    p1, p2 = time_ms(plain, plain_iters), time_ms(plain, plain_iters)
    k2 = device_ms(kernel, iters)
    return {"device_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "device_ms_turns": [k1, k2], "plain_ms_turns": [p1, p2]}


def _bitwise_twice(fn, what: str) -> None:
    """Two calls on the same inputs give the same loss and pred bits."""
    a, b = fn(), fn()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")


def check_head(dev, gen, dtype) -> dict:
    """K4 against its plain version (f32 logits over the same W) in each
    (batch, D) case: loss within the dtype's rtol, argmax equal wherever the
    plain top-2 gap exceeds the dtype's share of |max| (bf16 1e-3, f32 1e-5 —
    f32 logits carry f32 rounding only, TF32 off) and on at least the
    dtype's share of rows overall, two calls bitwise equal. f32 rows also
    log the float64 gap of the logits (``_head_f64_gaps``). Returns the
    B = 512, D = 512 row."""
    from mpi_pytorch_tpu_torch.hardware import H100_PEAK_BF16_FLOPS, H100_PEAK_TF32_FLOPS, bound_ms
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    cases, rtol, gap, min_agree, peak, name, source = HEAD_CHECKS[dtype]
    products, peak = {"bf16": (1, H100_PEAK_BF16_FLOPS), "tf32x3": (3, H100_PEAK_TF32_FLOPS)}[peak]
    size = torch.finfo(dtype).bits // 8
    weights = {}
    rows = {}
    for bsz, d in cases:
        if d not in weights:
            weights[d] = ((0.05 * torch.randn(V, d, generator=gen)).to(dev, dtype),
                          (0.1 * torch.randn(V, generator=gen)).to(dev))
        w, bias = weights[d]
        feats = torch.randn(bsz, d, generator=gen).abs().to(dev, dtype)
        labels = torch.randint(0, V, (bsz,), generator=gen, dtype=torch.int32)
        labels[::7] = -1
        labels = labels.to(dev)
        loss, pred = fh.head_predict(feats, w, bias, labels)
        torch.cuda.synchronize()
        ref_loss, ref_pred = fh.head_predict_reference(feats, w, bias, labels)
        top2 = torch.topk(fh._logits(feats, w, bias), 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > gap * top2[:, 0].abs()
        agree = pred == ref_pred
        what = f"{name} B={bsz} D={d}"
        if not bool(agree[clear].all()):
            raise AssertionError(f"{what}: argmax differs on a clear row")
        if float(agree.float().mean()) < min_agree:
            raise AssertionError(f"{what}: only {float(agree.float().mean())} agree")
        if not torch.allclose(loss, ref_loss, rtol=rtol, atol=0):
            raise AssertionError(f"{what}: loss off by {float((loss - ref_loss).abs().max())}")
        if not bool((loss[labels < 0] == 0).all()):
            raise AssertionError(f"{what}: padding rows carry loss")
        _bitwise_twice(lambda: fh.head_predict(feats, w, bias, labels), what)
        moved = size * bsz * d + size * V * d + 4 * V + 12 * bsz
        bound, by = bound_ms(moved, (products * 2 * bsz * d * V, peak))
        row = {
            "name": name, "route": "cuda", "source": "mpi_pytorch_tpu_torch/csrc/" + source,
            "replaces": "mpi_pytorch_tpu/ops/fused_head_ce.py:313",
            "batch": bsz, "d": d, "max_abs_err": float((loss - ref_loss).abs().max()),
            "argmax_agree": float(agree.float().mean()), "clear_rows": int(clear.sum()),
            "bitwise_repeatable": True,
            "kernel_ms": time_ms(lambda: fh.head_predict(feats, w, bias, labels), 50),
            **_in_turns(lambda: fh.head_predict(feats, w, bias, labels),
                        lambda: fh.head_predict_reference(feats, w, bias, labels), 50, 10),
            "bound_ms": bound, "bound_by": by,
            # Yardstick only, never called by the port: the cuBLAS logits
            # GEMM in the same dtype.
            "library_ms": time_ms(
                lambda: torch.nn.functional.linear(feats, w, bias.to(dtype)), 50
            ),
        }
        if dtype == torch.float32:
            row["f64_gaps"] = _head_f64_gaps(feats, w, bias, labels, loss, ref_loss)
        log({"kernel_check": row})
        rows[bsz, d] = row
    return rows[512, D]


def _head_f64_gaps(feats, w, bias, labels, loss, ref_loss) -> dict:
    """K4 f32 against float64: the relative gap (max |error| over max
    |logit|) of the six-pair logits the kernel forms, emulated in torch on
    the card (``split_product``), and of the three-pair control; and the
    largest loss error of the kernel and of the plain f32 version against
    the float64 loss. Raises unless six pairs come closer than three."""
    from mpi_pytorch_tpu_torch.ops.attention_split_numerics import SIX, THREE, relative_gap, split_product

    ref = feats.double() @ w.double().t() + bias.double()
    valid = labels >= 0
    lse = torch.logsumexp(ref, -1)
    picked = ref.gather(1, labels.clamp(min=0).long()[:, None])[:, 0]
    loss64 = torch.where(valid, lse - picked, torch.zeros_like(lse))
    gaps = {label: relative_gap(split_product("bd,vd->bv", feats, w, pairs) + bias, ref)
            for label, pairs in (("six_pairs", SIX), ("three_pairs", THREE))}
    gaps["kernel_loss_abs"] = float((loss.double() - loss64).abs().max())
    gaps["plain_loss_abs"] = float((ref_loss.double() - loss64).abs().max())
    if not gaps["six_pairs"] < gaps["three_pairs"]:
        raise AssertionError(f"head_predict_f32: six pairs no closer to float64 than three: {gaps}")
    return gaps


INT8_BATCHES = (1, 8, 512)


def _int8_head(dev, w):
    """w's int8 head: (w_q, w_scale) on the card."""
    from mpi_pytorch_tpu_torch.ops import quantize as qz

    return tuple(t.to(dev) for t in qz.quantize_per_channel(w))


def check_head_int8(dev, gen) -> dict:
    """K7 against its plain version (the int8 product summed exactly in
    f64) at each batch, bf16 feats as the serving path gives them, every
    7th label −1: predictions equal on EVERY row (the logits are the same
    bits), loss rtol 1e-5, padding rows 0, two calls bitwise equal. Each
    batch timed beside its plain version and ``torch._int_mm`` (the int8
    product alone, on W padded to a multiple of 8 columns; none where it
    refuses the shape). Returns the B = 512 row."""
    from mpi_pytorch_tpu_torch.hardware import H100_PEAK_INT8_OPS, bound_ms
    from mpi_pytorch_tpu_torch.ops import quantize as qz

    w_q, w_scale = _int8_head(dev, 0.05 * torch.randn(V, D, generator=gen))
    bias = (0.1 * torch.randn(V, generator=gen)).to(dev)
    w_pad = torch.zeros((-(-V // 8) * 8, D), dtype=torch.int8, device=dev)
    w_pad[:V] = w_q
    row = None
    for bsz in INT8_BATCHES:
        feats = torch.randn(bsz, D, generator=gen).abs().to(dev, torch.bfloat16)
        labels = torch.randint(0, V, (bsz,), generator=gen, dtype=torch.int32)
        labels[::7] = -1
        labels = labels.to(dev)
        act = float(feats.float().abs().max()) / 127.0
        scale_v = qz.combined_scale(w_scale, act)
        kernel = lambda: qz.head_predict_int8(feats, w_q, bias, labels, None, act, scale_v)  # noqa: E731
        plain = lambda: qz.head_predict_int8_reference(feats, w_q, bias, labels, None, act, scale_v)  # noqa: E731
        loss, pred = kernel()
        torch.cuda.synchronize()
        ref_loss, ref_pred = plain()
        if not torch.equal(pred, ref_pred):
            raise AssertionError(f"int8 head B={bsz}: argmax differs on {int((pred != ref_pred).sum())} rows")
        if not torch.allclose(loss, ref_loss, rtol=1e-5, atol=0):
            raise AssertionError(f"int8 head B={bsz}: loss off by {float((loss - ref_loss).abs().max())}")
        if not bool((loss[labels < 0] == 0).all()):
            raise AssertionError(f"int8 head B={bsz}: padding rows carry loss")
        _bitwise_twice(kernel, f"int8 head B={bsz}")
        # bf16 feats read, int8 W, f32 scale_v and bias read; loss and pred
        # written. Operations: the int8 product.
        moved = 2 * bsz * D + V * D + 8 * V + 4 * bsz + 8 * bsz
        bound, by = bound_ms(moved, (2 * bsz * D * V, H100_PEAK_INT8_OPS))
        row = {
            "name": "head_predict_int8", "route": "cuda",
            "source": "mpi_pytorch_tpu_torch/csrc/head_predict_tc.cu",
            "replaces": "mpi_pytorch_tpu/ops/quantize.py:286",
            "batch": bsz, "max_abs_err": float((loss - ref_loss).abs().max()),
            "bitwise_repeatable": True,
            "kernel_ms": time_ms(kernel, 50), **_in_turns(kernel, plain, 50, 10),
            "bound_ms": bound, "bound_by": by,
        }
        # Yardstick only, never called by the port: the int8 product on
        # cuBLAS, W padded to 64 504 columns.
        feats_q = qz.quantize_activations(feats, act)
        try:
            row["library_ms"] = time_ms(lambda: torch._int_mm(feats_q, w_pad.t()), 50)
        except RuntimeError as e:
            row["library_ms"] = None
            row["library_note"] = f"none: _int_mm refuses the shape ({str(e)[:120]})"
        log({"kernel_check": row})
    return row


def check_head_ties(dev, gen) -> None:
    """Exact ties where the tensor-core heads split their work, at B = 64
    (one consumer warpgroup a CTA; f32: one CTA of 64 rows) and B = 512
    (two, sharing each W stage, with longer splits; f32: eight row tiles):
    W rows duplicated (and their biases) in pairs that straddle a vocab
    tile boundary, a split boundary (from the wrappers' own geometry), the
    lanes of a quad, two columns of one thread, one thread's columns in two
    tiles of a split, two splits, the two consumer warpgroups of an f32
    tile, and lie inside the ragged last tile. Each row's features point at
    one pair, whose logit then leads every other by far: K4 bf16 and f32 and
    K7 must return the pair's first column on every row — the plain
    first-index argmax over f64 logits (bf16, f32) or over the int8 head's
    exact logits — and give the same bits twice."""
    for bsz in (64, 512):
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            _check_ties(dev, gen, bsz, dtype)


def _check_ties(dev, gen, bsz: int, dtype) -> None:
    """One batch and head (bf16, f32 or int8) of :func:`check_head_ties`."""
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh
    from mpi_pytorch_tpu_torch.ops import quantize as qz

    elem = torch.finfo(dtype).bits // 8 if dtype.is_floating_point else 1
    _, tiles_per_split = fh.tc_geometry(bsz, D, V, elem, fh._num_sms(dev.index),
                                        "check_head_ties")
    last = (V - 1) // 128 * 128  # the ragged last tile's first column
    split_end = tiles_per_split * 128
    pairs = [(127, 128), (256, 258), (384, 392), (130, 386), (520, 600), (1000, 9000),
             (last + 3, V - 2)]
    if all(split_end not in pair for pair in pairs):
        pairs.append((split_end - 1, split_end))
    w = 0.05 * torch.randn(V, D, generator=gen)
    bias = 0.1 * torch.randn(V, generator=gen)
    signs = torch.where(torch.rand(len(pairs), D, generator=gen) < 0.5, -1.0, 1.0)
    for p, (a, b) in enumerate(pairs):
        w[a] = w[b] = 0.1 * signs[p]
        bias[b] = bias[a]
    which = torch.arange(bsz) % len(pairs)
    feats = signs[which] * torch.rand(bsz, D, generator=gen)
    labels = torch.randint(0, V, (bsz,), generator=gen, dtype=torch.int32)
    labels[::7] = -1
    first = torch.tensor([pairs[p][0] for p in which.tolist()], dtype=torch.int32)
    labels, bias, first = labels.to(dev), bias.to(dev), first.to(dev)
    if dtype != torch.int8:
        wd, fd = w.to(dev, dtype), feats.to(dev, dtype)
        call = lambda: fh.head_predict(fd, wd, bias, labels)  # noqa: E731
        ref = (fd.double() @ wd.double().t() + bias.double()).argmax(-1).to(torch.int32)
        name = "head_predict" if dtype == torch.bfloat16 else "head_predict_f32"
    else:
        w_q, w_scale = _int8_head(dev, w)
        fd = feats.to(dev, torch.bfloat16)
        act = float(fd.float().abs().max()) / 127.0
        scale_v = qz.combined_scale(w_scale, act)
        call = lambda: qz.head_predict_int8(fd, w_q, bias, labels, None, act, scale_v)  # noqa: E731
        ref = qz.head_predict_int8_reference(fd, w_q, bias, labels, None, act, scale_v)[1]
        name = "head_predict_int8"
    _, pred = call()
    torch.cuda.synchronize()
    what = f"{name} ties B={bsz}"
    if not torch.equal(ref, first):
        raise AssertionError(f"{what}: the plain argmax misses the pairs' first columns")
    if not torch.equal(pred, ref):
        bad = (pred != ref).nonzero().flatten().tolist()
        raise AssertionError(f"{what}: rows {bad} picked {pred[bad].tolist()}, "
                             f"want {ref[bad].tolist()}")
    _bitwise_twice(call, what)
    log({"head_tie_check": {"name": name, "batch": bsz, "pairs": pairs,
                            "tiles_per_split": tiles_per_split, "rows_equal": bsz}})


def _head_ce_case(fh, w, b, bsz: int, gen, dev) -> dict:
    """One batch of :func:`check_head_ce_train`: bf16 feats, every 7th label
    −1, one label in V's last (ragged) vocab tile, a random upstream
    gradient; kernels against the plain version through autograd, and two
    backward calls bitwise equal."""
    feats = torch.randn(bsz, D, generator=gen).to(dev, torch.bfloat16)
    labels = torch.randint(0, V, (bsz,), generator=gen, dtype=torch.int32)
    labels[::7] = -1
    labels[1 % bsz] = V - 3
    labels = labels.to(dev)
    g = torch.rand(bsz, generator=gen).to(dev)
    out = {}
    for name, fn in (("kernels", fh.fused_head_ce), ("plain", fh.fused_head_ce_reference)):
        leaves = [t.clone().requires_grad_() for t in (feats, w, b)]
        loss = fn(*leaves, labels)
        loss.backward(g)
        out[name] = (loss.detach(), *(t.grad for t in leaves))
    torch.cuda.synchronize()
    (loss, *grads), (ref_loss, *ref_grads) = out["kernels"], out["plain"]
    if not torch.allclose(loss, ref_loss, rtol=1e-5, atol=0):
        raise AssertionError(f"head CE B={bsz}: loss off by {float((loss - ref_loss).abs().max())}")
    gaps = {}
    for gname, got, ref in zip(("dfeats", "dW", "db"), grads, ref_grads):
        gaps[gname] = float((got.float() - ref.float()).norm() / ref.float().norm())
        if gaps[gname] > 2e-3:
            raise AssertionError(f"head CE B={bsz} {gname}: relative L2 gap {gaps[gname]}")
    if bool((grads[0][labels < 0] != 0).any()):
        raise AssertionError(f"head CE B={bsz}: padding rows got a feats gradient")
    wb = w.to(torch.bfloat16)
    _, m, l = fh._ce_forward(feats, wb, b, labels)
    first = fh._ce_backward(feats, wb, b, labels, m, l, g)
    again = fh._ce_backward(feats, wb, b, labels, m, l, g)
    if not all(torch.equal(x, y) for x, y in zip(first, again)):
        raise AssertionError(f"head CE B={bsz} backward: two calls on the same inputs differ")
    loss_err = float((loss - ref_loss).abs().max())
    grad_err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(grads, ref_grads))
    log({"head_ce_train_check": {"batch": bsz, "loss_max_abs_err": loss_err, "grad_rel_l2": gaps,
                                 "grad_max_abs_err": grad_err, "backward_bitwise_repeatable": True}})
    return {"feats": feats, "wb": wb, "labels": labels, "g": g, "m": m, "l": l,
            "loss_err": loss_err, "grad_err": grad_err}


def check_head_ce_train(dev, gen) -> tuple[dict, dict]:
    """K5/K6 against ``fused_head_ce_reference`` at D = 512, V = 64 500 and
    B = 8, 128, 512 (``HEAD_CE_BATCHES``): an f32 W master, bf16 feats,
    every 7th label −1 and one in the ragged last vocab tile, a per-row
    random upstream gradient. Loss rtol 1e-5; dfeats, dW, db within
    relative L2 2e-3; padding rows' dfeats 0; two backward calls bitwise
    equal. Then forward and backward timed at B = 128 beside their plain
    versions and cuBLAS yardsticks (K5: the bf16 logits GEMM; K6: the two
    gradient GEMMs on a given bf16 dlog)."""
    from mpi_pytorch_tpu_torch.hardware import H100_PEAK_BF16_FLOPS, bound_ms
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    w = (0.01 * torch.randn(V, D, generator=gen)).to(dev)
    b = (0.1 * torch.randn(V, generator=gen)).to(dev)
    cases = {bsz: _head_ce_case(fh, w, b, bsz, gen, dev) for bsz in HEAD_CE_BATCHES}
    case, bsz = cases[TRAIN_BATCH], TRAIN_BATCH
    fb, wb, labels, g, m, l = (case[k] for k in ("feats", "wb", "labels", "g", "m", "l"))
    dlog = (torch.randn(bsz, V, generator=gen) * 1e-3).to(dev, torch.bfloat16)
    product = 2 * bsz * D * V
    # K5: bf16 feats and W, f32 b, labels read; loss, m, l written. K6: the
    # same inputs with m, l, g; dW and db (f32) and dfeats (bf16) written;
    # three products.
    fwd_moved = 2 * bsz * D + 2 * V * D + 4 * V + 4 * bsz + 12 * bsz
    bwd_moved = 2 * bsz * D + 2 * V * D + 4 * V + 16 * bsz + 4 * V * D + 4 * V + 2 * bsz * D
    rows = []
    for name, line, moved, n_products, source, kernel, plain, library, err in (
        ("head_ce_forward", 71, fwd_moved, 1, "head_predict_tc.cu",
         lambda: fh._ce_forward(fb, wb, b, labels),
         lambda: fh.fused_head_ce_forward_reference(fb, wb, b, labels),
         lambda: torch.nn.functional.linear(fb, wb), case["loss_err"]),
        ("head_ce_backward", 109, bwd_moved, 3, "fused_head_ce_bwd.cu",
         lambda: fh._ce_backward(fb, wb, b, labels, m, l, g),
         lambda: fh.fused_head_ce_backward_reference(fb, wb, b, labels, m, l, g),
         lambda: (dlog.t() @ fb, dlog @ wb), case["grad_err"]),
    ):
        bound, by = bound_ms(moved, (n_products * product, H100_PEAK_BF16_FLOPS))
        row = {
            "name": name, "route": "cuda", "source": "mpi_pytorch_tpu_torch/csrc/" + source,
            "replaces": f"mpi_pytorch_tpu/ops/fused_head_ce.py:{line}",
            "batch": bsz, "max_abs_err": err,
            "kernel_ms": time_ms(kernel, 50),
            "device_ms": device_ms(kernel, 50), "plain_ms": time_ms(plain, 10),
            "device_ms_by_kernel": device_ms_by_kernel(kernel, 50),
            "bound_ms": bound, "bound_by": by,
            # Yardstick only, never called by the port.
            "library_ms": time_ms(library, 50),
        }
        log({"kernel_check": row})
        rows.append(row)
    return rows[0], rows[1]


def _tied_logits(gen, rows: int) -> torch.Tensor:
    """bf16-rounded f32 logits [rows, V] from few levels (ties everywhere),
    with planted rows: the top value held by more than k columns, ties
    straddling the k-th place, zeros of both signs at the top."""
    x = torch.randint(-8, 9, (rows, V), generator=gen).float() * 0.375
    x = (x + torch.randn(rows, V, generator=gen) * (torch.rand(rows, 1, generator=gen) < 0.5))
    x = x.to(torch.bfloat16).float()
    top = float(x.max()) + 1
    x[0, [7, 3, 250, 11, 90, 4, V - 1]] = top
    x[1, [20, 5]] = top
    x[1, [30, 1, 200, 150, 77]] = top - 1
    x[2] = torch.where(torch.arange(V) % 2 == 1, 0.0, -0.0)
    x[3] = -1.0
    x[3, [9, 40]] = -0.0
    x[3, [60, 2]] = 0.0
    return x


def check_topk_ties(dev, gen) -> None:
    """ROADMAP C4 on the card: the plain predict step (``make_predict_step``
    with ``topk``, its model here returning fixed bf16-rounded logits with
    planted ties) must give each row's top k as ``jax.lax.top_k`` orders
    them — by value descending in its total order of floats (+0.0 above
    −0.0), equal values by index ascending: a NumPy stable descending
    argsort over that order, row for row. Column 0 must be the first-index
    argmax wherever the row's max is not a signed zero. Logs how many rows
    a bare ``torch.topk`` on the card orders otherwise."""
    from mpi_pytorch_tpu_torch.evaluate import make_predict_step

    x = _tied_logits(gen, TOPK_ROWS)
    bits = x.numpy().view(np.int32)
    order = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits).astype(np.int64)
    want = np.argsort(-order, axis=-1, kind="stable")[:, :TOPK].astype(np.int32)
    logits = x.to(dev)

    class Fixed(torch.nn.Module):
        def forward(self, _):
            return logits

    images = torch.zeros((TOPK_ROWS, 2, 2, 3), dtype=torch.uint8, device=dev)
    labels = torch.zeros((TOPK_ROWS,), dtype=torch.int32, device=dev)
    _, got = make_predict_step(torch.float32, topk=TOPK)(Fixed(), images, labels)
    _, top1 = make_predict_step(torch.float32)(Fixed(), images, labels)
    torch.cuda.synchronize()
    got, top1 = got.cpu().numpy(), top1.cpu().numpy()
    bad = np.flatnonzero((got != want).any(axis=1))
    if bad.size:
        raise AssertionError(f"top-{TOPK} ties: rows {bad[:10].tolist()} give {got[bad[0]].tolist()}, "
                             f"want {want[bad[0]].tolist()}")
    signed_zero = (x.amax(dim=-1) == 0).numpy()
    if not np.array_equal(got[~signed_zero, 0], top1[~signed_zero]):
        raise AssertionError(f"top-{TOPK} column 0 differs from the argmax")
    bare = torch.topk(logits, TOPK, dim=-1).indices.cpu().numpy()
    log({"topk_tie_check": {"rows": TOPK_ROWS, "k": TOPK, "rows_equal": TOPK_ROWS,
                            "bare_torch_topk_rows_differing": int((bare != want).any(axis=1).sum())}})


def _qkv(gen, shape, dev, n: int = 3, dtype=torch.bfloat16):
    return [torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(n)]


def _grad_check(got, ref, what: str) -> float:
    """bf16 gradients against f32 autograd: within one bf16 ulp of the
    reference (2^-7 relative) plus 1e-4 of its largest magnitude (f32 sums
    over S terms in another order, then the bf16 rounding); returns the max
    abs error."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    tol = 2.0**-7 * r.abs() + 1e-4 * r.abs().max()
    if not bool(torch.isfinite(g).all()) or bool((err > tol).any()):
        raise AssertionError(f"{what}: {int((err > tol).sum())} values off, max err {float(err.max())}")
    return float(err.max())


def _attn_check(got, ref, what: str) -> float:
    """An attention output against its plain version in its own dtype: bf16
    within one bf16 ulp (``_ulp_check``); f32 within rtol/atol 2e-5, the
    JAX attention tests' own (f32 sums of up to S terms in other orders).
    Returns the max abs error."""
    if got.dtype == torch.bfloat16:
        return _ulp_check(got, ref, what)
    err = (got - ref).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > 2e-5 + 2e-5 * ref.abs()).any()):
        raise AssertionError(f"{what}: off by up to {float(err.max())} (rtol/atol 2e-5)")
    return float(err.max())


def _f64_check(name: str, q, k, v, out, lse=None) -> dict:
    """An f32 tensor-core forward's output (and K8's lse) on the card
    against ``attention_f64`` on the same inputs, beside the two readings
    that place the limit: the six-pair torch emulation of the kernel's
    arithmetic (``emulate_flash`` where there is an lse, else
    ``emulate_small``) and the three-pair control. Raises unless the six
    pairs come within ``F64_REL``, the three pairs do not, and the kernel
    does (its lse within 1e-5). Logs and returns the gaps."""
    from mpi_pytorch_tpu_torch.ops.attention_split_numerics import (
        F64_REL, SIX, THREE, attention_f64, emulate_flash, emulate_small, relative_gap,
    )

    ref, ref_lse = attention_f64(q, k, v)
    gaps = {"kernel": relative_gap(out, ref)}
    for label, pairs in (("six_pairs", SIX), ("three_pairs", THREE)):
        emu = emulate_small(q, k, v, False, pairs) if lse is None else emulate_flash(q, k, v, False, pairs)
        gaps[label] = relative_gap(emu if lse is None else emu[0], ref)
        if lse is not None:
            gaps[f"{label}_lse_abs"] = float((emu[1].double() - ref_lse).abs().max())
    if lse is not None:
        gaps["kernel_lse_abs"] = float((lse.double() - ref_lse).abs().max())
    log({"f32_split_vs_f64": {"name": name, "shape": list(q.shape), "limit": F64_REL, **gaps}})
    if not gaps["six_pairs"] <= F64_REL < gaps["three_pairs"]:
        raise AssertionError(f"{name}: F64_REL {F64_REL} does not separate six pairs from three: {gaps}")
    if gaps["kernel"] > F64_REL or gaps.get("kernel_lse_abs", 0.0) > 1e-5:
        raise AssertionError(f"{name}: the kernel is off float64 attention by {gaps}")
    return gaps


def _f64_grad_check(name: str, q, k, v, do, grads) -> dict:
    """K10's f32 tensor-core gradients (dq, dk, dv) on the card against
    ``attention_backward_f64`` on the same inputs (the largest
    ``relative_gap`` of the three), beside its six-pair torch emulation
    (``emulate_small_backward``) and the three-pair control. Raises unless
    the six pairs and the kernel come within ``F64_REL`` and the three pairs
    do not. Logs and returns the gaps."""
    from mpi_pytorch_tpu_torch.ops.attention_split_numerics import (
        F64_REL, SIX, THREE, attention_backward_f64, emulate_small_backward, relative_gap,
    )

    ref = attention_backward_f64(q, k, v, do)
    gaps = {"kernel": max(relative_gap(g, r) for g, r in zip(grads, ref))}
    for label, pairs in (("six_pairs", SIX), ("three_pairs", THREE)):
        emu = emulate_small_backward(q, k, v, do, False, pairs)
        gaps[label] = max(relative_gap(g, r) for g, r in zip(emu, ref))
    log({"f32_split_vs_f64": {"name": name, "shape": list(q.shape), "limit": F64_REL, **gaps}})
    if not gaps["six_pairs"] <= F64_REL < gaps["three_pairs"]:
        raise AssertionError(f"{name}: F64_REL {F64_REL} does not separate six pairs from three: {gaps}")
    if gaps["kernel"] > F64_REL:
        raise AssertionError(f"{name}: the kernel is off float64 attention gradients by {gaps}")
    return gaps


def _attn_work(
    b: int, s: int, h: int, d: int, *, bf16_products: int, split_products: int,
    per_score: int, per_elem: int, f32: bool = False,
) -> tuple[tuple[float, float], ...]:
    """The (operations, peak) pairs of attention's least arithmetic over
    B·H heads of S rows, for ``hardware.bound_ms``. Each product is one
    [S, S]·[S, D]-sized multiply, 2·S²·D operations (a multiply-add counts
    2). With bf16 inputs a product of two bf16 operands (``bf16_products``:
    q·kᵀ with the scale applied to the f32 scores afterwards, do·vᵀ) is
    exact in f32 on the bf16 tensor cores: one product at their peak. A
    product of the f32 p or ds with a bf16 operand (``split_products``:
    p·v, pᵀ·do, ds·k, dsᵀ·q) is three bf16 products at that peak: p splits
    into three bf16 terms that keep it to 2^-25 relative (two keep 2^-17,
    which crosses the one-ulp check at outputs near zero:
    ``csrc/attention_tc.cuh``), and each term times a bf16 operand is
    exact. With f32 inputs (``f32``) every product
    is three TF32 products (a = a_hi + a_lo in TF32, a·b ≈ a_hi·b_hi +
    a_hi·b_lo + a_lo·b_hi to ~2^-21 relative: the split of CUTLASS's fast
    f32 GEMMs, which SDPA's f32 kernel runs). The elementwise work —
    ``per_score`` operations per score, ``per_elem`` per [S, D] element —
    at the f32 peak."""
    from mpi_pytorch_tpu_torch.hardware import (
        H100_PEAK_BF16_FLOPS, H100_PEAK_F32_FLOPS, H100_PEAK_TF32_FLOPS,
    )

    product = 2 * s * s * d
    elementwise = (b * h * (per_score * s * s + per_elem * s * d), H100_PEAK_F32_FLOPS)
    if f32:
        return (b * h * 3 * (bf16_products + split_products) * product, H100_PEAK_TF32_FLOPS), elementwise
    return (b * h * (bf16_products + 3 * split_products) * product, H100_PEAK_BF16_FLOPS), elementwise


def _kernel_row(name: str, source: str, line: str, shape, dtype, err: float, fn, plain,
                library, moved: float, work, iters: int, plain_iters: int,
                f64_gaps: dict | None = None) -> dict:
    """One ``kernel_check`` row: the kernel's busy time (``device_ms``) and
    event time, its plain version's event time, its bound, and the
    yardstick ``library`` (one PyTorch call of the same function, never
    called by the port) timed both ways; ``f64_gaps`` (``_f64_check``'s)
    where given. Raises when a measured time reads below the bound: the
    bound would be wrong."""
    from mpi_pytorch_tpu_torch.hardware import bound_ms

    bound, by = bound_ms(moved, *work)
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": line,
        "shape": list(shape), "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
        "kernel_ms": time_ms(fn, iters), "device_ms": device_ms(fn, iters),
        "plain_ms": time_ms(plain, plain_iters), "bound_ms": bound, "bound_by": by,
        "library_ms": device_ms(library, iters), "library_event_ms": time_ms(library, iters),
    }
    if f64_gaps is not None:
        row["f64_gaps"] = f64_gaps
    log({"kernel_check": row})
    for key in ("device_ms", "library_ms"):
        if row[key] < bound:
            raise AssertionError(f"{name}: {key} {row[key]} below its bound {bound} ms")
    return row


def _check_k10(fas, full_attention, q, k, v, do, causal: bool, what: str) -> float:
    """K10 on its route's kernel (``_build.attention_route``) against
    autograd through ``full_attention`` in f32: bf16 gradients by
    ``_grad_check``, f32 ones within rtol/atol 2e-5 (``_attn_check``); two
    calls bitwise equal, and the route's counter (and only it) moved by the
    two launches. Returns the max abs error."""
    from mpi_pytorch_tpu_torch.ops import _build

    counters = {"tc": fas.backward_tc_counter, PADDED_SUFFIX: fas.backward_tc_pad_counter,
                "f32tc": fas.backward_tc_f32_counter}
    grads = _launch_twice(lambda: fas.attention_small_backward(q, k, v, do, causal), counters,
                           _suffix(_build.attention_route(q.dtype, q.shape[-1]), q.shape[-1]), what)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    full_attention(*leaves, causal=causal).backward(do.float())
    check = _grad_check if q.dtype == torch.bfloat16 else _attn_check
    return max(check(got, leaf.grad, f"{what} {name}")
               for name, got, leaf in zip(("dq", "dk", "dv"), grads, leaves))


# An attention kernel's route (``_build.attention_route``) → the suffix
# of its kernel's row and launch count; bf16 head dims that are not a
# multiple of 16 (the tensor-core kernels zero-padded to the next one) have
# rows and counters of their own, timed at D = 40.
ROUTE_SUFFIX = {"tensor_core": "tc", "tensor_core_f32": "f32tc", "ffma": "ffma"}
PADDED_SUFFIX = "tc_d40"


def _suffix(route: str, d: int) -> str:
    return PADDED_SUFFIX if route == "tensor_core" and d % 16 else ROUTE_SUFFIX[route]


def _views(gen, shape, dev, n: int, offset: int):
    """n bf16 tensors of ``shape`` [B, S, H, D] as views of [B, S, H, D + 4]
    from column ``offset``: their rows start on 8 bytes (offset 0, rows of
    D + 4 elements with D % 8 == 4 or 0) or 2 bytes (offset 1)."""
    d = shape[3]
    return [t[..., offset:offset + d] for t in _qkv(gen, shape[:3] + (d + 4,), dev, n)]


def _launch_twice(fn, counters: dict, key: str, what: str):
    """Two calls of an attention kernel's wrapper, synchronized: the
    counter under ``key`` (its kernel's suffix, ``_suffix``), and only it,
    moved by two, and the two results bitwise equal. Returns the first
    result."""
    before = {name: c.count for name, c in counters.items()}
    out, again = fn(), fn()
    torch.cuda.synchronize()
    moved = {name: c.count - before[name] for name, c in counters.items()}
    if moved != {name: 2 * (name == key) for name in counters}:
        raise AssertionError(f"{what}: launches {moved}, want two on {key}")
    pairs = zip(out, again) if isinstance(out, tuple) else ((out, again),)
    if not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    return out


def check_attention_small(dev, gen) -> tuple[dict, ...]:
    """K9 and K10, each on its three kernels, against their plain versions
    at vit_s16's 128 px shape, at a padded S = 50, S = 65, S = 128 and
    causal: K9's training forward in bf16 (the tensor-core kernel) within
    one bf16 ulp of ``full_attention``, its bf16 inference forward (the
    FFMA kernel) the same, its f32 forward, training and inference (the f32
    tensor-core kernel), within rtol/atol 2e-5 (``_attn_check``) — and the
    f32 forward also at D = 40, D = 128 and S = 128 with D = 128, the FFMA
    forward at bf16 D = 40, and its inference forward also on rows that
    are not 16-byte aligned and at S = D = 128 (read from device memory
    into its tiles); each twice, bitwise equal, on its route's
    counter only. K10's dq, dk, dv against autograd through
    ``full_attention`` in f32, two calls bitwise equal, on its route's
    counter only — bf16 (``_grad_check``) and f32 (rtol/atol 2e-5) at D = 64
    and every S, both tensor-core kernels also at D = 128 and the
    envelope's corner S = 128, D = 128, the bf16 one at D = 32, the f32 one
    at D = 40, and the bf16 one at the head dims it takes zero-padded to a
    multiple of 16 (D = 40, 36, 8, 120; S = 50, 65, 128 and causal at
    D = 40; q, k, v views whose rows start on 8 bytes, copied in 8-byte
    pieces, and on 2 bytes, element by element). Then each timed beside
    its plain version and ``scaled_dot_product_attention`` (its backward
    for K10) in the same dtype and shape; the f32 tensor-core rows also
    against float64 (``_f64_check``, ``_f64_grad_check``). Returns the rows
    (K9 tensor-core, K9 f32 tensor-core, K9 FFMA at bf16 inference, K10
    tensor-core, K10 f32 tensor-core, K10 tensor-core at bf16 D = 40)."""
    from mpi_pytorch_tpu_torch.ops import _build
    from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
    from mpi_pytorch_tpu_torch.ops.ring_attention import full_attention

    counters = {"tc": fas.forward_tc_counter, "f32tc": fas.forward_tc_f32_counter,
                "ffma": fas.forward_ffma_counter}
    b, s, h, d = ATTN_SMALL_SHAPE
    fwd_err = dict.fromkeys(ROUTE_SUFFIX.values(), 0.0)
    bwd_err = dict.fromkeys((*ROUTE_SUFFIX.values(), PADDED_SUFFIX), 0.0)
    forwards = ((torch.bfloat16, True, "tensor_core"), (torch.bfloat16, False, "ffma"),
                (torch.float32, True, "tensor_core_f32"), (torch.float32, False, "tensor_core_f32"))
    cases = [((b, seq, h, d), causal, forwards)
             for seq, causal in ((s, False), (50, False), (65, False), (128, False), (s, True))]
    # The envelope's other head dims: the f32 kernel at D = 40 (not a
    # multiple of 16) and 128, and at S = 128 with D = 128 (its largest
    # shared memory, 193 KB); the FFMA kernel at a bf16 D the tensor cores
    # do not take.
    f32_only = forwards[2:]
    cases += [((b // 2, s, h, 40), False, f32_only), ((b // 2, s, h, 128), False, f32_only),
              ((8, 128, h, 128), False, f32_only),
              ((b // 2, s, h, 40), False, ((torch.bfloat16, True, "ffma"),))]
    for shape, causal, runs in cases:
        tag = f"{list(shape)}{', causal' if causal else ''}"
        for dtype, train, route in runs:
            q, k, v = _qkv(gen, shape, dev, 3, dtype)
            what = f"K9 {route} {tag} {str(dtype).removeprefix('torch.')} train={train}"
            out = _launch_twice(lambda: fas.attention_small_forward(q, k, v, causal, train=train),
                                 counters, ROUTE_SUFFIX[route], what)
            err = _attn_check(out, full_attention(q, k, v, causal=causal), what)
            fwd_err[ROUTE_SUFFIX[route]] = max(fwd_err[ROUTE_SUFFIX[route]], err)
    # The bf16 inference forward's other way in: each head read from device
    # memory into its tiles, for rows that are not 16-byte aligned (a view
    # of D + 4 columns) and at S = D = 128, whose stage does not fit.
    for shape, pad in (((b // 4, s, h, d), 4), ((8, 128, h, 128), 0)):
        q, k, v = (t[..., :shape[3]] for t in _qkv(gen, shape[:3] + (shape[3] + pad,), dev))
        what = f"K9 ffma {list(shape)} bf16 train=False{', rows unaligned' if pad else ''}"
        out = _launch_twice(lambda: fas.attention_small_forward(q, k, v, False, train=False),
                            counters, "ffma", what)
        fwd_err["ffma"] = max(fwd_err["ffma"], _attn_check(out, full_attention(q, k, v), what))
    bwd_cases = [((b, seq, h, d), causal, dtype, None)
                 for seq, causal in ((s, False), (50, False), (65, False), (128, False), (s, True))
                 for dtype in (torch.bfloat16, torch.float32)]
    # The backward's other head dims: the bf16 tensor-core kernel at D = 32
    # and 128 (and S = 128 with D = 128, where its shared memory holds one
    # stage); the f32 one at D = 40 (not a multiple of 16), 128 (two
    # slots, inputs staged again between products) and S = 128 with
    # D = 128 (193 KB).
    bwd_cases += [((b // 2, s, h, 32), False, torch.bfloat16, None),
                  ((b // 2, s, h, 128), False, torch.bfloat16, None),
                  ((8, 128, h, 128), False, torch.bfloat16, None),
                  ((b // 2, s, h, 40), False, torch.float32, None),
                  ((b // 2, s, h, 128), False, torch.float32, None),
                  ((8, 128, h, 128), False, torch.float32, None)]
    # The bf16 tensor-core kernel at head dims that are not a multiple of
    # 16, zero-padded to the next one: 16-byte rows (D = 40, 8, 120; D = 40
    # also at S = 50, 65, 128 and causal), 8-byte rows (D = 36, and the
    # first 40 of 44 columns: q, k, v as views) and 2-byte rows (a view
    # from column 1).
    bwd_cases += [((b // 2, seq, h, 40), causal, torch.bfloat16, None)
                  for seq, causal in ((s, False), (50, False), (65, False), (128, False), (s, True))]
    bwd_cases += [((b // 2, s, h, 36), False, torch.bfloat16, None),
                  ((b // 2, s, h, 8), False, torch.bfloat16, None),
                  ((b // 2, s, h, 120), False, torch.bfloat16, None),
                  ((8, 128, h, 120), False, torch.bfloat16, None),
                  ((b // 2, 65, h, 36), True, torch.bfloat16, None),
                  ((b // 2, s, h, 40), False, torch.bfloat16, 0),
                  ((b // 2, 65, h, 40), False, torch.bfloat16, 1)]
    for shape, causal, dtype, offset in bwd_cases:
        route = _build.attention_route(dtype, shape[-1])
        if offset is None:
            q, k, v, do = _qkv(gen, shape, dev, 4, dtype)
        else:
            (q, k, v), (do,) = _views(gen, shape, dev, 3, offset), _qkv(gen, shape, dev, 1)
        what = (f"K10 {route} {list(shape)} {str(dtype).removeprefix('torch.')}"
                f"{', causal' if causal else ''}{'' if offset is None else f', view from column {offset}'}")
        key = _suffix(route, shape[-1])
        bwd_err[key] = max(bwd_err[key], _check_k10(fas, full_attention, q, k, v, do, causal, what))

    source = "mpi_pytorch_tpu_torch/csrc/fused_attention_small.cu"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dtype, train, suffix in ((torch.bfloat16, True, "tc"), (torch.float32, True, "f32tc"),
                                 (torch.bfloat16, False, "ffma")):
        q, k, v = _qkv(gen, ATTN_SMALL_SHAPE, dev, 3, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # SDPA's [B, H, S, D]
        gaps = (_f64_check("attention_small_forward_f32tc", q, k, v,
                           fas.attention_small_forward(q, k, v, train=True))
                if suffix == "f32tc" else None)
        # q, k, v read, out written. q·kᵀ, p·v; per score mask, max, exp
        # of the difference, sum; per element q·scale, ÷ l.
        rows.append(_kernel_row(
            f"attention_small_forward_{suffix}", source,
            "mpi_pytorch_tpu/ops/fused_attention_small.py:135", ATTN_SMALL_SHAPE, dtype,
            fwd_err[suffix], lambda: fas.attention_small_forward(q, k, v, train=train),
            lambda: full_attention(q, k, v), lambda: sdpa(qt, kt, vt), 4 * q.numel() * q.element_size(),
            _attn_work(b, s, h, d, bf16_products=1, split_products=1, per_score=4, per_elem=2,
                       f32=dtype == torch.float32), 50, 20, f64_gaps=gaps))
    for shape, dtype, suffix in ((ATTN_SMALL_SHAPE, torch.bfloat16, "tc"),
                                 (ATTN_SMALL_SHAPE, torch.float32, "f32tc"),
                                 ((b, s, h, 40), torch.bfloat16, PADDED_SUFFIX)):
        q, k, v, do = _qkv(gen, shape, dev, 4, dtype)
        leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
        out_t, dot = sdpa(*leaves), do.transpose(1, 2).contiguous()
        gaps = (_f64_grad_check("attention_small_backward_f32tc", q, k, v, do,
                                fas.attention_small_backward(q, k, v, do))
                if suffix == "f32tc" else None)
        # q, k, v, do read; dq, dk, dv written. q·kᵀ and dp = do·vᵀ (bf16),
        # dv = pᵀ·do, dq = ds·k, dk = dsᵀ·q (split); per score the softmax
        # (4) and its normalizing (1), Δ = Σ p·dp (2), ds = p·(dp − Δ) (2) —
        # Δ needs no recomputed o = p·v; per element q·scale, dq·scale,
        # dk·scale.
        rows.append(_kernel_row(
            f"attention_small_backward_{suffix}", source,
            "mpi_pytorch_tpu/ops/fused_attention_small.py:151", shape, dtype,
            bwd_err[suffix], lambda: fas.attention_small_backward(q, k, v, do),
            lambda: fas.attention_small_backward_reference(q, k, v, do),
            lambda: torch.autograd.grad(out_t, leaves, dot, retain_graph=True),
            7 * q.numel() * q.element_size(),
            _attn_work(b, s, h, shape[3], bf16_products=2, split_products=3, per_score=9, per_elem=3,
                       f32=dtype == torch.float32), 50, 20, f64_gaps=gaps))
    return tuple(rows)


def check_flash(dev, gen) -> tuple[dict, ...]:
    """K8 on its two kernels against its plain version at vit_s16's
    224 px shape and at a longer causal S: bf16 (the tensor-core route;
    also zero-padded at D = 40, 36, 8 and 120, at the long causal S with
    D = 40 and 36, and on q, k, v views whose rows start on 8 bytes and on
    2 bytes) within one bf16 ulp of ``full_attention``, f32 (the f32
    tensor-core route; also at D = 40 and D = 128) within rtol/atol 2e-5
    (``_attn_check``); the lse within rtol/atol 1e-5 of ``torch.logsumexp``
    of the plain scores; each twice, bitwise equal, on its route's counter
    only. Then each kernel timed beside its plain version and
    ``scaled_dot_product_attention`` (bf16 also at D = 40), after one
    ``flash_backward_yardstick`` line: the blocked torch backward's busy
    time beside SDPA's backward and their bound. Returns the rows
    (tensor-core, f32 tensor-core, tensor-core at bf16 D = 40)."""
    from mpi_pytorch_tpu_torch.hardware import bound_ms
    from mpi_pytorch_tpu_torch.ops import _build
    from mpi_pytorch_tpu_torch.ops import flash_attention as fa

    counters = {"tc": fa.tc_counter, PADDED_SUFFIX: fa.tc_pad_counter, "f32tc": fa.tc_f32_counter}
    b, s, h, d = FLASH_SHAPE
    padded_shape = (b, s, h, 40)
    err = dict.fromkeys(("tc", "f32tc", PADDED_SUFFIX), 0.0)
    cases = [(shape, causal, dtype, None)
             for shape, causal in ((FLASH_SHAPE, False), (FLASH_LONG_SHAPE, True))
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [((b // 8, s, h, 40), False, torch.float32, None),
              ((b // 8, s, h, 128), False, torch.float32, None)]
    # bf16 head dims that are not a multiple of 16, zero-padded to the next
    # one: 16-byte rows (D = 40, 8, 120), 8-byte rows (D = 36, and the first
    # 40 of 44 columns as views), 2-byte rows (a view from column 1).
    long_b, long_s, long_h, _ = FLASH_LONG_SHAPE
    cases += [(padded_shape, False, torch.bfloat16, None),
              ((b // 8, s, h, 36), False, torch.bfloat16, None),
              ((b // 8, s, h, 8), False, torch.bfloat16, None),
              ((b // 8, s, h, 120), False, torch.bfloat16, None),
              ((long_b, long_s, long_h, 40), True, torch.bfloat16, None),
              ((long_b, long_s, long_h, 36), True, torch.bfloat16, None),
              ((b // 8, s, h, 40), False, torch.bfloat16, 0),
              ((b // 8, s, h, 36), True, torch.bfloat16, 1)]
    for shape, causal, dtype, offset in cases:
        route = _build.attention_route(dtype, shape[-1])
        q, k, v = _qkv(gen, shape, dev, 3, dtype) if offset is None else _views(gen, shape, dev, 3, offset)
        blk = min(fa.DEFAULT_BLOCK_Q, max(8, shape[1]))
        tag = (f"K8 {route} {list(shape)} {str(dtype).removeprefix('torch.')}{', causal' if causal else ''}"
               f"{'' if offset is None else f', view from column {offset}'}")
        key = _suffix(route, shape[-1])
        out, lse = _launch_twice(lambda: fa.flash_forward(q, k, v, causal, blk, blk), counters,
                                  key, tag)
        ref, ref_lse = fa.flash_forward_reference(q, k, v, causal)
        e = _attn_check(out, ref, tag)
        if not torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{tag} lse: off by {float((lse - ref_lse).abs().max())}")
        err[key] = max(err[key], e, float((lse - ref_lse).abs().max()))
    # The yardstick that places a flash backward kernel (no TPU kernel
    # stands behind the blocked backward, so it is no row of the kernels
    # line): the busy time of ``flash_backward`` and of SDPA's backward on
    # the same inputs, and the bound of the function both compute (bytes
    # as K10's plus out and the lse read; products and elementwise work as
    # K10's).
    q, k, v, do = _qkv(gen, FLASH_SHAPE, dev, 4)
    blk = min(fa.DEFAULT_BLOCK_K, max(8, s))
    out, lse = fa.flash_forward(q, k, v, False, blk, blk)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    out_t = torch.nn.functional.scaled_dot_product_attention(*leaves)
    dot = do.transpose(1, 2).contiguous()
    bound, by = bound_ms(8 * q.numel() * q.element_size() + 4 * b * h * s,
                         *_attn_work(b, s, h, d, bf16_products=2, split_products=3,
                                     per_score=9, per_elem=3))
    log({"flash_backward_yardstick": {
        "shape": list(FLASH_SHAPE), "dtype": "bfloat16", "block_k": blk,
        "flash_backward_device_ms": device_ms(
            lambda: fa.flash_backward(q, k, v, out, lse, do, False, blk), 10),
        "sdpa_backward_device_ms": device_ms(
            lambda: torch.autograd.grad(out_t, leaves, dot, retain_graph=True), 20),
        "bound_ms": bound, "bound_by": by,
    }})
    rows = []
    for shape, dtype, suffix in ((FLASH_SHAPE, torch.bfloat16, "tc"), (FLASH_SHAPE, torch.float32, "f32tc"),
                                 (padded_shape, torch.bfloat16, PADDED_SUFFIX)):
        q, k, v = _qkv(gen, shape, dev, 3, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        gaps = (_f64_check("flash_forward_f32tc", q, k, v, *fa.flash_forward(q, k, v, False))
                if suffix == "f32tc" else None)
        # q, k, v read, out written; lse (f32). As K9's forward: the online
        # recurrence's rescaling is the kernel's choice, not the function's
        # work.
        rows.append(_kernel_row(
            f"flash_forward_{suffix}", "mpi_pytorch_tpu_torch/csrc/flash_attention.cu",
            "mpi_pytorch_tpu/ops/flash_attention.py:53", shape, dtype, err[suffix],
            lambda: fa.flash_forward(q, k, v, False), lambda: fa.flash_forward_reference(q, k, v),
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
            4 * q.numel() * q.element_size() + 4 * b * h * s,
            _attn_work(b, s, h, shape[3], bf16_products=1, split_products=1, per_score=4, per_elem=2,
                       f32=dtype == torch.float32), 20, 10, f64_gaps=gaps))
    return tuple(rows)


def _plain_top1(
    model, images: np.ndarray, chunk: int, dev, head_logits=None
) -> tuple[np.ndarray, np.ndarray]:
    """(argmax, top-2 gap / |max|) per image through the plain bf16 path —
    ``model.features``, then ``head_logits(feats)``, by default f32 logits
    over the head's bf16 copy of W — in batches of ``chunk``."""
    from mpi_pytorch_tpu_torch.evaluate import head_weights
    from mpi_pytorch_tpu_torch.train.step import ingest_images

    if head_logits is None:
        w, b = head_weights(model, torch.bfloat16)

        def head_logits(feats):
            return feats.float() @ w.float().t() + b

    idx, gap = [], []
    with torch.no_grad():
        for s in range(0, len(images), chunk):
            x = torch.from_numpy(images[s : s + chunk]).to(dev)
            feats = model.features(ingest_images(x, torch.bfloat16).permute(0, 3, 1, 2))
            top2 = torch.topk(head_logits(feats), 2, dim=-1)
            idx.append(top2.indices[:, 0].cpu().numpy())
            v = top2.values.cpu().numpy()
            gap.append((v[:, 0] - v[:, 1]) / np.abs(v[:, 0]))
    return np.concatenate(idx), np.concatenate(gap)


def _agreement(preds: np.ndarray, ref: np.ndarray, gap: np.ndarray, what: str):
    """(agree, clear, share agreeing): served top-1 against the plain
    path's, which must agree on ≥ 99 % of rows and on every row whose
    plain top-2 gap exceeds ``E2E_GAP``·|max|."""
    agree = preds == ref
    clear = gap > E2E_GAP
    frac = float(agree.mean())
    if not agree[clear].all() or frac < 0.99:
        raise AssertionError(
            f"{what} top-1 vs plain path: {int(agree.sum())}/{len(ref)} agree, "
            f"{int(agree[clear].sum())}/{int(clear.sum())} on rows with a top-2 gap "
            f"above {E2E_GAP}·|max|"
        )
    return agree, clear, frac


def _serve_cfg(**kw):
    """resnet18 serving at full width: 64 500 classes, 128 px, bf16, uint8
    input, fused stem and fused head, buckets 1,8,32,128,512."""
    from mpi_pytorch_tpu_torch import Config

    return Config(**{**dict(
        model_name="resnet18", num_classes=V, width=IMG, height=IMG,
        compute_dtype="bfloat16", input_dtype="uint8", fused_stem=True,
        fused_head_eval=True, serve_topk=1, serve_buckets="1,8,32,128,512",
        seed=SEED,
    ), **kw})


def _flood(srv, images: np.ndarray) -> tuple[np.ndarray, dict]:
    """``FLOOD`` requests submitted at once, then ``SINGLES`` one at a time:
    (top-1 answers [n], {flood img/s, latency percentiles})."""
    done_at: dict[int, float] = {}
    lock = threading.Lock()

    def stamp(i):
        def cb(_):
            with lock:
                done_at[i] = time.perf_counter()
        return cb

    submitted, futs = {}, []
    t_start = time.perf_counter()
    for i in range(FLOOD):
        submitted[i] = time.perf_counter()
        f = srv.submit(images[i])
        f.add_done_callback(stamp(i))
        futs.append(f)
    preds = [f.result(timeout=600) for f in futs]
    t_flood = max(done_at[i] for i in range(FLOOD)) - t_start
    for i in range(FLOOD, FLOOD + SINGLES):
        submitted[i] = time.perf_counter()
        f = srv.submit(images[i])
        f.add_done_callback(stamp(i))
        preds.append(f.result(timeout=600))
    preds = np.stack(preds)
    if preds.shape != (FLOOD + SINGLES, 1) or preds.min() < 0 or preds.max() >= V:
        raise AssertionError(f"bad predictions: shape {preds.shape}, range {preds.min()}..{preds.max()}")
    lat_flood = [1e3 * (done_at[i] - submitted[i]) for i in range(FLOOD)]
    lat_single = [1e3 * (done_at[i] - submitted[i]) for i in range(FLOOD, FLOOD + SINGLES)]

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    return preds[:, 0], {
        "requests": len(images), "flood_img_per_s": FLOOD / t_flood,
        "flood_p50_ms": pct(lat_flood, 50), "flood_p99_ms": pct(lat_flood, 99),
        "single_p50_ms": pct(lat_single, 50), "single_p99_ms": pct(lat_single, 99),
        "single_mean_ms": statistics.fmean(lat_single),
    }


def serve_resnet18(dev) -> dict:
    """The slice at full width through ``InferenceServer``; returns the
    launch counts of the main-path run."""
    from mpi_pytorch_tpu_torch.evaluate import build_inference
    from mpi_pytorch_tpu_torch.ops import fused_head_ce, fused_stem
    from mpi_pytorch_tpu_torch.serve import InferenceServer

    cfg = _serve_cfg()
    images = np.random.default_rng(SEED).integers(
        0, 256, size=(FLOOD + SINGLES, 128, 128, 3), dtype=np.uint8
    )
    t0 = time.perf_counter()
    srv = InferenceServer(cfg, device=dev)
    log(f"server built and warmed in {time.perf_counter() - t0:.1f} s")
    try:
        fused_stem.counter.reset()
        fused_head_ce.counter.reset()
        preds, timing = _flood(srv, images)
        launches = {"stem": fused_stem.counter.count, "head": fused_head_ce.counter.count}
        stats = srv.stats()
        resident = srv._exe.resident_bytes()
    finally:
        srv.close()
    if launches["stem"] < 1 or launches["head"] < 1:
        raise AssertionError(f"the serving run did not go through both kernels: {launches}")

    # The plain path: the same seeded weights with the plain stem, and the
    # plain head over the same bf16 copy of W.
    plain_cfg = dataclasses.replace(cfg, fused_stem=False, fused_head_eval=False)
    plain = build_inference(plain_cfg, dev)
    # The served batches hold other rows than these chunks, and cuDNN picks
    # its convolution algorithms per batch shape, so bf16 activations (and
    # then logits) differ at the bf16 level between the two paths: near
    # ties may flip. The plain path run in two chunkings shows that floor.
    ref, gap = _plain_top1(plain, images, 512, dev)
    ref32, _ = _plain_top1(plain, images, 32, dev)
    agree, clear, frac = _agreement(preds, ref, gap, "served resnet18")
    log({"serve": {
        "model": "resnet18", "num_classes": V, "image": 128, "dtype": "bfloat16", **timing,
        "resident_bytes": resident,
        "by_bucket": stats["by_bucket"], "batches": stats["batches"],
        "padded_rows": stats["padded_rows"], "launches": launches,
        "top1_agree_plain": frac, "clear_rows": int(clear.sum()),
        "largest_flipped_gap": float(gap[~agree].max()) if not agree.all() else None,
        "plain_512_vs_32_agree": float((ref == ref32).mean()),
    }})
    predict_step_times(cfg, srv.model, plain_cfg, plain, dev)
    return launches


def serve_resnet18_f32(dev) -> int:
    """The f32 model through ``InferenceServer`` with the fused stem and the
    fused head, whose f32 kernel it runs; returns that kernel's launches.
    Answers against the plain f32 path: ≥ 99 % equal, and equal wherever
    the plain top-2 gap exceeds ``E2E_GAP_F32``·|max|."""
    from mpi_pytorch_tpu_torch import Config
    from mpi_pytorch_tpu_torch.evaluate import build_inference, head_weights
    from mpi_pytorch_tpu_torch.ops import fused_head_ce
    from mpi_pytorch_tpu_torch.serve import InferenceServer
    from mpi_pytorch_tpu_torch.train.step import ingest_images

    cfg = Config(
        model_name="resnet18", num_classes=V, width=IMG, height=IMG,
        compute_dtype="float32", input_dtype="uint8", fused_stem=True,
        fused_head_eval=True, serve_topk=1, serve_buckets="8,64", seed=SEED,
    )
    images = np.random.default_rng(SEED + 2).integers(
        0, 256, size=(F32_SERVE_IMAGES, IMG, IMG, 3), dtype=np.uint8
    )
    srv = InferenceServer(cfg, device=dev)
    try:
        fused_head_ce.counter_f32.reset()
        preds = srv.predict_batch(images, timeout=600)[:, 0]
        launches = fused_head_ce.counter_f32.count
    finally:
        srv.close()
    if launches < 1:
        raise AssertionError("the f32 serving run did not go through the f32 head kernel")
    plain = build_inference(dataclasses.replace(cfg, fused_stem=False, fused_head_eval=False), dev)
    w, b = head_weights(plain, torch.float32)
    with torch.no_grad():
        x = torch.from_numpy(images).to(dev)
        feats = plain.features(ingest_images(x, torch.float32).permute(0, 3, 1, 2))
        top2 = torch.topk(feats @ w.t() + b, 2, dim=-1)
    ref = top2.indices[:, 0].cpu().numpy()
    v = top2.values.cpu().numpy()
    clear = (v[:, 0] - v[:, 1]) / np.abs(v[:, 0]) > E2E_GAP_F32
    agree = preds == ref
    if not agree[clear].all() or agree.mean() < 0.99:
        raise AssertionError(
            f"f32 served top-1 vs plain path: {int(agree.sum())}/{len(images)} agree, "
            f"{int(agree[clear].sum())}/{int(clear.sum())} clear rows"
        )
    log({"serve_f32": {"requests": len(images), "launches": launches,
                       "top1_agree_plain": float(agree.mean()), "clear_rows": int(clear.sum())}})
    return launches


def serve_resnet18_int8(dev) -> int:
    """The int8 serving path at full width: ``serve_precision="int8"``,
    otherwise the bf16 server's configuration, a flood and singles. Answers
    against the plain int8 path — the same quantized weights and activation
    scale, the plain stem and the int8 head's plain version — by the
    agreement rule; K1 and K7 must launch. Returns K7's launches."""
    from mpi_pytorch_tpu_torch.evaluate import build_int8_inference, float_state_dict
    from mpi_pytorch_tpu_torch.ops import fused_stem
    from mpi_pytorch_tpu_torch.ops import quantize as qz
    from mpi_pytorch_tpu_torch.serve import InferenceServer

    cfg = _serve_cfg(serve_precision="int8")
    images = np.random.default_rng(SEED + 9).integers(
        0, 256, size=(FLOOD + SINGLES, IMG, IMG, 3), dtype=np.uint8
    )
    t0 = time.perf_counter()
    srv = InferenceServer(cfg, device=dev)
    build_s = time.perf_counter() - t0
    try:
        fused_stem.counter.reset()
        qz.counter.reset()
        preds, timing = _flood(srv, images)
        launches = {"stem": fused_stem.counter.count, "head_int8": qz.counter.count}
        stats = srv.stats()
        int8_set = srv._exe_sets["int8"]
        resident = int8_set.resident_bytes()
        act_scale = float(int8_set.model.fc.act_scale)
    finally:
        srv.close()
    if min(launches.values()) < 1:
        raise AssertionError(f"the int8 serving run did not go through K1 and K7: {launches}")
    plain_cfg = dataclasses.replace(cfg, fused_stem=False, fused_head_eval=False)
    plain = build_int8_inference(plain_cfg, float_state_dict(plain_cfg), dev, keep_head_int8=True,
                                 act_scale=act_scale)
    head = qz.int8_head_operands(plain)

    def head_logits(feats):
        return qz.int8_logits(feats, head.w_q, head.b, head.scale_v, head.act_scale)

    ref, gap = _plain_top1(plain, images, 512, dev, head_logits)
    agree, clear, frac = _agreement(preds, ref, gap, "served resnet18 int8")
    log({"serve_int8": {
        "model": "resnet18", "num_classes": V, "image": IMG, "precision": "int8", **timing,
        "built_and_warmed_s": build_s, "act_scale": act_scale, "resident_bytes": resident,
        "by_bucket": stats["by_bucket"], "batches": stats["batches"], "launches": launches,
        "top1_agree_plain": frac, "clear_rows": int(clear.sum()),
        "largest_flipped_gap": float(gap[~agree].max()) if not agree.all() else None,
    }})
    return launches["head_int8"]


def serve_resnet18_both(dev) -> None:
    """A ``serve_precision="both"`` server: the start-up parity stamp is
    logged, not held (random weights). Floods in turns, bf16, int8, int8,
    bf16, each after a ``set_precision`` switch that must build nothing (no
    kernel build, no new model): the bf16 floods go through K4 and not K7,
    the int8 floods through K7 and not K4. The one comparison of the two
    precisions' img/s taken on one server in one call."""
    from mpi_pytorch_tpu_torch.ops import _build, fused_head_ce
    from mpi_pytorch_tpu_torch.ops import quantize as qz
    from mpi_pytorch_tpu_torch.serve import InferenceServer

    images = np.random.default_rng(SEED + 11).integers(
        0, 256, size=(FLOOD + SINGLES, IMG, IMG, 3), dtype=np.uint8
    )
    srv = InferenceServer(_serve_cfg(serve_precision="both"), device=dev)
    try:
        parity = srv.stats()["parity_top1"]
        lib, built, sets = _build._lib, _build.build_seconds, dict(srv._exe_sets)
        runs = []
        for precision in ("bf16", "int8", "int8", "bf16"):
            t0 = time.perf_counter()
            srv.set_precision(precision)
            switch_ms = 1e3 * (time.perf_counter() - t0)
            fused_head_ce.counter.reset()
            qz.counter.reset()
            _, timing = _flood(srv, images)
            runs.append({"precision": precision, "switch_ms": switch_ms,
                         "head": fused_head_ce.counter.count, "head_int8": qz.counter.count, **timing})
        resident = {p: e.resident_bytes() for p, e in srv._exe_sets.items()}
        if _build._lib is not lib or _build.build_seconds != built or srv._exe_sets != sets:
            raise AssertionError("set_precision built something")
    finally:
        srv.close()
    for run in runs:
        used, unused = ("head", "head_int8") if run["precision"] == "bf16" else ("head_int8", "head")
        if run[used] < 1 or run[unused]:
            raise AssertionError(f"the {run['precision']} flood ran the wrong head kernel: {run}")
    log({"serve_both": {"parity_top1": parity, "runs_in_turns": runs, "resident_bytes": resident}})


def train_head_ce(dev) -> dict:
    """The training cross-entropy op's path: ``HEAD_STEPS`` Adam steps (lr
    4e-4) of a 64 500-class head (f32 W master, zero bias) on one fixed
    batch of 128 bf16 features with a gradient, the last 8 rows padding
    (label −1), the loss the mean of ``fused_head_ce`` over the valid rows.
    K5 and K6 must launch once a step and the loss must fall. Returns their
    launches."""
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    gen = torch.Generator().manual_seed(SEED + 10)
    feats = torch.randn(TRAIN_BATCH, D, generator=gen).to(dev, torch.bfloat16).requires_grad_()
    w = (0.01 * torch.randn(V, D, generator=gen)).to(dev).requires_grad_()
    b = torch.zeros(V, device=dev, requires_grad=True)
    labels = torch.randint(0, V, (TRAIN_BATCH,), generator=gen, dtype=torch.int32)
    labels[-8:] = -1
    labels = labels.to(dev)
    opt = torch.optim.Adam([w, b], lr=LR)
    fh.ce_forward_counter.reset()
    fh.ce_backward_counter.reset()
    losses = []
    for _ in range(HEAD_STEPS):
        opt.zero_grad(set_to_none=True)
        feats.grad = None
        loss = fh.fused_head_ce(feats, w, b, labels).sum() / (labels >= 0).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    launches = {"head_ce_forward": fh.ce_forward_counter.count,
                "head_ce_backward": fh.ce_backward_counter.count}
    if set(launches.values()) != {HEAD_STEPS}:
        raise AssertionError(f"head CE training: launches {launches} over {HEAD_STEPS} steps")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"head CE training: losses {losses}")
    if not bool(torch.isfinite(feats.grad.float()).all()) or bool((feats.grad[-8:] != 0).any()):
        raise AssertionError("head CE training: dfeats not finite, or padding rows got a gradient")
    log({"train_head_ce": {"batch": TRAIN_BATCH, "steps": HEAD_STEPS, "losses": losses,
                           "launches": launches}})
    return launches


def serve_vit(dev) -> dict:
    """vit_s16 through ``InferenceServer`` at 128 px, bf16, uint8 input,
    with the tiny-S attention (K9; inference takes its FFMA kernel,
    ``fused_attention_small._route``) and the fused head (K4, D = 384): a
    flood of seeded images, answers checked against the plain path (full
    attention, plain head) by the agreement rule; returns both kernels'
    launches during the flood."""
    from mpi_pytorch_tpu_torch import Config
    from mpi_pytorch_tpu_torch.evaluate import build_inference
    from mpi_pytorch_tpu_torch.ops import fused_attention_small, fused_head_ce
    from mpi_pytorch_tpu_torch.serve import InferenceServer

    cfg = Config(
        model_name="vit_s16", num_classes=V, width=IMG, height=IMG, compute_dtype="bfloat16",
        input_dtype="uint8", attn_impl="fused-small", fused_head_eval=True, serve_topk=1,
        serve_buckets="1,8,32,128", seed=SEED,
    )
    images = np.random.default_rng(SEED + 7).integers(
        0, 256, size=(VIT_FLOOD, IMG, IMG, 3), dtype=np.uint8
    )
    srv = InferenceServer(cfg, device=dev)
    try:
        fused_attention_small.forward_tc_counter.reset()
        fused_attention_small.forward_ffma_counter.reset()
        fused_head_ce.counter.reset()
        t0 = time.perf_counter()
        futs = [srv.submit(im) for im in images]
        preds = np.stack([f.result(timeout=600) for f in futs])[:, 0]
        t_flood = time.perf_counter() - t0
        launches = {"attention_small_forward_ffma": fused_attention_small.forward_ffma_counter.count,
                    "head": fused_head_ce.counter.count}
        tc = fused_attention_small.forward_tc_counter.count
        stats = srv.stats()
    finally:
        srv.close()
    if min(launches.values()) < 1 or tc:
        raise AssertionError(
            f"the vit serving run did not go through K9's FFMA kernel and K4: "
            f"{launches}, tensor-core forward {tc}"
        )
    plain = build_inference(dataclasses.replace(cfg, attn_impl="full", fused_head_eval=False), dev)
    ref, gap = _plain_top1(plain, images, 128, dev)
    _, clear, frac = _agreement(preds, ref, gap, "served vit_s16")
    log({"serve_vit": {
        "model": "vit_s16", "attn_impl": "fused-small", "image": IMG, "requests": VIT_FLOOD,
        "flood_img_per_s": VIT_FLOOD / t_flood, "batches": stats["batches"],
        "by_bucket": stats["by_bucket"], "launches": launches,
        "top1_agree_plain": frac, "clear_rows": int(clear.sum()),
    }})
    return launches


def _train_cfg(tmp: str, **kw):
    from mpi_pytorch_tpu_torch import Config

    base = dict(
        model_name="resnet18", num_classes=V, width=IMG, height=IMG, batch_size=TRAIN_BATCH,
        compute_dtype="bfloat16", learning_rate=LR, optimizer="adam",
        synthetic_data=True, debug=True, debug_sample_size=TRAIN_ROWS,
        test_csv=str(REPO / "data" / "test_sample.csv"), num_epochs=TRAIN_EPOCHS, validate=True,
        checkpoint_dir=os.path.join(tmp, "checkpoints"), keep_checkpoints=1,
        log_file=os.path.join(tmp, "training.log"),
        metrics_file=os.path.join(tmp, "metrics.jsonl"), log_every_steps=5, seed=SEED,
    )
    return Config(**{**base, **kw})


def _vit_cfg(tmp: str, attn_impl: str, image: int):
    return _train_cfg(tmp, model_name="vit_s16", attn_impl=attn_impl, width=image, height=image,
                      num_epochs=VIT_EPOCHS)


def train_resnet18(dev, run_dir: str) -> dict:
    """The training path at full width through ``trainer.train``, fused
    stem then plain stem; returns the fused run (K2's and K3's launches,
    its losses and epoch times).
    The fused run tracks its best validation accuracy and writes into
    ``run_dir``, which :func:`evaluate_resnet18` evaluates next."""
    from mpi_pytorch_tpu_torch import checkpoint as ckpt
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests
    from mpi_pytorch_tpu_torch.ops import fused_stem
    from mpi_pytorch_tpu_torch.train.trainer import train

    with tempfile.TemporaryDirectory() as tmp:
        labels = load_manifests(_train_cfg(tmp))[0].labels
    log({"train_data": {"rows": len(labels), "classes": len(np.unique(labels))}})
    runs = {}
    for name, fused in (("fused", True), ("plain", False)):
        with tempfile.TemporaryDirectory() as tmp:
            cfg = _train_cfg(run_dir if fused else tmp, fused_stem=fused, track_best=fused)
            fused_stem.argmax_counter.reset()
            fused_stem.backward_counter.reset()
            t0 = time.perf_counter()
            summary = train(cfg, device=dev)
            wall = time.perf_counter() - t0
            launches = {
                "stem_pool_argmax": fused_stem.argmax_counter.count,
                "stem_pool_backward": fused_stem.backward_counter.count,
            }
            saved = [p for p in sorted(os.listdir(cfg.checkpoint_dir)) if p.endswith(".pt")]
            marker = ckpt.best_marker(cfg.checkpoint_dir)
        losses = summary.step_losses
        if len(losses) != TRAIN_STEPS_PER_EPOCH * TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{name} training: step losses {losses}")
        last = f"ckpt_{TRAIN_EPOCHS - 1:05d}.pt"
        # Retention keeps the last keep_checkpoints (1) and, under
        # track_best, the file best.json named at the last save: at most
        # one more, and the marked file is among them.
        if fused:
            kept = (marker is not None and last in saved and marker["checkpoint"] in saved
                    and len(saved) <= cfg.keep_checkpoints + 1
                    and marker["accuracy"] == summary.best_accuracy)
        else:
            kept = saved == [last] and marker is None
        if not kept or summary.val_accuracy is None:
            raise AssertionError(f"{name} training: checkpoints {saved}, best {marker}, "
                                 f"val {summary.val_accuracy}")
        runs[name] = {
            "step_losses": losses, "wall_s": wall,
            "epoch_losses": summary.epoch_losses, "epoch_times_s": summary.epoch_times,
            "ms_per_step_last_epoch": 1e3 * summary.epoch_times[-1] / TRAIN_STEPS_PER_EPOCH,
            "img_per_s": summary.images_per_sec, "val_accuracy": summary.val_accuracy,
            "launches": launches, "checkpoints": saved, "best": marker,
        }
        log({"train": {"stem": name, **runs[name]}})
    fused, plain = runs["fused"], runs["plain"]
    if min(fused["launches"].values()) < len(fused["step_losses"]):
        raise AssertionError(f"training did not go through K2/K3 every step: {fused['launches']}")
    if max(plain["launches"].values()) != 0:
        raise AssertionError(f"the plain-stem run launched the stem kernels: {plain['launches']}")
    if not (fused["step_losses"][-1] < fused["step_losses"][0]
            and fused["epoch_losses"][-1] < fused["epoch_losses"][0]):
        raise AssertionError(
            f"training loss did not fall: steps {fused['step_losses']}, "
            f"epochs {fused['epoch_losses']}"
        )
    gaps = [abs(f / p - 1) for f, p in zip(fused["step_losses"], plain["step_losses"])]
    # bf16 convolutions pick their algorithms by batch content, so only
    # the first step (same weights, same batch) is held tight.
    if gaps[0] > 1e-3:
        raise AssertionError(f"step-1 loss, fused vs plain stem: relative gap {gaps[0]}")
    log({"train_fused_vs_plain_bf16": {"step_rel_gap": gaps}})
    return fused


def evaluate_resnet18(dev, run_dir: str) -> None:
    """``evaluate.evaluate`` over the fused training run's checkpoint
    directory at full width: (a) fused stem and fused head with the
    predictions CSV — a first pass, then the checked one: K1 and K4 once a
    batch, one row per test row in manifest order, the CSV's accuracy the
    reported one; (b) the same rows through the plain stem and plain head
    (``_plain_top1`` in the same batches): ``_agreement``; (c) ``use_best``
    evaluates the file ``best.json`` names; (d) ``--quantize-eval`` with
    the fused head launches K7 once. Where the pass's time goes: the loader
    alone over the same rows, and the card's busy time of one pass."""
    from mpi_pytorch_tpu_torch import checkpoint as ckpt
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests
    from mpi_pytorch_tpu_torch.evaluate import (
        build_inference,
        evaluate,
        evaluate_with_predictions,
        quantize_eval_report,
    )
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.ops import fused_head_ce, fused_stem, quantize
    from mpi_pytorch_tpu_torch.train.trainer import make_loader
    from mpi_pytorch_tpu_torch.utils.logging import init_logger

    t_phase = time.perf_counter()
    csv_path = os.path.join(run_dir, "predictions.csv")
    cfg = _train_cfg(run_dir, fused_stem=True, fused_head_eval=True, predictions_file=csv_path,
                     eval_log_file=os.path.join(run_dir, "evaluation.log"))
    train_m, test_m = load_manifests(cfg)
    batches = -(-len(test_m) // cfg.batch_size)
    first = evaluate(cfg, device=dev)  # cuDNN's algorithm search, the test rows' making
    fused_stem.counter.reset()
    fused_head_ce.counter.reset()
    summary = evaluate(cfg, device=dev)
    launches = {"stem": fused_stem.counter.count, "head": fused_head_ce.counter.count}
    if launches != {"stem": batches, "head": batches}:
        raise AssertionError(f"evaluate: {launches} launches over {batches} batches")
    with open(csv_path) as f:
        header, *rows = f.read().splitlines()
    body = [r.split(",") for r in rows]
    if header != "file_name,predicted_label,predicted_category_id" or (
        [b[0] for b in body] != list(test_m.filenames)
    ):
        raise AssertionError(f"predictions CSV: header {header!r}, {len(body)} rows "
                             f"for {len(test_m)} test rows")
    csv_acc = sum(int(b[2]) == int(c) for b, c in zip(body, test_m.category_ids)) / len(body)
    if abs(csv_acc - summary.accuracy) > 1e-12:
        raise AssertionError(f"CSV accuracy {csv_acc} against reported {summary.accuracy}")

    # (b) The plain path over the same checkpoint and rows.
    marker = ckpt.best_marker(cfg.checkpoint_dir)
    latest = ckpt.latest_checkpoint(cfg.checkpoint_dir)
    weights = ckpt.load_for_eval(latest)[0]
    plain = build_inference(dataclasses.replace(cfg, fused_stem=False, fused_head_eval=False),
                            dev, weights)
    t0 = time.perf_counter()
    images = np.concatenate([b[0] for b in make_loader(cfg, test_m, train=False).epoch(0)])
    loader_s = time.perf_counter() - t0
    ref, gap = _plain_top1(plain, images, cfg.batch_size, dev)
    preds = np.array([int(b[1]) for b in body])
    agree, clear, frac = _agreement(preds, ref, gap, "evaluated resnet18")
    del plain
    fused = build_inference(cfg, dev, weights)
    logger = init_logger("MPT_EVAL", cfg.eval_log_file)
    busy_ms = device_ms(
        lambda: evaluate_with_predictions(cfg, fused, train_m, test_m, logger), 1)
    del fused

    # (c) --use-best: the metrics-only pass over the marked file.
    best_path = os.path.join(cfg.checkpoint_dir, marker["checkpoint"])
    best = evaluate(dataclasses.replace(cfg, use_best=True, predictions_file="",
                                        fused_head_eval=False), device=dev)
    with open(cfg.eval_log_file) as f:
        loaded = [line for line in f if "loaded checkpoint" in line][-1]
    if f"loaded checkpoint {best_path} " not in loaded:
        raise AssertionError(f"use_best loaded {loaded.strip()!r}, best.json names {best_path}")

    # (d) --quantize-eval through the fused int8 head.
    quantize.counter.reset()
    report = quantize_eval_report(
        dataclasses.replace(cfg, quantize_eval=True, predictions_file="", serve_topk=1),
        device=dev)
    if quantize.counter.count != 1 or report["samples"] != cfg.quantize_calib or (
        report["top5_agree"] is not None or not np.isfinite(report["max_logit_drift"])
    ):
        raise AssertionError(f"quantize-eval: {quantize.counter.count} K7 launches, {report}")
    log({"evaluate": {
        "card": card_report().splitlines()[0], "model": "resnet18", "num_classes": V,
        "image": IMG, "dtype": "bfloat16", "images": summary.num_images, "batches": batches,
        "wall_s": summary.wall_s, "img_per_s": summary.images_per_sec,
        "first_pass_wall_s": first.wall_s, "first_pass_img_per_s": first.images_per_sec,
        "loader_alone_s": loader_s, "card_busy_ms_per_pass": busy_ms,
        "accuracy": summary.accuracy, "mean_loss": summary.mean_loss, "csv_accuracy": csv_acc,
        "launches": launches, "top1_agree_plain": frac, "clear_rows": int(clear.sum()),
        "largest_flipped_gap": float(gap[~agree].max()) if not agree.all() else None,
        "checkpoint": os.path.basename(latest), "best": marker,
        "use_best_accuracy": best.accuracy, "use_best_mean_loss": best.mean_loss,
        "quant_parity": report, "quant_k7_launches": quantize.counter.count,
        "phase_s": time.perf_counter() - t_phase,
    }})


CACHE_STEPS_HELD = (0, 1, 2, TRAIN_STEPS_PER_EPOCH - 1)  # epoch 0's first three, its tail
CACHE_TURNS = ("cached", "scanned", "scanned", "cached")  # the two modes in turns


def _cache_mb(rows: int, image: int, itemsize: int) -> str:
    """The trainer's log figure for a cache of ``rows`` rows."""
    return f"{rows * image * image * 3 * itemsize / 1e6:.1f}"


def train_resnet18_cached(dev, fused_run: dict) -> dict:
    """Phase 6b2: the device-resident training set at full width, through
    ``trainer.train``: the fused run's configuration (resnet18, 64 500
    classes, 128 px, bf16, Adam 4e-4, fused stem, the DEBUG sample's 2 560
    train rows, two epochs, validation) with ``device_cache``, and with
    ``device_cache`` and ``scan_epoch``, in turns (``CACHE_TURNS``),
    beside the streaming fused run that :func:`train_resnet18` made.
    Held, on every run: the cache holds 2 560 f32 rows,
    503.3 MB (the trainer's log line); K2 and K3 launch once a step and K1
    once a validation batch (the counters and the metrics records); each
    run's step-1 loss within 1e-3 of the streaming run's; the losses
    finite and falling; epoch 0's first three gathered batches and its
    last (``CACHE_STEPS_HELD``) ``torch.equal`` to the streaming loader's;
    validation from the cache gives the streaming validation's accuracy
    on the same weights (the last checkpoint). Logged beside the card's
    name and power limit: the second epoch's img/s of every run, the
    seconds to build the cache, and a cached step's enqueue time against
    its busy time. Returns K1's, K2's and K3's launches in the phase."""
    from mpi_pytorch_tpu_torch import checkpoint as ckpt
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.ops import fused_stem
    from mpi_pytorch_tpu_torch.train import trainer
    from mpi_pytorch_tpu_torch.train.step import _gather_batch, make_cached_train_step

    t_phase = time.perf_counter()
    counters = {"stem": fused_stem.counter, "stem_pool_argmax": fused_stem.argmax_counter,
                "stem_pool_backward": fused_stem.backward_counter}
    rows = TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH
    want_log = (f"device cache: {rows} images, rows sharded over 1 rank(s) "
                f"({_cache_mb(rows, IMG, 4)} MB/rank float32)")
    real_build, built = trainer.build_device_cache, {}

    def keep(*args, **kw):  # the run's own cache, held below
        built["cache"] = real_build(*args, **kw)
        return built["cache"]

    runs, launches = {name: [] for name in CACHE_TURNS}, {k: 0 for k in counters}
    trainer.build_device_cache = keep
    try:
        for name in CACHE_TURNS:
            with tempfile.TemporaryDirectory() as tmp:
                cfg = _train_cfg(tmp, fused_stem=True, device_cache=True,
                                 scan_epoch=name == "scanned")
                for c in counters.values():
                    c.reset()
                summary = trainer.train(cfg, device=dev)
                counts = {k: c.count for k, c in counters.items()}
                records = _records(cfg.metrics_file)
                with open(cfg.log_file) as f:
                    log_text = f.read()
                weights = ckpt.load_for_eval(ckpt.latest_checkpoint(cfg.checkpoint_dir))[0]
            losses = summary.step_losses
            steps = TRAIN_STEPS_PER_EPOCH * TRAIN_EPOCHS
            if want_log not in log_text or tuple(built["cache"][0].shape) != (rows, IMG, IMG, 3):
                raise AssertionError(f"{name}: the cache is not {want_log!r}")
            if counts != {"stem": TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH,
                          "stem_pool_argmax": steps, "stem_pool_backward": steps}:
                raise AssertionError(f"{name}: launches {counts} over {steps} steps and "
                                     f"{TRAIN_EPOCHS} validations of {TRAIN_STEPS_PER_EPOCH}")
            per_epoch = {"fused_stem.argmax_counter": TRAIN_STEPS_PER_EPOCH,
                         "fused_stem.backward_counter": TRAIN_STEPS_PER_EPOCH}
            if [r.get("launches") for r in records if r["kind"] == "epoch"] != [per_epoch] * 2 or (
                    [r.get("launches") for r in records if r["kind"] == "val"]
                    != [{"fused_stem.counter": TRAIN_STEPS_PER_EPOCH}] * 2):
                raise AssertionError(f"{name}: the records' launches {records}")
            if len(losses) != steps or not np.all(np.isfinite(losses)) or not (
                    losses[-1] < losses[0] and summary.epoch_losses[-1] < summary.epoch_losses[0]):
                raise AssertionError(f"{name}: step losses {losses}, epochs {summary.epoch_losses}")
            gap = abs(losses[0] / fused_run["step_losses"][0] - 1)
            if gap > 1e-3:
                raise AssertionError(f"{name}: step-1 loss {losses[0]} against the streaming "
                                     f"run's {fused_run['step_losses'][0]}")
            # Validation from the cache against the streaming validation on
            # the same weights: the epoch's checkpoint precedes its
            # validation.
            state = _train_state(dev, fused=True)
            state.model.load_state_dict(weights)
            train_m = load_manifests(cfg)[0]
            stream_acc, stream_loss = trainer.evaluate_manifest(cfg, state.model, train_m)
            if stream_acc != summary.val_accuracy:
                raise AssertionError(f"{name}: validation from the cache {summary.val_accuracy} "
                                     f"against streaming {stream_acc}")
            del state
            for k in launches:
                launches[k] += counts[k]
            runs[name].append({
                "step_losses": losses, "epoch_losses": summary.epoch_losses,
                "epoch_times_s": summary.epoch_times, "step1_rel_gap": gap,
                "epoch2_img_per_s": rows / summary.epoch_times[1],
                "cache_build_s": summary.cache_build_s, "val_accuracy": summary.val_accuracy,
                "val_loss": [r["loss"] for r in records if r["kind"] == "val"][-1],
                "streaming_val_loss_same_weights": stream_loss, "launches": counts,
            })
            log({"train_cached": {"mode": name, **runs[name][-1]}})
    finally:
        trainer.build_device_cache = real_build

    # The gathered batches against the streaming loader's, on the card.
    dataset, labels = built.pop("cache")
    cfg = _train_cfg("")
    loader = trainer.make_loader(cfg, load_manifests(cfg)[0], train=True)
    walk = trainer.epoch_indices(cfg, rows, 0, TRAIN_STEPS_PER_EPOCH, dev)
    for step_i, (images, lbl) in enumerate(
            trainer.synchronized_batches(loader, 0, TRAIN_STEPS_PER_EPOCH)):
        if step_i in CACHE_STEPS_HELD:
            got = _gather_batch(dataset, labels, walk[0][step_i], walk[1][step_i], torch.float32)
            want = trainer.to_device(images, lbl, dev)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"cached batch {step_i} differs from the loader's")

    # A cached step's enqueue time against its busy time (bf16, step 0's batch).
    state = _train_state(dev, fused=True)
    step = make_cached_train_step(torch.bfloat16)
    timing, _ = _step_times(lambda: step(state, dataset, labels, walk[0][0], walk[1][0]))
    del state, dataset, labels
    streaming_ips = rows / fused_run["epoch_times_s"][1]
    log({"train_cached_vs_streaming": {
        "card": card_report().splitlines()[0], "rows": rows, "cache_mb": float(
            _cache_mb(rows, IMG, 4)), "dtype": "float32",
        "turns": list(CACHE_TURNS), "epoch2_img_per_s": {
            "streaming": streaming_ips,
            **{k: [r["epoch2_img_per_s"] for r in v] for k, v in runs.items()}},
        "epoch1_img_per_s": {k: [rows / r["epoch_times_s"][0] for r in v]
                             for k, v in runs.items()},
        "cache_build_s": {k: [r["cache_build_s"] for r in v] for k, v in runs.items()},
        "cached_step_bf16": timing, "batches_held": list(CACHE_STEPS_HELD),
        "phase_s": time.perf_counter() - t_phase,
    }})
    return launches


DP_RANKS = 2  # ranks sharing the one card in the gloo check
DP_STEPS = 3


def _torchrun(module: str, argv: list[str], timeout: int) -> tuple[float, str]:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1
    -m module argv`` from the checkout's root: the real entry point as a
    one-rank world; raises unless it exits 0. Returns (wall s, output)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "1", "-m", module, *argv]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} under torchrun exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return wall, proc.stdout + proc.stderr


def _records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _dp_cli(tmp: str) -> list[str]:
    """The flags of ``_train_cfg``'s fused run, one epoch."""
    return [
        "--model-name", "resnet18", "--num-classes", str(V), "--image-size", str(IMG),
        "--batch-size", str(TRAIN_BATCH), "--compute-dtype", "bfloat16",
        "--learning-rate", str(LR), "--optimizer", "adam", "--fused-stem", "true",
        "--synthetic-data", "true", "--debug", "true", "--debug-sample-size", str(TRAIN_ROWS),
        "--test-csv", str(REPO / "data" / "test_sample.csv"), "--num-epochs", "1",
        "--validate", "true", "--checkpoint-dir", os.path.join(tmp, "checkpoints"),
        "--keep-checkpoints", "1", "--log-file", os.path.join(tmp, "training.log"),
        "--eval-log-file", os.path.join(tmp, "evaluation.log"),
        "--metrics-file", os.path.join(tmp, "metrics.jsonl"), "--log-every-steps", "5",
        "--seed", str(SEED),
    ]


def _dp_batches(dev, shape: dict):
    """Three f32-step batches of ``shape`` (uint8 images, seeded), and an
    uneven one for the spmd step: rank 1's half holds an eighth of the
    batch as valid rows (16 of 128)."""
    rng = np.random.default_rng(SEED + 6)
    n, img = shape["batch"], shape["image"]
    batches = [
        (torch.from_numpy(rng.integers(0, 256, (n, img, img, 3), dtype=np.uint8)).to(dev),
         torch.from_numpy(rng.integers(0, shape["classes"], (n,), dtype=np.int32)).to(dev))
        for _ in range(DP_STEPS + 1)
    ]
    uneven = batches[-1][1].clone()
    uneven[n // 2 + n // 8:] = -1
    return batches[:DP_STEPS], (batches[-1][0], uneven)


def _dp_state(dev, sync: bool, classes: int):
    """resnet18 with the fused stem, SGD (see ``data_parallel``)."""
    from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
    from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer

    bundle = create_model_bundle("resnet18", classes, seed=SEED, fused_stem=True)
    model = prepare_for_training(bundle.model, dev)
    set_batchnorm_sync(model, sync)
    opt, schedule = make_optimizer(model, LR, optimizer="sgd")
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def _bn1(state) -> dict:
    bn = state.model.bn1
    return {"running_mean": bn.running_mean.cpu().numpy().copy(),
            "running_var": bn.running_var.cpu().numpy().copy()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_rank(payload: dict) -> dict:
    """One of ``DP_RANKS`` ranks on ``payload["device"]`` (the one card)
    over gloo (``data_parallel``):
    three auto-mode f32 steps on its rows of each batch, one step profiled
    (where the step's card time and the collectives' time go), one
    spmd-mode step on the uneven batch, then its half of the device cache
    (:func:`_dp_cache_walk`) and three cached auto f32 steps from it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_pytorch_tpu_torch.ops import fused_stem as fs
    from mpi_pytorch_tpu_torch.ops.losses import classification_loss
    from mpi_pytorch_tpu_torch.parallel import distributed
    from mpi_pytorch_tpu_torch.train.step import (
        ingest_images,
        make_cached_train_step,
        make_spmd_train_step,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(payload["device"])
    distributed.maybe_initialize_distributed(dev, backend_name="gloo")
    rank, world = distributed.rank(), distributed.world_size()
    shape = payload["shape"]
    rows = slice(rank * shape["batch"] // world, (rank + 1) * shape["batch"] // world)
    batches, uneven = _dp_batches(dev, shape)
    out = {"rank": rank, "backend": distributed.backend(), "losses": [], "grad_norms": []}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        state = _dp_state(dev, sync=True, classes=shape["classes"])
        step = make_train_step(torch.float32)
        fs.argmax_counter.reset()
        fs.backward_counter.reset()
        for images, labels in batches:
            m = step(state, images[rows], labels[rows])
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
        out["launches"] = {"stem_pool_argmax": fs.argmax_counter.count,
                           "stem_pool_backward": fs.backward_counter.count}
        out["bn1"] = _bn1(state)
        images, labels = batches[0]
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, images[rows], labels[rows])
            _sync(dev)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        copies = [e for e in device if "memcpy" in e.key.lower()]
        # Each collective's range: its host time, and (the GPU-side copy of
        # the range) the span of the card's timeline it covers.
        ranges = [e for e in events if e.key.startswith("collectives.")]
        out["profile"] = {
            "step_wall_ms": wall_ms,
            "card_busy_ms": sum(e.self_device_time_total for e in device
                                if not e.key.startswith("collectives.")) / 1e3,
            "memcpy_card_ms": sum(e.self_device_time_total for e in copies) / 1e3,
            "collectives_host_ms": {e.key: e.cpu_time_total / 1e3 for e in ranges
                                    if e.device_type == DeviceType.CPU},
            "collectives_card_span_ms": {e.key: e.device_time_total / 1e3 for e in ranges
                                         if e.device_type == DeviceType.CUDA},
        }
        # spmd mode on the uneven batch: local batchnorm, averaged grads.
        spmd = _dp_state(dev, sync=False, classes=shape["classes"])
        images, labels = uneven
        # This rank's own masked mean, through the forward the step runs
        # (with gradients on: the stem's training kernel, as in the step).
        twin = copy.deepcopy(spmd.model)
        logits = twin(ingest_images(images[rows], torch.float32).permute(0, 3, 1, 2))
        out["spmd_local"] = (float(classification_loss(logits, labels[rows])),
                             int((labels[rows] >= 0).sum()))
        del twin, logits
        m = make_spmd_train_step(torch.float32)(spmd, images[rows], labels[rows])
        out["spmd_loss"] = float(m["loss"])
        out["spmd_count"] = int(m["count"])
        out["spmd_stats"] = [t.cpu().numpy() for mod in spmd.model.modules()
                             if hasattr(mod, "running_var")
                             for t in (mod.running_mean, mod.running_var)]
        del spmd
        # The device cache: this rank's half of the DEBUG sample's rows, in
        # uint8 and f32; epoch 0's first DP_STEPS gathered slices (digests),
        # then DP_STEPS cached auto steps from the f32 cache.
        out["cache_digests"], (dataset, labels), walk = _dp_cache_walk(dev, 1)
        cached = _dp_state(dev, sync=True, classes=shape["classes"])
        step = make_cached_train_step(torch.float32)
        fs.argmax_counter.reset()
        fs.backward_counter.reset()
        out["cached_losses"] = [float(step(cached, dataset, labels, i, v)["loss"])
                                for i, v in zip(*walk)]
        out["cached_launches"] = {"stem_pool_argmax": fs.argmax_counter.count,
                                  "stem_pool_backward": fs.backward_counter.count}
        out["cache_rows"] = int(dataset.shape[0])
    return out


def _digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_cache_walk(dev, parts: int):
    """This rank's device cache of the DEBUG sample's train rows in uint8
    and in f32 (all of them in a world of one), and the digests of its
    rows of epoch 0's first ``DP_STEPS`` gathered batches in each dtype
    (f32 ingest), each batch cut into ``parts`` equal row ranges; returns
    (digests [dtype][step][part], the f32 cache, the walk's [DP_STEPS, B]
    index and mask tensors)."""
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests
    from mpi_pytorch_tpu_torch.train import trainer
    from mpi_pytorch_tpu_torch.train.step import _gather_batch

    digests = {}
    for dtype in ("uint8", "float32"):
        cfg = _train_cfg("", input_dtype=dtype)
        train_m = load_manifests(cfg)[0]
        cache = trainer.build_device_cache(
            cfg, train_m, trainer.make_loader(cfg, train_m, train=True), dev)
        walk = trainer.epoch_indices(cfg, len(train_m), 0, DP_STEPS, dev)
        digests[dtype] = []
        for i, v in zip(*walk):
            images, lbl = _gather_batch(*cache, i, v, torch.float32)
            n = images.shape[0] // parts
            digests[dtype].append([_digest(images[p * n:(p + 1) * n], lbl[p * n:(p + 1) * n])
                                   for p in range(parts)])
    return digests, cache, walk


def _dp_cached_check(dev, ranks: list[dict], card: str) -> None:
    """The gloo ranks' cached steps (``dp_rank``): each rank's gathered
    slices, in uint8 and f32, byte-identical (digests) to its rows of this
    process's gather of the whole batches; its cache holds half the rows;
    K2 and K3 once a step; its losses rtol 1e-4 against this process's
    cached steps on the whole batches."""
    from mpi_pytorch_tpu_torch.train.step import make_cached_train_step

    digests, (dataset, labels), walk = _dp_cache_walk(dev, DP_RANKS)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        state = _dp_state(dev, sync=True, classes=V)
        cached_step = make_cached_train_step(torch.float32)
        cached_losses = [float(cached_step(state, dataset, labels, i, v)["loss"])
                         for i, v in zip(*walk)]
    del state, dataset, labels
    for r in ranks:
        mine = {k: [d[r["rank"]] for d in v] for k, v in digests.items()}
        if {k: [d[0] for d in v] for k, v in r["cache_digests"].items()} != mine:
            raise AssertionError(f"rank {r['rank']}: its gathered slices are not this "
                                 "process's rows of the same batches")
        if r["cache_rows"] != TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH // DP_RANKS or (
                r["cached_launches"] != {"stem_pool_argmax": DP_STEPS,
                                         "stem_pool_backward": DP_STEPS}):
            raise AssertionError(f"rank {r['rank']}: {r['cache_rows']} cache rows, "
                                 f"launches {r['cached_launches']}")
        if not np.allclose(r["cached_losses"], cached_losses, rtol=1e-4, atol=0):
            raise AssertionError(f"rank {r['rank']}: cached losses {r['cached_losses']} "
                                 f"against one process's {cached_losses}")
    log({"dp_gloo_cached": {
        "card": card, "rows_per_rank": ranks[0]["cache_rows"],
        "losses": ranks[0]["cached_losses"], "one_process_losses": cached_losses,
        "max_rel_gap": max(abs(a / b - 1) for r in ranks
                           for a, b in zip(r["cached_losses"], cached_losses)),
        "slices_byte_identical": ["uint8", "float32"],
    }})


def data_parallel(dev, fused_run: dict) -> dict:
    """Phase 6c: data parallelism through the real entry points and the
    step.

    (a) ``torchrun --standalone --nproc-per-node 1 -m
    mpi_pytorch_tpu_torch.train`` — a world of one over NCCL — on the
    fused run's configuration for one epoch, then ``-m
    mpi_pytorch_tpu_torch.evaluate --predictions-file`` on its checkpoint
    with the fused head. The kernels are not built again: the subprocess
    loads the library this script built. Held: exit 0, the backend NCCL
    in the log, K2 and K3 once a step and K1 once a validation batch (the
    metrics records' launches), one checkpoint, the step-1 loss within
    1e-3 of the one-process fused run's, then K1 and K4 once an eval batch
    and the CSV's rows in manifest order; its img/s beside the one-process
    run's first epoch.

    (b) ``DP_RANKS`` ranks on this one card over gloo (NCCL refuses two
    ranks on one card), each a process (``parallel.launch.run_world``):
    three auto-mode f32 steps (TF32 off) on their rows of resident batches,
    against this process taking the whole batches — losses and the step-1
    grad norm rtol 1e-4, ``bn1``'s running statistics rtol 1e-5 plus atol
    1e-6, K2 and K3 once a step on every rank. SGD, as the CPU tests: Adam
    turns f32 summation order on near-zero gradients into ±lr steps. Then
    one spmd-mode step on a batch whose halves hold 64 and 16 valid rows:
    every rank's running statistics bitwise equal, and the reported loss
    the count-weighted mean of the ranks' own masked means (rtol 1e-6);
    then three cached auto steps on each rank's half of the device cache
    (:func:`_dp_cached_check`).
    Returns K2's and K3's launches in the phase."""
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.ops import _build
    from mpi_pytorch_tpu_torch.parallel.launch import run_world
    from mpi_pytorch_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the subprocesses share the card
    out = {"card": card_report().splitlines()[0]}
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    with tempfile.TemporaryDirectory() as tmp:
        argv = _dp_cli(tmp)
        train_s, _ = _torchrun("mpi_pytorch_tpu_torch.train", argv, 900)
        with open(os.path.join(tmp, "training.log")) as f:
            log_text = f.read()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if f"world 1 (process group backend {backend})" not in log_text:
            raise AssertionError(f"torchrun train: no {backend} world of one in the log")
        records = _records(os.path.join(tmp, "metrics.jsonl"))
        steps = [r for r in records if r["kind"] == "step"]
        (epoch,) = [r for r in records if r["kind"] == "epoch"]
        (val,) = [r for r in records if r["kind"] == "val"]
        val_batches = -(-(TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH) // TRAIN_BATCH)
        want = {"fused_stem.argmax_counter": len(steps), "fused_stem.backward_counter": len(steps)}
        if len(steps) != TRAIN_STEPS_PER_EPOCH or epoch.get("launches") != want:
            raise AssertionError(f"torchrun train: {len(steps)} steps, launches {epoch}")
        if val.get("launches") != {"fused_stem.counter": val_batches}:
            raise AssertionError(f"torchrun train validation: {val}")
        saved = sorted(os.listdir(os.path.join(tmp, "checkpoints")))
        if saved != ["ckpt_00000.pt"]:
            raise AssertionError(f"torchrun train: checkpoints {saved}")
        gap = abs(steps[0]["loss"] / fused_run["step_losses"][0] - 1)
        if gap > 1e-3:
            raise AssertionError(f"torchrun step-1 loss {steps[0]['loss']} against the "
                                 f"one-process run's {fused_run['step_losses'][0]}")
        csv_path = os.path.join(tmp, "predictions.csv")
        eval_s, _ = _torchrun("mpi_pytorch_tpu_torch.evaluate",
                              argv + ["--fused-head-eval", "true", "--predictions-file", csv_path],
                              600)
        (ev,) = [r for r in _records(os.path.join(tmp, "metrics.jsonl")) if r["kind"] == "eval"]
        test_m = load_manifests(_train_cfg(tmp))[1]
        batches = -(-len(test_m) // TRAIN_BATCH)
        if ev.get("launches") != {"fused_stem.counter": batches, "fused_head_ce.counter": batches}:
            raise AssertionError(f"torchrun evaluate: {ev}")
        with open(csv_path) as f:
            header, *rows = f.read().splitlines()
        if [r.split(",")[0] for r in rows] != list(test_m.filenames):
            raise AssertionError(f"torchrun evaluate CSV: {len(rows)} rows, {header!r}")
        if sorted(p.name for p in _build.BUILD_DIR.glob("*.so")) != libs:
            raise AssertionError("the torchrun runs built the kernel library again")
        one_epoch0 = TRAIN_STEPS_PER_EPOCH * TRAIN_BATCH / fused_run["epoch_times_s"][0]
        out["torchrun_world1"] = {
            "train_wall_s": train_s, "evaluate_wall_s": eval_s,
            "img_per_s": epoch["images_per_sec"], "one_process_epoch0_img_per_s": one_epoch0,
            "step1_loss": steps[0]["loss"], "step1_rel_gap": gap,
            "launches": {"train": epoch["launches"], "val": val["launches"],
                         "evaluate": ev["launches"]},
            "accuracy": ev["accuracy"],
        }
    log({"dp_torchrun": out})

    t0 = time.perf_counter()
    shape = {"batch": TRAIN_BATCH, "image": IMG, "classes": V}
    ranks = run_world("chip_smoke:dp_rank", DP_RANKS, {"device": str(dev), "shape": shape},
                      timeout_s=600)
    ranks_s = time.perf_counter() - t0
    batches, _ = _dp_batches(dev, shape)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        state = _dp_state(dev, sync=True, classes=V)
        step = make_train_step(torch.float32)
        ref = [step(state, *b) for b in batches]
    losses = [float(m["loss"]) for m in ref]
    ref_bn1 = _bn1(state)
    for r in ranks:
        if r["backend"] != "gloo" or r["launches"] != {"stem_pool_argmax": DP_STEPS,
                                                       "stem_pool_backward": DP_STEPS}:
            raise AssertionError(f"rank {r['rank']}: {r['backend']}, launches {r['launches']}")
        if not np.allclose(r["losses"], losses, rtol=1e-4, atol=0) or not np.isclose(
                r["grad_norms"][0], float(ref[0]["grad_norm"]), rtol=1e-4, atol=0):
            raise AssertionError(f"rank {r['rank']}: losses {r['losses']}, grad norm "
                                 f"{r['grad_norms'][0]} against one process's {losses}, "
                                 f"{float(ref[0]['grad_norm'])}")
        for k, v in ref_bn1.items():
            if not np.allclose(r["bn1"][k], v, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"rank {r['rank']}: bn1.{k} against one process: max gap "
                                     f"{np.abs(r['bn1'][k] - v).max()}")
    for a, b in zip(ranks[0]["spmd_stats"], ranks[1]["spmd_stats"]):
        if a.tobytes() != b.tobytes():
            raise AssertionError("spmd step: the ranks' running statistics differ")
    (l0, c0), (l1, c1) = ranks[0]["spmd_local"], ranks[1]["spmd_local"]
    weighted = (l0 * c0 + l1 * c1) / (c0 + c1)
    if (c0, c1) != (TRAIN_BATCH // DP_RANKS, TRAIN_BATCH // 8) or not all(
            np.isclose(r["spmd_loss"], weighted, rtol=1e-6, atol=0) for r in ranks):
        raise AssertionError(f"spmd step: losses {[r['spmd_loss'] for r in ranks]} against "
                             f"the count-weighted mean {weighted} of {ranks[0]['spmd_local']}, "
                             f"{ranks[1]['spmd_local']}")
    _dp_cached_check(dev, ranks, out["card"])
    prof = ranks[0]["profile"]
    coll_ms = sum(prof["collectives_host_ms"].values())
    log({"dp_allreduce_share": {
        "card": out["card"], "ranks": DP_RANKS, "backend": "gloo", "dtype": "float32",
        "rows_per_rank": TRAIN_BATCH // DP_RANKS, "classes": V, "image": IMG, **prof,
        "collectives_share_of_step_wall": coll_ms / prof["step_wall_ms"],
        "memcpy_share_of_card_busy": (prof["memcpy_card_ms"] / prof["card_busy_ms"]
                                      if prof["card_busy_ms"] else None),
    }})
    log({"dp_gloo_two_ranks": {
        "losses": ranks[0]["losses"], "one_process_losses": losses,
        "grad_norm_step1": ranks[0]["grad_norms"][0],
        "one_process_grad_norm_step1": float(ref[0]["grad_norm"]),
        "bn1_max_abs_gap": {k: float(np.abs(ranks[0]["bn1"][k] - v).max())
                            for k, v in ref_bn1.items()},
        "spmd_loss": ranks[0]["spmd_loss"], "spmd_count_weighted_mean": weighted,
        "ranks_wall_s": ranks_s, "phase_s": time.perf_counter() - t_phase,
    }})
    del state, ref
    return {"torchrun": out["torchrun_world1"]["launches"]["train"],
            "gloo_rank": ranks[0]["launches"], "gloo_rank_cached": ranks[0]["cached_launches"]}


LEVER_STEPS = 3
# Phase 6d's configurations: (pods, zero_opt_state, grad_sync_buckets MiB);
# the first of each world is the reference the others are held against.
LEVER_RUNS_2 = {"baseline": (1, False, 0.0), "zero": (1, True, 0.0),
                "buckets_25": (1, False, 25.0), "buckets_4": (1, False, 4.0),
                "zero_buckets_25": (1, True, 25.0)}
LEVER_RUNS_4 = {"flat": (1, False, 0.0), "hier": (2, False, 0.0),
                "hier_zero_buckets_25": (2, True, 25.0)}


def _timed_share(state, step, images, labels, dev) -> dict:
    """One more step with the bucket timeline beside the backward's end: a
    CUDA event recorded where the first parameter's gradient lands (the
    backward's last kernel, ``conv1``'s weight gradient), on the host's
    clock through an event recorded on an idle card at a known time. The
    share of the buckets' collective time (issue to first seen done) that
    falls before it, and the buckets issued by then."""
    end = torch.cuda.Event(enable_timing=True)
    handle = state.model.conv1.weight.register_post_accumulate_grad_hook(
        lambda _p: end.record())
    _sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    step(state, images, labels)
    _sync(dev)
    handle.remove()
    backward_end = t0 + start.elapsed_time(end) / 1e3
    timeline = step.grad_sync.buckets.timeline
    total = sum(b["done_at"] - b["issued_at"] for b in timeline)
    before = sum(max(0.0, min(b["done_at"], backward_end) - b["issued_at"]) for b in timeline)
    return {"share_before_backward_end": before / total if total else 0.0,
            "buckets_issued_before_backward_end": sum(
                b["issued_at"] < backward_end for b in timeline),
            "buckets": len(timeline), "collectives_ms": 1e3 * total,
            "step_ms": 1e3 * (time.perf_counter() - t0),
            "backward_end_ms": 1e3 * (backward_end - t0)}


def lever_rank(payload: dict) -> dict:
    """One rank of phase 6d (gloo, on the one card; or ``payload["backend"]``
    on the rank's own card with ``payload["device"] == "local"``): each
    configuration of ``payload["runs"]`` (``LEVER_RUNS_2`` or
    ``LEVER_RUNS_4``) from the same seeded resnet18 (fused stem, 64 500 classes, 128 px, f32, TF32 off,
    SGD, spmd mode), ``LEVER_STEPS`` steps on this rank's rows of
    ``_dp_batches``; each run's losses and grad norms, K2's and K3's
    launches, its first step's ledger, its moment bytes against the
    formula, its bucket plan, its parameters' and statistics' largest gap
    to the first run's (``payload["rtol"]``, computed here: the tensors
    stay on the card), and for bucketed runs one timed step
    (:func:`_timed_share`)."""
    from mpi_pytorch_tpu_torch.config import MeshConfig
    from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
    from mpi_pytorch_tpu_torch.ops import fused_stem as fs
    from mpi_pytorch_tpu_torch.parallel import collectives, distributed
    from mpi_pytorch_tpu_torch.parallel.mesh import create_mesh, zero_shard_axis
    from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer, moment_bytes
    from mpi_pytorch_tpu_torch.train.step import (
        bucket_overlap_frac,
        grad_bucket_plan,
        make_spmd_train_step,
        synced_params,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    # "local": this rank's own card (one a rank, NCCL); else the shared one.
    dev = distributed.rank_device(None if payload["device"] == "local" else payload["device"])
    distributed.maybe_initialize_distributed(dev, backend_name=payload.get("backend", "gloo"))
    rank, world = distributed.rank(), distributed.world_size()
    shape = payload["shape"]
    rows = slice(rank * shape["batch"] // world, (rank + 1) * shape["batch"] // world)
    batches, _ = _dp_batches(dev, shape)
    # Every rank makes the same layouts in the same order (their groups).
    meshes = {pods: create_mesh(MeshConfig(pods=pods))
              for pods in sorted({pods for pods, _, _ in payload["runs"].values()})}
    out = {"rank": rank, "runs": {}, "peak_mb": 0.0}
    reference = None
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for name, (pods, zero, bucket_mb) in payload["runs"].items():
            mesh = meshes[pods]
            bundle = create_model_bundle("resnet18", shape["classes"], seed=SEED, fused_stem=True)
            model = prepare_for_training(bundle.model, dev)
            set_batchnorm_sync(model, False)
            axis = zero_shard_axis(mesh)[0] if zero else None
            opt, schedule = make_optimizer(model, LR, optimizer="sgd", zero_axis=axis)
            state = TrainState(model=model, optimizer=opt, schedule=schedule)
            step = make_spmd_train_step(torch.float32, zero_opt_state=zero,
                                        grad_bucket_mb=bucket_mb, mesh=mesh)
            fs.argmax_counter.reset()
            fs.backward_counter.reset()
            run = {"losses": [], "grad_norms": []}
            for i, (images, labels) in enumerate(batches):
                collectives.LEDGER.reset()
                m = step(state, images[rows], labels[rows])
                if i == 0:
                    run["ledger"] = collectives.LEDGER.snapshot()
                run["losses"].append(float(m["loss"]))
                run["grad_norms"].append(float(m["grad_norm"]))
            run["launches"] = {"stem_pool_argmax": fs.argmax_counter.count,
                               "stem_pool_backward": fs.backward_counter.count}
            run["moment_bytes"] = moment_bytes(opt)
            params = synced_params(model)
            n = axis.size if zero else 1
            # SGD keeps one momentum a parameter: ⌈numel / P⌉ f32 each.
            run["moment_bytes_formula"] = 4 * sum(-(-p.numel() // n) for p in params)
            if bucket_mb:
                plan = grad_bucket_plan(params, bucket_mb)
                run["plan"] = {"buckets": len(plan),
                               "overlap_frac": bucket_overlap_frac(params, plan)}
            if zero:
                run["route"] = {"reduce_scatter": "host-staged"
                                if collectives.host_staged(params[0], axis) else "direct"}
            tensors = {k: v.detach().clone() for k, v in model.state_dict().items()
                       if v.is_floating_point()}
            if reference is None:
                reference = tensors
            else:
                gaps = {k: float(((v - reference[k]).abs()
                                  - payload["rtol"] * reference[k].abs()).max())
                        for k, v in tensors.items()}
                run["worst_excess"] = max(gaps.items(), key=lambda kv: kv[1])
                run["max_abs_gap"] = max(float((v - reference[k]).abs().max())
                                         for k, v in tensors.items())
            if bucket_mb:
                run["timed"] = _timed_share(state, step, *(t[rows] for t in batches[0]), dev)
            out["runs"][name] = run
            out["peak_mb"] = max(out["peak_mb"], torch.cuda.max_memory_allocated(dev) / 1e6)
            del state, opt, model, step, tensors
            torch.cuda.empty_cache()
    return out


def _lever_torchrun(dev, card: str) -> dict:
    """Phase 6d (a): ``torchrun --nproc-per-node 1 -m
    mpi_pytorch_tpu_torch.train --spmd-mode true --zero-opt-state true
    --grad-sync-buckets 25`` (a NCCL world of one) on the fused run's
    configuration for one epoch, then ``-m mpi_pytorch_tpu_torch.evaluate``
    on its checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = _dp_cli(tmp) + ["--spmd-mode", "true", "--zero-opt-state", "true",
                               "--grad-sync-buckets", "25"]
        train_s, _ = _torchrun("mpi_pytorch_tpu_torch.train", argv, 900)
        with open(os.path.join(tmp, "training.log")) as f:
            log_text = f.read()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        for want in (f"world 1 (process group backend {backend})", "spmd mode",
                     "ZeRO opt-state sharding: moments partitioned 1/1", "grad-sync buckets:"):
            if want not in log_text:
                raise AssertionError(f"lever torchrun train: {want!r} not in the log")
        records = _records(os.path.join(tmp, "metrics.jsonl"))
        steps = [r for r in records if r["kind"] == "step"]
        (epoch,) = [r for r in records if r["kind"] == "epoch"]
        (sync,) = [r for r in records if r["kind"] == "grad_sync"]
        want = {"fused_stem.argmax_counter": len(steps), "fused_stem.backward_counter": len(steps)}
        if len(steps) != TRAIN_STEPS_PER_EPOCH or epoch.get("launches") != want:
            raise AssertionError(f"lever torchrun train: {len(steps)} steps, {epoch}")
        if not all(np.isfinite(r["loss"]) for r in steps):
            raise AssertionError("lever torchrun train: a non-finite loss")
        eval_s, _ = _torchrun("mpi_pytorch_tpu_torch.evaluate", argv, 600)
        (ev,) = [r for r in _records(os.path.join(tmp, "metrics.jsonl")) if r["kind"] == "eval"]
        if "fused_stem.counter" not in ev.get("launches", {}):
            raise AssertionError(f"lever torchrun evaluate: {ev}")
    return {"card": card, "train_wall_s": train_s, "evaluate_wall_s": eval_s,
            "img_per_s": epoch["images_per_sec"], "step1_loss": steps[0]["loss"],
            "launches": epoch["launches"], "grad_sync": sync, "accuracy": ev["accuracy"]}


def _check_lever_world(ranks: list[dict], runs: dict, rtol: float, what: str) -> None:
    """Every rank's runs against the first run: losses ``rtol``, parameters
    and statistics within ``rtol`` (plus ``atol`` in ``_LEVER_ATOL``), K2
    and K3 once a step, the moment bytes the formula's."""
    first = next(iter(runs))
    for r in ranks:
        ref = r["runs"][first]
        for name, run in r["runs"].items():
            if run["launches"] != {"stem_pool_argmax": LEVER_STEPS,
                                   "stem_pool_backward": LEVER_STEPS}:
                raise AssertionError(f"{what} {name} rank {r['rank']}: {run['launches']}")
            if run["moment_bytes"] != run["moment_bytes_formula"]:
                raise AssertionError(f"{what} {name} rank {r['rank']}: moments "
                                     f"{run['moment_bytes']} B, formula "
                                     f"{run['moment_bytes_formula']} B")
            if not np.allclose(run["losses"], ref["losses"], rtol=rtol, atol=0):
                raise AssertionError(f"{what} {name} rank {r['rank']}: losses {run['losses']} "
                                     f"against {first}'s {ref['losses']}")
            if name != first and run["worst_excess"][1] > _LEVER_ATOL[what]:
                raise AssertionError(f"{what} {name} rank {r['rank']}: {run['worst_excess']} "
                                     f"beyond rtol {rtol} of {first}'s")


# The parameters' absolute slack beyond rtol: none on two ranks (the same
# two-term sums); on four, where the layouts sum four terms in other
# orders, the atol the CPU test of the same comparison takes
# (tests/test_torch_hierarchical.py): a weight near zero has no relative
# room (conv1's sat 2.6e-7 apart after three steps).
_LEVER_ATOL = {"two ranks": 0.0, "four ranks": 1e-6}


def grad_sync_levers(dev) -> dict:
    """Phase 6d: the spmd step's gradient-sync levers.

    (a) :func:`_lever_torchrun`: the entry point with ZeRO and 25 MiB
    buckets as a NCCL world of one, exit 0, K2 and K3 once a step, its
    checkpoint through the evaluate CLI.

    (b) Two gloo ranks on the card (``LEVER_RUNS_2``): the baseline, ZeRO,
    buckets at 25 and 4 MiB, ZeRO with 25 MiB buckets, three SGD steps
    each; losses, parameters and statistics rtol 1e-6 against the
    baseline (the same two-term sums: 0 expected); K2 and K3 once a step
    on each rank; each rank's moment bytes Σ ⌈numel/2⌉·4; the plans and
    the timed share of the bucket collectives before the backward's end
    (printed, not asserted).

    (c) Four gloo ranks as 2 pods × 2 (``LEVER_RUNS_4``): the hierarchical
    sync, and it with ZeRO and 25 MiB buckets, against the flat four-rank
    step, rtol 1e-5 (the parameters plus atol 1e-6); each step's ledger
    bytes, the dcn payload 1/ici of
    the flat step's; the card's memory before the four ranks."""
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.parallel.launch import run_world

    t_phase = time.perf_counter()
    card = card_report().splitlines()[0]
    torch.cuda.empty_cache()
    out = {"torchrun": _lever_torchrun(dev, card)}
    log({"lever_torchrun": out["torchrun"]})
    shape = {"batch": TRAIN_BATCH, "image": IMG, "classes": V}
    t0 = time.perf_counter()
    two = run_world("chip_smoke:lever_rank", 2,
                    {"device": str(dev), "shape": shape, "runs": LEVER_RUNS_2, "rtol": 1e-6},
                    timeout_s=600)
    _check_lever_world(two, LEVER_RUNS_2, 1e-6, "two ranks")
    r0 = two[0]["runs"]
    log({"lever_two_ranks": {
        "card": card, "backend": "gloo", "rows_per_rank": TRAIN_BATCH // 2, "dtype": "float32",
        "losses": {k: v["losses"] for k, v in r0.items()},
        "max_abs_gap_to_baseline": {k: v.get("max_abs_gap") for k, v in r0.items()},
        "moment_mb_per_rank": {k: v["moment_bytes"] / 1e6 for k, v in r0.items()},
        "plan": {k: v["plan"] for k, v in r0.items() if "plan" in v},
        "timed_step": {k: v["timed"] for k, v in r0.items() if "timed" in v},
        "ledger_bytes": {k: v["ledger"]["ici"]["by_op"] for k, v in r0.items()},
        "route": {k: v["route"] for k, v in r0.items() if "route" in v},
        "peak_mb_per_rank": [r["peak_mb"] for r in two], "wall_s": time.perf_counter() - t0,
    }})
    free, total = torch.cuda.mem_get_info(dev)
    log({"lever_four_ranks_memory": {
        "card": card, "free_mb": free / 1e6, "total_mb": total / 1e6,
        "two_rank_peak_mb_per_rank": max(r["peak_mb"] for r in two),
        "budget": "4 ranks × (the two-rank peak: parameters, gradients, momentum, "
                  "the gathered flats, activations of 64 rows — 32 here) + 4 contexts",
    }})
    t0 = time.perf_counter()
    four = run_world("chip_smoke:lever_rank", 4,
                     {"device": str(dev), "shape": shape, "runs": LEVER_RUNS_4, "rtol": 1e-5},
                     timeout_s=600)
    _check_lever_world(four, LEVER_RUNS_4, 1e-5, "four ranks")
    r0 = four[0]["runs"]
    flat_ar = r0["flat"]["ledger"]["ici"]["by_op"]["all_reduce"]
    flat_payload = flat_ar / (2 * 3 / 4)
    for name in ("hier", "hier_zero_buckets_25"):
        dcn = r0[name]["ledger"]["dcn"]
        # The pod all-reduce's ring factor over 2 pods is 1: its bytes are
        # its payload, 1/ici of the flat step's.
        if dcn["by_op"].keys() != {"all_reduce"} or dcn["bytes"] != flat_payload / 2:
            raise AssertionError(f"four ranks {name}: dcn {dcn}, flat payload {flat_payload}")
    log({"lever_four_ranks": {
        "card": card, "backend": "gloo", "layout": "2 pods × 2 ici", "rows_per_rank":
        TRAIN_BATCH // 4, "losses": {k: v["losses"] for k, v in r0.items()},
        "max_abs_gap_to_flat": {k: v.get("max_abs_gap") for k, v in r0.items()},
        "ledger": {k: {"ici": v["ledger"]["ici"]["bytes"], "dcn": v["ledger"]["dcn"]["bytes"],
                       "by_op": {kind: v["ledger"][kind]["by_op"] for kind in ("ici", "dcn")}}
                   for k, v in r0.items()},
        "dcn_payload_over_flat_payload": r0["hier"]["ledger"]["dcn"]["bytes"] / flat_payload,
        "moment_mb_per_rank": {k: v["moment_bytes"] / 1e6 for k, v in r0.items()},
        "timed_step": {k: v["timed"] for k, v in r0.items() if "timed" in v},
        "peak_mb_per_rank": [r["peak_mb"] for r in four], "wall_s": time.perf_counter() - t0,
        "phase_s": time.perf_counter() - t_phase,
    }})
    launches = {"torchrun": out["torchrun"]["launches"],
                "two_ranks": two[0]["runs"]["baseline"]["launches"],
                "four_ranks": four[0]["runs"]["flat"]["launches"]}
    return launches


AUTO_STEPS = 3
# Phase 6e's runs: the (data, model) layout's model size, ZeRO-1, FSDP and
# the microbatches a step. On two ranks every run but the TP one is 2 × 1.
AUTO_RUNS_2 = {"baseline": (1, False, False, 1), "zero": (1, True, False, 1),
               "fsdp": (1, False, True, 1), "accum2": (1, False, False, 2),
               "fsdp_accum2": (1, False, True, 2), "tp_1x2": (2, False, False, 1)}
AUTO_RUNS_4 = {"2x2_fsdp_accum2": (2, False, True, 2)}
# Each rank's parameter and moment MB a run (SGD: one momentum a
# parameter), from resnet18's 44 265 012 parameters at 64 500 classes —
# the head 33 088 500, the trunk 11 176 512 — by the placement rule.
_TRUNK_MB, _HEAD_MB = 11_176_512 * 4 / 1e6, 33_088_500 * 4 / 1e6
AUTO_PREDICTED_MB = {
    "baseline": (_TRUNK_MB + _HEAD_MB,) * 2, "zero": (_TRUNK_MB + _HEAD_MB, (_TRUNK_MB + _HEAD_MB) / 2),
    "fsdp": ((_TRUNK_MB + _HEAD_MB) / 2,) * 2, "accum2": (_TRUNK_MB + _HEAD_MB,) * 2,
    "fsdp_accum2": ((_TRUNK_MB + _HEAD_MB) / 2,) * 2, "tp_1x2": (_TRUNK_MB + _HEAD_MB / 2,) * 2,
    "2x2_fsdp_accum2": (_TRUNK_MB / 2 + _HEAD_MB / 2,) * 2,
}


def _auto_state(dev, classes: int, mesh=None, zero: bool = False, fsdp: bool = False):
    """resnet18 with the fused stem, SGD, for the auto step: batchnorm over
    ``mesh``'s data axis, laid out on it with the levers (``place_model``;
    none for one process)."""
    from mpi_pytorch_tpu_torch.models.common import set_batchnorm_sync
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
    from mpi_pytorch_tpu_torch.parallel.mesh import data_axis
    from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer, place_model

    bundle = create_model_bundle("resnet18", classes, seed=SEED, fused_stem=True)
    model = prepare_for_training(bundle.model, dev)
    placed = mesh is not None and (zero or fsdp or mesh.model.size > 1)
    set_batchnorm_sync(model, True, data_axis(mesh) if placed else None)
    placement = place_model(model, mesh, fsdp=fsdp, zero=zero) if placed else None
    opt, schedule = make_optimizer(model, LR, optimizer="sgd", placement=placement)
    return TrainState(model=model, optimizer=opt, schedule=schedule, placement=placement)


def _state_gap(got: dict, ref: dict, rtol: float) -> tuple[str, float, float]:
    """(the worst tensor, its largest |got − ref| beyond rtol·|ref|, its
    largest |got − ref|) of two unsharded state_dicts (floating tensors)."""
    worst = ("", -float("inf"), 0.0)
    for k, v in ref.items():
        if not v.is_floating_point():
            continue
        diff = (got[k].to(v.device) - v).abs()
        excess = float((diff - rtol * v.abs()).max())
        if excess > worst[1]:
            worst = (k, excess, float(diff.max()))
    return worst


def auto_rank(payload: dict) -> dict:
    """One rank of phase 6e (gloo, on the one card): each configuration of
    ``payload["runs"]`` (``AUTO_RUNS_2`` or ``AUTO_RUNS_4``) from the same
    seeded resnet18 (fused stem, 64 500 classes, 128 px, f32, TF32 off,
    SGD, auto mode), ``AUTO_STEPS`` steps on its data index's rows of
    ``_dp_batches``; each run's losses and grad norms, K2's and K3's
    launches, this rank's parameter and moment bytes, a digest of the
    tensors the model axis replicates, and its largest gap to the run
    ``payload["against"]`` names for it (rtol 1e-6: computed here, the
    tensors stay on the card). Rank 0 saves the unsharded state of the
    runs ``payload["save"]`` names under ``payload["tmp"]`` (a gather:
    every rank takes part) and, with ``payload["checkpoint"]``, a
    checkpoint of the last run, which ``payload["evaluate"]`` (argv) then
    evaluates on the layout: its K1 and K4 launches are returned."""
    import hashlib

    from mpi_pytorch_tpu_torch import checkpoint as ckpt
    from mpi_pytorch_tpu_torch.config import MeshConfig, parse_config
    from mpi_pytorch_tpu_torch.evaluate import evaluate
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh
    from mpi_pytorch_tpu_torch.ops import fused_stem as fs
    from mpi_pytorch_tpu_torch.parallel import distributed
    from mpi_pytorch_tpu_torch.parallel.mesh import MODEL_AXIS, create_mesh, data_axis
    from mpi_pytorch_tpu_torch.train.state import full_state_dict, placed_bytes
    from mpi_pytorch_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(payload["device"])
    distributed.maybe_initialize_distributed(dev, backend_name="gloo")
    rank = distributed.rank()
    shape = payload["shape"]
    batches, _ = _dp_batches(dev, shape)
    meshes = {mp: create_mesh(MeshConfig(model_parallel=mp))
              for mp in sorted({run[0] for run in payload["runs"].values()})}
    out = {"rank": rank, "runs": {}, "peak_mb": 0.0}
    kept = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for name, (mp, zero, fsdp, accum) in payload["runs"].items():
            mesh = meshes[mp]
            data = data_axis(mesh)
            state = _auto_state(dev, shape["classes"], mesh, zero=zero, fsdp=fsdp)
            step = make_train_step(torch.float32, mesh=mesh, accum_steps=accum)
            n = shape["batch"] // data.size
            rows = slice(data.index * n, (data.index + 1) * n)
            fs.argmax_counter.reset()
            fs.backward_counter.reset()
            run = {"losses": [], "grad_norms": [], "coords": (data.index, mesh.model.index)}
            t0 = time.perf_counter()
            for images, labels in batches:
                m = step(state, images[rows], labels[rows])
                run["losses"].append(float(m["loss"]))
                run["grad_norms"].append(float(m["grad_norm"]))
            _sync(dev)
            run["wall_s"] = time.perf_counter() - t0
            run["launches"] = {"stem_pool_argmax": fs.argmax_counter.count,
                               "stem_pool_backward": fs.backward_counter.count}
            param_b, moment_b = placed_bytes(state)
            run["param_mb"], run["moment_mb"] = param_b / 1e6, moment_b / 1e6
            h = hashlib.sha256()
            held = (state.placement.held if state.placement is not None
                    else dict(state.model.named_parameters()))
            for k, t in [*held.items(), *state.model.named_buffers()]:
                if state.placement is None or state.placement.specs.get(k) is None or \
                        state.placement.specs[k].axis != MODEL_AXIS:
                    h.update(k.encode())
                    h.update(t.detach().cpu().numpy().tobytes())
            run["replica_digest"] = h.hexdigest()
            full = {k: v.to(dev) for k, v in
                    full_state_dict(state.model, state.placement).items()}
            ref = payload.get("against", {}).get(name)
            if ref is not None:
                run["gap"] = (ref, *_state_gap(full, kept[ref], 1e-6))
            if name in payload.get("save", ()) and rank == 0:
                torch.save({k: v.cpu() for k, v in full.items()},
                           os.path.join(payload["tmp"], f"{name}.pt"))
            if name in payload.get("against", {}).values():
                kept[name] = full
            del full
            out["runs"][name] = run
            if dev.type == "cuda":
                out["peak_mb"] = max(out["peak_mb"],
                                     torch.cuda.max_memory_allocated(dev) / 1e6)
            if payload.get("checkpoint") and name == list(payload["runs"])[-1]:
                ckpt.save_checkpoint(payload["checkpoint"], epoch=0, state=state,
                                     loss=run["losses"][-1])
            del state, step
            torch.cuda.empty_cache()
    if payload.get("evaluate"):
        fs.counter.reset()
        fh.counter_f32.reset()
        t0 = time.perf_counter()
        summary = evaluate(parse_config(payload["evaluate"]), dev)
        out["evaluate"] = {"accuracy": summary.accuracy, "wall_s": time.perf_counter() - t0,
                           "launches": {"stem_pool": fs.counter.count,
                                        "head_predict_f32": fh.counter_f32.count}}
    return out


def _auto_torchrun(dev, card: str) -> dict:
    """Phase 6e (a): ``torchrun --nproc-per-node 1 -m
    mpi_pytorch_tpu_torch.train --zero-optimizer true --fsdp true
    --accum-steps 4`` (a NCCL world of one) on the fused run's
    configuration for one epoch, then ``-m mpi_pytorch_tpu_torch.evaluate
    --fused-head-eval true --predictions-file`` on its checkpoint."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = _dp_cli(tmp) + ["--zero-optimizer", "true", "--fsdp", "true",
                               "--accum-steps", "4", "--validate", "false"]
        train_s, _ = _torchrun("mpi_pytorch_tpu_torch.train", argv, 900)
        with open(os.path.join(tmp, "training.log")) as f:
            log_text = f.read()
        backend = "nccl" if dev.type == "cuda" else "gloo"
        for want in (f"world 1 (process group backend {backend})", "4 microbatches a step",
                     "placement: mesh data 1 × model 1"):
            if want not in log_text:
                raise AssertionError(f"auto levers torchrun train: {want!r} not in the log")
        records = _records(os.path.join(tmp, "metrics.jsonl"))
        steps = [r for r in records if r["kind"] == "step"]
        (epoch,) = [r for r in records if r["kind"] == "epoch"]
        (placement,) = [r for r in records if r["kind"] == "placement"]
        want = {"fused_stem.argmax_counter": 4 * len(steps),
                "fused_stem.backward_counter": 4 * len(steps)}
        if len(steps) != TRAIN_STEPS_PER_EPOCH or epoch.get("launches") != want:
            raise AssertionError(f"auto levers torchrun train: {len(steps)} steps, {epoch}")
        if not all(np.isfinite(r["loss"]) for r in steps):
            raise AssertionError("auto levers torchrun train: a non-finite loss")
        csv_path = os.path.join(tmp, "predictions.csv")
        eval_s, _ = _torchrun("mpi_pytorch_tpu_torch.evaluate",
                              argv + ["--fused-head-eval", "true", "--predictions-file", csv_path],
                              600)
        (ev,) = [r for r in _records(os.path.join(tmp, "metrics.jsonl")) if r["kind"] == "eval"]
        batches = -(-len(load_test_manifest(tmp)) // TRAIN_BATCH)
        if ev.get("launches") != {"fused_stem.counter": batches, "fused_head_ce.counter": batches}:
            raise AssertionError(f"auto levers torchrun evaluate: {ev}")
    return {"card": card, "train_wall_s": train_s, "evaluate_wall_s": eval_s,
            "img_per_s": epoch["images_per_sec"], "step1_loss": steps[0]["loss"],
            "launches": epoch["launches"], "eval_launches": ev["launches"],
            "placement": placement, "accuracy": ev["accuracy"]}


def load_test_manifest(tmp: str):
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests

    return load_manifests(_train_cfg(tmp))[1]


def _microbatch_order(batch: int, ranks: int, accum: int) -> np.ndarray:
    """The row order whose contiguous split into ``accum`` microbatches is
    that of ``ranks`` data ranks each splitting its contiguous rows."""
    rows = batch // ranks
    per = rows // accum
    return np.array([r * rows + j * per + i for j in range(accum) for r in range(ranks)
                     for i in range(per)])


def _one_process(dev, batches, accum: int = 1) -> tuple[list[float], list[float], dict]:
    """The unplaced auto step in this process on whole batches: losses,
    grad norms and the state after the last step (on the card)."""
    from mpi_pytorch_tpu_torch.train.step import make_train_step

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        state = _auto_state(dev, V)
        step = make_train_step(torch.float32, accum_steps=accum)
        ms = [step(state, images, labels) for images, labels in batches]
        losses = [float(m["loss"]) for m in ms]
        norms = [float(m["grad_norm"]) for m in ms]
        full = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del state, step
    return losses, norms, full


# The 2 × 2 run's absolute slack beyond rtol 1e-5 against 2 × 1, after
# three steps: the TP head's split dfeats and vocab-parallel CE round apart
# (~1e-7 relative) and the batchnorm backward amplifies it — 1.6e-6 on a
# running mean when this phase ran on the CPU at 64 px; the tests' atol for sums
# in another order (tests/test_torch_dp_step.py).
AUTO_2X2_ATOL = 2e-6
# The runs held to their reference at rtol 1e-6 (two-term sums: 0
# expected); FSDP with microbatches reduce-scatters each microbatch's
# gradient, a sum in another order, and its gap is printed.
AUTO_EXACT = {"zero": "baseline", "fsdp": "baseline"}


def _check_auto_ranks(ranks: list[dict], what: str) -> None:
    """Every rank's runs: K2 and K3 once a microbatch, the tensors the model
    axis replicates bit-identical on the ranks of each model group, the
    parameter and moment MB the prediction's, ZeRO-1's and FSDP's losses,
    parameters and statistics within rtol 1e-6 of the baseline's."""
    groups: dict = {}
    for r in ranks:
        for name, run in r["runs"].items():
            k = AUTO_STEPS * (AUTO_RUNS_2 | AUTO_RUNS_4)[name][3]
            if run["launches"] != {"stem_pool_argmax": k, "stem_pool_backward": k}:
                raise AssertionError(f"{what} {name} rank {r['rank']}: {run['launches']}")
            want = AUTO_PREDICTED_MB[name]
            if not np.allclose((run["param_mb"], run["moment_mb"]), want, rtol=1e-6, atol=0):
                raise AssertionError(f"{what} {name} rank {r['rank']}: {run['param_mb']} MB "
                                     f"parameters, {run['moment_mb']} MB moments, predicted {want}")
            if name in AUTO_EXACT:
                ref, tensor, excess, _ = run["gap"]
                base = r["runs"][ref]["losses"]
                if excess > 0 or not np.allclose(run["losses"], base, rtol=1e-6, atol=0):
                    raise AssertionError(f"{what} {name} rank {r['rank']}: losses "
                                         f"{run['losses']} against {ref}'s {base}; {tensor} "
                                         f"beyond rtol 1e-6 by {excess}")
            groups.setdefault((name, run["coords"][0]), set()).add(run["replica_digest"])
    for key, digests in groups.items():
        if len(digests) != 1:
            raise AssertionError(f"{what} {key}: the model group's replicas differ")


def _csv_agreement(tp_rows: list[str], one_rows: list[str], eval_argv: list[str],
                   ckpt_dir: str, tmp: str, dev):
    """The 2 × 2 evaluate's predicted labels against the world of one's,
    by the f32 serving rule: equal on ≥ 99 % of the rows and on every row
    whose top-2 gap through the plain f32 path (plain stem and head, the
    same checkpoint) exceeds ``E2E_GAP_F32``·|max| — a row closer to a tie
    may take either label, as the two runs' convolutions sum in their own
    orders (cuDNN picks its algorithms by timing, process by process).
    Returns (agree, clear, gap) a row."""
    from mpi_pytorch_tpu_torch import checkpoint as ckpt
    from mpi_pytorch_tpu_torch.config import parse_config
    from mpi_pytorch_tpu_torch.evaluate import build_inference
    from mpi_pytorch_tpu_torch.train.step import ingest_images
    from mpi_pytorch_tpu_torch.train.trainer import make_loader

    cfg = parse_config(eval_argv + ["--fused-stem", "false", "--fused-head-eval", "false"])
    model = build_inference(cfg, dev, ckpt.load_for_eval(ckpt.latest_checkpoint(ckpt_dir))[0])
    test_m = load_test_manifest(tmp)
    gaps = []
    with torch.no_grad():
        for images, _ in make_loader(cfg, test_m, train=False).epoch(0):
            x = ingest_images(torch.from_numpy(images).to(dev), torch.float32)
            v = torch.topk(model(x.permute(0, 3, 1, 2)).float(), 2, dim=-1).values.cpu().numpy()
            gaps.append((v[:, 0] - v[:, 1]) / np.abs(v[:, 0]))
    gap = np.concatenate(gaps)
    tp = np.array([int(r.split(",")[1]) for r in tp_rows[1:]])
    one = np.array([int(r.split(",")[1]) for r in one_rows[1:]])
    agree, clear = tp == one, gap > E2E_GAP_F32
    if not agree[clear].all() or agree.mean() < 0.99:
        raise AssertionError(
            f"2 × 2 evaluate CSV against the world of one's: {int(agree.sum())}/{len(one)} "
            f"agree, {int(agree[clear].sum())}/{int(clear.sum())} on rows with a top-2 gap "
            f"above {E2E_GAP_F32}·|max|")
    del model
    return agree, clear, gap


def _check_eval_launches(ranks: list[dict], test_rows: int) -> None:
    """K1 and K4 (its f32 route: the evaluate runs in f32) once a batch on
    every rank of the 2 × 2 evaluate: batches of 64 rows over the larger
    of the two data shards."""
    want = -(-(-(-test_rows // 2)) // (TRAIN_BATCH // 2))
    for r in ranks:
        ev = r["evaluate"]["launches"]
        if ev != {"stem_pool": want, "head_predict_f32": want}:
            raise AssertionError(f"2 × 2 evaluate rank {r['rank']}: launches {ev}, "
                                 f"{want} batches")


def auto_levers(dev) -> dict:
    """Phase 6e: the auto step's levers — the TP head
    (``--mesh.model-parallel``), ZeRO-1, FSDP and accumulation.

    (a) :func:`_auto_torchrun`: the entry point with ``--zero-optimizer
    true --fsdp true --accum-steps 4`` as a NCCL world of one, exit 0, K2
    and K3 four times a step, its checkpoint through the evaluate CLI with
    the fused head (K1 and K4 once a batch).

    (b) Two gloo ranks on the card (``AUTO_RUNS_2``, three SGD steps each,
    f32, TF32 off): ZeRO-1 and FSDP against the baseline (parameters and
    statistics rtol 1e-6, the losses equal: two-term sums, 0 expected);
    the TP head as 1 × 2 against this process on the same rows (losses
    and the step-1 grad norm rtol 1e-5, the state rtol 1e-5 plus atol
    1e-6 — later grad norms are printed: from step 2 the gradient is
    that sensitive to rounding that a relative 1e-7 change of every
    weight moves ``conv1``'s by 0.56 % in the one-process step itself,
    measured on the CPU at 64 px, 16 rows, 64 500 classes, more than TP
    moves it there, 0.27 %); 2
    microbatches against this process on the same microbatches (losses
    and the step-1 grad norm rtol 1e-4, phase 6c's tolerance for sums in
    another order; the state's gap printed); K2 and K3 once a microbatch
    on each rank; each rank's parameter and moment MB against the
    prediction; the model group's replicas bit-identical.

    (c) Four gloo ranks as 2 × 2 with FSDP and 2 microbatches against the
    two-rank 2 × 1 run with the same levers (losses rtol 1e-5, the state
    rtol 1e-5 plus ``AUTO_2X2_ATOL``); its checkpoint evaluated on the 2 × 2
    layout (``evaluate.evaluate``, what ``python -m
    mpi_pytorch_tpu_torch.evaluate --mesh.model-parallel 2`` runs, on four
    ranks sharing the card over gloo: NCCL takes one card a rank) with the
    fused head, in f32 (K1 and K4's f32 route once a batch on every rank):
    its CSV against a world of one's over the same checkpoint at the same
    rows a batch, by the f32 serving rule (:func:`_csv_agreement`: three
    SGD steps from a random init leave many rows near a tie); the card's
    free memory before the four ranks."""
    from mpi_pytorch_tpu_torch.config import parse_config
    from mpi_pytorch_tpu_torch.evaluate import evaluate
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.parallel.launch import run_world

    t_phase = time.perf_counter()
    card = card_report().splitlines()[0]
    torch.cuda.empty_cache()
    out = {"torchrun": _auto_torchrun(dev, card)}
    log({"auto_torchrun": out["torchrun"]})
    shape = {"batch": TRAIN_BATCH, "image": IMG, "classes": V}
    batches, _ = _dp_batches(dev, shape)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        two = run_world("chip_smoke:auto_rank", 2, {
            "device": str(dev), "shape": shape, "runs": AUTO_RUNS_2, "tmp": tmp,
            "against": {**AUTO_EXACT, "fsdp_accum2": "accum2"},
            "save": ("accum2", "fsdp_accum2", "tp_1x2")}, timeout_s=600)
        two_s = time.perf_counter() - t0
        _check_auto_ranks(two, "two ranks")
        r0 = two[0]["runs"]
        losses, norms, full = _one_process(dev, batches)
        tp = torch.load(os.path.join(tmp, "tp_1x2.pt"), map_location=dev, weights_only=True)
        tp_gap = _state_gap(tp, full, 1e-5)
        if (not np.allclose(r0["tp_1x2"]["losses"], losses, rtol=1e-5, atol=0)
                or not np.isclose(r0["tp_1x2"]["grad_norms"][0], norms[0], rtol=1e-5, atol=0)
                or tp_gap[1] > 1e-6):
            raise AssertionError(f"TP 1 × 2: losses {r0['tp_1x2']['losses']}, grad norms "
                                 f"{r0['tp_1x2']['grad_norms']} against one process's {losses}, "
                                 f"{norms}; state {tp_gap}")
        order = torch.from_numpy(_microbatch_order(TRAIN_BATCH, 2, 2)).to(dev)
        twin = [(images[order], labels[order]) for images, labels in batches]
        a_losses, a_norms, a_full = _one_process(dev, twin, accum=2)
        accum = torch.load(os.path.join(tmp, "accum2.pt"), map_location=dev, weights_only=True)
        accum_gap = _state_gap(accum, a_full, 1e-5)
        if (not np.allclose(r0["accum2"]["losses"], a_losses, rtol=1e-4, atol=0)
                or not np.isclose(r0["accum2"]["grad_norms"][0], a_norms[0], rtol=1e-4, atol=0)):
            raise AssertionError(f"accumulation: losses {r0['accum2']['losses']} against the "
                                 f"one-process twin's {a_losses}")
        del tp, full, accum, a_full
        log({"auto_two_ranks": {
            "card": card, "backend": "gloo", "dtype": "float32", "optimizer": "sgd",
            "losses": {k: v["losses"] for k, v in r0.items()},
            "one_process_losses": losses, "accum2_twin_losses": a_losses,
            "grad_norms": {k: v["grad_norms"] for k, v in r0.items()},
            "one_process_grad_norms": norms, "accum2_twin_grad_norms": a_norms,
            "gaps_to_reference": {k: v["gap"] for k, v in r0.items() if "gap" in v},
            "tp_1x2_state_gap_to_one_process": tp_gap,
            "accum2_state_gap_to_twin": accum_gap,
            "mb_per_rank": {k: {"parameters": v["param_mb"], "moments": v["moment_mb"],
                                "predicted": AUTO_PREDICTED_MB[k]} for k, v in r0.items()},
            "run_wall_s": {k: v["wall_s"] for k, v in r0.items()},
            "peak_mb_per_rank": [r["peak_mb"] for r in two], "wall_s": two_s,
        }})
        free, total = torch.cuda.mem_get_info(dev)
        log({"auto_four_ranks_memory": {
            "card": card, "free_mb": free / 1e6, "total_mb": total / 1e6,
            "two_rank_peak_mb_per_rank": max(r["peak_mb"] for r in two)}})
        ckpt_dir = os.path.join(tmp, "ckpt_2x2")
        eval_argv = _dp_cli(tmp) + [
            "--checkpoint-dir", ckpt_dir, "--compute-dtype", "float32", "--fused-head-eval",
            "true", "--metrics-file", ""]
        t0 = time.perf_counter()
        four = run_world("chip_smoke:auto_rank", 4, {
            "device": str(dev), "shape": shape, "runs": AUTO_RUNS_4, "tmp": tmp,
            "save": ("2x2_fsdp_accum2",), "checkpoint": ckpt_dir,
            "evaluate": eval_argv + ["--mesh.model-parallel", "2", "--predictions-file",
                                     os.path.join(tmp, "tp.csv")]}, timeout_s=600)
        four_s = time.perf_counter() - t0
        _check_auto_ranks(four, "four ranks")
        f0 = four[0]["runs"]["2x2_fsdp_accum2"]
        ref = torch.load(os.path.join(tmp, "fsdp_accum2.pt"), map_location=dev, weights_only=True)
        got = torch.load(os.path.join(tmp, "2x2_fsdp_accum2.pt"), map_location=dev,
                         weights_only=True)
        gap_2x2 = _state_gap(got, ref, 1e-5)
        if (not np.allclose(f0["losses"], r0["fsdp_accum2"]["losses"], rtol=1e-5, atol=0)
                or gap_2x2[1] > AUTO_2X2_ATOL):
            raise AssertionError(f"2 × 2: losses {f0['losses']} against 2 × 1's "
                                 f"{r0['fsdp_accum2']['losses']}; state {gap_2x2}")
        del ref, got
        test_rows = len(load_test_manifest(tmp))
        _check_eval_launches(four, test_rows)
        t0 = time.perf_counter()
        one = evaluate(parse_config(eval_argv + ["--batch-size", str(TRAIN_BATCH // 2),
                                                 "--predictions-file",
                                                 os.path.join(tmp, "one.csv")]), dev)
        one_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "tp.csv")) as f, open(os.path.join(tmp, "one.csv")) as g:
            tp_rows, one_rows = f.read().splitlines(), g.read().splitlines()
        if len(tp_rows) != test_rows + 1 or [r.split(",")[0] for r in tp_rows] != [
                r.split(",")[0] for r in one_rows]:
            raise AssertionError(f"2 × 2 evaluate CSV: {len(tp_rows)} rows against the world "
                                 f"of one's {len(one_rows)}")
        agree, clear, gap = _csv_agreement(tp_rows, one_rows, eval_argv, ckpt_dir, tmp, dev)
        log({"auto_four_ranks": {
            "card": card, "backend": "gloo", "layout": "data 2 × model 2", "fsdp": True,
            "accum_steps": 2, "losses": f0["losses"],
            "two_rank_2x1_losses": r0["fsdp_accum2"]["losses"],
            "state_gap_to_2x1": gap_2x2,
            "mb_per_rank": {"parameters": f0["param_mb"], "moments": f0["moment_mb"],
                            "predicted": AUTO_PREDICTED_MB["2x2_fsdp_accum2"]},
            "evaluate": {"rows": test_rows, "accuracy": four[0]["evaluate"]["accuracy"],
                         "one_process_accuracy": one.accuracy,
                         "csv_rows_differing": int((~agree).sum()),
                         "clear_rows": int(clear.sum()),
                         "largest_differing_gap": float(gap[~agree].max())
                         if not agree.all() else None,
                         "launches_rank0": four[0]["evaluate"]["launches"],
                         "wall_s": four[0]["evaluate"]["wall_s"], "one_process_wall_s": one_s},
            "peak_mb_per_rank": [r["peak_mb"] for r in four], "wall_s": four_s,
            "phase_s": time.perf_counter() - t_phase,
        }})
    return {"torchrun": out["torchrun"]["launches"],
            "two_ranks": {k: v["launches"] for k, v in r0.items()},
            "four_ranks": f0["launches"]}


def train_vit(dev) -> dict:
    """vit_s16 at full width and depth through ``trainer.train``: the
    tiny-S configuration (K9: the tensor-core kernel in training, the FFMA
    kernel in validation; K10) at 128 px and the flash configuration (K8's
    tensor-core kernel) at 224 px, ``VIT_EPOCHS`` epochs of the DEBUG sample each with
    validation and one checkpoint kept, then each again with
    ``attn_impl="full"`` on the
    same seed and rows. The forwards must launch once per block in every
    train step and every validation batch on their kernels (flash: the
    tensor-core kernel for both; tiny-S: the tensor-core kernel in train
    steps, FFMA in validation), K10's bf16 tensor-core kernel once per
    block in every train step (its other kernels never), the kernels
    zero-padded at a head dim that is not a multiple of 16 never (the
    heads are 64 wide), the full runs none; step-1
    losses within 1e-3 of the full twin's. Returns every counted kernel's
    launches over the two kernel runs (zero where none)."""
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests
    from mpi_pytorch_tpu_torch.ops import flash_attention, fused_attention_small
    from mpi_pytorch_tpu_torch.train.trainer import train

    counters = {
        "attention_small_forward_tc": fused_attention_small.forward_tc_counter,
        "attention_small_forward_ffma": fused_attention_small.forward_ffma_counter,
        "attention_small_backward_tc": fused_attention_small.backward_tc_counter,
        "attention_small_backward_f32tc": fused_attention_small.backward_tc_f32_counter,
        "flash_forward_tc": flash_attention.tc_counter,
        f"flash_forward_{PADDED_SUFFIX}": flash_attention.tc_pad_counter,
        f"attention_small_backward_{PADDED_SUFFIX}": fused_attention_small.backward_tc_pad_counter,
        "attention_small_forward_f32tc": fused_attention_small.forward_tc_f32_counter,
        "flash_forward_f32tc": flash_attention.tc_f32_counter,
    }
    with tempfile.TemporaryDirectory() as tmp:
        rows = len(load_manifests(_train_cfg(tmp))[0])
    steps = rows // TRAIN_BATCH * VIT_EPOCHS
    val_batches = -(-rows // TRAIN_BATCH) * VIT_EPOCHS
    launches = {}
    for attn_impl, image in VIT_RUNS.items():
        runs = {}
        for impl in (attn_impl, "full"):
            with tempfile.TemporaryDirectory() as tmp:
                cfg = _vit_cfg(tmp, impl, image)
                for c in counters.values():
                    c.reset()
                t0 = time.perf_counter()
                summary = train(cfg, device=dev)
                wall = time.perf_counter() - t0
                counts = {name: c.count for name, c in counters.items()}
                saved = sorted(os.listdir(cfg.checkpoint_dir))
            losses = summary.step_losses
            if len(losses) != steps or not np.all(np.isfinite(losses)):
                raise AssertionError(f"vit_s16 {impl} training: step losses {losses}")
            if saved != [f"ckpt_{VIT_EPOCHS - 1:05d}.pt"] or summary.val_accuracy is None:
                raise AssertionError(f"vit_s16 {impl}: checkpoints {saved}, val {summary.val_accuracy}")
            runs[impl] = {"step_losses": losses, "wall_s": wall, "epoch_losses": summary.epoch_losses,
                          "epoch_times_s": summary.epoch_times,
                          "ms_per_step_last_epoch": 1e3 * summary.epoch_times[-1] / (steps // VIT_EPOCHS),
                          "img_per_s_last_epoch": (steps // VIT_EPOCHS) * TRAIN_BATCH / summary.epoch_times[-1],
                          "img_per_s": summary.images_per_sec,
                          "val_accuracy": summary.val_accuracy, "launches": counts}
            log({"train_vit": {"attn_impl": impl, "image": image, **runs[impl]}})
        want = dict.fromkeys(counters, 0)
        if attn_impl == "flash":
            want["flash_forward_tc"] = VIT_BLOCKS * (steps + val_batches)
        else:
            want["attention_small_forward_tc"] = VIT_BLOCKS * steps
            want["attention_small_forward_ffma"] = VIT_BLOCKS * val_batches
            want["attention_small_backward_tc"] = VIT_BLOCKS * steps
        if runs[attn_impl]["launches"] != want:
            raise AssertionError(f"{attn_impl} launches {runs[attn_impl]['launches']}, want {want}")
        if any(runs["full"]["launches"].values()):
            raise AssertionError(f"the full-attention run launched a kernel: {runs['full']['launches']}")
        gap = abs(runs[attn_impl]["step_losses"][0] / runs["full"]["step_losses"][0] - 1)
        if gap > 1e-3:
            raise AssertionError(f"vit_s16 {attn_impl}: step-1 loss against full, relative gap {gap}")
        log({"train_vit_vs_full": {"attn_impl": attn_impl, "step1_rel_gap": gap}})
        for name, count in runs[attn_impl]["launches"].items():
            launches[name] = launches.get(name, 0) + count
    return launches


def _train_state(dev, fused: bool = False, model_name: str = "resnet18", **bundle_kw):
    from mpi_pytorch_tpu_torch.models.registry import create_model_bundle, prepare_for_training
    from mpi_pytorch_tpu_torch.train.state import TrainState, make_optimizer

    bundle = create_model_bundle(model_name, V, seed=SEED, fused_stem=fused, **bundle_kw)
    model = prepare_for_training(bundle.model, dev)
    opt, schedule = make_optimizer(model, LR)
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def _resident_batches(dev, n: int, seed: int, image: int = IMG):
    rng = np.random.default_rng(seed)
    return [
        (
            torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, image, image, 3), dtype=np.uint8)).to(dev),
            torch.from_numpy(rng.integers(0, V, (TRAIN_BATCH,), dtype=np.int32)).to(dev),
        )
        for _ in range(n)
    ]


def train_step_checks(dev) -> None:
    """K2/K3 inside the real train step, in f32 (TF32 off), from the same
    seeded weights on the same three batches, three ways: the fused model
    through the kernels; the same model with the stem's plain versions in
    their place; and the plain-stem model (batchnorm, relu, max-pool).

    Kernels against plain versions: the forward values are the same bits,
    so this isolates the kernels — losses and the stem parameters' step-1
    gradients (norm-wise) rtol 1e-4, and ``bn1``'s parameters after three
    Adam steps rtol 1e-4 plus one Adam step (lr) absolute. Kernels against the plain stem: losses rtol 1e-4; the
    gradients are logged, not held — the two stems round the batchnorm
    affine differently (a folded ``y·a + b`` against ``(y − μ)·m + β``),
    and 16 more batchnorm layers amplify that ulp-level forward gap into a
    per-mille gradient gap at the stem.

    Then the device time of one bf16 train step on a resident batch,
    fused and plain stem, timed in turns (plain, fused, fused, plain)."""
    from unittest import mock

    from mpi_pytorch_tpu_torch.ops import fused_stem as fs
    from mpi_pytorch_tpu_torch.train.step import make_train_step

    stem_params = ("conv1.weight", "bn1.weight", "bn1.bias")
    batches = _resident_batches(dev, 3, SEED + 3)
    step = make_train_step(torch.float32)

    def run(fused: bool):
        state = _train_state(dev, fused)
        params = dict(state.model.named_parameters())
        losses = [float(step(state, *batches[0])["loss"])]
        grads = {n: params[n].grad.detach().clone() for n in stem_params}
        losses += [float(step(state, *b)["loss"]) for b in batches[1:]]
        return losses, grads, {n: params[n].detach().clone() for n in stem_params[1:]}

    # cuDNN's heuristics and deterministic algorithms: every run convolves
    # alike (with benchmarking each run would time its own picks).
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        kernels = run(True)
        with mock.patch.object(fs, "stem_pool_argmax", fs.stem_pool_argmax_reference), \
                mock.patch.object(fs, "stem_pool_backward", fs.stem_pool_backward_reference):
            plain_versions = run(True)
        plain_stem = run(False)

    def gaps(a, b):
        return {
            "losses": (a[0], b[0]),
            "step1_grad_rel_l2": {n: float((a[1][n] - b[1][n]).norm() / b[1][n].norm())
                                  for n in stem_params},
            "bn1_after_3_steps_max_abs": {n: float((a[2][n] - b[2][n]).abs().max()) for n in a[2]},
        }

    log({"train_f32_kernels_vs_plain_versions": gaps(kernels, plain_versions),
         "train_f32_kernels_vs_plain_stem": gaps(kernels, plain_stem)})
    for other, what in ((plain_versions, "plain versions"), (plain_stem, "plain stem")):
        if not np.allclose(kernels[0], other[0], rtol=1e-4, atol=0):
            raise AssertionError(f"f32 train steps, kernels vs {what}: losses {kernels[0]} vs {other[0]}")
    rel = gaps(kernels, plain_versions)["step1_grad_rel_l2"]
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"f32 step-1 stem gradients, kernels vs plain versions: {rel}")
    for n in kernels[2]:
        # Plus one Adam step (lr) absolute: Adam's early updates are ±lr
        # per element whatever the gradient's size, so a channel whose
        # gradient sums to near zero may step either way on rounding.
        if not torch.allclose(kernels[2][n], plain_versions[2][n], rtol=1e-4, atol=LR):
            raise AssertionError(f"f32 train steps: {n} after 3 steps, kernels vs plain versions")

    (images, labels), = _resident_batches(dev, 1, SEED + 4)
    step = make_train_step(torch.bfloat16)
    states = {"plain": _train_state(dev, False), "fused": _train_state(dev, True)}
    times = {"plain": [], "fused": []}
    for name in ("plain", "fused", "fused", "plain"):
        times[name].append(time_ms(lambda n=name: step(states[n], images, labels), 10))
    log({"train_step_ms": {"batch": TRAIN_BATCH, "dtype": "bfloat16", **{f"{k}_ms": v for k, v in times.items()}}})


def vit_step_checks(dev) -> None:
    """K8, K9 and K10 inside the real vit_s16 train step, in f32 (TF32
    off), from the same seeded weights on the same three resident batches,
    three ways per configuration: through the kernels (the f32 tensor-core
    forwards and K10's f32 tensor-core kernel, each of which must launch
    once per block in every step; the FFMA and bf16 forwards and K10's
    bf16 kernels, zero-padded or not, never); the same model
    with the kernels' plain versions in their place; and
    ``attn_impl="full"``. Losses rtol 1e-4 both ways; the step-1 gradients
    of ``patch_embed`` and block 0's q, k, v and out projections, kernels
    against plain versions, within ``VIT_GRAD_GAP`` (relative L2). Then the
    time of one bf16 train step on a resident batch, kernels and full, in
    turns. Returns the counted kernels' launches in the kernel runs."""
    import contextlib
    from unittest import mock

    from mpi_pytorch_tpu_torch.ops import flash_attention as fa
    from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
    from mpi_pytorch_tpu_torch.ops.ring_attention import full_attention
    from mpi_pytorch_tpu_torch.train.step import make_train_step

    watch = ("patch_embed.weight",) + tuple(f"blocks.0.attn.{p}.weight" for p in "qkv") + (
        "blocks.0.attn.out.weight",)
    plain_versions = {
        "fused-small": (
            (fas, "attention_small_forward",
             lambda q, k, v, causal=False, train=False: full_attention(q, k, v, causal=causal)),
            (fas, "attention_small_backward", fas.attention_small_backward_reference),
        ),
        "flash": (
            (fa, "flash_forward",
             lambda q, k, v, causal=False, *blocks: fa.flash_forward_reference(q, k, v, causal)),
        ),
    }
    step = make_train_step(torch.float32)
    launches = {}
    for attn_impl, image in VIT_RUNS.items():
        batches = _resident_batches(dev, 3, SEED + 6, image)

        def run(impl, patches=()):
            state = _train_state(dev, model_name="vit_s16", image_size=image, attn_impl=impl)
            params = dict(state.model.named_parameters())
            with contextlib.ExitStack() as stack:
                for target, name, repl in patches:
                    stack.enter_context(mock.patch.object(target, name, repl))
                losses = [float(step(state, *batches[0])["loss"])]
                grads = {n: params[n].grad.detach().clone() for n in watch}
                losses += [float(step(state, *b)["loss"]) for b in batches[1:]]
            return losses, grads

        counted = {"flash": {"flash_forward_f32tc": fa.tc_f32_counter},
                   "fused-small": {"attention_small_forward_f32tc": fas.forward_tc_f32_counter,
                                   "attention_small_backward_f32tc": fas.backward_tc_f32_counter}}[attn_impl]
        idle = (fa.tc_counter, fa.tc_pad_counter, fas.forward_tc_counter, fas.forward_ffma_counter,
                fas.backward_tc_counter, fas.backward_tc_pad_counter)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            for counter in (*counted.values(), *idle):
                counter.reset()
            kernels = run(attn_impl)
            launches.update({name: counter.count for name, counter in counted.items()})
            stray = [c.count for c in idle]
            plain = run(attn_impl, plain_versions[attn_impl])
            full = run("full")
        rel = {n: float((kernels[1][n] - plain[1][n]).norm() / plain[1][n].norm()) for n in watch}
        rel_full = {n: float((kernels[1][n] - full[1][n]).norm() / full[1][n].norm()) for n in watch}
        log({"train_f32_vit": {"attn_impl": attn_impl, "image": image, "losses": kernels[0],
                               "plain_versions_losses": plain[0], "full_losses": full[0],
                               "step1_grad_rel_l2_vs_plain_versions": rel,
                               "step1_grad_rel_l2_vs_full": rel_full}})
        for other, what in ((plain, "plain versions"), (full, "full attention")):
            if not np.allclose(kernels[0], other[0], rtol=1e-4, atol=0):
                raise AssertionError(f"f32 vit {attn_impl} steps vs {what}: {kernels[0]} vs {other[0]}")
        if max(rel.values()) > VIT_GRAD_GAP:
            raise AssertionError(f"f32 vit {attn_impl}: step-1 gradients vs plain versions {rel}")
        if any(launches[name] != VIT_BLOCKS * len(batches) for name in counted) or any(stray):
            raise AssertionError(f"f32 vit {attn_impl}: launches {launches}, other forwards {stray}")

        (images, labels), = _resident_batches(dev, 1, SEED + 8, image)
        step16 = make_train_step(torch.bfloat16)
        states = {impl: _train_state(dev, model_name="vit_s16", image_size=image, attn_impl=impl)
                  for impl in (attn_impl, "full")}
        times = {impl: [] for impl in states}
        for impl in ("full", attn_impl, attn_impl, "full"):
            times[impl].append(time_ms(lambda i=impl: step16(states[i], images, labels), 5))
        log({"train_step_ms_vit": {"attn_impl": attn_impl, "image": image, "batch": TRAIN_BATCH,
                                   **{f"{k}_ms": v for k, v in times.items()}}})
    return launches


def _step_times(step) -> tuple[dict, list]:
    """The host's time to enqueue one ``step()`` against the time until the
    card has run it (ms, five steps after three warm-ups), and the card's
    busy time per step from ``torch.profiler`` (kernel time summed over
    three steps); also the profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    out["step_host_enqueue_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    out["step_enqueue_to_done_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out["step_device_busy_ms"] = sum(e.self_device_time_total for e in kernels) / 3e3
    return out, kernels


def train_time_breakdown(dev, label: str, cfg_kw: dict, state_kw: dict, image: int) -> None:
    """Where a training step's time goes, bf16, batch 128: the host loader
    alone (ms per batch into device memory: synthetic f32 rows from the row
    cache the training phase filled, stacked, pinned and copied); the
    host's time to enqueue one step against the time until the card has run
    it; and the card's busy time per step from ``torch.profiler`` (kernel
    time summed, three steps), with the kernels that take most of it and
    the port's own kernels by name."""
    from mpi_pytorch_tpu_torch.data.manifest import load_manifests
    from mpi_pytorch_tpu_torch.train import trainer
    from mpi_pytorch_tpu_torch.train.step import make_train_step

    out = {"config": label}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _train_cfg(tmp, **cfg_kw)
        loader = trainer.make_loader(cfg, load_manifests(cfg)[0], train=True)
        t0, n = time.perf_counter(), 0
        for images, labels in loader.epoch(0):
            trainer.to_device(images, labels, dev)
            n += 1
        torch.cuda.synchronize()
        out["loader_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / n
    state = _train_state(dev, **state_kw)
    (images, labels), = _resident_batches(dev, 1, SEED + 5, image)
    step = make_train_step(torch.bfloat16)
    timing, kernels = _step_times(lambda: step(state, images, labels))
    out.update(timing)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out["top_kernels_ms_per_step"] = [[e.key[:80], e.self_device_time_total / 3e3] for e in top]
    # The port's own kernels, each by name with its busy time per step:
    # csrc/ keeps them in an anonymous namespace, where PyTorch keeps a few
    # kernels templated on its at:: functors.
    names = {e: e.key.removeprefix("void (anonymous namespace)::").split("(")[0] for e in kernels}
    out["port_kernels_ms_per_step"] = {
        names[e]: e.self_device_time_total / 3e3 for e in kernels
        if e.key.startswith("void (anonymous namespace)::") and "at::" not in names[e]
    }
    log({"train_breakdown": out})


def predict_step_times(cfg, fused_model, plain_cfg, plain_model, dev) -> None:
    """Device time of one predict step at the smallest and largest bucket:
    the plain path (cuDNN stem tail, logits + CE + argmax) against the
    kernels' path, timed in turns (plain, fused, fused, plain)."""
    from mpi_pytorch_tpu_torch.serve import BucketExecutables

    exes = {
        "plain": BucketExecutables(plain_cfg, plain_model, dev),
        "fused": BucketExecutables(cfg, fused_model, dev),
    }
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for bucket in (1, 512):
        imgs = rng.integers(0, 256, size=(bucket, 128, 128, 3), dtype=np.uint8)
        labels = np.full((bucket,), -1, np.int32)
        placed = {k: exe.place(imgs, labels) for k, exe in exes.items()}
        times = {"plain": [], "fused": []}
        for k in ("plain", "fused", "fused", "plain"):
            times[k].append(time_ms(lambda k=k: exes[k](bucket, placed[k]), 20))
        out[str(bucket)] = {f"{k}_ms": v for k, v in times.items()}
    log({"predict_step_ms": out})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.ops import _build

    smi = card_report().splitlines()[0]
    print(smi, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    _build.load_library()
    log({"build_seconds": _build.build_seconds})
    # Each kernel's registers and spills; the kernels whose wgmma ptxas
    # serialized (its C7512/C7514/C7515/C7520 notes: "... are serialized
    # due to ..."; a C7519 note is an inserted warpgroup arrive).
    kernel, spills, serialized = "?", "", set()
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line.split("'")[1])
        elif "serialized" in line and "'" in line:
            serialized.add(_kernel_name(line.split("'")[1]))
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            log(f"{kernel}: {line.strip()}, {spills}")
        elif "error" in line.lower():
            log(line.strip())
    log({"wgmma_serialized_by_ptxas": sorted(serialized)})

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    check_ingest(dev)
    stem = check_stem(dev, gen)
    stem_argmax = check_stem_argmax(dev, gen)
    stem_backward = check_stem_backward(dev, gen)
    head = check_head(dev, gen, torch.bfloat16)
    head_f32 = check_head(dev, gen, torch.float32)
    check_head_ties(dev, gen)
    attn_fwd, attn_fwd_f32, attn_fwd_ffma, attn_bwd, attn_bwd_f32, attn_bwd_pad = (
        check_attention_small(dev, gen))
    flash, flash_f32, flash_pad = check_flash(dev, gen)
    head_int8 = check_head_int8(dev, gen)
    head_ce_fwd, head_ce_bwd = check_head_ce_train(dev, gen)
    check_topk_ties(dev, gen)
    launches = serve_resnet18(dev)
    stem["launches"], head["launches"] = launches["stem"], launches["head"]
    head_f32["launches"] = serve_resnet18_f32(dev)
    head_int8["launches"] = serve_resnet18_int8(dev)
    serve_resnet18_both(dev)
    ce_launches = train_head_ce(dev)
    head_ce_fwd["launches"] = ce_launches["head_ce_forward"]
    head_ce_bwd["launches"] = ce_launches["head_ce_backward"]
    serve_vit(dev)
    with tempfile.TemporaryDirectory() as run_dir:
        fused_run = train_resnet18(dev, run_dir)
        evaluate_resnet18(dev, run_dir)
    # K1's, K2's and K3's launches on the device-cache path (PERF.md's
    # third figure of their rows; the kernels line keeps the main path's).
    log({"cached_launches": train_resnet18_cached(dev, fused_run)})
    stem_argmax["launches"] = fused_run["launches"]["stem_pool_argmax"]
    stem_backward["launches"] = fused_run["launches"]["stem_pool_backward"]
    dp_launches = data_parallel(dev, fused_run)
    # K2's and K3's launches in the data-parallel phase: the second figure
    # of their rows in PERF.md (the kernels line keeps the main path's).
    log({"dp_launches": dp_launches})
    # K2's and K3's launches in phase 6d, a run at a time.
    log({"lever_launches": grad_sync_levers(dev)})
    # K2's and K3's launches in phase 6e, a run at a time.
    log({"auto_lever_launches": auto_levers(dev)})
    vit_launches = train_vit(dev)
    train_step_checks(dev)
    vit_launches.update(vit_step_checks(dev))
    # The padded rows read 0: vit_s16's heads are 64 wide, and train_vit
    # fails if its runs launch a padded kernel.
    for row in (attn_fwd, attn_fwd_f32, attn_fwd_ffma, attn_bwd, attn_bwd_f32, attn_bwd_pad, flash,
                flash_f32, flash_pad):
        row["launches"] = vit_launches[row["name"]]
    train_time_breakdown(dev, "resnet18 fused stem 128 px", {"fused_stem": True}, {"fused": True}, IMG)
    for attn_impl, image in VIT_RUNS.items():
        train_time_breakdown(
            dev, f"vit_s16 {attn_impl} {image} px",
            {"model_name": "vit_s16", "attn_impl": attn_impl, "width": image, "height": image},
            {"model_name": "vit_s16", "attn_impl": attn_impl, "image_size": image}, image,
        )
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = (stem, stem_argmax, stem_backward, head, head_f32, head_ce_fwd, head_ce_bwd, head_int8,
            flash, flash_f32, flash_pad, attn_fwd, attn_fwd_f32, attn_fwd_ffma, attn_bwd,
            attn_bwd_f32, attn_bwd_pad)
    print(smi, flush=True)
    for row in rows:
        row["ms"] = row["device_ms"]
        if row["ms"] < row["bound_ms"]:
            raise AssertionError(f"{row['name']}: {row['ms']} ms below its bound {row['bound_ms']} ms")
    log({"kernels": [{k: row[k] for k in keys} for row in rows]})
    log({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
