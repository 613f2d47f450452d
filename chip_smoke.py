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

import dataclasses
import json
import os
import re
import statistics
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
    stem then plain stem; returns K2's and K3's launches in the fused run.
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
    return fused["launches"]


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


def train_time_breakdown(dev, label: str, cfg_kw: dict, state_kw: dict, image: int) -> None:
    """Where a training step's time goes, bf16, batch 128: the host loader
    alone (ms per batch into device memory: synthetic f32 rows from the row
    cache the training phase filled, stacked, pinned and copied); the
    host's time to enqueue one step against the time until the card has run
    it; and the card's busy time per step from ``torch.profiler`` (kernel
    time summed, three steps), with the kernels that take most of it and
    the port's own kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    for _ in range(3):
        step(state, images, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(state, images, labels)
    out["step_host_enqueue_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    out["step_enqueue_to_done_ms"] = 1e3 * (time.perf_counter() - t0) / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, images, labels)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out["step_device_busy_ms"] = sum(e.self_device_time_total for e in kernels) / 3e3
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
        train_launches = train_resnet18(dev, run_dir)
        evaluate_resnet18(dev, run_dir)
    stem_argmax["launches"] = train_launches["stem_pool_argmax"]
    stem_backward["launches"] = train_launches["stem_pool_backward"]
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
