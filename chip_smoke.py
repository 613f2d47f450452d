"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build its CUDA kernels,
hold each against its plain PyTorch version, and serve resnet18 at full
width through them.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the kernel library from ``mpi_pytorch_tpu_torch/csrc`` (nvcc,
   sm_90a) into the git-ignored ``build/kernels``;
3. each kernel against its plain version on the card, at the serving
   path's shapes, then timed beside its plain version, a one-call PyTorch
   yardstick where one exists, and its roofline bound;
4. the serving path: ``InferenceServer`` with resnet18, 64 500 classes,
   128 px, bf16, uint8 input, fused stem and fused head, buckets
   1,8,32,128,512, seeded random weights. A flood of seeded images, then
   requests one at a time; every answer is checked against the plain path
   (same weights, plain stem and plain head: ≥ 99 % equal, and equal on
   every row not within ``E2E_GAP`` of a tie) and both kernels' launch
   counts must have risen during the run.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card it exits 2 and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import threading
import time

import numpy as np
import torch

V, D = 64500, 512  # the headline head: 64 500 classes over 512 features
STEM_SHAPE = (512, 64, 64, 64)  # conv1 output at bucket 512, 128 px, NHWC
HEAD_BATCHES = (1, 8, 512)
FLOOD, SINGLES = 1000, 16
# A served answer must equal the plain path's wherever the plain top-2 gap
# exceeds this share of |max|: a little above one bf16 rounding step
# (2^-7 = 7.8e-3 relative), the resolution the activations carry.
E2E_GAP = 1e-2
SEED = 0


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


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
        g, r = got.float(), ref.float()
        if not torch.equal(torch.isnan(g), torch.isnan(r)):
            raise AssertionError(f"fused stem ({name}): NaN positions differ from the plain version")
        fin = ~torch.isnan(r)
        err = (g[fin] - r[fin]).abs()
        tol = 2.0**-7 * torch.maximum(g[fin].abs(), r[fin].abs()) + 1e-6
        if bool((err > tol).any()):
            raise AssertionError(
                f"fused stem ({name}): {int((err > tol).sum())} values beyond one "
                f"bf16 ulp, max err {float(err.max())}"
            )
        max_err = max(max_err, float(err.max()))
    n_in, n_out = y.numel(), y.numel() // 4
    moved = 2 * n_in + 2 * n_out + 8 * c  # bf16 y read, bf16 out written, f32 a, b
    ops = 3 * n_in + 8 * n_out  # fma + relu per input, 8 max per window
    bound, by = bound_ms(moved, ops, H100_PEAK_F32_FLOPS)
    row = {
        "name": "stem_affine_relu_pool", "route": "cuda",
        "source": "mpi_pytorch_tpu_torch/csrc/fused_stem.cu",
        "replaces": "mpi_pytorch_tpu/ops/fused_stem.py:275",
        "shape": list(STEM_SHAPE), "dtype": "bfloat16",
        "max_abs_err": max_err,
        "kernel_ms": time_ms(lambda: fs.stem_affine_relu_pool(y, a, b), 50),
        "plain_ms": time_ms(lambda: fs.stem_affine_relu_pool_reference(y, a, b), 20),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None,  # no one PyTorch call computes pool(relu(affine))
    }
    log({"kernel_check": row})
    return row


def check_head(dev, gen) -> dict:
    """K4 against its plain version at each batch: loss rtol 1e-3; preds
    equal wherever the plain top-2 gap exceeds 1e-3·|max|, and on at least
    99% of rows overall."""
    from mpi_pytorch_tpu_torch.hardware import H100_PEAK_BF16_FLOPS, bound_ms
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    w = (0.05 * torch.randn(V, D, generator=gen)).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn(V, generator=gen)).to(dev)
    w_lib, b_lib = w, bias.to(torch.bfloat16)
    rows = []
    for bsz in HEAD_BATCHES:
        feats = torch.randn(bsz, D, generator=gen).abs().to(dev, torch.bfloat16)
        labels = torch.randint(0, V, (bsz,), generator=gen, dtype=torch.int32)
        labels[::7] = -1
        labels = labels.to(dev)
        loss, pred = fh.head_predict(feats, w, bias, labels)
        torch.cuda.synchronize()
        ref_loss, ref_pred = fh.head_predict_reference(feats, w, bias, labels)
        top2 = torch.topk(fh._logits(feats, w, bias), 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3 * top2[:, 0].abs()
        agree = pred == ref_pred
        if not bool(agree[clear].all()):
            raise AssertionError(f"head_predict B={bsz}: argmax differs on a clear row")
        if float(agree.float().mean()) < 0.99:
            raise AssertionError(f"head_predict B={bsz}: only {float(agree.float().mean())} agree")
        if not torch.allclose(loss, ref_loss, rtol=1e-3, atol=0):
            raise AssertionError(
                f"head_predict B={bsz}: loss off by {float((loss - ref_loss).abs().max())}"
            )
        if not bool((loss[labels < 0] == 0).all()):
            raise AssertionError(f"head_predict B={bsz}: padding rows carry loss")
        moved = 2 * bsz * D + 2 * V * D + 4 * V + 12 * bsz
        bound, by = bound_ms(moved, 2 * bsz * D * V, H100_PEAK_BF16_FLOPS)
        row = {
            "name": "head_predict", "route": "cuda",
            "source": "mpi_pytorch_tpu_torch/csrc/fused_head_ce.cu",
            "replaces": "mpi_pytorch_tpu/ops/fused_head_ce.py:313",
            "batch": bsz, "max_abs_err": float((loss - ref_loss).abs().max()),
            "argmax_agree": float(agree.float().mean()), "clear_rows": int(clear.sum()),
            "kernel_ms": time_ms(lambda: fh.head_predict(feats, w, bias, labels), 50),
            "plain_ms": time_ms(lambda: fh.head_predict_reference(feats, w, bias, labels), 10),
            "bound_ms": bound, "bound_by": by,
            # Yardstick only, never called by the port: cuBLAS logits GEMM.
            "library_ms": time_ms(lambda: torch.nn.functional.linear(feats, w_lib, b_lib), 50),
        }
        log({"kernel_check": row})
        rows.append(row)
    return rows[-1]  # B = 512, the largest bucket


def serve_resnet18(dev) -> dict:
    """The slice at full width through ``InferenceServer``; returns the
    launch counts of the main-path run."""
    from mpi_pytorch_tpu_torch import Config
    from mpi_pytorch_tpu_torch.evaluate import build_inference, head_weights
    from mpi_pytorch_tpu_torch.ops import fused_head_ce, fused_stem
    from mpi_pytorch_tpu_torch.serve import InferenceServer
    from mpi_pytorch_tpu_torch.train.step import ingest_images

    cfg = Config(
        model_name="resnet18", num_classes=V, width=128, height=128,
        compute_dtype="bfloat16", input_dtype="uint8", fused_stem=True,
        fused_head_eval=True, serve_topk=1, serve_buckets="1,8,32,128,512",
        seed=SEED,
    )
    images = np.random.default_rng(SEED).integers(
        0, 256, size=(FLOOD + SINGLES, 128, 128, 3), dtype=np.uint8
    )
    t0 = time.perf_counter()
    srv = InferenceServer(cfg, device=dev)
    log(f"server built and warmed in {time.perf_counter() - t0:.1f} s")
    done_at: dict[int, float] = {}
    lock = threading.Lock()

    def stamp(i):
        def cb(_):
            with lock:
                done_at[i] = time.perf_counter()
        return cb

    try:
        fused_stem.counter.reset()
        fused_head_ce.counter.reset()
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
        launches = {"stem": fused_stem.counter.count, "head": fused_head_ce.counter.count}
        stats = srv.stats()
    finally:
        srv.close()
    if launches["stem"] < 1 or launches["head"] < 1:
        raise AssertionError(f"the serving run did not go through both kernels: {launches}")
    preds = np.stack(preds)
    if preds.shape != (FLOOD + SINGLES, 1) or preds.min() < 0 or preds.max() >= V:
        raise AssertionError(f"bad predictions: shape {preds.shape}, range {preds.min()}..{preds.max()}")

    # The plain path: the same seeded weights with the plain stem, and the
    # plain head over the same bf16 copy of W.
    plain_cfg = dataclasses.replace(cfg, fused_stem=False, fused_head_eval=False)
    plain = build_inference(plain_cfg, dev)
    w, b = head_weights(plain, torch.bfloat16)

    def plain_top1(chunk: int) -> tuple[np.ndarray, np.ndarray]:
        """(argmax, top-2 gap / |max|) per image, in batches of ``chunk``."""
        idx, gap = [], []
        with torch.no_grad():
            for s in range(0, len(images), chunk):
                x = torch.from_numpy(images[s : s + chunk]).to(dev)
                feats = plain.features(ingest_images(x, torch.bfloat16).permute(0, 3, 1, 2))
                top2 = torch.topk(feats.float() @ w.float().t() + b, 2, dim=-1)
                idx.append(top2.indices[:, 0].cpu().numpy())
                v = top2.values.cpu().numpy()
                gap.append((v[:, 0] - v[:, 1]) / np.abs(v[:, 0]))
        return np.concatenate(idx), np.concatenate(gap)

    # The served batches hold other rows than these chunks, and cuDNN picks
    # its convolution algorithms per batch shape, so bf16 activations (and
    # then logits) differ at the bf16 level between the two paths: near
    # ties may flip. The plain path run in two chunkings shows that floor.
    ref, gap = plain_top1(512)
    ref32, _ = plain_top1(32)
    agree = preds[:, 0] == ref
    clear = gap > E2E_GAP
    frac = float(agree.mean())
    if not agree[clear].all() or frac < 0.99:
        raise AssertionError(
            f"served top-1 vs plain path: {int(agree.sum())}/{len(images)} agree, "
            f"{int(agree[clear].sum())}/{int(clear.sum())} on rows with a top-2 gap "
            f"above {E2E_GAP}·|max|"
        )
    lat_flood = [1e3 * (done_at[i] - submitted[i]) for i in range(FLOOD)]
    lat_single = [1e3 * (done_at[i] - submitted[i]) for i in range(FLOOD, FLOOD + SINGLES)]

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q))

    log({"serve": {
        "model": "resnet18", "num_classes": V, "image": 128, "dtype": "bfloat16",
        "requests": len(images), "flood_img_per_s": FLOOD / t_flood,
        "flood_p50_ms": pct(lat_flood, 50), "flood_p99_ms": pct(lat_flood, 99),
        "single_p50_ms": pct(lat_single, 50), "single_p99_ms": pct(lat_single, 99),
        "single_mean_ms": statistics.fmean(lat_single),
        "by_bucket": stats["by_bucket"], "batches": stats["batches"],
        "padded_rows": stats["padded_rows"], "launches": launches,
        "top1_agree_plain": frac, "clear_rows": int(clear.sum()),
        "largest_flipped_gap": float(gap[~agree].max()) if not agree.all() else None,
        "plain_512_vs_32_agree": float((ref == ref32).mean()),
    }})
    predict_step_times(cfg, srv.model, plain_cfg, plain, dev)
    return launches


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "error" in line.lower():
            log(line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    stem = check_stem(dev, gen)
    head = check_head(dev, gen)
    launches = serve_resnet18(dev)
    stem["launches"], head["launches"] = launches["stem"], launches["head"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi, flush=True)
    for row in (stem, head):
        row["ms"] = row["kernel_ms"]
    log({"kernels": [{k: row[k] for k in keys} for row in (stem, head)]})
    log({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
