"""Hold this checkout's K9 FFMA forward, K4 f32 head and training CE head
(K5 forward, K6 backward) against another checkout's on one NVIDIA GPU —
for example the parent commit, unpacked by ``git archive`` into a
git-ignored directory:

    python3 chip_compare.py PARENT_DIR [--only k9|k4|k5|k6]

It builds the parent's ``mpi_pytorch_tpu_torch/csrc`` file of each entry
compared (``PARENT_SOURCES``) with nvcc into ``build/parent_kernels``, in
parallel with this checkout's library, which builds as ``chip_smoke.py``
builds it (the compared kernels' ptxas lines are printed); loads both
through ctypes, then:

- k9: ``mpt_attn_small_fwd`` (bf16) of both on the same inputs at vit_s16's
  serving and validation shape [B, 64, 6, 64] (B = 1, 8, 32, 128), at S =
  50, 65, 128, causal, D = 40, S = D = 128 and a view whose rows are not
  16-byte aligned: the two outputs must be bitwise equal. Then both timed
  (busy ms, ``chip_smoke.device_ms``) in turns — parent, this, this,
  parent — at [128, 64, 6, 64].
- k4: ``mpt_head_predict_f32`` of both at B = 8, 64, 512, D = 512,
  V = 64 500, each against the plain f32 version (loss rtol 1e-5, argmax
  equal wherever the plain top-2 gap exceeds 1e-5·|max|), timed in turns.
- k5: ``mpt_head_ce_fwd`` of both at B = 128, D = 512, V = 64 500 (bf16,
  every 7th label −1): each against the plain forward (loss rtol 1e-5),
  the largest difference of loss, m and l between the two logged, timed
  in turns.
- k6: ``mpt_head_ce_bwd`` of both on the same (m, l, g): dfeats, dW and db
  each against the plain backward (relative L2 within 2e-3) and between
  the two (relative L2 and largest difference logged), timed in turns.

The parent's entry points take the arguments and scratch of the tree
before the training head's redesign (``PARENT_SIGNATURES``): K5's WMMA
kernel with its argmax scratch, K6's three-kernel backward.

Each case prints one JSON line; the last line is ``{"ok": true, ...}``. A
failed check raises. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
# The parent source that carries each compared entry point.
PARENT_SOURCES = {"k9": ("fused_attention_small.cu", "mpt_attn_small_fwd"),
                  "k4": ("head_predict_tc.cu", "mpt_head_predict_f32"),
                  "k5": ("fused_head_ce.cu", "mpt_head_ce_fwd"),
                  "k6": ("fused_head_ce_bwd.cu", "mpt_head_ce_bwd")}
_P, _I = ctypes.c_void_p, ctypes.c_int
# The parent's argument types where they differ from this checkout's.
PARENT_SIGNATURES = {
    # feats, w, bias, labels, loss, m, l, part_mlp, part_arg, B, D, V,
    # n_split, tiles_per_split, stream
    "mpt_head_ce_fwd": (_P,) * 9 + (_I,) * 5 + (_P,),
    # feats, w, bias, labels, m, l, g, dlog, dw, db, part, dfeats, B, D, V,
    # n_split, chunks_per_split, stream
    "mpt_head_ce_bwd": (_P,) * 12 + (_I,) * 5 + (_P,),
}
CE_BATCH = 128
V, D = 64500, 512
K9_CASES = (  # (shape, causal, aligned)
    ((1, 64, 6, 64), False, True), ((8, 64, 6, 64), False, True), ((32, 64, 6, 64), False, True),
    ((128, 64, 6, 64), False, True), ((128, 50, 6, 64), False, True),
    ((128, 65, 6, 64), False, True), ((128, 128, 6, 64), False, True),
    ((128, 64, 6, 64), True, True), ((64, 64, 6, 40), False, True),
    ((8, 128, 6, 128), False, True), ((32, 64, 6, 64), False, False),
)


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def start_parent_build(parent: Path, only: str | None) -> tuple[Path, list]:
    """nvcc for the parent source of each compared entry, all started at
    once; returns the target library and the (object, process) pairs."""
    from mpi_pytorch_tpu_torch.ops import _build

    out = REPO / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    src = parent / "mpi_pytorch_tpu_torch" / "csrc"
    procs = []
    target = out / f"libparent_{parent.name}_{only or 'all'}.so"
    if target.exists():  # built by an earlier run of this command
        return target, procs
    for key, (name, _) in PARENT_SOURCES.items():
        if only not in (None, key):
            continue
        obj = out / f"{parent.name}_{Path(name).stem}.o"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(src / name), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True)))
    return target, procs


def finish_parent_build(target: Path, procs: list, only: str | None) -> ctypes.CDLL:
    from mpi_pytorch_tpu_torch.ops import _build

    for obj, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent nvcc failed for {obj.name}:\n{text}")
    if procs:
        link = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:2], "-shared",
                               *[str(o) for o, _ in procs], "-o", str(target)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"parent link failed:\n{link.stdout}{link.stderr}")
    lib = ctypes.CDLL(str(target))
    for key, (_, name) in PARENT_SOURCES.items():
        if only not in (None, key):
            continue
        fn = getattr(lib, name)
        fn.argtypes = list(PARENT_SIGNATURES.get(name, _build.SIGNATURES[name]))
        fn.restype = ctypes.c_int
    return lib


def log_ptxas(kernels: tuple[str, ...]) -> None:
    """ptxas' registers and spills of this checkout's ``kernels``, and any
    kernel whose wgmma it serialized."""
    from chip_smoke import _kernel_name
    from mpi_pytorch_tpu_torch.ops import _build

    name, spills = "?", ""
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "serialized" in line:
            log({"ptxas": line.strip()})
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and any(k in name for k in kernels):
            log({"ptxas": f"{name}: {line.strip()}, {spills}"})


def _k9(lib, q, k, v, causal: bool) -> torch.Tensor:
    from mpi_pytorch_tpu_torch.ops import _build

    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    rc = lib.mpt_attn_small_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                *q.stride()[:3], b, s, h, d, d**-0.5, int(causal),
                                _build.stream(q.device))
    _build.check(rc, "mpt_attn_small_fwd")
    return out


def compare_k9(parent, dev, gen) -> None:
    import chip_smoke
    from mpi_pytorch_tpu_torch.ops import _build
    from mpi_pytorch_tpu_torch.ops.ring_attention import full_attention

    this = _build.load_library()
    for shape, causal, aligned in K9_CASES:
        b, s, h, d = shape
        # Not aligned: rows of D + 4 elements, read D at a time.
        full = [torch.randn((b, s, h, d if aligned else d + 4), generator=gen).to(dev, torch.bfloat16)
                for _ in range(3)]
        q, k, v = (t if aligned else t[..., :d] for t in full)
        new, old = _k9(this, q, k, v, causal), _k9(parent, q, k, v, causal)
        torch.cuda.synchronize()
        diff = int((new.view(torch.int16) != old.view(torch.int16)).sum())
        err = chip_smoke._ulp_check(new, full_attention(q, k, v, causal=causal), f"K9 {shape}")
        log({"k9_bitwise": {"shape": list(shape), "causal": causal, "aligned": aligned,
                            "elements_differing": diff, "max_abs_err_vs_plain": err}})
        if diff:
            raise AssertionError(f"K9 {shape}: {diff} elements differ from the parent kernel")
    q, k, v = (torch.randn((128, 64, 6, 64), generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    turns = [chip_smoke.device_ms(lambda lib=lib: _k9(lib, q, k, v, False), 50)
             for lib in (parent, this, this, parent)]
    log({"k9_turns_ms": {"shape": [128, 64, 6, 64], "parent_this_this_parent": turns,
                         "parent_ms": (turns[0] + turns[3]) / 2, "this_ms": (turns[1] + turns[2]) / 2}})


def _k4(lib, feats, w, bias, labels, geometry) -> tuple[torch.Tensor, torch.Tensor]:
    from mpi_pytorch_tpu_torch.ops import _build

    bsz = feats.shape[0]
    n_split, per_split = geometry
    dev = feats.device
    part_mlp = torch.empty((3, n_split, bsz), dtype=torch.float32, device=dev)
    part_arg = torch.empty((n_split, bsz), dtype=torch.int32, device=dev)
    loss = torch.empty((bsz,), dtype=torch.float32, device=dev)
    pred = torch.empty((bsz,), dtype=torch.int32, device=dev)
    rc = lib.mpt_head_predict_f32(feats.data_ptr(), w.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                                  loss.data_ptr(), pred.data_ptr(), part_mlp.data_ptr(),
                                  part_arg.data_ptr(), bsz, feats.shape[1], w.shape[0], n_split,
                                  per_split, _build.stream(dev))
    _build.check(rc, "mpt_head_predict_f32")
    return loss, pred


def compare_k4(parent, dev, gen) -> None:
    import chip_smoke
    from mpi_pytorch_tpu_torch.ops import _build
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    this = _build.load_library()
    sms = fh._num_sms(dev.index)
    w = (0.05 * torch.randn(V, D, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(V, generator=gen)).to(dev)
    for bsz in (8, 64, 512):
        feats = torch.randn(bsz, D, generator=gen).abs().to(dev)
        labels = torch.randint(0, V, (bsz,), generator=gen, dtype=torch.int32)
        labels[::7] = -1
        labels = labels.to(dev)
        geo = fh.tc_geometry(bsz, D, V, 4, sms, "chip_compare")
        runs = {"parent": (parent, geo), "this": (this, geo)}
        ref_loss, ref_pred = fh.head_predict_reference(feats, w, bias, labels)
        top2 = torch.topk(fh._logits(feats, w, bias), 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * top2[:, 0].abs()
        row = {"batch": bsz}
        for name, (lib, geo) in runs.items():
            loss, pred = _k4(lib, feats, w, bias, labels, geo)
            torch.cuda.synchronize()
            agree = pred == ref_pred
            row[name] = {"loss_max_abs_err": float((loss - ref_loss).abs().max()),
                         "argmax_agree": float(agree.float().mean()),
                         "clear_rows_agree": bool(agree[clear].all())}
            if not (row[name]["clear_rows_agree"] and torch.allclose(loss, ref_loss, rtol=1e-5, atol=0)):
                raise AssertionError(f"K4 f32 {name} B={bsz}: {row[name]}")
        turns = [chip_smoke.device_ms(
                     lambda lib=runs[n][0], geo=runs[n][1]: _k4(lib, feats, w, bias, labels, geo), 20)
                 for n in ("parent", "this", "this", "parent")]
        row.update(parent_this_this_parent_ms=turns, parent_ms=(turns[0] + turns[3]) / 2,
                   this_ms=(turns[1] + turns[2]) / 2)
        log({"k4_f32": row})


def _ce_inputs(dev, gen):
    """The training CE head's operands at CE_BATCH: bf16 feats and W, f32
    bias, int32 labels (every 7th −1, one in V's ragged last tile), f32 g."""
    w = (0.01 * torch.randn(V, D, generator=gen)).to(dev, torch.bfloat16)
    b = (0.1 * torch.randn(V, generator=gen)).to(dev)
    feats = torch.randn(CE_BATCH, D, generator=gen).to(dev, torch.bfloat16)
    labels = torch.randint(0, V, (CE_BATCH,), generator=gen, dtype=torch.int32)
    labels[::7] = -1
    labels[1] = V - 3
    g = torch.rand(CE_BATCH, generator=gen).to(dev)
    return feats, w, b, labels.to(dev), g


def _parent_ce_fwd(lib, feats, w, b, labels):
    """The parent's K5: its WMMA kernel's split geometry (64-row, 128-column
    tiles, two CTAs an SM) and scratch."""
    from mpi_pytorch_tpu_torch.ops import _build
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    dev, (bsz, d), vocab = feats.device, feats.shape, w.shape[0]
    n_split, per_split = fh.split_geometry(bsz, vocab, fh._num_sms(dev.index), 64, 128, 2)
    part_mlp = torch.empty((3, n_split, bsz), dtype=torch.float32, device=dev)
    part_arg = torch.empty((n_split, bsz), dtype=torch.int32, device=dev)
    loss, m, l = (torch.empty((bsz,), dtype=torch.float32, device=dev) for _ in range(3))
    rc = lib.mpt_head_ce_fwd(feats.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                             loss.data_ptr(), m.data_ptr(), l.data_ptr(), part_mlp.data_ptr(),
                             part_arg.data_ptr(), bsz, d, vocab, n_split, per_split,
                             _build.stream(dev))
    _build.check(rc, "parent mpt_head_ce_fwd")
    return loss, m, l


def _parent_ce_bwd(lib, feats, w, b, labels, m, l, g):
    """The parent's K6: 64-row vocab and batch tiles, 128 D columns, dfeats
    splits for about two CTAs an SM."""
    from mpi_pytorch_tpu_torch.ops import _build
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    dev, (bsz, d), vocab = feats.device, feats.shape, w.shape[0]
    vp, bp, dp = -(-vocab // 64) * 64, -(-bsz // 64) * 64, -(-d // 128) * 128
    chunks = vp // 64
    want = max(1, -(-2 * fh._num_sms(dev.index) // ((bp // 64) * (dp // 128))))
    per_split = -(-chunks // min(want, chunks))
    n_split = -(-chunks // per_split)
    dlog = torch.empty((bsz, vp), dtype=torch.bfloat16, device=dev)
    part = torch.empty((n_split, bp, dp), dtype=torch.float32, device=dev)
    dw = torch.empty((vocab, d), dtype=torch.float32, device=dev)
    db = torch.empty((vocab,), dtype=torch.float32, device=dev)
    dfeats = torch.empty((bsz, d), dtype=torch.bfloat16, device=dev)
    rc = lib.mpt_head_ce_bwd(feats.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                             m.data_ptr(), l.data_ptr(), g.data_ptr(), dlog.data_ptr(),
                             dw.data_ptr(), db.data_ptr(), part.data_ptr(), dfeats.data_ptr(),
                             bsz, d, vocab, n_split, per_split, _build.stream(dev))
    _build.check(rc, "parent mpt_head_ce_bwd")
    return dfeats, dw, db


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def compare_k5(parent, dev, gen) -> None:
    import chip_smoke
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    feats, w, b, labels, _ = _ce_inputs(dev, gen)
    ref = fh.fused_head_ce_forward_reference(feats, w, b, labels)
    runs = {"parent": lambda: _parent_ce_fwd(parent, feats, w, b, labels),
            "this": lambda: fh._ce_forward(feats, w, b, labels)}
    out, row = {}, {"batch": CE_BATCH}
    for name, fn in runs.items():
        out[name] = fn()
        torch.cuda.synchronize()
        row[name] = {"loss_max_abs_err": float((out[name][0] - ref[0]).abs().max())}
        if not torch.allclose(out[name][0], ref[0], rtol=1e-5, atol=0):
            raise AssertionError(f"K5 {name}: {row[name]}")
    row["max_abs_diff"] = {k: float((x - y).abs().max())
                           for k, x, y in zip(("loss", "m", "l"), out["parent"], out["this"])}
    turns = [chip_smoke.device_ms(runs[n], 50) for n in ("parent", "this", "this", "parent")]
    row.update(parent_this_this_parent_ms=turns, parent_ms=(turns[0] + turns[3]) / 2,
               this_ms=(turns[1] + turns[2]) / 2)
    log({"k5": row})


def compare_k6(parent, dev, gen) -> None:
    import chip_smoke
    from mpi_pytorch_tpu_torch.ops import fused_head_ce as fh

    feats, w, b, labels, g = _ce_inputs(dev, gen)
    _, m, l = fh._ce_forward(feats, w, b, labels)
    ref = fh.fused_head_ce_backward_reference(feats, w, b, labels, m, l, g)
    runs = {"parent": lambda: _parent_ce_bwd(parent, feats, w, b, labels, m, l, g),
            "this": lambda: fh._ce_backward(feats, w, b, labels, m, l, g)}
    names = ("dfeats", "dW", "db")
    out, row = {}, {"batch": CE_BATCH}
    for name, fn in runs.items():
        out[name] = fn()
        torch.cuda.synchronize()
        row[name] = {k: _rel_l2(x, y) for k, x, y in zip(names, out[name], ref)}
        if max(row[name].values()) > 2e-3:
            raise AssertionError(f"K6 {name}: relative L2 against the plain backward {row[name]}")
    row["between"] = {k: {"rel_l2": _rel_l2(x, y), "max_abs_diff": float((x.float() - y.float()).abs().max())}
                      for k, x, y in zip(names, out["this"], out["parent"])}
    turns = [chip_smoke.device_ms(runs[n], 20) for n in ("parent", "this", "this", "parent")]
    row.update(parent_this_this_parent_ms=turns, parent_ms=(turns[0] + turns[3]) / 2,
               this_ms=(turns[1] + turns[2]) / 2)
    log({"k6": row})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="a checkout whose csrc to compare with")
    ap.add_argument("--only", choices=tuple(PARENT_SOURCES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.ops import _build

    print(card_report().splitlines()[0], flush=True)
    target, procs = start_parent_build(args.parent.resolve(), args.only)
    _build.load_library()
    log_ptxas(("attn_small_fwd_kernel", "head_predict_f32_kernel", "head_predict_tc_kernel",
               "ce_bwd"))
    parent = finish_parent_build(target, procs, args.only)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    if args.only in (None, "k9"):
        compare_k9(parent, dev, gen)
    if args.only in (None, "k4"):
        compare_k4(parent, dev, gen)
    if args.only in (None, "k5"):
        compare_k5(parent, dev, gen)
    if args.only in (None, "k6"):
        compare_k6(parent, dev, gen)
    log({"ok": True, "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
