"""Hold this checkout's K9 FFMA forward, K4 f32 head and K2 stem training
forward against another checkout's on one NVIDIA GPU — for example the
parent commit, unpacked by ``git archive`` into a git-ignored directory:

    python3 chip_compare.py PARENT_DIR [--only {k9,k4,k2} ...]

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
- k2: ``mpt_stem_pool_argmax`` of both on the same inputs at the training
  shape [128, 64, 64, 64] bf16 (random, tie-heavy with a NaN, all relu
  zero) and at ``chip_smoke.STEM_ARGMAX_EDGES`` (random, all relu zero):
  pooled bitwise equal, NaN in the same places, and k equal on every
  window whose max is finite (``chip_smoke.check_stem_argmax_equal``).
  Then both timed in turns at the training shape.

Each takes this checkout's entry point and signature: a comparison goes
once no parent tree has its entry any more, and its logged numbers stay
in PERF.md.

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
                  "k2": ("fused_stem.cu", "mpt_stem_pool_argmax")}
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


def start_parent_build(parent: Path, only: list[str]) -> tuple[Path, list]:
    """nvcc for the parent source of each compared entry, all started at
    once; returns the target library and the (object, process) pairs."""
    from mpi_pytorch_tpu_torch.ops import _build

    out = REPO / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    src = parent / "mpi_pytorch_tpu_torch" / "csrc"
    procs = []
    target = out / f"libparent_{parent.name}_{'_'.join(only)}.so"
    if target.exists():  # built by an earlier run of this command
        return target, procs
    names = {name for key, (name, _) in PARENT_SOURCES.items() if key in only}
    for name in sorted(names):
        obj = out / f"{parent.name}_{Path(name).stem}.o"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(src / name), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True)))
    return target, procs


def finish_parent_build(target: Path, procs: list, only: list[str]) -> ctypes.CDLL:
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
        if key not in only:
            continue
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
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
    n_split, per_split, _, rows = geometry
    dev = feats.device
    part_mlp = torch.empty((3, n_split, bsz), dtype=torch.float32, device=dev)
    part_arg = torch.empty((n_split, bsz), dtype=torch.int32, device=dev)
    loss = torch.empty((bsz,), dtype=torch.float32, device=dev)
    pred = torch.empty((bsz,), dtype=torch.int32, device=dev)
    rc = lib.mpt_head_predict_f32(feats.data_ptr(), w.data_ptr(), bias.data_ptr(), labels.data_ptr(),
                                  loss.data_ptr(), pred.data_ptr(), part_mlp.data_ptr(),
                                  part_arg.data_ptr(), bsz, feats.shape[1], w.shape[0], n_split,
                                  per_split, rows, _build.stream(dev))
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
        geo = fh.tc_geometry(bsz, D, V, 4, sms)
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


def _turns(runs: dict, iters: int) -> dict:
    """Busy ms of the two runs in turns: parent, this, this, parent."""
    import chip_smoke

    turns = [chip_smoke.device_ms(runs[n], iters) for n in ("parent", "this", "this", "parent")]
    return {"parent_this_this_parent_ms": turns, "parent_ms": (turns[0] + turns[3]) / 2,
            "this_ms": (turns[1] + turns[2]) / 2}


def _k2(lib, y, a, b) -> tuple[torch.Tensor, torch.Tensor]:
    from mpi_pytorch_tpu_torch.ops import _build

    bsz, h, w, c = y.shape
    out = torch.empty((bsz, h // 2, w // 2, c), dtype=y.dtype, device=y.device)
    idx = torch.empty((bsz, h // 2, w // 2, c), dtype=torch.int8, device=y.device)
    rc = lib.mpt_stem_pool_argmax(y.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  idx.data_ptr(), bsz, h, w, c, _build.DTYPE_CODE[y.dtype],
                                  _build.stream(y.device))
    _build.check(rc, "mpt_stem_pool_argmax")
    return out, idx


def compare_k2(parent, dev, gen) -> None:
    import chip_smoke
    from mpi_pytorch_tpu_torch.ops import _build

    this = _build.load_library()
    cases = [(chip_smoke.STEM_TRAIN_SHAPE, torch.bfloat16, kind)
             for kind in ("random", "tie_heavy_nan", "all_relu_zero")]
    cases += [(shape, dtype, kind) for shape, dtype in chip_smoke.STEM_ARGMAX_EDGES
              for kind in ("random", "all_relu_zero")]
    for shape, dtype, kind in cases:
        y, a, b = chip_smoke.stem_argmax_input(shape, dtype, kind, dev, gen)
        (new, new_k), (old, old_k) = _k2(this, y, a, b), _k2(parent, y, a, b)
        torch.cuda.synchronize()
        what = f"K2 {list(shape)} {dtype} {kind}"
        chip_smoke.check_stem_argmax_equal(new, new_k, old, old_k, what)
        log({"k2_bitwise": {"shape": list(shape), "dtype": str(dtype), "input": kind,
                            "pooled_bitwise": True, "k_equal_on_finite": True,
                            "windows_not_centre": int((new_k != 4).sum())}})
    y, a, b = chip_smoke.stem_argmax_input(chip_smoke.STEM_TRAIN_SHAPE, torch.bfloat16, "random", dev,
                                           gen)
    runs = {"parent": lambda: _k2(parent, y, a, b), "this": lambda: _k2(this, y, a, b)}
    log({"k2_turns_ms": {"shape": list(chip_smoke.STEM_TRAIN_SHAPE), **_turns(runs, 50)}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="a checkout whose csrc to compare with")
    ap.add_argument("--only", nargs="+", choices=tuple(PARENT_SOURCES), default=list(PARENT_SOURCES),
                    help="the comparisons to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    from mpi_pytorch_tpu_torch.hardware import card_report
    from mpi_pytorch_tpu_torch.ops import _build

    print(card_report().splitlines()[0], flush=True)
    target, procs = start_parent_build(args.parent.resolve(), args.only)
    _build.load_library()
    log_ptxas(("attn_small_fwd_kernel", "head_predict_f32_kernel", "stem_pool_argmax"))
    parent = finish_parent_build(target, procs, args.only)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    if "k9" in args.only:
        compare_k9(parent, dev, gen)
    if "k4" in args.only:
        compare_k4(parent, dev, gen)
    if "k2" in args.only:
        compare_k2(parent, dev, gen)
    log({"ok": True, "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
