"""Hold this checkout's K9 FFMA forward, K4 f32 head and bf16 attention at
a head dim that is not a multiple of 16 (K8 forward, K10 backward) against
another checkout's on one
NVIDIA GPU — for example the parent commit, unpacked by ``git archive``
into a git-ignored directory:

    python3 chip_compare.py PARENT_DIR [--only {k9,k4,k8,k10} ...]

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
- k8: the parent's FFMA flash forward ``mpt_flash_fwd`` (bf16, blocks of
  128) against this checkout's ``flash_forward`` (its bf16 tensor-core
  kernel, zero-padded) at [128, 196, 6, 40]; k10: the parent's FFMA
  backward ``mpt_attn_small_bwd`` against this checkout's
  ``attention_small_backward`` at [128, 64, 6, 40]. Each output (and K8's
  lse) against the plain version (one bf16 ulp, ``chip_smoke._grad_check``
  for gradients, lse within 1e-5); the largest difference between the two
  logged — not bitwise: their sums run in other orders; timed in turns.

k9 and k4 take this checkout's entry points and signatures. k8 and k10
build the FFMA attention entries of a tree from before the padded
tensor-core route, which this checkout no longer has
(``PARENT_SIGNATURES``), so they run only against such a tree.

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
                  "k8": ("flash_attention.cu", "mpt_flash_fwd"),
                  "k10": ("fused_attention_small.cu", "mpt_attn_small_bwd")}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The parent's argument types where they differ from this checkout's.
PARENT_SIGNATURES = {
    # q, k, v, out, lse, q/k/v strides, B, S, H, D, block_q, block_k,
    # scale, causal, stream
    "mpt_flash_fwd": (_P,) * 5 + (_L,) * 3 + (_I,) * 6 + (_F, _I, _P),
    # q, k, v, dout, dq, dk, dv, q/k/v strides, B, S, H, D, scale, causal,
    # stream
    "mpt_attn_small_bwd": (_P,) * 7 + (_L,) * 3 + (_I,) * 4 + (_F, _I, _P),
}
# The timed shapes of the K8 and K10 comparisons: vit_s16's at D = 40.
K8_SHAPE = (128, 196, 6, 40)
K10_SHAPE = (128, 64, 6, 40)
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
        fn.argtypes = list(PARENT_SIGNATURES[name] if name in PARENT_SIGNATURES else _build.SIGNATURES[name])
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


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _turns(runs: dict, iters: int) -> dict:
    """Busy ms of the two runs in turns: parent, this, this, parent."""
    import chip_smoke

    turns = [chip_smoke.device_ms(runs[n], iters) for n in ("parent", "this", "this", "parent")]
    return {"parent_this_this_parent_ms": turns, "parent_ms": (turns[0] + turns[3]) / 2,
            "this_ms": (turns[1] + turns[2]) / 2}


def _parent_flash(lib, q, k, v):
    """The parent's FFMA flash forward, blocks of 128 as its wrapper cut
    them at S = 196."""
    from mpi_pytorch_tpu_torch.ops import _build

    b, s, h, d = q.shape
    blk = min(128, max(8, s))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = lib.mpt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                           *q.stride()[:3], b, s, h, d, blk, blk, d**-0.5, 0, _build.stream(q.device))
    _build.check(rc, "parent mpt_flash_fwd")
    return out, lse


def _parent_small_bwd(lib, q, k, v, do):
    from mpi_pytorch_tpu_torch.ops import _build

    b, s, h, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rc = lib.mpt_attn_small_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), *q.stride()[:3], b, s, h, d, d**-0.5, 0,
                                _build.stream(q.device))
    _build.check(rc, "parent mpt_attn_small_bwd")
    return dq, dk, dv


def compare_k8(parent, dev, gen) -> None:
    import chip_smoke
    from mpi_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v = chip_smoke._qkv(gen, K8_SHAPE, dev)
    ref, ref_lse = fa.flash_forward_reference(q, k, v)
    runs = {"parent": lambda: _parent_flash(parent, q, k, v), "this": lambda: fa.flash_forward(q, k, v)}
    out, row = {}, {"shape": list(K8_SHAPE), "dtype": "bfloat16"}
    for name, fn in runs.items():
        out[name] = fn()
        torch.cuda.synchronize()
        err = chip_smoke._ulp_check(out[name][0], ref, f"K8 {name}")
        lse_err = _max_diff(out[name][1], ref_lse)
        if lse_err > 1e-5 + 1e-5 * float(ref_lse.abs().max()):
            raise AssertionError(f"K8 {name}: lse off by {lse_err}")
        row[name] = {"max_abs_err_vs_plain": err, "lse_max_abs_err_vs_plain": lse_err}
    row["between"] = {"bitwise": False, "why": "the trees sum in other orders",
                      "out_max_abs_diff": _max_diff(out["parent"][0], out["this"][0]),
                      "out_elements_differing": int((out["parent"][0] != out["this"][0]).sum()),
                      "lse_max_abs_diff": _max_diff(out["parent"][1], out["this"][1])}
    row.update(_turns(runs, 20))
    log({"k8": row})


def compare_k10(parent, dev, gen) -> None:
    import chip_smoke
    from mpi_pytorch_tpu_torch.ops import fused_attention_small as fas
    from mpi_pytorch_tpu_torch.ops.ring_attention import full_attention

    q, k, v, do = chip_smoke._qkv(gen, K10_SHAPE, dev, 4)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    full_attention(*leaves).backward(do.float())
    runs = {"parent": lambda: _parent_small_bwd(parent, q, k, v, do),
            "this": lambda: fas.attention_small_backward(q, k, v, do)}
    names = ("dq", "dk", "dv")
    out, row = {}, {"shape": list(K10_SHAPE), "dtype": "bfloat16"}
    for name, fn in runs.items():
        out[name] = fn()
        torch.cuda.synchronize()
        row[name] = {f"{g}_max_abs_err_vs_plain": chip_smoke._grad_check(x, leaf.grad, f"K10 {name} {g}")
                     for g, x, leaf in zip(names, out[name], leaves)}
    row["between"] = {"bitwise": False, "why": "the trees sum in other orders",
                      **{f"{g}_max_abs_diff": _max_diff(x, y)
                         for g, x, y in zip(names, out["parent"], out["this"])}}
    row.update(_turns(runs, 50))
    log({"k10": row})


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
    log_ptxas(("attn_small_fwd_kernel", "head_predict_f32_kernel", "flash_fwd_tc_kernel",
               "attn_small_bwd_tc_kernel"))
    parent = finish_parent_build(target, procs, args.only)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    if "k9" in args.only:
        compare_k9(parent, dev, gen)
    if "k4" in args.only:
        compare_k4(parent, dev, gen)
    if "k8" in args.only:
        compare_k8(parent, dev, gen)
    if "k10" in args.only:
        compare_k10(parent, dev, gen)
    log({"ok": True, "device": torch.cuda.get_device_name(0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
