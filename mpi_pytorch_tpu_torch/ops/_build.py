"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface, loaded through ``ctypes`` — no PyTorch
headers, so a build takes seconds instead of minutes. The sources compile
in parallel (one ``nvcc`` per file, all started together) and link once.

The library lands in the git-ignored ``build/kernels/`` at the checkout's
root, named by a hash of the sources and flags: a changed source never
loads a stale build, and an unchanged one is not rebuilt. Nothing is built
until a kernel is first launched, so importing a kernel module needs no
``nvcc`` (the CPU tests import them all).

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code, so a
refused launch (too many threads, too much shared memory) fails the call
instead of silently never running. The wrappers share the rest of their
launch plumbing here too: :class:`LaunchCounter`, :func:`on_cpu`,
:func:`stream`, ``DTYPE_CODE`` and the attention kernels'
:func:`attention_route` and :func:`attention_layout`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points → argtypes. Every pointer and the stream are c_void_p (a
# bare Python int would be passed as a 32-bit int and cut the pointer).
SIGNATURES = {
    # y, a, b, out, B, H, W, C, dtype (0 = f32, 1 = bf16), stream
    "mpt_stem_pool_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # y, a, b, out, idx, B, H, W, C, dtype, stream
    "mpt_stem_pool_argmax": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # g, idx, pooled, y, a, dy, dadb, part, B, H, W, C, dtype, stream
    "mpt_stem_pool_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the backward's scratch rows for B, H, W, C
    "mpt_stem_bwd_parts": (_I, _I, _I, _I),
    # the predict head K4, bf16 (tensor cores) and f32: feats, w, bias,
    # labels, loss, pred, part_mlp, part_arg, B, D, V, n_split,
    # tiles_per_split, then bf16's route (0 resident feats, 1 streamed) and
    # rows a CTA, or f32's rows a CTA; stream
    "mpt_head_predict_bf16": (_P,) * 8 + (_I, _I, _I, _I, _I, _I, _I, _P),
    "mpt_head_predict_f32": (_P,) * 8 + (_I, _I, _I, _I, _I, _I, _P),
    # the tensor-core heads' (K4, K5, K7) vocab rows per tile
    "mpt_head_tc_tile_vocab": (),
    # feats, feats_q (scratch), w_q, scale_v, bias, labels, loss, pred,
    # part_mlp, part_arg, B, D, V, n_split, tiles_per_split, route, rows,
    # act_scale, dtype, stream
    "mpt_head_predict_int8": (_P,) * 10 + (_I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # feats, w, bias, labels, loss, m, l, part_mlp,
    # B, D, V, n_split, tiles_per_split, route, rows, stream
    "mpt_head_ce_fwd": (_P,) * 8 + (_I, _I, _I, _I, _I, _I, _I, _P),
    # feats, w, bias, labels, m, l, g, dlog, dw, db, part, dfeats,
    # B, D, V, n_ctas, n_split, tiles_per_split, stream
    "mpt_head_ce_bwd": (_P,) * 12 + (_I, _I, _I, _I, _I, _I, _P),
    # the backward's tiles: vocab rows, pass 2's batch rows and D columns;
    # pass 1's batch rows a chunk for (B, D), 0 when D is too wide
    "mpt_head_ce_bwd_tile_vocab": (),
    "mpt_head_ce_bwd_tile_rows": (),
    "mpt_head_ce_bwd_tile_cols": (),
    "mpt_head_ce_bwd_rows": (_I, _I),
    # the tiny-S FFMA forward (bf16): q, k, v, out, q/k/v strides (sb, ss,
    # sh), B, S, H, D, scale, causal, stream
    "mpt_attn_small_fwd": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P),
    # the tensor-core forwards (bf16): q, k, v, out[, lse], q/k/v strides,
    # B, S, H, D, scale, causal, stream
    "mpt_attn_small_fwd_tc": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P),
    "mpt_flash_fwd_tc": (_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P),
    # the f32 tensor-core forwards: the same arguments as the bf16 ones
    "mpt_attn_small_fwd_tc_f32": (_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P),
    "mpt_flash_fwd_tc_f32": (_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P),
    # the tensor-core tiny-S backward (bf16): q, k, v, dout, dq, dk, dv,
    # q/k/v strides, B, S, H, D, scale, causal, stream
    "mpt_attn_small_bwd_tc": (
        _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P,
    ),
    # the f32 tensor-core tiny-S backward: the same arguments, f32
    "mpt_attn_small_bwd_tc_f32": (
        _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _F, _I, _P,
    ),
}

# The dtype argument of every C entry point.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds the last build took (0.0 when a cached library was loaded) and
# nvcc's output for it (ptxas registers / shared memory per kernel).
build_seconds: float | None = None
build_log: str = ""


class LaunchCounter:
    """A kernel wrapper's launch count: one per launch of its kernel, and
    nowhere else — the evidence that a run went through the kernel. Each
    is registered under ``name`` (``module.attribute``) for
    :func:`launch_counts`."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._n = 0
        self._lock = threading.Lock()
        _COUNTERS[name] = self

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


_COUNTERS: dict[str, LaunchCounter] = {}


def launch_counts() -> dict[str, int]:
    """Every kernel counter that has counted, by name → its count: what a
    run launched, for the records an entry point writes (the trainer's
    epoch and validation records, the evaluate pass's)."""
    return {name: c.count for name, c in sorted(_COUNTERS.items()) if c.count}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels build from csrc/ on first use"
    )


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(sources + list(SRC_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path, sources: list[Path]) -> None:
    global build_log
    nvcc = _nvcc()
    obj_dir = target.parent / f"obj_{target.stem}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(obj_dir, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use (thread-safe)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
        target = BUILD_DIR / f"libmpt_kernels_{_digest(sources)}.so"
        t0 = time.perf_counter()
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build(target, sources)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mpt_error_string.argtypes = [ctypes.c_int]
        lib.mpt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = _lib.mpt_error_string(code).decode() if _lib is not None else "?"
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} ({msg})")


def on_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the wrapper runs its plain version), False
    for a CUDA one (it launches its kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {t.device}")
    return False


def stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev``, as the C entry points take it."""
    return torch.cuda.current_stream(dev).cuda_stream


def attention_layout(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str, max_head_dim: int
) -> tuple[int, int, int]:
    """(sb, ss, sh) of q, k, v as an attention kernel reads them: strided
    [B, S, H, D] views sharing one set of strides (the projections' outputs
    as they stand), the head dim contiguous, f32 or bf16, D a multiple of 4
    up to ``max_head_dim``. Raises on anything else."""
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{what} kernel takes f32 or bf16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what} kernel needs q, k, v on one device")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(-1) != 1:
        raise ValueError(
            f"{what} kernel needs q, k, v with one set of strides and the head "
            f"dim contiguous, got {q.stride()}, {k.stride()}, {v.stride()}"
        )
    d = q.shape[-1]
    if d % 4 or d > max_head_dim:
        raise ValueError(f"{what} kernel needs D % 4 == 0 and D <= {max_head_dim}, got D={d}")
    return q.stride(0), q.stride(1), q.stride(2)


def attention_route(dtype: torch.dtype, d: int) -> str:
    """Which kernel the attention kernels (the forwards K8, K9 and the
    tiny-S backward K10) launch for q of ``dtype`` and head dim ``d``:
    ``"tensor_core"`` for bf16 with D a multiple of 4 up to 128 (wgmma
    takes k-steps of 16 bf16: the kernels are instantiated per D rounded up
    to 16, and the columns past D are zeros written at every load, so they
    add exact zeros to every product); ``"tensor_core_f32"`` for f32 with D
    a multiple of 4 up to 128 (every f32 operand split into three bf16
    terms, each product six exact term-pair products, the same padding);
    else ``"ffma"``, which no K8 or K10 kernel takes (``attention_layout``
    refuses such a D) and K9's ``_route`` refines. Every S up to the
    kernels' 128 takes the same route. A stated rule, never a fallback: a
    launch on any route that fails raises."""
    if d % 4 or d > 128:
        return "ffma"
    return {torch.float32: "tensor_core_f32", torch.bfloat16: "tensor_core"}.get(dtype, "ffma")


def require_16b_rows(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str, *contiguous: torch.Tensor
) -> None:
    """The f32 tensor-core kernels and K9's bf16 training forward copy rows
    of q, k and v (and of the ``contiguous`` [B, S, H, D] operands, such as
    the backward's do) in 16-byte pieces: raises unless each starts on 16
    bytes and q, k, v's (shared) B, S, H strides are multiples of 16 bytes
    (8 bf16 or 4 f32 elements). K8's and K10's bf16 kernels need none of
    it: they copy each row in the widest pieces it allows (16 or 8 bytes,
    else element by element)."""
    per = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k, v, *contiguous)) or any(x % per for x in q.stride()[:3]):
        raise ValueError(
            f"{what} tensor-core kernel needs its operands on 16-byte boundaries and strides "
            f"multiple of {per} elements, got strides {q.stride()}"
        )
