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
instead of silently never running.
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

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points → argtypes. Every pointer and the stream are c_void_p (a
# bare Python int would be passed as a 32-bit int and cut the pointer).
SIGNATURES = {
    # y, a, b, out, B, H, W, C, dtype (0 = f32, 1 = bf16), stream
    "mpt_stem_pool_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # feats, w, bias, labels, loss, pred, part_mlp, part_arg,
    # B, D, V, n_split, tiles_per_split, stream
    "mpt_head_predict": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the head kernel's tile geometry: rows per CTA, vocab rows per tile
    "mpt_head_tile_rows": (),
    "mpt_head_tile_vocab": (),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds the last build took (0.0 when a cached library was loaded) and
# nvcc's output for it (ptxas registers / shared memory per kernel).
build_seconds: float | None = None
build_log: str = ""


class LaunchCounter:
    """A kernel wrapper's launch count: one per launch of its kernel, and
    nowhere else — the evidence that a run went through the kernel."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


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
