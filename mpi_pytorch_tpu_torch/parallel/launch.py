"""Run one function in N local ranks through ``torchrun`` and get each
rank's return value back — for code that drives ranks itself (the CPU
tests' gloo worlds, and ``chip_smoke.py``'s ranks sharing one card).

    results = run_world("package.module:function", 2, payload, timeout_s=120)

torchrun alone starts the ranks with their environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` on a free port
with ``--standalone``) and stops them all when one fails. It does not call
a function with a payload, hand the ranks' results back, or bound the
world's time, so a hung rendezvous would hang its caller. ``run_world``
adds those: it runs ``torchrun --standalone`` on this module, which
imports ``function``, calls ``function(payload)`` and pickles the return
value; it kills every rank and torchrun at ``timeout_s``; and it
returns the results in rank order, or raises with the world's output.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path
from typing import Any


def run_world(
    target: str,
    nprocs: int,
    payload: Any = None,
    *,
    timeout_s: float = 120.0,
    env: dict[str, str] | None = None,
    pythonpath: list[str] | None = None,
) -> list[Any]:
    """``target``'s return value on each of ``nprocs`` ranks (see the module
    docstring). ``env`` adds to the ranks' environment; ``pythonpath``
    lists directories the ranks import ``target`` from (the checkout root
    always)."""
    root = str(Path(__file__).resolve().parents[2])
    paths = [root, *(pythonpath or []), *os.environ.get("PYTHONPATH", "").split(os.pathsep)]
    with tempfile.TemporaryDirectory(prefix="mpt_world_") as tmp:
        Path(tmp, "payload.pkl").write_bytes(pickle.dumps(payload))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={nprocs}", "-m", __name__, target, tmp]
        world_env = {**os.environ, **(env or {}),
                     "PYTHONPATH": os.pathsep.join(p for p in paths if p)}
        failed = None
        with open(os.path.join(tmp, "world.log"), "w") as log:
            proc = subprocess.Popen(cmd, env=world_env, stdout=log, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                if proc.wait(timeout=timeout_s):
                    failed = f"torchrun exited with {proc.returncode}"
            except subprocess.TimeoutExpired:
                failed = f"the world of {nprocs} ranks outlived {timeout_s} s"
            finally:
                # torchrun starts each rank in a session of its own, so a
                # world cut short has its ranks killed by the pids they
                # wrote, then torchrun.
                for pid in Path(tmp).glob("pid*") if failed or proc.poll() is None else ():
                    with contextlib.suppress(ProcessLookupError, ValueError):
                        os.kill(int(pid.read_text()), signal.SIGKILL)
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        if failed:
            tail = Path(tmp, "world.log").read_text()[-12000:]
            raise RuntimeError(f"run_world({target!r}): {failed}\n{tail}")
        return [pickle.loads(Path(tmp, f"result{r}.pkl").read_bytes()) for r in range(nprocs)]


def _rank_main(target: str, tmp: str) -> int:
    rank = int(os.environ["RANK"])
    Path(tmp, f"pid{rank}").write_text(str(os.getpid()))
    try:
        module, fn = target.split(":")
        func = getattr(importlib.import_module(module), fn)
        result = func(pickle.loads(Path(tmp, "payload.pkl").read_bytes()))
        part = Path(tmp, f"result{rank}.pkl.tmp")
        part.write_bytes(pickle.dumps(result))
        os.replace(part, Path(tmp, f"result{rank}.pkl"))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        return 1
    finally:
        from mpi_pytorch_tpu_torch.parallel import distributed

        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], sys.argv[2]))
