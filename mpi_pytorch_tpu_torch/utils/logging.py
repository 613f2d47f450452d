"""Run logging shared by the port's modules (the JAX package's
``utils/logging.py``): the rank-tagged run logger (``MPT_R{rank}``) with a
stream handler on every rank and a file handler on rank 0, and the
structured JSONL metrics writer, which only rank 0 writes (the
reference's rank-0 result reporting, ``main.py:173-185``)."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Mapping

from mpi_pytorch_tpu_torch.parallel.distributed import rank as process_index


def init_logger(name: str = "MPT", log_file: str | None = "training.log",
                level: int = logging.INFO) -> logging.Logger:
    """The ``{name}_R{rank}`` logger with a stdout handler and, on rank 0
    for a non-empty ``log_file``, a file handler (swapped when the path
    changes): one log file per run, however many ranks."""
    rank = process_index()
    logger = logging.getLogger(f"{name}_R{rank}")
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file and rank == 0:
        target = os.path.abspath(log_file)
        file_handlers = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if not any(h.baseFilename == target for h in file_handlers):
            for h in file_handlers:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(target), exist_ok=True)
            fh = logging.FileHandler(target)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
            logger.info("Logger Initialized (process %d)", rank)
    return logger


def run_logger() -> logging.Logger:
    """The rank-tagged run logger (``MPT_R{rank}``) — the same logger name
    the JAX package's ``init_logger`` configures, so one logging setup
    serves both packages."""
    return logging.getLogger(f"MPT_R{process_index()}")


class MetricsWriter:
    """Structured JSONL records, one per line with a ``ts`` stamp, in the
    JAX stream's keys (``kind`` = ``step`` | ``epoch`` | ``val``). A falsy
    path writes nothing, and neither does any rank but 0."""

    def __init__(self, path: str | None):
        self._fh = None
        if path and process_index() == 0:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, record: Mapping[str, Any]) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps({"ts": time.time(), **record}) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
