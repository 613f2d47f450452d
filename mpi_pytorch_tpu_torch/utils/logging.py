"""Run logging shared by the port's modules (the JAX package's
``utils/logging.py``): the rank-tagged run logger with stream and file
handlers, and the structured JSONL metrics writer. The port runs one
process, so the rank is 0."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Mapping

_RANK = 0


def init_logger(name: str = "MPT", log_file: str | None = "training.log",
                level: int = logging.INFO) -> logging.Logger:
    """The ``{name}_R0`` logger with a stdout handler and, for a non-empty
    ``log_file``, a file handler (swapped when the path changes)."""
    logger = logging.getLogger(f"{name}_R{_RANK}")
    logger.setLevel(level)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file:
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
            logger.info("Logger Initialized (process %d)", _RANK)
    return logger


def run_logger() -> logging.Logger:
    """The rank-tagged run logger (``MPT_R0``) — the same logger name the
    JAX package's ``init_logger`` configures, so one logging setup serves
    both packages."""
    return logging.getLogger(f"MPT_R{_RANK}")


class MetricsWriter:
    """Structured JSONL records, one per line with a ``ts`` stamp, in the
    JAX stream's keys (``kind`` = ``step`` | ``epoch`` | ``val``). A falsy
    path writes nothing."""

    def __init__(self, path: str | None):
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, record: Mapping[str, Any]) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps({"ts": time.time(), **record}) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
