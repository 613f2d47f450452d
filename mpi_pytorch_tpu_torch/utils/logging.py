"""The run logger shared by the port's modules (the JAX package's
``utils/logging.py`` ``run_logger``). A single-process server has rank 0."""

from __future__ import annotations

import logging


def run_logger() -> logging.Logger:
    """The rank-tagged run logger (``MPT_R0``) — the same logger name the
    JAX package's ``init_logger`` configures, so one logging setup serves
    both packages."""
    return logging.getLogger("MPT_R0")
