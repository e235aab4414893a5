"""Idempotent named logger (port of texgs/utils/logger.py), and
``logging_to``, the log file of one run, of which a process may make
several."""

from __future__ import annotations

import contextlib
import logging

FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name: str = "texgs_torch",
               level=logging.INFO) -> logging.Logger:
    """The named logger, writing to stderr; ``logging_to`` adds a run's
    file."""
    logger = logging.getLogger(name)
    if getattr(logger, "_texgs_initialized", False):
        return logger
    logger.setLevel(level)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(FORMAT))
    logger.addHandler(sh)
    logger._texgs_initialized = True
    logger.propagate = False
    return logger


@contextlib.contextmanager
def logging_to(logger: logging.Logger, log_file: str | None):
    """``logger`` also writes into ``log_file`` (truncated) inside the
    block, and stops writing there when it ends, so each of several runs
    in one process (the stages of tools/prod_pipeline) writes its own
    file."""
    if not log_file:
        yield logger
        return
    handler = logging.FileHandler(log_file, "w")
    handler.setFormatter(logging.Formatter(FORMAT))
    logger.addHandler(handler)
    try:
        yield logger
    finally:
        logger.removeHandler(handler)
        handler.close()
