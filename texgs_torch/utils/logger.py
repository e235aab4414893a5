"""Idempotent named logger (port of texgs/utils/logger.py)."""

from __future__ import annotations

import logging


def get_logger(name: str = "texgs_torch", log_file: str | None = None,
               level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_texgs_initialized", False):
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file, "w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger._texgs_initialized = True
    logger.propagate = False
    return logger
