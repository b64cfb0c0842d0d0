"""Logging factory (port of ``visual_slam_tpu.utils.logging``, unchanged: it is
pure Python): per-component rotating-file loggers with handler dedupe and a
root console/app-log setup.
"""
from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path

_DEFAULT_FMT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def get_logger(
    name: str,
    log_dir: str | None = None,
    log_file: str | None = None,
    level: int = logging.INFO,
) -> logging.Logger:
    """Component logger; with ``log_dir`` a deduped 5 MB x 3 rotating file."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if log_dir is not None:
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        fname = path / (log_file or f"{name}.log")
        if not any(
            isinstance(h, logging.handlers.RotatingFileHandler)
            and getattr(h, "baseFilename", None) == str(fname)
            for h in logger.handlers
        ):
            h = logging.handlers.RotatingFileHandler(
                fname, maxBytes=5 * 1024 * 1024, backupCount=3
            )
            h.setFormatter(logging.Formatter(_DEFAULT_FMT))
            logger.addHandler(h)
    return logger


def setup_logging(log_dir: str | None = None, level: int = logging.INFO) -> None:
    """Root console handler, and ``app.log`` under ``log_dir``."""
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_DEFAULT_FMT))
        root.addHandler(sh)
    if log_dir is not None:
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            path / "app.log", maxBytes=10 * 1024 * 1024, backupCount=5
        )
        fh.setFormatter(logging.Formatter(_DEFAULT_FMT))
        root.addHandler(fh)
