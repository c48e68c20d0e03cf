"""Logging setup: stderr with [date][time][name][LEVEL] prefix
(reference src/logger.rs:5-26 format parity)."""

from __future__ import annotations

import logging
import sys


class _RefFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        import time

        t = time.localtime(record.created)
        date = time.strftime("%Y-%m-%d", t)
        clock = time.strftime("%H:%M:%S", t)
        return (
            f"[{date}][{clock}][portello-tpu][{record.levelname}] "
            f"{record.getMessage()}"
        )


def setup_logger(debug: bool = False) -> logging.Logger:
    logger = logging.getLogger("portello-tpu")
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_RefFormatter())
        logger.addHandler(handler)
    logger.propagate = False
    return logger
