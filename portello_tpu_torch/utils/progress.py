"""Progress reporting: tty progress bar / periodic non-tty logging.

Behavioral equivalent of the reference ProgressReporter
(reference lib/rust-vc-utils/src/progress_reporter.rs:27-175): an atomic
counter incremented by workers; on a tty an in-place bar, otherwise a log line
every 5 minutes; auto-clear on close.
"""

from __future__ import annotations

import logging
import sys
import threading
import time

NON_TTY_LOG_INTERVAL_S = 300.0  # (progress_reporter.rs:29-37)


class ProgressReporter:
    def __init__(
        self,
        total: int,
        label_prefix: str,
        label_units: str,
        force_periodic: bool = False,
        interval_s: float = NON_TTY_LOG_INTERVAL_S,
    ):
        self.total = max(int(total), 1)
        self.label_prefix = label_prefix
        self.label_units = label_units
        self._count = 0
        self._lock = threading.Lock()
        self._start = time.monotonic()
        self._interval = interval_s
        self._is_tty = sys.stderr.isatty() and not force_periodic
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if not self._is_tty:
            self._thread = threading.Thread(target=self._periodic, daemon=True)
            self._thread.start()

    def inc(self, delta: int) -> None:
        with self._lock:
            self._count += int(delta)
        if self._is_tty:
            self._draw()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _message(self) -> str:
        n = self.count
        pct = 100.0 * n / self.total
        return f"{self.label_prefix} {n}/{self.total} {self.label_units} ({pct:.1f}%)"

    def _draw(self) -> None:
        sys.stderr.write("\r" + self._message())
        sys.stderr.flush()

    def _periodic(self) -> None:
        while not self._stop.wait(self._interval):
            logging.getLogger("portello-tpu").info(self._message())

    def clear(self) -> None:
        """Auto-clear semantics (progress_reporter.rs Drop impl)."""
        self._stop.set()
        if self._is_tty:
            sys.stderr.write("\r" + " " * len(self._message()) + "\r")
            sys.stderr.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.clear()
