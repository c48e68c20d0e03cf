"""The spans of one CLI call, kept in memory and handed out with the native
feed's stats.

A span is ``[name, parent, role, t0_ns, t1_ns]``: ``parent`` is the index of
the enclosing span in the list (-1 for a root), ``role`` the thread that
ran it (``main``, or a native thread's role), and the times are
CLOCK_MONOTONIC ns (``time.monotonic_ns``, the clock the native scanner's
``now_ns`` reads).  ``clock_offset_ns`` (Unix-time ns less monotonic ns,
sampled when the recorder is made) moves a span onto the clock of
``torch.profiler``'s events.

The main thread's spans nest: ``open`` makes a child of the innermost open
span.  ``phase`` ends the current phase, a child of the root, and opens the
next, so that the phases of a call (``startup``, ``feed``, ``finish``)
follow each other with no gap."""

from __future__ import annotations

import itertools
import json
import os
import time

_calls = itertools.count()

MAIN = "main"
# A span's row in a Chrome trace: one per thread role, below the profiler's
# own rows.
_TID_BASE = 1 << 30


class CallSpans:
    """The span recorder of one call, with the call's CPU seconds by thread
    role (``cpu_s``): the native feed adds its threads'; ``close_all`` adds
    the main thread's, over the recorder's life."""

    def __init__(self, root: str):
        self.call_id = f"{os.getpid()}.{next(_calls)}"
        self.clock_offset_ns = time.time_ns() - time.monotonic_ns()
        self.spans: list[list] = []
        self.cpu_s: dict[str, float] = {}
        self._open: list[int] = []
        self._phase: int | None = None
        self._cpu0 = time.thread_time()
        self.open(root)

    def open(self, name: str) -> int:
        """Opens ``name`` inside the innermost open span; returns its index."""
        i = len(self.spans)
        parent = self._open[-1] if self._open else -1
        self.spans.append([name, parent, MAIN, time.monotonic_ns(), 0])
        self._open.append(i)
        return i

    def close(self, i: int) -> None:
        """Closes span ``i``, and any still open inside it, now."""
        t = time.monotonic_ns()
        while self._open:
            j = self._open.pop()
            self.spans[j][4] = t
            if j == i:
                break

    def span(self, name: str) -> _Span:
        """``with spans.span(name) as i:`` opens ``name`` for the block."""
        return _Span(self, name)

    def phase(self, name: str) -> int:
        """Ends the current phase and opens ``name`` in its place, at one
        instant."""
        if self._phase is None:
            self._phase = self.open(name)
            return self._phase
        self.close(self._phase)
        t = self.spans[self._phase][4]
        self._phase = self.open(name)
        self.spans[self._phase][3] = t
        return self._phase

    def add(self, name: str, t0: int, t1: int, role: str = MAIN,
            parent: int | None = None) -> int:
        """Adds a closed span (a native thread's, or one timed elsewhere)
        inside ``parent``, by default the innermost open span."""
        if parent is None:
            parent = self._open[-1] if self._open else -1
        self.spans.append([name, parent, role, int(t0), int(t1)])
        return len(self.spans) - 1

    def seconds(self, i: int) -> float:
        return (self.spans[i][4] - self.spans[i][3]) / 1e9

    def seconds_by_name(self) -> dict[str, float]:
        """Closed spans' seconds, summed by name."""
        out: dict[str, float] = {}
        for name, _, _, t0, t1 in self.spans:
            if t1:
                out[name] = out.get(name, 0.0) + (t1 - t0) / 1e9
        return out

    def close_all(self) -> None:
        """Closes every open span (the call is over) and adds the main
        thread's CPU seconds."""
        if self._open:
            self.close(self._open[0])
        self._phase = None
        self.cpu_s[MAIN] = time.thread_time() - self._cpu0


class _Span:
    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: CallSpans, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> int:
        self.i = self.rec.open(self.name)
        return self.i

    def __exit__(self, *exc) -> None:
        self.rec.close(self.i)


def add_to_chrome_trace(path: str, spans: CallSpans) -> None:
    """Writes ``spans`` into the Chrome trace at ``path`` (one written by
    ``torch.profiler``), on the trace's clock: one row per thread role,
    under this process.  A span still open ends now."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    now = time.monotonic_ns()
    pid = os.getpid()
    roles: dict[str, int] = {}
    events = trace.setdefault("traceEvents", [])
    for i, (name, parent, role, t0, t1) in enumerate(spans.spans):
        if role not in roles:
            roles[role] = _TID_BASE + len(roles)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": roles[role],
                           "args": {"name": f"portello {role}"}})
        t1 = t1 or now
        events.append({
            "ph": "X", "cat": "portello_span", "name": name, "pid": pid,
            "tid": roles[role],
            "ts": (t0 + spans.clock_offset_ns - base) / 1e3,
            "dur": (t1 - t0) / 1e3,
            "args": {"call_id": spans.call_id, "index": i, "parent": parent},
        })
    with open(path, "w") as f:
        json.dump(trace, f)
