"""The port's tracer: named host spans and counters, process-wide, off by
default.

Counterpart of the reference's Module registry with its RAII
ScopedModuleTimer (Snake/System/Module.h:38-95) and its end-of-run table
(Snake/System/Module.cpp:78-100).  ``enable()`` turns it on; until then
``span(name)`` returns one shared no-op context manager (no allocation, no
clock read) and ``count`` returns at once.

While on, ``with span(name, frame_id):`` records ``Record(name, t0, t1,
parent, frame_id, thread)``: ``t0`` and ``t1`` from
``time.perf_counter_ns``, ``parent`` the index (into ``records()``) of the
span open around it on the same thread, else -1, and ``frame_id`` the frame
the work is for (inherited from the parent where not given; a span opened
before its frame is known sets it with ``set_frame``).  Spans time the
host: a span around an enqueue ends when the enqueue does, and the places
where the host blocks on the device have spans of their own, named
``*.wait``.  Nothing is written during a run; ``records()``,
``counters()`` and ``table()`` read what was kept since ``reset()``.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

_clock = time.perf_counter_ns
_on = False
_lock = threading.Lock()
_local = threading.local()
_records: list = []      # [name, t0, t1, parent, frame_id, thread]
_counters: dict[str, int] = {}


class Record(NamedTuple):
    name: str
    t0: int              # ns, time.perf_counter_ns
    t1: int | None       # None while the span is open
    parent: int          # index of the enclosing span, -1 at the top
    frame_id: int | None
    thread: int


class _Null:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_frame(self, frame_id):
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "stack")

    def __init__(self, name: str, frame_id):
        self.rec = [name, 0, None, -1, frame_id, 0]

    def __enter__(self):
        rec = self.rec
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack and rec[4] is None:
            rec[4] = stack[-1][1][4]
        if rec[4] is not None:
            rec[4] = int(rec[4])
        rec[5] = threading.get_ident()
        with _lock:
            kept = _records
            # a parent recorded before the last reset is not kept
            if stack and stack[-1][2] is kept:
                rec[3] = stack[-1][0]
            index = len(kept)
            kept.append(rec)
        stack.append((index, rec, kept))
        self.stack = stack
        rec[1] = _clock()
        return self

    def __exit__(self, *exc):
        self.rec[2] = _clock()
        self.stack.pop()
        return False

    def set_frame(self, frame_id):
        self.rec[4] = int(frame_id)


def enable():
    global _on
    _on = True


def disable():
    """Off: spans open now still record their end."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset():
    """Drop every record and counter.  A span open at the reset, on any
    thread, is dropped with them; one opened inside it later is recorded
    at the top (``parent`` -1)."""
    global _records
    with _lock:
        _records = []
        _counters.clear()


def span(name: str, frame_id=None):
    """A context manager timing its block as ``name`` while the tracer is
    on; the shared no-op while it is off."""
    if not _on:
        return _NULL
    return _Span(name, frame_id)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def records() -> list[Record]:
    """Every span recorded since ``reset()``, in the order they opened."""
    with _lock:
        return [Record(*r) for r in _records]


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def table() -> str:
    """The end-of-run table: per span name its closed calls, mean ms and
    mean self ms (its time less its children's), then the counters."""
    recs = records()
    child = [0] * len(recs)
    for r in recs:
        if r.parent >= 0 and r.t1 is not None:
            child[r.parent] += r.t1 - r.t0
    rows: dict[str, list] = {}
    for r, c in zip(recs, child):
        if r.t1 is None:
            continue
        row = rows.setdefault(r.name, [0, 0, 0])
        row[0] += 1
        row[1] += r.t1 - r.t0
        row[2] += r.t1 - r.t0 - c
    w = max([24] + [len(n) + 2 for n in rows])
    lines = [f"{'Span':<{w}}{'Calls':>8}{'Mean (ms)':>12}{'Self (ms)':>12}"]
    for name, (n, tot, own) in sorted(rows.items()):
        lines.append(f"{name:<{w}}{n:>8}{tot / n * 1e-6:>12.3f}"
                     f"{own / n * 1e-6:>12.3f}")
    for name, v in sorted(counters().items()):
        lines.append(f"{name:<{w}}{v:>8}")
    return "\n".join(lines)
