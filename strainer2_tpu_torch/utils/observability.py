"""Stage timing, counters and the in-memory trace of the port.

- ``stage(name, items=0)``: the one span API.  It adds the block's wall
  time and ``items`` under ``name``, always; with STRAINER2_TIMINGS=1 a
  summary goes to stderr at process exit: each name's time, its self time
  (its time less what the stages nested in it on the same thread took),
  its items and their rate, then the counters that are no stage's items.
- ``count(name, n=1)``: the one way to add to a counter (the store that
  stage's items share).
- ``start_recording()`` / ``stop_recording()``: between them every stage
  is also kept as a ``Span`` (name, id, parent id on its thread, thread
  ident and name, start and end) on ``time.time_ns()``, the clock of
  ``torch.profiler``'s records; the second call returns the spans and the
  counters' changes since the first, and clears both.

Threads: the main thread adds into ``_totals``, ``_items`` and ``_self``
with no lock; another thread adds into ``_thread_totals``,
``_thread_items`` and ``_thread_self`` under one module lock, so that no
entry is ever written by two threads without it.  The report and
``stop_recording`` add the two.  With recording off and no timings
report, a stage costs one flag check and one thread check more than the
original's: no span, no list append, and no lock on the main thread.

A copy of ``stage`` and ``_items`` of ``strainer2_tpu.utils.observability``
(whose ``maybe_profile`` wraps the JAX profiler), pinned by
tests/test_torch_host.py; ``count``, the self times and the recorder are
the port's own (tests/test_torch_observability.py).
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple

__all__ = ["Span", "count", "stage", "start_recording", "stop_recording", "timings_enabled"]

# the main thread's; _self holds self seconds, kept while nesting is tracked
_totals: dict[str, float] = defaultdict(float)
_items: dict[str, int] = defaultdict(int)
_self: dict[str, float] = defaultdict(float)
# every other thread's, under _lock
_thread_totals: dict[str, float] = defaultdict(float)
_thread_items: dict[str, int] = defaultdict(int)
_thread_self: dict[str, float] = defaultdict(float)
_registered = False
_lock = threading.Lock()
_MAIN = threading.main_thread().ident

# nesting is tracked (a stack a thread) while the report is due or recording is on
_nested = False
_recording = False
_generation = 0  # one a recording: a thread's span list belongs to one
_lists: list = []  # the span list of each thread of this recording
_counters_at_start: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    id: int
    parent: int  # the enclosing span on the same thread; 0 for none
    thread: int
    thread_name: str
    start_ns: int  # time.time_ns()
    end_ns: int


def timings_enabled() -> bool:
    return bool(os.environ.get("STRAINER2_TIMINGS"))


def _both(main: dict, other: dict) -> dict:
    """The main thread's entries plus the other threads' (from the main
    thread, holding _lock)."""
    out = main.copy()
    for name, v in other.items():
        out[name] += v
    return out


def _report() -> None:
    with _lock:
        totals = _both(_totals, _thread_totals)
        items = _both(_items, _thread_items)
        self_s = _both(_self, _thread_self)
    if not totals:
        return
    print("# strainer2-tpu stage timings (total, self):", file=sys.stderr)
    for name in totals:
        extra = ""
        if items[name]:
            extra = f"  ({items[name]} items, {items[name] / max(totals[name], 1e-9):,.0f}/s)"
        print(f"#   {name:<28s} {totals[name]:8.3f}s {self_s[name]:8.3f}s{extra}",
              file=sys.stderr)
    for name, n in items.items():
        if name not in totals and n:
            print(f"#   {name:<28s} {n:>18,d}", file=sys.stderr)


def _add(name: str, seconds: float, items: int, self_s: float | None) -> None:
    if threading.get_ident() == _MAIN:
        _into(_totals, _items, _self, name, seconds, items, self_s)
        return
    with _lock:
        _into(_thread_totals, _thread_items, _thread_self, name, seconds, items, self_s)


def _into(totals, items_, self_, name, seconds, items, self_s) -> None:
    totals[name] += seconds
    items_[name] += items
    if self_s is not None:
        self_[name] += self_s


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if threading.get_ident() == _MAIN:
        _items[name] += n
        return
    with _lock:
        _thread_items[name] += n


def _thread_spans() -> list:
    """This thread's span list of the current recording, made and
    registered at its first span."""
    if getattr(_local, "generation", None) != _generation:
        spans: list = []
        with _lock:
            _lists.append(spans)
        _local.generation, _local.spans = _generation, spans
        _local.name = threading.current_thread().name
    return _local.spans


@contextlib.contextmanager
def stage(name: str, items: int = 0):
    """Accumulate wall time (and an optional item count) for a stage; a
    span of it while recording."""
    global _registered, _nested
    if not _registered and timings_enabled():
        atexit.register(_report)
        _registered = _nested = True
    if not _nested:
        t0 = time.time_ns()
        try:
            yield
        finally:
            _add(name, (time.time_ns() - t0) / 1e9, items, None)
        return
    stack = _local.__dict__.setdefault("stack", [])
    parent = stack[-1] if stack else None
    frame = [next(_ids), 0]  # this span's id, the time its children took
    stack.append(frame)
    generation = _generation if _recording else None
    t0 = time.time_ns()
    try:
        yield
    finally:
        t1 = time.time_ns()
        stack.pop()
        if parent is not None:
            parent[1] += t1 - t0
        _add(name, (t1 - t0) / 1e9, items, (t1 - t0 - frame[1]) / 1e9)
        if generation == _generation and _recording:
            _thread_spans().append(Span(name, frame[0], parent[0] if parent else 0,
                                        threading.get_ident(), _local.name, t0, t1))


def start_recording() -> None:
    """Keep every stage from now on as a Span, and the counters' values
    now, until ``stop_recording``.  Called from the main thread."""
    global _recording, _nested, _generation, _counters_at_start
    with _lock:
        _generation += 1
        _lists.clear()
        _counters_at_start = _both(_items, _thread_items)
        _recording = _nested = True


def stop_recording() -> tuple[list[Span], dict[str, int]]:
    """The spans kept since ``start_recording`` (by start) and each
    counter's change since then; clears both and stops keeping spans.
    Nothing where no recording is on.  Called from the main thread."""
    global _recording, _nested, _generation
    with _lock:
        if not _recording:
            return [], {}
        _recording = False
        _nested = _registered
        _generation += 1
        spans = sorted((s for lst in _lists for s in lst), key=lambda s: s.start_ns)
        _lists.clear()
        items = _both(_items, _thread_items)
        counters = {name: n - _counters_at_start.get(name, 0) for name, n in items.items()
                    if n != _counters_at_start.get(name, 0)}
    return spans, counters
