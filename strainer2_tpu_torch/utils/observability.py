"""Stage timing: ``stage(name, items=...)`` accumulates per-stage wall time
(and an optional item count); with STRAINER2_TIMINGS=1 a summary with the
derived rates (e.g. lookups/s) goes to stderr at process exit.  A copy of
``stage`` and ``_items`` of ``strainer2_tpu.utils.observability``, whose
``maybe_profile`` wraps the JAX profiler (pinned by tests/test_torch_host.py).
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
import time
from collections import defaultdict

__all__ = ["stage", "timings_enabled"]

_totals: dict[str, float] = defaultdict(float)
_items: dict[str, int] = defaultdict(int)
_registered = False


def timings_enabled() -> bool:
    return bool(os.environ.get("STRAINER2_TIMINGS"))


def _report() -> None:
    if not _totals:
        return
    print("# strainer2-tpu stage timings:", file=sys.stderr)
    for name in _totals:
        extra = ""
        if _items[name]:
            extra = f"  ({_items[name]} items, {_items[name] / max(_totals[name], 1e-9):,.0f}/s)"
        print(f"#   {name:<28s} {_totals[name]:8.3f}s{extra}", file=sys.stderr)


@contextlib.contextmanager
def stage(name: str, items: int = 0):
    """Accumulate wall time (and an optional item count) for a stage."""
    global _registered
    if timings_enabled() and not _registered:
        atexit.register(_report)
        _registered = True
    t0 = time.time()
    try:
        yield
    finally:
        _totals[name] += time.time() - t0
        _items[name] += items
