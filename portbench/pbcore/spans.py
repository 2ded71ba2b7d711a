"""The program's own spans and counters in a traced window, on the device
trace's clock, and the shares of device-idle time and of feeder time that
they give.

The program (``strainer2_tpu_torch.utils.observability``) keeps every
``stage`` as a span on ``time.time_ns()`` while its recorder is on.
``SpanTracer`` is ``trace.Tracer`` that also turns that recorder on at the
window's start and off at its end; its ``reduce`` gives all that
``Tracer.reduce`` gives, and

- ``gaps``: the device-idle intervals of the window, the complement of the
  union of its device intervals (``Tracer.reduce``'s rule, on the
  profiler's clock), and ``device``, those intervals;
- ``offset``: the host clock to the profiler's (``Tracer.reduce``'s, for
  the stack samples);
- ``spans``: the recorder's spans shifted by ``offset``; ``counters``: the
  counters' changes over the window; ``main``: the main thread's ident.

It also prints the idle time by the main thread's innermost span, the ten
largest, to standard error.  ``SHARES`` names the per-layer shares that
these give, each a function of that dict returning a percentage or None
where the window holds no span of its stage's root (``detect.score_samples``;
``scrub.panel_lookups`` or ``scrub.write_table``).
"""

from __future__ import annotations

import sys
from collections import defaultdict

import torch

from pbcore.trace import MARK, Tracer

DETECT_ROOTS = ("detect.score_samples",)
COUNT_ROOTS = ("scrub.panel_lookups", "scrub.write_table")


def union(intervals) -> list:
    """Sorted, disjoint (start, end) pairs covering ``intervals``."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        elif b > a:
            out.append((a, b))
    return out


def length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def overlap(x, y) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def covered(spans, names, thread=None) -> list:
    """Where a span of ``names`` (on ``thread``, if given) runs."""
    return union((s.start_ns, s.end_ns) for s in spans
                 if s.name in names and (thread is None or s.thread == thread))


def self_pieces(spans, thread) -> dict:
    """Each name's time on ``thread`` where it is the innermost span: its
    spans less their children's (spans on one thread nest)."""
    mine = [s for s in spans if s.thread == thread]
    children = defaultdict(list)
    for s in mine:
        children[s.parent].append((s.start_ns, s.end_ns))
    pieces = defaultdict(list)
    for s in mine:
        cur = s.start_ns
        for a, b in union(children[s.id]):
            if a > cur:
                pieces[s.name].append((cur, a))
            cur = max(cur, b)
        if s.end_ns > cur:
            pieces[s.name].append((cur, s.end_ns))
    return {name: union(p) for name, p in pieces.items()}


def idle_by_innermost(tr: dict) -> dict:
    """Device-idle seconds by the main thread's innermost span, and
    "(no span)" for the idle time outside every span of the main thread."""
    gaps = tr["gaps"]
    out = {name: overlap(p, gaps) / 1e9
           for name, p in self_pieces(tr["spans"], tr["main"]).items()}
    outside = length(gaps) - overlap(covered(tr["spans"], {s.name for s in tr["spans"]},
                                             tr["main"]), gaps)
    out["(no span)"] = outside / 1e9
    return {k: v for k, v in out.items() if v > 0}


def _has(tr: dict, roots) -> bool:
    return any(s.name in roots for s in tr.get("spans") or ())


def _idle_share(tr, roots, names):
    if not _has(tr, roots):
        return None
    gaps = tr["gaps"]
    idle = length(gaps)
    if idle <= 0:
        return None
    return 100.0 * overlap(covered(tr["spans"], names, tr["main"]), gaps) / idle


def _feed_share(tr, name):
    """Feeders' time inside ``name`` (a span directly in a feeder's loop)
    over their time inside ``scrub.feed``."""
    if not _has(tr, COUNT_ROOTS):
        return None
    feeds = {s.id: s for s in tr["spans"] if s.name == "scrub.feed"}
    total = sum(s.end_ns - s.start_ns for s in feeds.values())
    if total <= 0:
        return None
    part = sum(s.end_ns - s.start_ns for s in tr["spans"] if s.name == name and s.parent in feeds)
    return 100.0 * part / total


def _pass_share(tr):
    if not _has(tr, DETECT_ROOTS):
        return None
    c = tr["counters"]
    return 100.0 * c.get("detect.reads_passing", 0) / c["detect.emit_reads"] \
        if c.get("detect.emit_reads") else None


SHARES = {
    "emit_idle_share.detect": lambda tr: _idle_share(tr, DETECT_ROOTS, {"detect.emit"}),
    "emit_pass_share.detect": _pass_share,
    "pack_wait_idle_share.detect": lambda tr: _idle_share(tr, DETECT_ROOTS, {"prefetch.wait"}),
    "engine_idle_share.detect": lambda tr: _idle_share(
        tr, DETECT_ROOTS, {"engine.classify", "engine.gate_readback", "engine.d2h"}),
    "feed_pack_share.count": lambda tr: _feed_share(tr, "pack.batch"),
    "feed_lock_wait_share.count": lambda tr: _feed_share(tr, "scrub.feed.lock_wait"),
    "table_write_idle_share.count": lambda tr: _idle_share(tr, COUNT_ROOTS,
                                                           {"scrub.write_table"}),
}


def device_intervals(events, w0: int, w1: int) -> list:
    """The device's kernel, memcpy and memset intervals inside [w0, w1],
    chosen and clipped as ``Tracer.reduce`` chooses them."""
    out = []
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.name() == MARK \
                or e.is_user_annotation():
            continue
        a, b = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
        if b > a:
            out.append((a, b))
    return sorted(out)


class SpanTracer(Tracer):
    """``Tracer`` with the program's recorder on for the window."""

    def __enter__(self):
        from strainer2_tpu_torch.utils import observability

        super().__enter__()
        observability.start_recording()
        return self

    def __exit__(self, *exc):
        from strainer2_tpu_torch.utils import observability

        super().__exit__(*exc)
        self.spans, self.counters = observability.stop_recording()
        return False

    def reduce(self) -> dict:
        out = super().reduce()
        events = self.prof.profiler.kineto_results.events()
        win = next(e for e in events if e.name() == MARK)
        w0, w1 = win.start_ns(), win.start_ns() + win.duration_ns()
        offset = w0 - self.t_mark
        dev = device_intervals(events, w0, w1)
        gaps, cur = [], w0
        for a, b in union(dev):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < w1:
            gaps.append((cur, w1))
        out.update(gaps=gaps, device=dev, offset=offset, main=self._main,
                   spans=[s._replace(start_ns=s.start_ns + offset, end_ns=s.end_ns + offset)
                          for s in self.spans],
                   counters=self.counters)
        top = sorted(idle_by_innermost(out).items(), key=lambda kv: -kv[1])[:10]
        print("[portbench] idle by innermost main-thread span: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in top), file=sys.stderr, flush=True)
        self.reduced = out
        return out
