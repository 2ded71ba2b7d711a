"""The program's spans on the device trace's clock (``pbcore/spans.py``):
the interval arithmetic, the shares of each cell family on traced tiny
cells (``SpanTracer`` in place of the harness's ``Tracer``), and on a card
the clock check of the gate's readback against the device's records."""

import bisect
import os
import threading

import pytest

from conftest import ROOT

from pbcore import harness, spans
from strainer2_tpu_torch.utils.observability import Span

DETECT = ["emit_idle_share.detect", "emit_pass_share.detect", "pack_wait_idle_share.detect",
          "engine_idle_share.detect"]
COUNT = ["feed_pack_share.count", "feed_lock_wait_share.count", "table_write_idle_share.count"]


class Keep(spans.SpanTracer):
    made: list = []

    def __init__(self, cuda):
        super().__init__(cuda)
        Keep.made.append(self)


def traced(monkeypatch, root, cell, device="cpu", seed=2**31 + 11):
    Keep.made.clear()
    monkeypatch.setattr(harness, "Tracer", Keep)
    r = harness.run_cell(root, cell, seed=seed, seconds=0.0, trace=True, device=device)
    (t,) = Keep.made
    return r, t.reduced


def test_interval_arithmetic():
    assert spans.union([(5, 9), (0, 2), (1, 3), (9, 10), (4, 4)]) == [(0, 3), (5, 10)]
    assert spans.overlap([(0, 3), (5, 10)], [(2, 6), (8, 20)]) == 1 + 1 + 2
    s = [Span("root", 1, 0, 7, "m", 0, 100), Span("a", 2, 1, 7, "m", 10, 30),
         Span("a.b", 3, 2, 7, "m", 12, 20), Span("c", 4, 1, 7, "m", 50, 60),
         Span("w", 5, 0, 8, "w", 0, 100)]
    assert spans.self_pieces(s, 7) == {"root": [(0, 10), (30, 50), (60, 100)],
                                       "a": [(10, 12), (20, 30)], "a.b": [(12, 20)],
                                       "c": [(50, 60)]}
    tr = {"spans": s, "main": 7, "gaps": [(0, 40), (90, 120)]}
    assert spans.idle_by_innermost(tr) == {"root": 30e-9, "a": 12e-9, "a.b": 8e-9,
                                           "(no span)": 20e-9}
    # the window's idle time where the main thread is inside "a" (with its child)
    assert spans._idle_share(tr, ("root",), {"a"}) == pytest.approx(100 * 20 / 70)
    assert spans._idle_share(tr, ("absent",), {"a"}) is None


@pytest.mark.parametrize("cell,mine,others", [("tiny.detect", DETECT, COUNT),
                                              ("tiny.count", COUNT, DETECT),
                                              ("tiny.multi", [], DETECT + COUNT)])
def test_shares_of_each_family(tiny_root, monkeypatch, cell, mine, others):
    r, tr = traced(monkeypatch, tiny_root, cell)
    assert r["correct"], r["checks"]
    got = {name: spans.SHARES[name](tr) for name in DETECT + COUNT}
    for name in mine:
        assert got[name] is not None and 0 <= got[name] <= 100, (name, got[name])
    assert all(got[name] is None for name in others), got
    if cell == "tiny.detect":
        assert sum(got[n] for n in DETECT if n != "emit_pass_share.detect") <= 100 + 1e-9
        assert tr["counters"]["detect.emit_reads"] > 0
    main = threading.get_ident()
    assert tr["main"] == main
    # spans lie in the window on the profiler's clock
    lo = min(a for a, _ in tr["gaps"])
    hi = max(b for _, b in tr["gaps"])
    assert all(lo - 5e6 <= s.start_ns <= s.end_ns <= hi + 5e6 for s in tr["spans"])


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.count"])
def test_the_result_line_is_the_plain_tracers(tiny_root, monkeypatch, cell):
    """The recorder and the spans' readings leave the result line as the
    harness's own Tracer makes it: the same metric names, the breakdown's
    two keys."""
    plain = harness.run_cell(tiny_root, cell, seed=2**31 + 13, seconds=0.0, trace=True,
                             device="cpu")
    r, _ = traced(monkeypatch, tiny_root, cell, seed=2**31 + 13)
    assert set(r["metrics"]) == set(plain["metrics"])
    assert set(r["breakdown"]) == set(plain["breakdown"]) == {"device_ops", "idle_gaps"}
    untraced = harness.run_cell(tiny_root, cell, seed=2**31 + 13, seconds=0.0, trace=False,
                                device="cpu")
    assert "breakdown" not in untraced


def gate_margins(tr) -> list:
    """For each engine.gate_readback span, its end less the latest end of
    the device intervals that started before it (ns): the sync cannot
    return before that work ends, so a negative margin is the clocks'
    disagreement."""
    dev = sorted(tr["device"])
    starts = [a for a, _ in dev]
    latest, m = [], 0
    for _, b in dev:
        m = max(m, b)
        latest.append(m)
    out = []
    for s in tr["spans"]:
        if s.name != "engine.gate_readback":
            continue
        i = bisect.bisect_left(starts, s.start_ns)
        if i:
            out.append(s.end_ns - latest[i - 1])
    return out


@pytest.mark.cuda
def test_gate_readback_clock(card, monkeypatch):
    """On a traced strain.detect call on the card no device interval that
    starts before a gate readback starts ends more than 0.1 ms after the
    readback ends."""
    monkeypatch.delenv("STRAINER2_NATIVE_COUNT", raising=False)
    r, tr = traced(monkeypatch, ROOT, "strain.detect", device="cuda",
                   seed=int(os.environ.get("PORTBENCH_CLOCK_SEED", 3_000_000_311)))
    assert r["correct"], r["checks"]
    margins = gate_margins(tr)
    assert len(margins) > 100
    print(f"\ngate readbacks {len(margins)}, worst margin {min(margins) / 1e6:.4f} ms, "
          f"median {sorted(margins)[len(margins) // 2] / 1e6:.4f} ms")
    assert min(margins) >= -100_000
