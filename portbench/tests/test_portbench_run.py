"""The harness end to end on the CPU at a tiny size: every cell's result
line, and correct false where the timed path is broken underneath."""

import json

import pytest

from pbcore import harness


def run(root, cell, trace=False):
    return harness.run_cell(root, cell, seed=2**31 + 7, seconds=0.0, trace=trace, device="cpu")


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.multi", "tiny.count"])
def test_cell_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    json.dumps(r)


@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.count"])
def test_trace_run_per_layer(tiny_root, cell):
    r = run(tiny_root, cell, trace=True)
    assert r["correct"]
    fam = "detect" if cell == "tiny.detect" else "count"
    # no card: no peak, so no roofline share; the rest is read
    assert set(r["metrics"]) == {f"pack_windows_per_s.{fam}", f"device_idle.{fam}",
                                 "index_build_s"}
    assert r["device"]["window_s"] > 0 and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
