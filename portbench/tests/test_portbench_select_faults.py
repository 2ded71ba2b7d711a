"""The detect cells' faults planted where the detect route classifies: the
engine's ``classify_select_batch`` (K4, then K4e's choice of the passing
reads and their rows).  A run with it broken comes out not correct, for
each fault a one-card cell can have: a selection that comes back empty,
half of the batch left out, the rows' codes altered where they are
produced.  On the CPU in the tiny cell; on the card (marked cuda) in
strain.detect at its own size."""

import pytest

from conftest import ROOT

from pbcore import harness
from test_portbench_faults import broken, half_rows


def emptied(sel):
    for x in sel:
        x.zero_()
    return sel


def altered(sel):
    sel.codes.bitwise_xor_(1)  # every row's last base
    return sel


FAULTS = {
    "select unchanged": lambda orig, self, *a, **kw: emptied(orig(self, *a, **kw)),
    "select half": (lambda orig, self, table, h, s, bases, bnd, **kw:
                    orig(self, table, h, s, half_rows(bases), bnd, **kw)),
    "select altered": lambda orig, self, *a, **kw: altered(orig(self, *a, **kw)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_select_fault_is_not_correct(tiny_root, monkeypatch, fault):
    broken(monkeypatch, "classify_select_batch", FAULTS[fault])
    r = harness.run_cell(tiny_root, "tiny.detect", 21, 0.0, False, device="cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] == 1, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["select half", "select altered"])
def test_select_fault_at_cell_size(card, monkeypatch, fault):
    broken(monkeypatch, "classify_select_batch", FAULTS[fault])
    r = harness.run_cell(ROOT, "strain.detect", 3000000211, 0.0, False)
    print(f"fault {fault!r} in strain.detect: "
          + ", ".join(f"{n} {c['value']} (limit {c['limit']})" for n, c in r["checks"].items()))
    assert not r["correct"] and r["failed"] == r["attempted"], r["checks"]
