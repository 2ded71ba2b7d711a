"""A run with the timed path broken underneath comes out not correct, for
each fault a one-card cell can have: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced.  (The exchange between cards does not exist on one card.)  On
the CPU in the tiny cells; on the card (marked cuda) in cells of the
benchmark at their own sizes."""

import numpy as np
import pytest
import torch

from conftest import ROOT

from pbcore import harness


def broken(monkeypatch, name, wrap):
    from strainer2_tpu_torch.pipeline import engine

    orig = getattr(engine.TorchKmerEngine, name)
    monkeypatch.setattr(engine.TorchKmerEngine, name,
                        lambda self, *a, **kw: wrap(orig, self, *a, **kw))


def half_rows(bases):
    b = np.array(bases, copy=True)
    b[b.shape[0] // 2 :] = 4
    return b


def bump(counts):
    counts.view(torch.int32).add_(1)  # uint32 has no add on the CPU
    return counts


FAULTS = {
    # (cell, engine method, fault)
    "count unchanged": ("tiny.count", "count_batch",
                        lambda orig, self, counts, table, h, s, bases: counts),
    "count half": ("tiny.count", "count_batch",
                   lambda orig, self, counts, table, h, s, bases:
                   orig(self, counts, table, h, s, half_rows(bases))),
    "count altered": ("tiny.count", "count_batch",
                      lambda orig, self, *a: bump(orig(self, *a))),
    "classify unchanged": ("tiny.detect", "classify_batch",
                           lambda orig, self, *a, **kw: tuple(x.zero_() for x in orig(self, *a, **kw))),
    "classify half": ("tiny.detect", "classify_batch",
                      lambda orig, self, table, h, s, bases, bnd, **kw:
                      orig(self, table, h, s, half_rows(bases), bnd, **kw)),
    "classify altered": ("tiny.detect", "classify_batch",
                         lambda orig, self, *a, **kw: (lambda t, i: (t, i.add_(1)))(*orig(self, *a, **kw))),
    "multi unchanged": ("tiny.multi", "hit_words_batch",
                        lambda orig, self, *a: orig(self, *a).zero_()),
    "multi half": ("tiny.multi", "hit_words_batch",
                   lambda orig, self, rows, h, s, bases, n: orig(self, rows, h, s, half_rows(bases), n)),
    "multi altered": ("tiny.multi", "strain_sums",
                      lambda orig, self, *a: (lambda t, i: (t.add_(1), i))(*orig(self, *a))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_root, monkeypatch, fault):
    cell, method, wrap = FAULTS[fault]
    broken(monkeypatch, method, wrap)
    r = harness.run_cell(tiny_root, cell, 21, 0.0, False, device="cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] == 1, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [("strain.detect", "classify half"),
                                        ("strain.count", "count altered")])
def test_fault_at_cell_size(card, monkeypatch, cell, fault):
    _, method, wrap = FAULTS[fault]
    broken(monkeypatch, method, wrap)
    r = harness.run_cell(ROOT, cell, 3000000211, 0.0, False)
    print(f"fault {fault!r} in {cell}: "
          + ", ".join(f"{n} {c['value']} (limit {c['limit']})" for n, c in r["checks"].items()))
    assert not r["correct"] and r["failed"] == r["attempted"], r["checks"]
