"""The control (pbcore/control.py: the reference with 32-bit fingerprint
membership in the program's place) comes out not correct through the
harness's own comparison: on the CPU at a size where fingerprints collide,
and on the card at each cell's own size on three seeds."""

import json
import os

import pytest

from conftest import ROOT, TINY_STRAIN, write_json

from pbcore import control, harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def run_control(root, cell, seed, device):
    return harness.run_cell(root, cell, seed, 0.0, False, device=device,
                            driver=control.Control(harness.plan(root, cell).driver))


def test_control_is_not_correct(tiny_root):
    """A 2 Mbp strain and 2.4 M target windows: fingerprints collide."""
    cfg = dict(TINY_STRAIN, strain_bp=2_000_000, strain_contigs=4, informative_fraction=0.05)
    mix = {"driver": "strain_detector", "insert": [300, 500], "n_rate": 0.001,
           "samples": [{"type": "SE", "reads": 20000, "strain_fraction": 0.1}],
           "warm_samples": [{"type": "SE", "reads": 10, "strain_fraction": 0.5}]}
    pb = os.path.join(tiny_root, "portbench")
    write_json(os.path.join(pb, "configs", "control_strain.json"), cfg)
    write_json(os.path.join(pb, "traffic", "control_targets.json"), mix)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "control.detect", "config": "control_strain",
                               "traffic": "control_targets", "chips": 1, "why": "control"})
    write_json(os.path.join(tiny_root, "BENCHMARK.json"), bench)
    r = run_control(tiny_root, "control.detect", 11, "cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] == 1, r["checks"]
    assert r["checks"]["rows_differing"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000000201, 3000000202, 3000000203])
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size(card, cell, seed):
    r = run_control(ROOT, cell, seed, "cuda")
    print(f"control {cell} seed {seed}: "
          + ", ".join(f"{n} {c['value']} (limit {c['limit']})" for n, c in r["checks"].items()))
    assert not r["correct"], r["checks"]
