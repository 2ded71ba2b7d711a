"""CPU tests of the benchmark harness (run: python -m pytest portbench/tests -q).

They put ``portbench/`` (for ``pbcore``) and the repository root (for the
program) on the path, and build tiny cells in a copy of ``portbench/``, so
that they run without a card.  The tests that need a card are marked
``cuda`` and skip inside the ``card`` fixture where there is none; on a
card: ``python -m pytest portbench/tests -m cuda -s``.
"""

import json
import os
import shutil
import sys

import pytest

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
for p in (PB, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips itself where there is none")


TINY_STRAIN = {
    "source": "tiny copy of strain_vs_metagenomes for the CPU tests", "reduced": [],
    "k": 31, "layout": "bucket", "rows": 8, "row_len": 512, "read_len": 150,
    "strains": 1, "strain_bp": 20000, "strain_contigs": 3, "snp_rate": 0,
    "informative_fraction": 0.05, "panel_genomes": 2, "panel_genome_bp": 30000,
    "panel_block_bp": 1000, "panel_shared_fraction": 0.3, "distinct_metagenomes": 2,
    "metagenome_entries": 3, "metagenome_reads": 400, "metagenome_strain_fraction": 0.3,
    "n_rate": 0.002,
}
TINY_COHORT = dict(TINY_STRAIN, strains=3, snp_rate=0.01)
TINY_TARGETS = {
    "driver": "strain_detector", "insert": [300, 500], "n_rate": 0.002,
    "samples": [{"type": "SE", "reads": 500, "strain_fraction": 0.3},
                {"type": "PE", "pairs": 250, "strain_fraction": 0.3}],
    "warm_samples": [{"type": "SE", "reads": 40, "strain_fraction": 0.5}],
}
TINY_COHORT_TARGETS = dict(
    TINY_TARGETS, driver="multi_strain_detector",
    samples=[{"type": "SE", "reads": 500, "strain_fraction": 0.3, "present_strains": 2},
             {"type": "PE", "pairs": 250, "strain_fraction": 0.3, "present_strains": 2}])
TINY_PANEL = {"driver": "scrub_count", "panel": True,
              "warm_panel": {"genome_bp": 2000, "reads": 20}}
TINY_CELLS = {
    "tiny.detect": ("tiny_strain", "tiny_targets"),
    "tiny.multi": ("tiny_cohort", "tiny_cohort_targets"),
    "tiny.count": ("tiny_strain", "tiny_panel"),
}


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of portbench/ with tiny configurations, mixes and cells in
    its own BENCHMARK.json, every metric of the real one kept; the program
    on the CPU takes its plain torch kernels (the timed path's twins)."""
    monkeypatch.setenv("STRAINER2_NATIVE_COUNT", "0")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = tmp_path / "root"
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, obj in (("tiny_strain", TINY_STRAIN), ("tiny_cohort", TINY_COHORT)):
        write_json(root / "portbench" / "configs" / f"{name}.json", obj)
    for name, obj in (("tiny_targets", TINY_TARGETS), ("tiny_cohort_targets", TINY_COHORT_TARGETS),
                      ("tiny_panel", TINY_PANEL)):
        write_json(root / "portbench" / "traffic" / f"{name}.json", obj)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    rename = {"strain.detect": ["tiny.detect", "tiny.multi"], "strain.count": ["tiny.count"],
              "strain.detect_engrafted": ["tiny.detect"]}
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = sorted({t for w in m["workloads"] for t in rename[w]})
    bench["per_layer"].append({"name": "multi_classify_roofline", "unit": "%",
                               "better": "higher", "source": "device_trace", "layer": "kernels",
                               "moves": "detect_windows_per_s", "workloads": ["tiny.multi"]})
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "tiny"}
                          for n, (c, t) in TINY_CELLS.items()]
    write_json(root / "BENCHMARK.json", bench)
    return str(root)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
