"""The command's contract where there is no card, and the last line's
schema, and the card check (marked cuda)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import PB, ROOT

from pbcore import harness


def test_no_card_no_result():
    p = subprocess.run([sys.executable, os.path.join(PB, "run.py"), "--workload",
                        "strain.detect", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/ it fails."""
    import shutil

    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "strain.detect",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(tiny_root, trace):
    r = harness.run_cell(tiny_root, "tiny.detect", 2**33, 0.0, trace, device="cpu")
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    if trace:
        assert line["device"]["window_s"] > 0
        assert all(len(line["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    else:
        assert set(line["metrics"]) == {"detect_windows_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.detect", "tiny.multi", "tiny.count"])
def test_tiny_cells_on_the_card(card, tiny_root, cell):
    r = harness.run_cell(tiny_root, cell, 31, 0.0, True, device="cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
