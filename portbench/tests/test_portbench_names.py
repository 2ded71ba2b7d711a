"""Every configuration, mix, driver and metric is found by its name, and a
new cell, mix, stage entry or metric needs only new files and new entries."""

import json
import os
import shutil

import pytest

from conftest import PB, ROOT, write_json

from pbcore import harness


def test_every_name_is_found():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        p = harness.plan(ROOT, w["name"])
        for fn in ("build", "warm", "call", "answers", "expected", "pack", "step_bytes"):
            assert callable(getattr(p.driver, fn)), (w["name"], fn)
        assert p.driver.FAMILY in ("detect", "count")
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert sorted(json.load(f)["reduced"]) == sorted(c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.plan(ROOT, bench["workloads"][0]["name"]).reader(m["name"]).read)
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3", "portbench/run.py"]


def test_a_throwaway_cell_mix_and_metric(tiny_root):
    """A new mix (data), a new cell (an entry) and a new per-layer metric
    (a reader file and an entry): no file of the harness edited."""
    pb = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pb, "traffic", "tiny_targets.json")) as f:
        mix = json.load(f)
    mix["samples"] = mix["samples"][:1]
    write_json(os.path.join(pb, "traffic", "throwaway_mix.json"), mix)
    with open(os.path.join(pb, "metrics", "throwaway_calls.py"), "w") as f:
        f.write("def read(r):\n    return float(r['calls'])\n")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "throwaway.cell", "config": "tiny_strain",
                               "traffic": "throwaway_mix", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({"name": "throwaway_calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "stage",
                               "moves": "detect_windows_per_s", "workloads": ["throwaway.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "detect_windows_per_s":
            m["workloads"].append("throwaway.cell")
    write_json(os.path.join(tiny_root, "BENCHMARK.json"), bench)
    before = {n: open(os.path.join(PB, "pbcore", n)).read() for n in os.listdir(os.path.join(PB, "pbcore"))
              if n.endswith(".py")}
    e2e = harness.run_cell(tiny_root, "throwaway.cell", 5, 0.0, False, device="cpu")
    assert e2e["correct"] and set(e2e["metrics"]) == {"detect_windows_per_s", "setup_s"}
    layer = harness.run_cell(tiny_root, "throwaway.cell", 6, 0.0, True, device="cpu")
    assert layer["metrics"]["throwaway_calls"] == {"value": 1.0, "unit": "calls"}
    assert before == {n: open(os.path.join(PB, "pbcore", n)).read() for n in before}
    shutil.rmtree(os.path.join(pb, "metrics"))  # nothing else reads the copy


THROWAWAY_DRIVER = """
import os

from pbcore.harness import load

_d = load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "strain_detector.py"),
          "throwaway_base")
build, warm, call, answers, expected, pack = (_d.build, _d.warm, _d.call, _d.answers,
                                              _d.expected, _d.pack)
STEP, FAMILY = "throwaway_step", "detect"
"""


@pytest.mark.parametrize("own_bytes", [True, False])
def test_a_throwaway_stage_entry(tiny_root, own_bytes):
    """A new stage entry (a driver file with a step of its own) and its
    roofline's reader: the driver's own byte count reaches the reader, and
    a driver that gives none leaves the metric out of the line."""
    pb = os.path.join(tiny_root, "portbench")
    with open(os.path.join(pb, "drivers", "throwaway_entry.py"), "w") as f:
        f.write(THROWAWAY_DRIVER + ("step_bytes = lambda stats, cell: 1000 + stats.reads\n"
                                    if own_bytes else ""))
    with open(os.path.join(pb, "metrics", "throwaway_step_bytes.py"), "w") as f:
        f.write("def read(r):\n    return None if r['step_bytes'] is None "
                "else float(r['step_bytes'])\n")
    with open(os.path.join(pb, "traffic", "tiny_targets.json")) as f:
        mix = json.load(f)
    write_json(os.path.join(pb, "traffic", "throwaway_entry_mix.json"),
               dict(mix, driver="throwaway_entry"))
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "throwaway.entry", "config": "tiny_strain",
                               "traffic": "throwaway_entry_mix", "chips": 1, "why": "throwaway"})
    bench["per_layer"].append({"name": "throwaway_step_bytes", "unit": "B", "better": "higher",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "detect_windows_per_s", "workloads": ["throwaway.entry"]})
    write_json(os.path.join(tiny_root, "BENCHMARK.json"), bench)
    r = harness.run_cell(tiny_root, "throwaway.entry", 8, 0.0, True, device="cpu")
    assert r["correct"], r["checks"]
    reads = 500 + 2 * 250  # the mix's SE reads and PE mates
    if own_bytes:
        assert r["metrics"]["throwaway_step_bytes"]["value"] == 1000.0 + reads
    else:
        assert "throwaway_step_bytes" not in r["metrics"]
