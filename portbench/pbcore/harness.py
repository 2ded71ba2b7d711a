"""One run of one cell: inputs from the seed, set-up, the measured window,
the check against the plain reference, and the metrics.

Everything that belongs to one configuration, traffic mix, stage entry or
metric is a file that this module finds by name (see ``portbench/README.md``):

- ``BENCHMARK.json``'s workload entry names a configuration and a mix;
- ``portbench/configs/<config>.json`` and ``portbench/traffic/<mix>.json``
  are data for ``gen.make_inputs``; the mix names its ``driver``;
- ``portbench/drivers/<driver>.py`` drives one stage entry of the program
  and gives its step's byte count (``step_bytes``; none, no roofline);
- ``portbench/metrics/<metric>.py`` reads one metric from the run's
  readings, or returns None where it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

from pbcore import check, gen, peaks
from pbcore.trace import Tracer

BANNED = ("jax", "jaxlib", "flax", "strainer2_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(BANNED))


def load(path: str, name: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """What a driver gets: the cell's data, its inputs, and room to keep a
    call's answers until the check."""
    name: str
    config: dict
    mix: dict
    device: str
    dir: str
    inputs: gen.Inputs
    store: dict = field(default_factory=dict)


@dataclass
class Plan:
    root: str
    bench: dict
    entry: dict
    config: dict
    mix: dict
    driver: object

    def metrics(self, group: str) -> list:
        name = self.entry["name"]
        return [m for m in self.bench[group] if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        return load(os.path.join(self.root, "portbench", "metrics", f"{metric}.py"),
                    f"portbench_metric_{metric}")


def plan(root: str, workload: str) -> Plan:
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    pb = os.path.join(root, "portbench")
    config = read_json(os.path.join(pb, "configs", f"{entry['config']}.json"))
    mix = read_json(os.path.join(pb, "traffic", f"{entry['traffic']}.json"))
    driver = load(os.path.join(pb, "drivers", f"{mix['driver']}.py"),
                  f"portbench_driver_{mix['driver']}")
    return Plan(root, bench, entry, config, mix, driver)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None, log=sys.stderr,
             driver=None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``driver`` takes the place of the cell's own (the control, in
    ``control.py``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    p = plan(root, workload)
    drv = driver or p.driver
    cuda = device.startswith("cuda")
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        cell = Cell(workload, p.config, p.mix, device, tmp,
                    gen.make_inputs(p.config, p.mix, seed, tmp))
        print(f"[portbench] {workload}: inputs made {time.perf_counter() - t_start:.3f} s "
              "after start", file=log, flush=True)
        t = time.perf_counter()
        state = drv.build(cell)
        _sync(device)
        index_build_s = time.perf_counter() - t
        drv.warm(state, cell)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        print(f"[portbench] {workload}: set-up {setup_s:.3f} s (constructor "
              f"{index_build_s:.3f} s)", file=log, flush=True)

        tracer = Tracer(cuda) if trace else contextlib.nullcontext()
        calls, windows = 0, 0
        with tracer:
            t0 = time.perf_counter()
            walls = []
            while True:
                windows += drv.call(state, cell, calls)
                _sync(device)
                calls += 1
                walls.append(time.perf_counter() - t0 - sum(walls))
                if time.perf_counter() - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        traced = tracer.reduce() if trace else None
        print(f"[portbench] {workload}: {calls} calls, {windows} windows in {elapsed:.3f} s "
              f"(calls {', '.join(f'{w:.3f}' for w in walls)} s)", file=log, flush=True)
        del state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        packed = drv.pack(cell) if trace else None
        t = time.perf_counter()
        want, stats = drv.expected(cell, False)
        per_call = []
        for i in range(calls):
            got = drv.answers(cell, i)
            if len(got) != len(want):
                raise RuntimeError(f"call {i} gave {len(got)} outputs, the reference {len(want)}")
            per_call.append(check.total([check.compare(g, w) for g, w in zip(got, want)]))
        print(f"[portbench] {workload}: reference and comparison "
              f"{time.perf_counter() - t:.3f} s", file=log, flush=True)
        checks = check.total(per_call)
        failed = sum(1 for r in per_call if any(r.values()))

        kind = torch.cuda.get_device_name(0) if cuda else None
        step_bytes = getattr(drv, "step_bytes", None)
        readings = {
            "workload": workload, "family": drv.FAMILY, "step": drv.STEP,
            "setup_s": setup_s, "index_build_s": index_build_s,
            "calls": calls, "windows": windows, "elapsed_s": elapsed,
            "trace": traced, "pack": packed, "peak": peaks.peak(kind),
            "step_bytes": calls * step_bytes(stats, cell) if step_bytes else None,
        }
        metrics = {}
        for m in p.metrics("per_layer" if trace else "end_to_end"):
            value = p.reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else device, "kind": kind or device, "count": 1,
               "memory_peak_bytes": int(memory_peak)}
        result = {"correct": not any(checks.values()), "attempted": calls, "failed": failed,
                  "metrics": metrics, "device": dev}
        if traced is not None:
            dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
            result["breakdown"] = {"device_ops": traced["device_ops"],
                                   "idle_gaps": traced["idle_gaps"]}
        result["checks"] = {n: {"value": v, "limit": 0} for n, v in checks.items()}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

