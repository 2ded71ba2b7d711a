"""Run one cell of the port's benchmark once, on one card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, the last line of standard output, and
the numbers compared against the plain reference, each beside its limit,
as the last lines of standard error.  See ``portbench/README.md``.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, ROOT)  # the program; this file's folder (pbcore) is sys.path[0]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import importlib.util

    import torch

    from pbcore import harness

    if importlib.util.find_spec("strainer2_tpu_torch") is None:
        print("portbench: the program (strainer2_tpu_torch) is not beside portbench/",
              file=sys.stderr)
        return 2

    chips = harness.plan(ROOT, a.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[portbench] card: {power_limit()}", file=sys.stderr, flush=True)
    result = harness.run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                              t_start=T_START)
    found = harness.banned_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
