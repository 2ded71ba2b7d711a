#!/usr/bin/env python3
"""The port's CLIs as N processes over the cards of one host.

    python3 chip_ranks.py [--ranks 4,6]

For each N of --ranks, ``kmer_scrub_count`` and then ``strain_detect -B``
run on tests/golden/mini as N ranks under the launch contract
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), through
``chip_smoke.two_ranks`` (each rank's CLI ``main`` in chip_smoke's
RANK_WRAPPER, --device cuda), every rank given the same ``-o``.  Rank 0's
table and stdout and the hits payload must equal the goldens, the other
ranks' stdout must be empty, and each rank must run on card
``rank % torch.cuda.device_count()`` alone (two_ranks fails otherwise).
Prints the card line, a line a rank and a JSON summary; exits non-zero
on any mismatch and where torch.cuda.is_available() is false.  Meant for
a host of several cards; chip_smoke.py's phase 11 covers one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", default="4,6", help="comma-separated process counts")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import chip_smoke as cs

    mini = os.path.join(repo, "tests", "golden", "mini")
    os.chdir(mini)  # the mini lists hold paths relative to it
    print(cs.card_line(), flush=True)
    ok = {}
    with tempfile.TemporaryDirectory(prefix="chip_ranks_") as d:
        for n in (int(x) for x in args.ranks.split(",")):
            cs.RANKS = n
            hits = os.path.join(d, f"hits{n}.gz")
            for label, module, argv, golden in (
                    (f"scrub{n}", "kmer_scrub_count",
                     ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                      "-B", "data/metagenomes.txt"], "scrub_counts.tsv"),
                    (f"detect{n}", "strain_detect",
                     ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt",
                      "-B", "data/targets.txt", "-o", hits], "detect_stdout.txt")):
                run = cs.two_ranks(d, label, module, argv)
                out = lambda r: os.path.join(d, f"{label}_{r}.stdout")  # noqa: E731
                ok[f"{label} rank 0 stdout"] = cs.same_bytes(out(0), os.path.join("expected", golden))
                ok[f"{label} other ranks quiet"] = all(os.path.getsize(out(r)) == 0
                                                       for r in range(1, n))
                for r, x in enumerate(run["ranks"]):
                    print(f"{label} rank {r}: launches K1 {x['launches']['canonical_windows']}, "
                          f"K3 {x['launches']['count_step']}, K4 {x['launches']['classify_step']}; "
                          f"peak MiB a card {x['card_peak_mib']}", flush=True)
            ok[f"detect{n} payload"] = cs.same_bytes(hits, "expected/kmer_hits.txt", gz=True)
    print(json.dumps(ok), flush=True)
    return 0 if all(ok.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
