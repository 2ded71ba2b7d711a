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
On a host of exactly four cards it then runs, in this process, the device
mesh over them (``--device cuda``, parallel/sharding.py): ``strain_detect
--mesh 2x2`` and ``--mesh 1x4`` and ``strainer2_tools detect-multi --mesh
1x4`` and ``2x2`` on the same data, each to the goldens, with every card's
peak memory above zero, and checks that ``make_mesh`` on a bare ``cuda``
puts shard (d, i) of a table and of the count buffers on card d * I + i;
elsewhere it prints that the mesh runs were skipped.
Prints the card line, a line a rank and a JSON summary; exits non-zero
on any mismatch and where torch.cuda.is_available() is false.  Meant for
a host of several cards; chip_smoke.py's phases 11 and 12 cover one card.
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
        if torch.cuda.device_count() == 4:
            ok.update(mesh_runs(d))
        else:
            print(f"mesh runs skipped: {torch.cuda.device_count()} card(s), they need 4", flush=True)
    print(json.dumps(ok), flush=True)
    return 0 if all(ok.values()) else 1


def mesh_runs(d: str) -> dict:
    """strain_detect and detect-multi over a 2x2 and a 1x4 mesh of the four
    cards (a bare ``cuda``), in this process: the goldens, memory on every
    card, and shard (d, i) of a table and of the counts on card d * I + i."""
    import contextlib
    import gzip

    import numpy as np
    import torch

    from strainer2_tpu_torch.cli import strain_detect, strainer2_tools
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.parallel.sharding import ShardedKmerEngine, make_mesh
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    ok = {}
    with open("expected/kmer_hits.txt", "rb") as f:
        golden = f.read()
    strains = os.path.join(d, "strains.tsv")
    with open(strains, "w") as f:
        f.write("data/strainA.fna.gz\texpected/scrubbed_m05.txt\n")
    index = StrainIndex.from_fasta("data/strainA.fna.gz", TorchKmerEngine(31, device="cuda:0"))
    t = index.table
    for mesh in ("2x2", "1x4"):
        n_data, n_index = (int(x) for x in mesh.split("x"))
        grid = make_mesh(n_data, n_index)
        eng = ShardedKmerEngine(31, grid, t.h_bits, t.salt, t.num_slots, layout="bucket")
        table, counts = eng.put_table(t.table), eng.init_counts()
        ok[f"mesh {mesh} placement"] = all(
            table.at(grid, dd, i).table.device == counts[dd][i].device == torch.device("cuda", dd * n_index + i)
            for dd in range(n_data) for i in range(n_index))
        del table, counts
        for label, main, argv, out in (
                ("strain_detect", strain_detect.main,
                 ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt", "-B",
                  "data/targets.txt", "-o", os.path.join(d, f"mesh{mesh}.gz")],
                 os.path.join(d, f"mesh{mesh}.gz")),
                ("detect-multi", strainer2_tools.main,
                 ["detect-multi", "-S", strains, "-B", "data/targets.txt", "-o",
                  os.path.join(d, f"multi{mesh}")],
                 os.path.join(d, f"multi{mesh}", "strainA.kmer_hits.gz"))):
            for c in range(4):
                torch.cuda.reset_peak_memory_stats(c)
            stdout = os.path.join(d, f"{label}{mesh}.stdout")
            with open(stdout, "w") as f, contextlib.redirect_stdout(f):
                rc = main(argv + ["--device", "cuda", "--mesh", mesh])
            peaks = [torch.cuda.max_memory_allocated(c) / 2**20 for c in range(4)]
            with gzip.open(out, "rb") as f:
                same = rc == 0 and f.read() == golden
            print(f"{label} --mesh {mesh} on 4 cards: exit {rc}, golden {same}, peak MiB a card "
                  + "/".join(f"{m:.0f}" for m in peaks), flush=True)
            ok[f"{label} mesh {mesh} golden"] = same
            ok[f"{label} mesh {mesh} memory on every card"] = bool(np.all(np.array(peaks) > 0))
    return ok


if __name__ == "__main__":
    sys.exit(main())
