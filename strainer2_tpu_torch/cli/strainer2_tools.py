"""CLI: strainer2_tools on the torch engine (the parser of
strainer2_tpu.cli.strainer2_tools, plus --device on every subcommand).

``detect-multi`` scores many strains against shared target samples in one
stream pass per planned pass of strains; every other subcommand is not
ported yet and exits 1 saying so.

    python -m strainer2_tpu_torch.cli.strainer2_tools detect-multi \\
        -S strains.tsv -B targets.txt -o out_dir [-g background.txt] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

from strainer2_tpu.cli.strainer2_tools import build_parser as _jax_parser
from strainer2_tpu_torch.cli._common import check_args, torch_parser

PORTED = ("detect-multi",)


def build_parser() -> argparse.ArgumentParser:
    parser = _jax_parser()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for sub in action.choices.values():
                torch_parser(sub)
    if parser.description:
        parser.description = parser.description.replace("TPU engine", "torch engine")
    return parser


def _stem(path: str) -> str:
    """Genome-file output stem: the rule of strainer2_tpu.pipeline.fused._stem
    (that module imports jax)."""
    return re.sub(r"\.(fna|fasta|fa)(\.gz)?$", "", os.path.basename(path))


def _read_strain_list(path: str) -> list[tuple[str, str]]:
    strains = []
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                r, a = line.rstrip("\n").split("\t")[:2]
                strains.append((r, a))
    return strains


def detect_multi(args) -> None:
    """Passes sized by strain count and by the exact union's projected
    row-table bytes (the greedy cut of strainer2_tpu/cli/strainer2_tools.py
    :183-215): each genome is scanned once, and its index is handed to the
    detector, so planning costs no second read of any genome.  Genomes scan
    on a worker pool a few strains ahead of the cut, which stays in order."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from strainer2_tpu.utils.observability import stage
    from strainer2_tpu_torch.index.build import StrainIndex, scan_file_codes
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, strain_threads
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.multi_detect import (
        MAX_STRAINS_PER_PASS,
        MultiStrainDetector,
        device_mem_budget,
        projected_rows_bytes,
        union_sorted,
    )

    strains = _read_strain_list(args.strain_list)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = DetectConfig(device=args.device)
    eng = TorchKmerEngine(cfg.k, device=args.device)
    budget = device_mem_budget(args.device)

    def scan(r):
        ix = StrainIndex.from_scan_codes(scan_file_codes(r, eng), k=cfg.k)
        return ix, np.sort(ix.codes)

    def run_pass(chunk, idxs):
        det = MultiStrainDetector(chunk, cfg=cfg, background_list=args.background_list,
                                  indexes=idxs)
        outs = [os.path.join(args.out_dir, _stem(r) + ".kmer_hits.gz") for r, _ in chunk]
        det.quantify_all(outs, args.batch_list)

    threads = strain_threads(len(strains))
    chunk, idxs, union = [], [], None
    with ThreadPoolExecutor(threads) as ex:
        ahead = deque(ex.submit(scan, r) for r, _ in strains[:threads])
        for n, (r, a) in enumerate(strains):
            with stage("multi.plan_scan"):
                ix, codes = ahead.popleft().result()
                if n + threads < len(strains):
                    ahead.append(ex.submit(scan, strains[n + threads][0]))
                cand = union_sorted(union, codes)
            if chunk and (
                len(chunk) >= MAX_STRAINS_PER_PASS
                or (budget is not None and projected_rows_bytes(cand.shape[0], len(chunk) + 1) > budget)
            ):
                run_pass(chunk, idxs)
                chunk, idxs = [], []
                cand = union_sorted(None, codes)
            chunk.append((r, a))
            idxs.append(ix)
            union = cand
    if chunk:
        run_pass(chunk, idxs)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.cmd not in PORTED:
        print(f"strainer2_tools {args.cmd}: not yet ported to the torch engine "
              f"(ported: {', '.join(PORTED)})", file=sys.stderr)
        return 1
    rc = check_args(parser, args)
    if rc:
        return rc
    detect_multi(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
