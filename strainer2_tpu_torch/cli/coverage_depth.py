"""CLI: coverage_depth (flags of strainer2_tpu.cli.coverage_depth, plus
--device).  The metrics are host code; --device is checked like every port
CLI's, so a missing card is reported rather than passed over."""

from __future__ import annotations

import argparse
import sys

from strainer2_tpu_torch.cli._common import add_device, check_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="coverage_depth",
        description="Per-metagenome informative-k-mer coverage and depth metrics",
    )
    p.add_argument("--kmer_hits_file", "-k", required=True,
                   help="strain_detect output with per-metagenome k-mer hits")
    p.add_argument("--min_kmer_hits", "-m", required=False, default=1, type=int,
                   help="minimum k-mer matches for a read's hits to count; default 1")
    p.add_argument("--background_metagenomes_file", "-b", required=False,
                   help="file with background metagenome names (optional)")
    return add_device(p)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    rc = check_args(parser, args)
    if rc:
        return rc
    from strainer2_tpu_torch.pipeline.coverage import run_coverage_depth

    run_coverage_depth(
        args.kmer_hits_file,
        min_kmer_hits=args.min_kmer_hits,
        background_metagenomes_file=args.background_metagenomes_file,
        out=sys.stdout,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
