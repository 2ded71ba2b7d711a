"""CLI: kmer_scrub_filter (flags of strainer2_tpu.cli.kmer_scrub_filter, plus
--device).  The filter is host code; --device is checked like every port
CLI's, so a missing card is reported rather than passed over."""

from __future__ import annotations

import argparse
import sys

from strainer2_tpu_torch.cli._common import add_device, check_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kmer_scrub_filter",
        description="Select informative (rare) strain k-mers from kmer_scrub_count output",
    )
    p.add_argument("--scrub_count_file", "-s", required=False,
                   help="input file with k-mer counts vs pangenome and metagenomes")
    p.add_argument("--scrub_count_list", "-l", required=False,
                   help="text file listing multiple k-mer count files")
    p.add_argument("--min_fraction", "-m", required=False, default=0.04, type=float,
                   help="minimum fraction of k-mers to keep; default 0.04; range (0.0-1.0)")
    p.add_argument("--independent", "-i", action="store_true",
                   help="scrub metagenome and pangenome panels independently")
    return add_device(p)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    rc = check_args(parser, args)
    if rc:
        return rc

    # reference reports these conditions without exiting
    if args.min_fraction < 0.0 or args.min_fraction > 1.0:
        sys.stderr.write(
            "error --min_fraction (-m) must be between 0.0 and 1.0 (%s)\n" % args.min_fraction
        )
    if not args.scrub_count_file and not args.scrub_count_list:
        sys.stderr.write("error: one of scrub_count_file or scrub_count_list must be provided.")
        return 1
    if args.scrub_count_file and args.scrub_count_list:
        sys.stderr.write("error: can provide only one of either scrub_count_file or scrub_count_list.")
        return 1

    from strainer2_tpu_torch.pipeline.filter import parse_scrub_tables, run_filter

    if args.scrub_count_file:
        paths = [args.scrub_count_file]
    else:
        with open(args.scrub_count_list) as f:
            paths = [line.rstrip() for line in f]
    table = parse_scrub_tables(paths)
    run_filter(table, min_fraction=args.min_fraction, independent=args.independent,
               out=sys.stdout, err=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
