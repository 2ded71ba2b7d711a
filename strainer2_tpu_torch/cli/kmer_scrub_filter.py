"""CLI: kmer_scrub_filter (flags of strainer2_tpu.cli.kmer_scrub_filter, plus
--device).  The filter is host code; --device is checked like every port
CLI's, so a missing card is reported rather than passed over."""

from __future__ import annotations

import sys

from strainer2_tpu.cli.kmer_scrub_filter import build_parser as _jax_parser
from strainer2_tpu_torch.cli._common import check_args, torch_parser


def build_parser():
    return torch_parser(_jax_parser())


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
