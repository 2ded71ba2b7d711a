"""CLI: coverage_depth (flags of strainer2_tpu.cli.coverage_depth, plus
--device).  The metrics are host code; --device is checked like every port
CLI's, so a missing card is reported rather than passed over."""

from __future__ import annotations

import sys

from strainer2_tpu.cli.coverage_depth import build_parser as _jax_parser
from strainer2_tpu_torch.cli._common import check_args, torch_parser


def build_parser():
    return torch_parser(_jax_parser())


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
