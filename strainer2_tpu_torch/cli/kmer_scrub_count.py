"""CLI: kmer_scrub_count on the torch engine (flags of strainer2_tpu.cli.kmer_scrub_count,
plus --device).  The count table goes to stdout; row order and bytes match
the reference."""

from __future__ import annotations

import sys

from strainer2_tpu.cli.kmer_scrub_count import build_parser as _jax_parser
from strainer2_tpu_torch.cli._common import check_args, torch_parser


def build_parser():
    return torch_parser(_jax_parser())


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    rc = check_args(parser, args)
    if rc:
        return rc

    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    cfg = ScrubCountConfig(device=args.device, reference_order=not args.no_reference_order)
    if args.rows:
        cfg.rows = args.rows
    if args.row_len:
        cfg.row_len = args.row_len

    progress = None
    if args.p_file:
        try:
            progress = open(args.p_file, "w")
        except OSError:
            print(f"could not open progress file {args.p_file}", file=sys.stderr)
            return 1
        progress.write("adding kmer counts for:\n")
    try:
        run_scrub_count(args.r_file, args.a_list, args.b_list, c_list=args.c_list,
                        out=sys.stdout, progress=progress, cfg=cfg)
    finally:
        if progress is not None:
            progress.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
