"""CLI: genome_compare on the torch engine (flags of
strainer2_tpu.cli.genome_compare, plus --device).

Flags (reference src/main.c:45-62): -a reference fasta, -b query or -B
query list, -s seed length (default 20), -r rapid-mode k-mer budget,
-t fullmap threshold, -C clone mode (50k/0.1), -S strain mode (100k/0.05),
-H header.  One result line a query goes to stdout.

    python -m strainer2_tpu_torch.cli.genome_compare -a strain.fna -B queries.txt -S \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

from strainer2_tpu_torch.cli._common import add_device, check_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genome_compare",
        description="k-mer containment scoring between genomes (torch engine)",
    )
    p.add_argument("-a", dest="a_file", required=True, help="reference FASTA[.gz]")
    p.add_argument("-b", dest="b_file", default=None, help="query FASTA[.gz]")
    p.add_argument("-B", dest="b_list", default=None, help="file listing query FASTAs")
    p.add_argument("-s", dest="seed", type=int, default=None, help="seed (k-mer) length, default 20")
    p.add_argument("-r", dest="rapid", type=int, default=None,
                   help="rapid mode: decide after this many query k-mers")
    p.add_argument("-t", dest="threshold", type=float, default=None,
                   help="fullmap threshold (0.0-1.0), default 0.1")
    p.add_argument("-C", dest="clone_mode", action="store_true", help="clone mode (50k seeds, t=0.1)")
    p.add_argument("-S", dest="strain_mode", action="store_true", help="strain mode (100k seeds, t=0.05)")
    p.add_argument("-H", dest="header", action="store_true", help="print header line")
    return add_device(p)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from strainer2_tpu_torch.pipeline.compare import (
        CLONE_MODE,
        STRAIN_MODE,
        CompareConfig,
        run_genome_compare,
    )

    if not args.b_file and not args.b_list:
        parser.print_usage(sys.stderr)
        return 1
    if args.clone_mode and args.strain_mode:
        print(
            "Cannot run in clone mode and strain mode at same time (they are mutually exclusive)",
            file=sys.stderr,
        )
        return 1
    rc = check_args(parser, args)
    if rc:
        return rc

    cfg = CompareConfig(device=args.device)
    if args.seed:
        cfg.k = args.seed
    if args.rapid is not None:
        cfg.max_seeds = args.rapid
    if args.threshold is not None:
        cfg.threshold_for_fullmap = args.threshold
    if args.clone_mode:
        cfg.max_seeds, cfg.threshold_for_fullmap = CLONE_MODE
    if args.strain_mode:
        cfg.max_seeds, cfg.threshold_for_fullmap = STRAIN_MODE

    run_genome_compare(
        args.a_file,
        b_file=args.b_file,
        b_list=args.b_list,
        cfg=cfg,
        print_header=args.header,
        out=sys.stdout,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
