"""CLI: kmer_scrub_count on the torch engine (flags of strainer2_tpu.cli.kmer_scrub_count,
plus --device).  The count table goes to stdout; row order and bytes match
the reference."""

from __future__ import annotations

import argparse
import sys

from strainer2_tpu_torch.cli._common import add_device, check_args, mesh_shape


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kmer_scrub_count",
        description="Count strain k-mer occurrences across background panels (torch engine)",
    )
    p.add_argument("-r", dest="r_file", required=True, help="reference (strain) genome FASTA[.gz]")
    p.add_argument("-A", dest="a_list", required=True, help="file listing genome panel FASTAs")
    p.add_argument("-B", dest="b_list", required=True, help="file listing metagenome panel files")
    p.add_argument("-C", dest="c_list", default=None, help="file listing co-occurring (drug) strain FASTAs")
    p.add_argument("-p", dest="p_file", default=None, help="progress output file")
    p.add_argument("-d", dest="write_dist", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rows", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--row-len", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--mesh", default=None,
                   help="DATAxINDEX device mesh for sharded counting (e.g. 4x2)")
    p.add_argument("--checkpoint", dest="checkpoint_dir", default=None,
                   help="directory for restartable counting state (resume skips finished panel files)")
    p.add_argument("--no-reference-order", action="store_true",
                   help="emit rows in first-encounter order instead of replaying the reference hash order")
    return add_device(p)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    rc = check_args(parser, args)
    if rc:
        return rc

    from strainer2_tpu_torch.parallel.distributed import initialize
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    # a multi-process run brings its group up before sys.stdout is taken
    # as the table's stream: the bring-up rebinds sys.stdout
    initialize()
    cfg = ScrubCountConfig(device=args.device, reference_order=not args.no_reference_order,
                           mesh=mesh_shape(args.mesh))
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
                        out=sys.stdout, progress=progress, cfg=cfg,
                        checkpoint_dir=args.checkpoint_dir)
    finally:
        if progress is not None:
            progress.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
