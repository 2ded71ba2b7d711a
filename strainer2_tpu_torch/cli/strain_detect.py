"""CLI: strain_detect on the torch engine (flags of strainer2_tpu.cli.strain_detect,
plus --device).  Writes the gzip hits file (--no-gzip: plain TSV, same row
bytes) and the reference's stdout diagnostics."""

from __future__ import annotations

import sys

from strainer2_tpu.cli.strain_detect import build_parser as _jax_parser
from strainer2_tpu.constants import IS_PAIRED_END, NOT_PAIRED_END
from strainer2_tpu_torch.cli._common import check_args, torch_parser


def build_parser():
    return torch_parser(_jax_parser())


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    rc = check_args(parser, args)
    if rc:
        return rc

    from strainer2_tpu_torch.pipeline.detect import DetectConfig, get_file_type, run_detect

    if not args.b_file and not args.batch_list:
        parser.print_usage(sys.stderr)
        return 1
    if args.b_file and args.batch_list:
        print(
            "cannot have -B flag and -b flag\nEither have a file with metagenomics "
            "files to be detect the strain in or specify one metagenomic file to "
            "detect the strain in",
            file=sys.stdout,
        )
        return 1

    ftype = NOT_PAIRED_END
    if args.file_type is not None:
        ftype = get_file_type(args.file_type)
        if ftype < 0:
            print("unknown filetype specification. allowed are SE, PE, PEI\n", file=sys.stdout)
            return 1
    if args.b_file and ftype == IS_PAIRED_END and not args.b_file2:
        print("commandline PE mapping requires two files (-b [file1] and -c [file2])\n",
              file=sys.stdout)
        return 1

    cfg = DetectConfig(device=args.device)
    if args.rows:
        cfg.rows = args.rows
    if args.row_len:
        cfg.row_len = args.row_len

    run_detect(
        args.r_file, args.a_file, args.out_file,
        batch_list=args.batch_list, b_file=args.b_file, b_file2=args.b_file2,
        file_type=ftype, background_list=args.background_list, cfg=cfg,
        index_cache=args.index_cache, gzip_output=not args.no_gzip,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
