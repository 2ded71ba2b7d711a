"""CLI: strain_detect on the torch engine (flags of strainer2_tpu.cli.strain_detect,
plus --device).  Writes the gzip hits file (--no-gzip: plain TSV, same row
bytes) and the reference's stdout diagnostics."""

from __future__ import annotations

import argparse
import sys

from strainer2_tpu_torch.cli._common import add_device, check_args, mesh_shape
from strainer2_tpu_torch.constants import IS_PAIRED_END, NOT_PAIRED_END


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="strain_detect",
        description="Detect informative strain k-mers in target metagenomes (torch engine)",
    )
    p.add_argument("-r", dest="r_file", required=True, help="reference (strain) genome FASTA[.gz]")
    p.add_argument("-a", dest="a_file", required=True, help="informative k-mer file (post scrubbing)")
    p.add_argument("-b", dest="b_file", default=None, help="metagenome file (read 1)")
    p.add_argument("-c", dest="b_file2", default=None, help="metagenome file (read 2, PE)")
    p.add_argument("-B", dest="batch_list", default=None, help="batch file of metagenomes (PE/SE/PEI rows)")
    p.add_argument("-t", dest="file_type", default=None, help="SE, PE, or PEI")
    p.add_argument("-g", dest="background_list", default=None, help="file listing background metagenomes")
    p.add_argument("-o", dest="out_file", required=True, help="k-mer hits output (gzip)")
    p.add_argument("--no-gzip", dest="no_gzip", action="store_true",
                   help="write plain TSV instead of gzip (the reference's "
                        "NO_GZIP_OUTPUT build toggle as a runtime flag; "
                        "row bytes identical)")
    p.add_argument("-n", dest="not_pe", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mesh", default=None,
                   help="DATAxINDEX device mesh for sharded classification (e.g. 4x2)")
    p.add_argument("--index-cache", default=None,
                   help="npz path to cache/reuse the strain k-mer index")
    p.add_argument("--checkpoint", dest="checkpoint_dir", default=None,
                   help="directory for sample-granular resume of -B batch "
                        "runs (restart skips completed samples; output "
                        "byte-identical)")
    p.add_argument("--rows", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--row-len", type=int, default=None, help=argparse.SUPPRESS)
    return add_device(p)


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

    cfg = DetectConfig(device=args.device, mesh=mesh_shape(args.mesh))
    if args.rows:
        cfg.rows = args.rows
    if args.row_len:
        cfg.row_len = args.row_len

    run_detect(
        args.r_file, args.a_file, args.out_file,
        batch_list=args.batch_list, b_file=args.b_file, b_file2=args.b_file2,
        file_type=ftype, background_list=args.background_list, cfg=cfg,
        index_cache=args.index_cache, checkpoint_dir=args.checkpoint_dir,
        gzip_output=not args.no_gzip,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
