"""CLI: strainer2_tools on the torch engine (a copy of the parser of
strainer2_tpu.cli.strainer2_tools, plus --device on every subcommand).

``pangenome``, ``kmer-matrix`` and ``strain-track`` are the reference's
library-only modes (pipeline/multi.py); ``detect-multi`` scores many
strains against shared target samples in one stream pass per planned pass
of strains; ``scrub-multi`` counts many strains' panels in one shared
scan; ``pipeline`` and ``pipeline-multi`` run scrub -> filter -> detect ->
coverage in one process for one or many strains (``--checkpoint`` makes
the long stages resumable).  ``detect-multi --mesh DxI`` splits the union
table over a (data, index) device mesh on ``--device`` (parallel/
sharding.py), the budget of its pass planner times the index shards.

    python -m strainer2_tpu_torch.cli.strainer2_tools pipeline \\
        -r strain.fna -A genomes.txt -B metagenomes.txt -T targets.txt -o out_dir \\
        [--checkpoint ckpt_dir] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

from strainer2_tpu_torch.cli._common import add_device, check_args, mesh_shape
from strainer2_tpu_torch.pipeline.fused import _stem


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="strainer2_tools",
        description="Auxiliary multi-genome k-mer analyses (torch engine)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pg = sub.add_parser("pangenome", help="per-genome k-mer occurrence tracks over a genome panel")
    pg.add_argument("-A", dest="a_list", required=True, help="file listing genome FASTAs")
    pg.add_argument("-r", dest="ref_file", default=None,
                    help="write a track only for this genome (default: all)")
    pg.add_argument("-d", dest="write_dist", action="store_true",
                    help="also write the pangenome count histogram")
    pg.add_argument("-s", dest="seed", type=int, default=31, help="k-mer length")

    km = sub.add_parser("kmer-matrix", help="k-mer x file count matrix")
    km.add_argument("-A", dest="a_list", required=True, help="file listing genome FASTAs")
    km.add_argument("-s", dest="seed", type=int, default=31, help="k-mer length")

    st = sub.add_parser("strain-track", help="unique-k-mer strain abundances in one metagenome")
    st.add_argument("-A", dest="a_list", required=True, help="file listing strain FASTAs")
    st.add_argument("-b", dest="b_file", required=True, help="metagenome file")
    st.add_argument("-n", dest="no_track", action="store_true",
                    help="skip per-strain track files")
    st.add_argument("-m", dest="max_reads", type=int, default=0,
                    help="stop after ~this many metagenome reads (0 = all)")
    st.add_argument("-s", dest="seed", type=int, default=31, help="k-mer length")

    md = sub.add_parser(
        "detect-multi",
        help="score up to 16 strains against shared target metagenomes in ONE "
        "stream pass (outputs identical to per-strain strain_detect runs)",
    )
    md.add_argument("-S", dest="strain_list", required=True,
                    help="file with one `genome<TAB>informative_kmers` pair per line")
    md.add_argument("-B", dest="batch_list", required=True,
                    help="batch file of target metagenomes (PE/SE/PEI rows)")
    md.add_argument("-g", dest="background_list", default=None,
                    help="background metagenome list (shared counting, per-strain thresholds)")
    md.add_argument("-o", dest="out_dir", required=True,
                    help="output directory; one <genome-stem>.kmer_hits.gz per strain")
    md.add_argument("--mesh", default=None,
                    help="DATAxINDEX device mesh for sharded multi-strain "
                    "classification (e.g. 4x2)")

    ms = sub.add_parser(
        "scrub-multi",
        help="kmer_scrub_count for many strains with ONE shared scan of the "
        "-A/-B/-C panels (tables identical to per-strain runs)",
    )
    ms.add_argument("-R", dest="r_list", required=True,
                    help="file listing strain genome FASTAs (one per line)")
    ms.add_argument("-A", dest="a_list", required=True)
    ms.add_argument("-B", dest="b_list", required=True)
    ms.add_argument("-C", dest="c_list", default=None)
    ms.add_argument("-p", dest="p_file", default=None, help="progress output file")
    ms.add_argument("-o", dest="out_dir", required=True,
                    help="output directory; one <genome-stem>.scrub_kmer_counts.tsv per strain")
    ms.add_argument("--checkpoint", dest="checkpoint_dir", default=None,
                    help="checkpoint directory: the shared union panel scan "
                    "resumes at file granularity (bit-identical; keyed to "
                    "the strain set, so a stale checkpoint restarts fresh)")

    fp = sub.add_parser(
        "pipeline",
        help="fused scrub -> filter -> detect -> coverage in one process "
        "(one index build, no TSV round trips; intermediate artifacts "
        "byte-identical to the staged CLIs)",
    )
    fp.add_argument("-r", dest="r_file", required=True, help="strain genome FASTA")
    fp.add_argument("-A", dest="a_list", required=True, help="genome panel list")
    fp.add_argument("-B", dest="b_list", required=True, help="metagenome panel list")
    fp.add_argument("-C", dest="c_list", default=None, help="co-occurring strain list")
    fp.add_argument("-T", dest="target_list", required=True,
                    help="target metagenome batch file (PE/SE/PEI rows)")
    fp.add_argument("-g", dest="background_list", default=None,
                    help="background metagenome list for the detect filter")
    fp.add_argument("-m", dest="min_fraction", type=float, default=0.04,
                    help="filter min_fraction (default 0.04)")
    fp.add_argument("-i", dest="independent", action="store_true",
                    help="independent per-panel scrub")
    fp.add_argument("--min_kmer_hits", type=int, default=1,
                    help="coverage_depth row threshold (default 1)")
    fp.add_argument("--no-intermediates", action="store_true",
                    help="skip writing scrub_kmer_counts.gz / scrubbed_kmers.gz")
    fp.add_argument("-o", dest="out_dir", required=True, help="output directory")
    fp.add_argument("--checkpoint", dest="checkpoint_dir", default=None,
                    help="checkpoint directory: panel counting resumes at "
                    "file granularity, detection at sample granularity "
                    "(bit-identical to an uninterrupted run)")

    fpm = sub.add_parser(
        "pipeline-multi",
        help="fused pipeline for MANY strains: one shared panel scan, "
        "per-strain filters, multi-strain detection (16 strains/pass); "
        "per-strain outputs identical to independent runs",
    )
    fpm.add_argument("-R", dest="r_list", required=True,
                     help="file listing strain genome FASTAs (one per line)")
    fpm.add_argument("-A", dest="a_list", required=True, help="genome panel list")
    fpm.add_argument("-B", dest="b_list", required=True, help="metagenome panel list")
    fpm.add_argument("-C", dest="c_list", default=None, help="co-occurring strain list")
    fpm.add_argument("-T", dest="target_list", required=True,
                     help="target metagenome batch file (PE/SE/PEI rows)")
    fpm.add_argument("-g", dest="background_list", default=None,
                     help="background metagenome list for the detect filter")
    fpm.add_argument("-m", dest="min_fraction", type=float, default=0.04)
    fpm.add_argument("-i", dest="independent", action="store_true")
    fpm.add_argument("--min_kmer_hits", type=int, default=1)
    fpm.add_argument("--no-intermediates", action="store_true")
    fpm.add_argument("-o", dest="out_dir", required=True, help="output directory")
    fpm.add_argument("--checkpoint", dest="checkpoint_dir", default=None,
                     help="checkpoint directory: the shared union panel scan "
                     "resumes at file granularity, each detection pass at "
                     "sample granularity (bit-identical; keyed to the strain "
                     "set and filter config, so stale state restarts fresh)")
    for sub_parser in sub.choices.values():
        add_device(sub_parser)
    return p


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

    from strainer2_tpu_torch.utils.observability import stage
    from strainer2_tpu_torch.index.build import StrainIndex, scan_file_codes
    from strainer2_tpu_torch.parallel.sharding import make_mesh
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, strain_threads
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.multi_detect import (
        MAX_STRAINS_PER_PASS,
        MultiStrainDetector,
        device_mem_budget,
        mesh_mem_budget,
        projected_rows_bytes,
        union_sorted,
    )

    strains = _read_strain_list(args.strain_list)
    os.makedirs(args.out_dir, exist_ok=True)
    cfg = DetectConfig(device=args.device, mesh=mesh_shape(args.mesh))
    eng = TorchKmerEngine(cfg.k, device=args.device)
    # the union splits over the index shards, on as many cards as the mesh gives them
    mesh = make_mesh(*cfg.mesh, devices=args.device) if cfg.mesh is not None else None
    budget = mesh_mem_budget(device_mem_budget(args.device), mesh)

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


def scrub_multi(args) -> None:
    """One count table per strain, <out_dir>/<stem>.scrub_kmer_counts.tsv,
    from one shared scan of the panels."""
    from strainer2_tpu_torch.pipeline.multi_scrub import run_multi_scrub
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, read_list_file

    r_files = [p for p in read_list_file(args.r_list) if p]
    os.makedirs(args.out_dir, exist_ok=True)
    progress = open(args.p_file, "w") if args.p_file else None
    if progress:
        progress.write("adding kmer counts for:\n")
    outs = []
    try:
        for r in r_files:
            outs.append(open(os.path.join(args.out_dir, _stem(r) + ".scrub_kmer_counts.tsv"), "w"))
        run_multi_scrub(r_files, args.a_list, args.b_list, args.c_list, outs,
                        cfg=ScrubCountConfig(device=args.device), progress=progress,
                        checkpoint_dir=args.checkpoint_dir)
    finally:
        for o in outs:
            o.close()
        if progress:
            progress.close()


def _fused_cfg(args):
    from strainer2_tpu_torch.pipeline.fused import FusedConfig

    return FusedConfig(
        min_fraction=args.min_fraction, independent=args.independent,
        min_kmer_hits=args.min_kmer_hits, write_counts=not args.no_intermediates,
        write_scrubbed=not args.no_intermediates, device=args.device,
    )


def pipeline(args) -> None:
    """The fused single-strain pipeline; the artifacts' paths go to stderr."""
    from strainer2_tpu_torch.pipeline.fused import run_pipeline

    paths = run_pipeline(
        args.r_file, args.a_list, args.b_list, args.target_list, args.out_dir,
        c_list=args.c_list, background_list=args.background_list,
        checkpoint_dir=args.checkpoint_dir, fused_cfg=_fused_cfg(args),
    )
    for k, v in paths.items():
        if v:
            print(f"{k}\t{v}", file=sys.stderr)


def pipeline_multi(args) -> int:
    """The fused pipeline for the strains of -R; the artifacts' paths go to
    stderr."""
    from strainer2_tpu_torch.pipeline.fused import run_multi_pipeline
    from strainer2_tpu_torch.pipeline.scrub_count import read_list_file

    r_files = read_list_file(args.r_list)
    if not r_files:
        print(f"error: no strain genomes listed in {args.r_list}", file=sys.stderr)
        return 1
    all_paths = run_multi_pipeline(
        r_files, args.a_list, args.b_list, args.target_list, args.out_dir,
        c_list=args.c_list, background_list=args.background_list,
        checkpoint_dir=args.checkpoint_dir, fused_cfg=_fused_cfg(args),
    )
    for paths in all_paths:
        for k, v in paths.items():
            if v:
                print(f"{k}\t{v}", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    rc = check_args(parser, args)
    if rc:
        return rc
    if args.cmd in ("pangenome", "kmer-matrix", "strain-track"):
        from strainer2_tpu_torch.pipeline import multi

        if args.cmd == "pangenome":
            multi.run_pangenome(args.a_list, ref_file=args.ref_file, write_dist=args.write_dist,
                                k=args.seed, out=sys.stdout, device=args.device)
        elif args.cmd == "kmer-matrix":
            multi.run_kmer_matrix(args.a_list, k=args.seed, out=sys.stdout, device=args.device)
        else:
            multi.run_strain_track(args.a_list, args.b_file, k=args.seed,
                                   print_track=not args.no_track, max_reads=args.max_reads,
                                   out=sys.stdout, device=args.device)
    elif args.cmd == "detect-multi":
        detect_multi(args)
    elif args.cmd == "scrub-multi":
        scrub_multi(args)
    elif args.cmd == "pipeline":
        pipeline(args)
    else:
        return pipeline_multi(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
