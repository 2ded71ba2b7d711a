"""Fused end-to-end pipeline on the torch engine: scrub count -> filter ->
detect -> coverage in ONE process.

Port of ``strainer2_tpu.pipeline.fused``.  The reference workflow
(reference test/example.sh:1-28) runs four processes wired by gzip'd TSV
files; every stage re-parses what the previous one formatted, and
detection re-scans the strain genome the scrub stage already indexed.
The fused runner keeps everything in memory instead:

- the strain index is built once (K1) and shared by panel counting (K3)
  and detection (K4; K6 and K7 for many strains);
- the filter consumes the count columns directly through an in-memory
  ScrubTable in the reference's row order, so the joint-scrub tie
  handling is unchanged;
- the kept rows map straight to strain-index keys: the -a file parse of
  strain_detect is skipped;
- the intermediate artifacts (scrub_kmer_counts.gz, scrubbed_kmers.gz)
  are still written by default, byte-identical to the staged CLIs.

Output files land in ``out_dir`` with the reference workflow's names:
<stem>.scrub_kmer_counts.gz, <stem>.scrubbed_kmers.gz, <stem>.kmer_hits.gz,
<stem>.coverage_depth.

In a multi-process run (parallel/distributed.py, one process per card)
the ranks count their shares of the panels and merge the columns, so every
rank derives the same filter result and detector, and score their shares
of the target samples; rank 0 alone writes the artifacts and stdout.
"""

from __future__ import annotations

import gzip
import io
import os
import re
import sys
import threading
from dataclasses import dataclass

import numpy as np

from strainer2_tpu_torch.index.refhash_order import reference_row_order
from strainer2_tpu_torch.parallel.distributed import initialize, merge_across_hosts
from strainer2_tpu_torch.utils.observability import stage

__all__ = ["FusedConfig", "run_pipeline", "run_multi_pipeline"]


@dataclass
class FusedConfig:
    min_fraction: float = 0.04  # reference kmer_scrub_filter.py default
    independent: bool = False
    min_kmer_hits: int = 1  # coverage_depth threshold
    write_counts: bool = True
    write_scrubbed: bool = True
    device: str = "cuda"
    # table layout of the single-strain index and of the union panel scan;
    # multi-strain detection runs on bucket rows whatever it is
    layout: str = "bucket"


# gzip level of the intermediates; the reference example uses `gzip --best`
_GZIP_LEVEL = 1


def _stem(path: str) -> str:
    """Genome-file output stem (the one place this naming rule lives: the
    CLIs import it too, so artifact names cannot diverge)."""
    return re.sub(r"\.(fna|fasta|fa)(\.gz)?$", "", os.path.basename(path))


class _NullTextSink:
    """Text sink that discards writes (write_scrubbed=False; the stdout and
    stderr of ranks other than 0)."""

    def write(self, s):
        return len(s)

    def flush(self):
        pass

    def close(self):
        pass


def _filter_in_memory(index, order, col_pan, col_meta, col_drug,
                      scrubbed_path, fcfg, err) -> np.ndarray:
    """Filter one strain's in-memory count table (reference row order);
    returns the informative key indices (first-encounter order).  Writes
    the scrubbed-k-mer artifact when scrubbed_path is given."""
    from strainer2_tpu_torch.pipeline.filter import CodeKeyRows, ScrubTable, run_filter

    keys = CodeKeyRows(index.codes[order], index.k)
    table = ScrubTable(
        keys=keys,
        strain=index.genome_counts[order].astype(np.int64),
        pan=col_pan[order].astype(np.int64),
        meta=col_meta[order].astype(np.int64),
        drug_mask=(col_drug[order] > 0) if col_drug is not None
        else np.zeros(len(keys), dtype=bool),
        has_drug=col_drug is not None,
    )
    if scrubbed_path:
        scrub_out = gzip.open(scrubbed_path, "wt", compresslevel=_GZIP_LEVEL)
    else:
        scrub_out = _NullTextSink()  # don't render megabytes just to discard
    try:
        _, kept_idx = run_filter(
            table, min_fraction=fcfg.min_fraction,
            independent=fcfg.independent, out=scrub_out, err=err,
            return_indices=True,
        )
    finally:
        scrub_out.close()
    return order[kept_idx]


def _background_counts_writer(path, index, col_pan, col_meta, col_drug, order,
                              errors: list) -> threading.Thread:
    """Start writing the counts artifact on a thread.  No later fused stage
    reads it (the filter runs on the in-memory columns), so its gzip write
    overlaps the remaining stages; the caller joins it before returning
    and raises the first of ``errors``."""
    from strainer2_tpu_torch.pipeline.scrub_count import write_scrub_table

    def _write():
        try:
            with stage("fused.write_counts"):
                with gzip.open(path, "wt", compresslevel=_GZIP_LEVEL) as f:
                    write_scrub_table(f, index, col_pan, col_meta, col_drug, order=order)
        except BaseException as e:  # surfaced at join
            errors.append(e)

    w = threading.Thread(target=_write, name="fused-counts-writer")
    w.start()
    return w


def _silent(fcfg: FusedConfig) -> FusedConfig:
    """``fcfg`` for a rank other than 0: it takes part in the scans but
    writes no artifact."""
    from dataclasses import replace

    return replace(fcfg, write_counts=False, write_scrubbed=False)


def run_pipeline(r_file: str, a_list: str, b_list: str, target_list: str, out_dir: str,
                 c_list: str | None = None, background_list: str | None = None,
                 fused_cfg: FusedConfig | None = None, progress=None, err=None,
                 stdout=None, checkpoint_dir: str | None = None) -> dict:
    """Run all four stages; returns the output paths keyed by stage.

    checkpoint_dir makes the two long stages resumable, bit-identical to
    an uninterrupted run: panel counting per file (<dir>/scrub, keyed to
    the strain's k-mer set so a stale checkpoint cannot mix in) and
    detection per sample (<dir>/detect).  The filter and coverage
    recompute: they are seconds next to the scans they sit between.
    In a multi-process run the panel checkpoint of rank i is
    <dir>/scrub/rank<i>, its detect checkpoint <dir>/detect/rank<i>."""
    from strainer2_tpu_torch.constants import COL_DRUG, COL_METAGENOME, COL_PANGENOME
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.coverage import run_coverage_depth
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, StrainDetector
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.scrub_count import (
        ScrubCountConfig,
        _count_panel,
        resume_layout,
    )

    fcfg = fused_cfg or FusedConfig()
    err = err if err is not None else sys.stderr
    os.makedirs(out_dir, exist_ok=True)
    pidx, pcount = initialize()
    partition = (pidx, pcount) if pcount > 1 else None
    stem = _stem(r_file)
    paths = {
        "counts": os.path.join(out_dir, stem + ".scrub_kmer_counts.gz"),
        "scrubbed": os.path.join(out_dir, stem + ".scrubbed_kmers.gz"),
        "hits": os.path.join(out_dir, stem + ".kmer_hits.gz"),
        "coverage": os.path.join(out_dir, stem + ".coverage_depth"),
    }

    cfg = ScrubCountConfig(device=fcfg.device, layout=fcfg.layout)
    engine = TorchKmerEngine(cfg.k, device=fcfg.device, layout=fcfg.layout)
    with stage("fused.index_build"):
        index = StrainIndex.from_fasta(r_file, engine, cfg.rows, cfg.row_len)

    # overlap the djb2 row-order replay with the panel scans (it needs only
    # the index; the counts writer and the filter consume it)
    order_box: list = []

    def _order_bg():
        try:
            order_box.append(reference_row_order(index.codes, index.k))
        except BaseException as e:  # surfaced at join
            order_box.append(e)

    order_thread = threading.Thread(target=_order_bg, name="fused-row-order")
    order_thread.start()

    # ---- stage 1: panel counting (one shared index) ----
    ckpt = None
    if checkpoint_dir:
        from strainer2_tpu_torch.pipeline.multi_scrub import union_checkpoint_key
        from strainer2_tpu_torch.pipeline.progress import ScrubCheckpoint

        scrub_dir = os.path.join(checkpoint_dir, "scrub")
        if pcount > 1:
            scrub_dir = os.path.join(scrub_dir, f"rank{pidx}")
        ckpt = ScrubCheckpoint(scrub_dir, key=union_checkpoint_key(index.codes, cfg.k))
        # stored counts set the layout of the scan and of detection
        engine, index = resume_layout(engine, index, ckpt)
    with stage("fused.scrub"):
        col_pan = _count_panel(engine, index, a_list, cfg, progress,
                               column=COL_PANGENOME, checkpoint=ckpt, partition=partition)
        col_meta = _count_panel(engine, index, b_list, cfg, progress,
                                column=COL_METAGENOME, checkpoint=ckpt, partition=partition)
        col_drug = (
            _count_panel(engine, index, c_list, cfg, progress, skip_path=r_file,
                         column=COL_DRUG, checkpoint=ckpt, partition=partition)
            if c_list
            else None
        )
    # every rank gets the same columns, hence the same filter result and
    # detector; the detection scan is split across ranks too
    col_pan = merge_across_hosts(col_pan)
    col_meta = merge_across_hosts(col_meta)
    if col_drug is not None:
        col_drug = merge_across_hosts(col_drug)
    if pidx != 0:
        fcfg, err, stdout = _silent(fcfg), _NullTextSink(), _NullTextSink()

    order_thread.join()
    if isinstance(order_box[0], BaseException):
        raise order_box[0]
    order = order_box[0]
    counts_writer = None
    counts_write_err: list[BaseException] = []
    if fcfg.write_counts:
        counts_writer = _background_counts_writer(
            paths["counts"], index, col_pan, col_meta, col_drug, order, counts_write_err
        )
    else:
        paths["counts"] = None

    # ---- stage 2: filter on the in-memory table (reference row order) ----
    with stage("fused.filter"):
        if not fcfg.write_scrubbed:
            paths["scrubbed"] = None
        informative_keys = _filter_in_memory(
            index, order, col_pan, col_meta, col_drug, paths["scrubbed"], fcfg, err,
        )

    # ---- stages 3+4: detect on the shared index, then coverage ----
    with stage("fused.detect"):
        det = StrainDetector(
            r_file, None, DetectConfig(k=cfg.k, device=fcfg.device, layout=fcfg.layout),
            stdout=stdout if stdout is not None else sys.stdout,
            index=index, informative_keys=informative_keys,
        )
        if background_list:
            det.background_filter(background_list)
        det.quantify_all(
            paths["hits"], batch_list=target_list,
            checkpoint_dir=os.path.join(checkpoint_dir, "detect") if checkpoint_dir else None,
        )

    if pidx != 0:
        return paths  # rank 0 owns the remaining artifacts
    with stage("fused.coverage"), open(paths["coverage"], "w") as f:
        run_coverage_depth(
            paths["hits"], min_kmer_hits=fcfg.min_kmer_hits,
            background_metagenomes_file=None, out=f,
        )
    if counts_writer is not None:
        counts_writer.join()
        if counts_write_err:
            raise counts_write_err[0]
    return paths


def run_multi_pipeline(r_files: list, a_list: str, b_list: str, target_list: str,
                       out_dir: str, c_list: str | None = None,
                       background_list: str | None = None,
                       fused_cfg: FusedConfig | None = None, progress=None, err=None,
                       stdout=None, checkpoint_dir: str | None = None) -> list:
    """Fused pipeline for S strains: ONE shared scan of the -A/-B/-C panels
    over the union of their k-mers (pipeline/multi_scrub.py), per-strain
    in-memory filters, then multi-strain detection (one target scan per
    planned pass, pipeline/multi_detect.py) and per-strain coverage.

    Per-strain outputs are byte-identical to S independent staged runs;
    the panels and the target metagenomes are each read once instead of S
    times.

    checkpoint_dir makes the two long stages resumable, bit-identical to
    an uninterrupted run: the union panel scan per file (<dir>/scrub, keyed
    to a content hash of the union k-mer set) and each detection pass per
    sample (<dir>/detect_<pass>_<identity hash>, the hash covering the
    pass's strains, their informative sets and the filter and background
    configuration).  Index builds, filters and coverage recompute.  In a
    multi-process run the panel scan and each detection pass are split
    across ranks (checkpoints under rank<i> subdirectories) and rank 0
    alone writes."""
    from concurrent.futures import ThreadPoolExecutor

    from strainer2_tpu_torch.pipeline.coverage import run_coverage_depth
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, strain_threads
    from strainer2_tpu_torch.pipeline.multi_detect import (
        MultiStrainDetector,
        device_mem_budget,
        plan_strain_passes_from_codes,
    )
    from strainer2_tpu_torch.pipeline.multi_scrub import multi_scrub_counts
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig

    fcfg = fused_cfg or FusedConfig()
    err = err if err is not None else sys.stderr
    os.makedirs(out_dir, exist_ok=True)
    pidx, _ = initialize()
    if pidx != 0:
        fcfg, err, stdout = _silent(fcfg), _NullTextSink(), _NullTextSink()
    cfg = ScrubCountConfig(device=fcfg.device, layout=fcfg.layout)

    stems = [_stem(r) for r in r_files]
    if len(set(stems)) != len(stems):
        dup = sorted({s for s in stems if stems.count(s) > 1})
        raise ValueError(
            "strain genomes map to duplicate output stems "
            f"{dup}: outputs would overwrite each other (rename the files "
            "or run them in separate output directories)"
        )

    with stage("fused.multi_scrub"):
        strain_indexes, columns = multi_scrub_counts(
            r_files, a_list, b_list, c_list, cfg, progress,
            checkpoint_dir=os.path.join(checkpoint_dir, "scrub") if checkpoint_dir else None,
        )
    # passes cut on the exact union's projected row-table bytes against the
    # device budget: the indexes are in memory, so the real unions are known.
    # Planned before the per-strain filters start the counts writers, which
    # would take the host's cores from it
    with stage("fused.plan"):
        passes = plan_strain_passes_from_codes([ix.codes for ix in strain_indexes],
                                               budget=device_mem_budget(fcfg.device))

    all_paths = []
    for stem in stems:
        out = lambda suffix: os.path.join(out_dir, stem + suffix)  # noqa: E731
        all_paths.append({
            "counts": out(".scrub_kmer_counts.gz") if fcfg.write_counts else None,
            "scrubbed": out(".scrubbed_kmers.gz") if fcfg.write_scrubbed else None,
            "hits": out(".kmer_hits.gz"),
            "coverage": out(".coverage_depth"),
        })
    counts_writers: list = []
    counts_write_err: list[BaseException] = []
    writers_lock = threading.Lock()

    def _prep_strain(arg):
        """Per-strain order replay, counts-write kickoff and filter:
        independent per strain, so strains run across a worker pool; their
        stderr diagnostics buffer and flush in strain order."""
        r_file, index, (col_pan, col_meta, col_drug), paths = arg
        order = reference_row_order(index.codes, index.k)
        if fcfg.write_counts:
            w = _background_counts_writer(paths["counts"], index, col_pan, col_meta,
                                          col_drug, order, counts_write_err)
            with writers_lock:
                counts_writers.append(w)
        err_buf = io.StringIO()
        try:
            with stage("fused.filter"):
                informative = _filter_in_memory(
                    index, order, col_pan, col_meta, col_drug, paths["scrubbed"], fcfg, err_buf,
                )
        except BaseException as e:
            # carry the partial diagnostics so the consumer below flushes
            # them in strain order before propagating
            e._s2_err = err_buf.getvalue()  # type: ignore[attr-defined]
            raise
        return (r_file, index, informative), err_buf.getvalue()

    prep_args = list(zip(r_files, strain_indexes, columns, all_paths))
    threads = strain_threads(len(r_files))
    prebuilt: list = []

    def _consume(fu_result):
        """Flush each strain's buffered stderr in strain order as results
        resolve, so diagnostics before a failure still reach stderr."""
        try:
            p, err_text = fu_result()
        except BaseException as e:
            err.write(getattr(e, "_s2_err", ""))
            raise
        if err_text:
            err.write(err_text)
        prebuilt.append(p)

    with stage("fused.prep"):
        if threads > 1 and len(prep_args) > 1:
            with ThreadPoolExecutor(threads) as ex:
                futures = [ex.submit(_prep_strain, a) for a in prep_args]
                for fu in futures:  # strain order, as the serial loop writes
                    _consume(fu.result)
        else:
            for a in prep_args:
                _consume(lambda a=a: _prep_strain(a))

    def _detect_ckpt_dir(start: int, chunk) -> str | None:
        """Per-pass detect checkpoint directory.  The identity hash covers
        what determines a pass's outputs beyond the (f1, f2, type) keys
        DetectCheckpoint checks per sample: the pass's strain files, each
        strain's informative k-mer set (the filter's outcome, so changed
        panels or filter parameters change it) and the background and
        filter configuration."""
        if not checkpoint_dir:
            return None
        import hashlib

        h = hashlib.sha256()
        h.update(f"m={fcfg.min_fraction};i={fcfg.independent};g={background_list};".encode())
        for r_file, index, informative in chunk:
            h.update(f"{r_file};{index.num_kmers};".encode())
            h.update(np.ascontiguousarray(index.codes[informative]).tobytes())
        return os.path.join(checkpoint_dir, f"detect_{start}_{h.hexdigest()[:16]}")

    for start, end in passes:
        chunk = prebuilt[start:end]
        with stage("fused.multi_detect"):
            det = MultiStrainDetector(
                [], DetectConfig(k=cfg.k, device=fcfg.device),
                stdout=stdout if stdout is not None else sys.stdout,
                background_list=background_list, prebuilt=chunk,
            )
            det.quantify_all(
                [p["hits"] for p in all_paths[start:end]], target_list,
                checkpoint_dir=_detect_ckpt_dir(start, chunk),
            )
            del det

    if pidx != 0:
        return all_paths  # rank 0 owns the remaining artifacts
    with stage("fused.coverage"):
        for paths in all_paths:
            with open(paths["coverage"], "w") as f:
                run_coverage_depth(
                    paths["hits"], min_kmer_hits=fcfg.min_kmer_hits,
                    background_metagenomes_file=None, out=f,
                )
    with stage("fused.join_writers"):
        for w in counts_writers:
            w.join()
    if counts_write_err:
        raise counts_write_err[0]
    return all_paths
