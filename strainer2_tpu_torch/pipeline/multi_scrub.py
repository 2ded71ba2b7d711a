"""Multi-strain shared-panel scrub counting on the torch engine.

Port of ``strainer2_tpu.pipeline.multi_scrub``.  Panel counting is
lookup-only: the count of a k-mer in a panel is a property of the k-mer,
not of the strain asking.  So S strains share ONE scan of the -A/-B/-C
panels over the union of their k-mer sets, counted on the device by the
count kernel (K3), and each strain's table is a projection of the union
counts: byte-identical to S independent ``kmer_scrub_count`` runs.

The -C (co-occurring strain) column differs per strain only in that each
strain skips its own genome file (reference src/genome_compare.c:115-146):
here the total over all drug files minus the strain's own-file
contribution, counted once per distinct own file.

Only the union's bucket table is built and uploaded; the per-strain
indexes keep their codes and genome counts and never build a table.
"""

from __future__ import annotations

from typing import IO

import numpy as np

from strainer2_tpu_torch.index.build import StrainIndex
from strainer2_tpu_torch.pipeline.detect import strain_threads
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
from strainer2_tpu_torch.pipeline.multi_detect import union_sorted_many
from strainer2_tpu_torch.pipeline.scrub_count import (
    ScrubCountConfig,
    _count_files,
    _progress_line,
    _resume_counts,
    count_panel_file,
    read_list_file,
    write_scrub_table,
)

__all__ = [
    "run_multi_scrub",
    "multi_scrub_counts",
    "strain_threads",
    "union_checkpoint_key",
]


def union_checkpoint_key(union_codes: np.ndarray, k: int) -> str:
    """Identity key for a union-count checkpoint: a content hash of the
    union k-mer set (plus k).  Slot-indexed count buffers are only valid
    against the exact table geometry they were recorded for, and the
    geometry is a pure function of the union codes, so a checkpoint
    recorded for another strain set hashes differently and is discarded
    instead of mixing counts."""
    import hashlib

    h = hashlib.sha256()
    h.update(f"k={k};n={union_codes.shape[0]};".encode())
    h.update(np.ascontiguousarray(union_codes).tobytes())
    return h.hexdigest()


def multi_scrub_counts(r_files: list[str], a_list: str, b_list: str, c_list: str | None,
                       cfg: ScrubCountConfig, progress: IO | None = None,
                       checkpoint_dir: str | None = None):
    """ONE shared panel scan over the union of S strains' k-mer sets.

    Returns (strain_indexes, per-strain (col_pan, col_meta, col_drug)
    column triples) with counts identical to S independent scans.

    checkpoint_dir makes the union counting restartable at panel-file
    granularity, keyed by a content hash of the union k-mer set
    (union_checkpoint_key); checkpointed files count one after another.
    The per-strain own-file -C contributions are not checkpointed: one
    genome scan per distinct strain file."""
    from collections import Counter
    from concurrent.futures import ThreadPoolExecutor

    from strainer2_tpu_torch.constants import COL_DRUG, COL_METAGENOME, COL_PANGENOME

    engine = TorchKmerEngine(cfg.k, device=cfg.device, layout=cfg.layout)
    threads = strain_threads(len(r_files))

    def position(union_codes, ix, order):
        """Union position of each of a strain's keys (key order), found for
        the keys in sorted order: sorted needles search far faster."""
        pos = np.empty(order.shape[0], dtype=np.int64)
        pos[order] = np.searchsorted(union_codes, ix.codes[order])
        return pos

    # per-strain work (index builds: own k-mer sets and genome occurrence
    # counts; sorts; projections) runs on a thread pool: numpy sorts and
    # searches and the native scan release the GIL
    with ThreadPoolExecutor(threads) as ex:
        strain_indexes = list(ex.map(
            lambda r: StrainIndex.from_fasta(r, engine, cfg.rows, cfg.row_len), r_files))
        orders = list(ex.map(lambda ix: np.argsort(ix.codes, kind="stable"), strain_indexes))
        union_codes = union_sorted_many(
            [ix.codes[o] for ix, o in zip(strain_indexes, orders)], threads)
        positions = list(ex.map(lambda a: position(union_codes, *a), zip(strain_indexes, orders)))
    del orders
    union = StrainIndex.from_unique_codes(union_codes, k=cfg.k, layout=cfg.layout)

    ckpt = None
    if checkpoint_dir:
        from strainer2_tpu_torch.pipeline.progress import ScrubCheckpoint

        ckpt = ScrubCheckpoint(checkpoint_dir, key=union_checkpoint_key(union_codes, cfg.k))

    def count_list(paths: list[str], column: int) -> np.ndarray:
        for path in paths:
            _progress_line(progress, path)
        counts, todo = _resume_counts(engine, union, paths, column, ckpt)
        counts = _count_files(engine, union, counts, todo, cfg, column, ckpt)
        return union.key_values(engine.finalize_counts(counts)).astype(np.uint32)

    pan_union = count_list(read_list_file(a_list), COL_PANGENOME)
    meta_union = count_list(read_list_file(b_list), COL_METAGENOME)

    drug_union = None
    own_contrib: dict[str, np.ndarray] = {}
    if c_list:
        drug_paths = read_list_file(c_list)
        drug_union = count_list(drug_paths, COL_DRUG)
        listed = Counter(drug_paths)
        # each strain subtracts its own genome's contribution: the reference
        # skips EVERY occurrence of the strain's -r path in the -C list
        # (reference src/genome_compare.c:138-141)
        single: dict[str, np.ndarray] = {}
        for r in set(r_files):
            if listed[r]:
                if r not in single:
                    counts = count_panel_file(engine, union, engine.init_counts(union), r,
                                              cfg.rows, cfg.row_len)
                    single[r] = union.key_values(engine.finalize_counts(counts)).astype(np.uint32)
                own_contrib[r] = single[r] * np.uint32(listed[r])
            else:
                own_contrib[r] = np.zeros_like(drug_union)

    columns = []
    for pos, r_file in zip(positions, r_files):
        col_drug = None
        if drug_union is not None:
            col_drug = drug_union[pos] - own_contrib[r_file][pos]
        columns.append((pan_union[pos], meta_union[pos], col_drug))
    return strain_indexes, columns


def run_multi_scrub(r_files: list[str], a_list: str, b_list: str, c_list: str | None,
                    outs: list[IO], cfg: ScrubCountConfig | None = None,
                    progress: IO | None = None, checkpoint_dir: str | None = None) -> None:
    """Emit one reference-identical scrub-count table per strain from one
    shared scan of the -A/-B (and -C) panels; checkpoint_dir makes the
    union counting resumable per panel file (bit-identical)."""
    cfg = cfg or ScrubCountConfig()
    strain_indexes, columns = multi_scrub_counts(
        r_files, a_list, b_list, c_list, cfg, progress, checkpoint_dir=checkpoint_dir,
    )
    for ix, (col_pan, col_meta, col_drug), out in zip(strain_indexes, columns, outs):
        write_scrub_table(out, ix, col_pan, col_meta, col_drug,
                          reference_order=cfg.reference_order)
