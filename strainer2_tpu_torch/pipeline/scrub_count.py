"""kmer_scrub_count stage on the torch engine.

Port of ``strainer2_tpu.pipeline.scrub_count`` (reference
src/kmer_scrub_count.c:29-124): build the strain index from -r, stream
every file of the -A genome panel, the -B metagenome panel and the
optional -C co-occurring-strain panel through the count kernel (K3)
into a slot-indexed uint32 count buffer on the device, then write the
4- or 5-column table in the reference's row order.

Counts are integers, so neither the batch order nor the order in which
the feeder threads' batches reach the device can change a byte.  With a
checkpoint directory, files count one after another and the count buffer
is saved after each (pipeline/progress.py), so a restarted run skips the
finished files.  There is no device mesh and no multi-process
partitioning; the CLI refuses those.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import IO

import numpy as np

from strainer2_tpu_torch import native
from strainer2_tpu_torch.constants import DEFAULT_K
from strainer2_tpu_torch.index.build import StrainIndex
from strainer2_tpu_torch.index.refhash_order import reference_row_order
from strainer2_tpu_torch.io.batches import DEFAULT_ROW_LEN, DEFAULT_ROWS
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
from strainer2_tpu_torch.utils.observability import _items, stage
from strainer2_tpu_torch.utils.prefetch import prefetch

__all__ = [
    "ScrubCountConfig",
    "run_scrub_count",
    "count_panel_file",
    "read_list_file",
    "write_scrub_table",
]


@dataclass
class ScrubCountConfig:
    k: int = DEFAULT_K
    rows: int = DEFAULT_ROWS
    row_len: int = DEFAULT_ROW_LEN
    # replay the reference's printed row order (djb2); False emits rows in
    # first-encounter order (same counts, other order)
    reference_order: bool = True
    device: str = "cuda"
    layout: str = "bucket"  # table layout of the index the stage builds


def read_list_file(path: str) -> list[str]:
    """File-of-filenames, one path per line (reference getline loops)."""
    with open(path) as f:
        return [line.rstrip("\n") for line in f]


def _progress_line(progress: IO | None, path: str) -> None:
    """Reference format: `<path>\\t<asctime>` (reference
    src/genome_compare.c:133-136)."""
    if progress is not None:
        progress.write(f"{path}\t{time.asctime(time.localtime())}\n")
        progress.flush()


def _exit_could_not_read(msg: str) -> None:
    """Reference-exact unreadable-file diagnostic + exit 1."""
    print(msg, file=sys.stderr)
    raise SystemExit(1)


def count_panel_file(engine: TorchKmerEngine, index: StrainIndex, counts,
                     path: str, rows: int, row_len: int):
    """Stream one panel file through the count kernel; packing runs on a
    prefetch thread so it overlaps the device."""
    table = engine.table_for(index)
    t = index.table
    windows_per_batch = rows * (row_len - engine.k + 1)
    n = 0
    with stage("scrub.panel_lookups"):
        for batch in prefetch(native.pack_file(path, engine.k, rows, row_len)):
            counts = engine.count_batch(counts, table, t.h_bits, t.salt, batch.bases)
            n += windows_per_batch
    _items["scrub.panel_lookups"] += n
    return counts


def _count_threads(n_files: int) -> int:
    """Feeder threads for multi-file panels (STRAINER2_COUNT_THREADS
    overrides; default caps at 8)."""
    import os

    env = os.environ.get("STRAINER2_COUNT_THREADS")
    if env is not None:
        return max(1, min(int(env), n_files))
    return max(1, min(os.cpu_count() or 1, 8, n_files))


def _count_files_device_parallel(engine, index, counts, todo, n_threads, cfg):
    """Several files decode and pack on worker threads, OUTSIDE the lock,
    while their batches reach the one device count buffer under a lock
    (strainer2_tpu/pipeline/scrub_count.py:258-322).  Integer adds commute,
    so the counts equal the sequential loop's."""
    import threading

    table = engine.table_for(index)
    t = index.table
    dispatch_lock = threading.Lock()
    path_lock = threading.Lock()
    paths = iter(todo)
    errs: list[BaseException] = []
    windows_per_batch = cfg.rows * (cfg.row_len - engine.k + 1)
    n_batches = [0]

    def worker():
        while True:
            with path_lock:
                path = next(paths, None)
            if path is None or errs:
                return
            try:
                for batch in native.pack_file(path, engine.k, cfg.rows, cfg.row_len):
                    with dispatch_lock:
                        engine.count_batch(counts, table, t.h_bits, t.salt, batch.bases)
                        n_batches[0] += 1
            except BaseException as e:
                if isinstance(e, OSError) and not getattr(e, "filename", None):
                    e.filename = path
                errs.append(e)
                return

    with stage("scrub.panel_lookups"):
        threads = [
            threading.Thread(target=worker, name=f"s2-device-feed-{i}")
            for i in range(n_threads)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    _items["scrub.panel_lookups"] += n_batches[0] * windows_per_batch
    if errs:
        raise errs[0]
    return counts


def _resume_counts(engine: TorchKmerEngine, index, paths: list[str], column: int,
                   checkpoint):
    """(device counts, files of ``paths`` still to count): the checkpoint's
    stored column and the files it has not recorded, or zeros and all of
    them.  Finished files are a multiset: a duplicate list entry counts
    again, as it does in an uninterrupted run."""
    from collections import Counter

    counts_np = checkpoint.counts(column) if checkpoint is not None else None
    if counts_np is None:
        return engine.init_counts(index), list(paths)
    if counts_np.shape[0] != index.table.num_slots:
        raise ValueError(
            f"scrub checkpoint {checkpoint.dir}: its counts have {counts_np.shape[0]} cells, "
            f"the {index.layout} table has {index.table.num_slots} slots: the checkpoint was "
            "counted in another table layout or size"
        )
    done = Counter(checkpoint.done_files(column))
    todo = []
    for path in paths:
        if done[path] > 0:
            done[path] -= 1
            continue
        todo.append(path)
    return engine.counts_from_numpy(index, counts_np), todo


def _count_files(engine: TorchKmerEngine, index, counts, todo: list[str],
                 cfg: ScrubCountConfig, column: int = 0, checkpoint=None):
    """Count every file of ``todo`` into the device ``counts``.  With a
    checkpoint, files count one after another and the whole buffer is
    saved after each: only that gives a snapshot that is complete per
    file, so the device-parallel feeder serves runs without one."""
    n_threads = _count_threads(len(todo))
    if checkpoint is None and len(todo) > 1 and n_threads > 1:
        try:
            return _count_files_device_parallel(engine, index, counts, todo, n_threads, cfg)
        except OSError as e:
            _exit_could_not_read(
                f"could not read file {getattr(e, 'filename', None) or e} "
                "in GEN_calculate_kmer_count()"
            )
    for path in todo:
        try:
            counts = count_panel_file(engine, index, counts, path, cfg.rows, cfg.row_len)
        except OSError:
            # reference src/genome_compare.c:196
            _exit_could_not_read(f"could not read file {path} in GEN_calculate_kmer_count()")
        if checkpoint is not None:
            checkpoint.record(column, path, engine.finalize_counts(counts))
    return counts


def _count_panel(engine: TorchKmerEngine, index: StrainIndex, list_path: str | None,
                 cfg: ScrubCountConfig, progress: IO | None,
                 skip_path: str | None = None, column: int = 0,
                 checkpoint=None) -> np.ndarray:
    """Count every file of one panel list into a fresh device column (or
    the checkpoint's stored one); returns per-key counts in
    first-encounter order."""
    todo: list[str] = []
    if list_path is not None:
        try:
            listed = read_list_file(list_path)
        except OSError:
            # reference src/genome_compare.c:125,159
            _exit_could_not_read(f"could not read file {list_path} in GEN_all_kmer_counts()")
        for path in listed:
            _progress_line(progress, path)
            if skip_path is not None and path == skip_path:
                print(f"skipping {path} (identical match)", file=sys.stderr)
                continue
            todo.append(path)
    counts, todo = _resume_counts(engine, index, todo, column, checkpoint)
    counts = _count_files(engine, index, counts, todo, cfg, column, checkpoint)
    return index.key_values(engine.finalize_counts(counts))


def run_scrub_count(r_file: str, a_list: str, b_list: str, c_list: str | None = None,
                    out: IO = None, progress: IO | None = None,
                    cfg: ScrubCountConfig | None = None,
                    index: StrainIndex | None = None,
                    checkpoint_dir: str | None = None) -> StrainIndex:
    """Full kmer_scrub_count stage; writes the count table to ``out`` and
    returns the strain index.  checkpoint_dir makes counting restartable
    at panel-file granularity (bit-identical to an uninterrupted run)."""
    import threading

    from strainer2_tpu_torch.constants import COL_DRUG, COL_METAGENOME, COL_PANGENOME

    cfg = cfg or ScrubCountConfig()
    out = out if out is not None else sys.stdout
    engine = TorchKmerEngine(cfg.k, device=cfg.device,
                             layout=index.layout if index is not None else cfg.layout)

    if index is None:
        with stage("scrub.index_build"):
            try:
                index = StrainIndex.from_fasta(r_file, engine, cfg.rows, cfg.row_len)
                index.table
            except OSError:
                # reference src/genome_compare.c:986 (no "in", as printed)
                _exit_could_not_read(
                    f"could not read file {r_file} GEN_hash_sequences_set_count_vec()"
                )

    ckpt = None
    if checkpoint_dir:
        from strainer2_tpu_torch.pipeline.progress import ScrubCheckpoint

        ckpt = ScrubCheckpoint(checkpoint_dir)

    # the djb2 row-order replay needs only the index: overlap it with the
    # panel scans
    order_box: list = []
    order_thread = None
    if cfg.reference_order:
        def _order_bg():
            try:
                order_box.append(reference_row_order(index.codes, index.k))
            except BaseException as e:  # surfaced at join
                order_box.append(e)

        order_thread = threading.Thread(target=_order_bg, name="scrub-row-order")
        order_thread.start()

    col_pan = _count_panel(engine, index, a_list, cfg, progress,
                           column=COL_PANGENOME, checkpoint=ckpt)
    col_meta = _count_panel(engine, index, b_list, cfg, progress,
                            column=COL_METAGENOME, checkpoint=ckpt)
    col_drug = (
        _count_panel(engine, index, c_list, cfg, progress, skip_path=r_file,
                     column=COL_DRUG, checkpoint=ckpt)
        if c_list
        else None
    )

    order = None
    if order_thread is not None:
        order_thread.join()
        if isinstance(order_box[0], BaseException):
            raise order_box[0]
        order = order_box[0]

    with stage("scrub.write_table", items=index.num_kmers):
        write_scrub_table(out, index, col_pan, col_meta, col_drug,
                          reference_order=cfg.reference_order, order=order)
    return index


def write_scrub_table(out: IO, index: StrainIndex, col_pan: np.ndarray,
                      col_meta: np.ndarray, col_drug: np.ndarray | None,
                      reference_order: bool = True, chunk: int = 200_000,
                      order: np.ndarray | None = None) -> None:
    """Emit the table (reference src/kmer_scrub_count.c:134-156): header is
    always 5 columns; rows have 4 columns without -C, 5 with."""
    import queue
    import threading

    from strainer2_tpu_torch.ops.packing_np import decode_codes_np

    out.write("#kmer\treference_count\tpangenome_count\tmetagenome_count\tdrug_count\n")
    if order is None:
        if reference_order:
            order = reference_row_order(index.codes, index.k)
        else:
            order = np.arange(index.num_kmers, dtype=np.int64)

    codes = index.codes[order]
    c0 = index.genome_counts[order]
    c1 = col_pan[order]
    c2 = col_meta[order]
    c3 = col_drug[order] if col_drug is not None else None

    raw = getattr(out, "buffer", None)
    if raw is not None:
        out.flush()  # keep the text-layer header ordered before raw writes

    # writer thread: native formatting (GIL released) overlaps the writes
    wq: queue.Queue = queue.Queue(maxsize=4)
    werr: list[BaseException] = []

    def _drain() -> None:
        while True:
            blob = wq.get()
            if blob is None:
                return
            if werr:
                continue  # keep consuming so the producer never blocks
            try:
                if raw is not None:
                    raw.write(blob)
                else:
                    out.write(blob.decode("ascii"))
            except BaseException as e:  # surfaced after join
                werr.append(e)

    writer = threading.Thread(target=_drain, name="scrub-table-writer")
    writer.start()
    start = 0
    try:
        for start in range(0, codes.shape[0], chunk):
            end = min(start + chunk, codes.shape[0])
            nat = native.format_scrub_rows(
                codes[start:end], c0[start:end], c1[start:end], c2[start:end],
                c3[start:end] if c3 is not None else None, index.k,
            )
            if nat is None or werr:
                break  # native library unavailable: Python fallback below
            wq.put(nat)
        else:
            start = codes.shape[0]
    finally:
        wq.put(None)
        writer.join()
    if werr:
        raise werr[0]

    for start in range(start, codes.shape[0], chunk):
        end = min(start + chunk, codes.shape[0])
        kmers = decode_codes_np(codes[start:end], index.k)
        if c3 is not None:
            rows = [
                f"{s}\t{a}\t{b}\t{c}\t{d}\n"
                for s, a, b, c, d in zip(
                    kmers, c0[start:end], c1[start:end], c2[start:end], c3[start:end]
                )
            ]
        else:
            rows = [
                f"{s}\t{a}\t{b}\t{c}\n"
                for s, a, b, c in zip(kmers, c0[start:end], c1[start:end], c2[start:end])
            ]
        out.write("".join(rows))
