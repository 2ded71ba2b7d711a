"""Multi-strain single-pass detection (``strainer2_tools detect-multi``) on
the torch engine.

Port of ``strainer2_tpu.pipeline.multi_detect``: up to 256 strains share one
union bucket table whose meta words carry two bits per strain (present,
informative; 16 strains per word, ceil(S/16) words per row), so one scan of
the target samples gives every strain's per-read hit counts.  Per batch the
device runs K6 (canonical windows, one probe, masked meta words) and K7
(per-read, per-strain sums), then a pass gate in plain torch: only when a
read or pair passes for some strain do the passing rows cross to the host,
where they are re-scanned to emit each strain's rows.  The per-strain files
are byte-identical to single-strain ``strain_detect`` runs.

With a checkpoint directory, or in a multi-process run
(parallel/distributed.py), samples run through the single-strain
detector's staged loop (``detect._staged_quantify``), one payload per
strain per sample: split across ranks by size, gathered, and written by
rank 0; the shared background panel is split and its counts summed.  With
``DetectConfig.mesh = (D, I)`` one process classifies over a (data, index)
device mesh (parallel/sharding.py): the union rows split along the index
axis, K6s on each shard, R adding the shards' words on each data shard's
first device, K7 on them; the device budget then multiplies by I where
each shard has a card of its own, as in the JAX detector, so a union that
outgrows one card runs over a host's cards (``mesh_mem_budget``).  A mesh
and a multi-process run cannot combine.

On ``--device cpu`` (the single-strain detector's route: the plain engine
on the CPU, the host library built, STRAINER2_NATIVE_COUNT not 0) the JAX
package's CPU route is taken: the shared background panel is counted by
the host library's fused counter over the union, each sample is
classified by its fused multi-strain classifier over the union's meta
words, the passing reads are read back with the read extractor and looked
up in the union, and samples are scored on the single-strain detector's
thread pool, written in list order.
"""

from __future__ import annotations

import gzip
import io
import os
import sys
from dataclasses import dataclass
from typing import IO

import numpy as np
import torch

from strainer2_tpu_torch import native
from strainer2_tpu_torch.constants import (
    INFORMATIVE_KMER,
    IS_PAIRED_END,
    IS_PAIRED_END_INTERLEAVE,
    NOT_PAIRED_END,
)
from strainer2_tpu_torch.index.bucket import build_bucket_table
from strainer2_tpu_torch.io.batches import (
    batch_read_grouping,
    max_reads_capacity,
    read_codes_from_batch,
)
from strainer2_tpu_torch.ops.lookup import META_LANE
from strainer2_tpu_torch.ops.packing_np import canonical_codes_np, decode_codes_np
from strainer2_tpu_torch.ops.segsum import words_for_strains
from strainer2_tpu_torch.parallel.distributed import (
    host_file_partition,
    merge_across_hosts,
    process_count,
    process_index,
)
from strainer2_tpu_torch.parallel.sharding import pad_rows
from strainer2_tpu_torch.pipeline.detect import (
    DetectConfig,
    StrainDetector,
    _aggregate_classify_chunk,
    _detect_threads,
    _evaluated_totals,
    _exit_unreadable_sample,
    _parse_batch_entries,
    _run_sample_pool,
    _staged_quantify,
    background_demote,
    strain_threads,
)
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine, resolve_device
from strainer2_tpu_torch.pipeline.scrub_count import (
    _use_native_counting,
    count_files_native_pooled,
    count_panel_file,
    read_list_file,
)
from strainer2_tpu_torch.utils.observability import stage
from strainer2_tpu_torch.utils.prefetch import prefetch

__all__ = [
    "MultiStrainDetector",
    "MAX_STRAINS_PER_PASS",
    "plan_strain_passes",
    "plan_strain_passes_from_codes",
    "projected_rows_bytes",
    "device_mem_budget",
    "mesh_mem_budget",
    "estimate_genome_kmers",
    "union_sorted",
    "union_sorted_many",
    "passing_any_pairs",
    "gather_passing_rows",
]

# 2 meta bits per strain, 16 strains per 16-lane meta block; a 256-strain
# pass uses 288-lane rows.  The count cap alone cannot bound device memory
# (the union row table costs num_buckets x row_width x 4 bytes), so passes
# are also sized by projected bytes against the device budget.
MAX_STRAINS_PER_PASS = 256

DEVICE_MEM_BUDGET_ENV = "STRAINER2_DEVICE_MEM_BUDGET"


def projected_rows_bytes(union_keys: int, n_strains: int) -> int:
    """Projected bucket row-table bytes for a union of ``union_keys``
    distinct k-mers carrying ``n_strains`` strains' meta bits: row_width =
    32 key lanes + 16 lanes per meta block, ceil(S/16) blocks (min 2);
    num_buckets = 2**h_bits with h_bits = ceil(log2(union/3.3)); 4 bytes
    per lane (the build of index/bucket.py)."""
    n_words = max(2, -(-int(n_strains) // 16))
    row_width = 32 + 16 * n_words
    h_bits = max(4, int(np.ceil(np.log2(max(int(union_keys), 1) / 3.3))))
    return (1 << h_bits) * row_width * 4


def device_mem_budget(device="cuda") -> int | None:
    """Byte budget for the multi-strain row table on ``device``, or None for
    unbounded: STRAINER2_DEVICE_MEM_BUDGET (bytes; float forms like 2e9
    accepted) first; None on the CPU (host RAM); else 75% of the card's
    memory as torch.cuda.mem_get_info reports it."""
    env = os.environ.get(DEVICE_MEM_BUDGET_ENV)
    if env:
        return int(float(env))
    dev = resolve_device(device)
    if dev.type == "cpu":
        return None
    return int(torch.cuda.mem_get_info(dev)[1] * 0.75)


def mesh_mem_budget(budget: int | None, mesh) -> int | None:
    """A card's ``budget`` for the union rows spread over ``mesh`` (None:
    one device).  Index shard i holds 1/I of the rows and a card holds
    every cell of the grid that names it, so the rows may reach budget *
    I / (cells on the busiest card): JAX's I where each cell has a card of
    its own (JAX multi_detect.py:405-445), budget / D where one card holds
    all D x I.  A CPU mesh keeps the factor I: its cells stand for XLA's
    virtual host devices, each with the STRAINER2_DEVICE_MEM_BUDGET bytes."""
    if budget is None or mesh is None:
        return budget
    n_index = mesh.shape["index"]
    if all(dev.type == "cpu" for dev in mesh.devices):
        return budget * n_index
    busiest = max(mesh.devices.count(dev) for dev in set(mesh.devices))
    return budget * n_index // busiest


_UNSET = object()


def plan_strain_passes(kmer_counts, *, max_strains=MAX_STRAINS_PER_PASS,
                       budget=_UNSET, index_shards: int = 1):
    """Split strains into contiguous passes bounded by both the strain
    count cap and the projected union row-table bytes, sizing each union
    by the sum of its strains' k-mer counts (an upper bound).

    budget: bytes (default device_mem_budget()); None disables the
    byte bound; index_shards multiplies it.  Returns (start, end) bounds
    covering range(len(kmer_counts)); a single strain over budget still
    gets its own pass (the detector's check reports it)."""
    if budget is _UNSET:
        budget = device_mem_budget()
    if budget is not None:
        budget = int(budget) * max(1, int(index_shards))
    passes = []
    start = 0
    n = len(kmer_counts)
    while start < n:
        end = start + 1
        total = int(kmer_counts[start])
        while end < n and end - start < max_strains:
            t = total + int(kmer_counts[end])
            if budget is not None and projected_rows_bytes(t, end - start + 1) > budget:
                break
            total = t
            end += 1
        passes.append((start, end))
        start = end
    return passes


def _gzip_total_uncompressed(path: str) -> int | None:
    """Exact total uncompressed length of a (possibly multi-member) gzip
    file, decoding every member and storing nothing; stops at trailing
    non-gzip bytes after a complete member.  None on a decode error."""
    import zlib

    total = 0
    d = zlib.decompressobj(wbits=31)
    try:
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                while chunk:
                    total += len(d.decompress(chunk))
                    if not d.eof:
                        break
                    chunk = d.unused_data
                    if not chunk.startswith(b"\x1f\x8b"):
                        return total
                    d = zlib.decompressobj(wbits=31)
    except zlib.error:
        return None
    if not d.eof:
        return None
    return total


def union_sorted(union: np.ndarray | None, codes_sorted: np.ndarray) -> np.ndarray:
    """Sorted distinct union of a sorted distinct ``union`` (or None) and
    sorted ``codes_sorted``: a stable sort of two sorted runs is a linear
    merge, about 3x faster than np.union1d at 20 M keys."""
    if union is None:
        merged = np.asarray(codes_sorted, dtype=np.uint64).copy()
    else:
        merged = np.concatenate([union, np.asarray(codes_sorted, dtype=np.uint64)])
        merged.sort(kind="stable")
    keep = np.ones(merged.shape[0], dtype=bool)
    keep[1:] = merged[1:] != merged[:-1]
    return merged[keep]


def union_sorted_many(arrays: list, threads: int = 8) -> np.ndarray:
    """Sorted distinct union of sorted distinct arrays: pairwise merges, a
    level at a time on a thread pool (numpy sorts without the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    level = list(arrays)
    if len(level) <= 1:
        return union_sorted(None, level[0] if level else np.empty(0, np.uint64))
    with ThreadPoolExecutor(max(1, threads)) as ex:
        while len(level) > 1:
            merged = list(ex.map(lambda i: union_sorted(level[i], level[i + 1]),
                                 range(0, len(level) - 1, 2)))
            if len(level) % 2:
                merged.append(level[-1])
            level = merged
    return level[0]


def plan_strain_passes_from_codes(codes_list, *, max_strains=MAX_STRAINS_PER_PASS,
                                  budget=_UNSET, index_shards: int = 1):
    """Exact pass planning from per-strain canonical-code arrays (or
    zero-arg callables returning them): merge codes strain by strain and
    cut a pass when the exact union's projected bytes exceed the budget.
    Same return shape as plan_strain_passes.  The unions are sorts and
    merges (union_sorted), not np.unique or np.union1d: numpy 2.3's
    np.unique is far slower than np.sort on millions of uint64 codes."""
    if budget is _UNSET:
        budget = device_mem_budget()
    if budget is not None:
        budget = int(budget) * max(1, int(index_shards))

    def get(i):
        c = codes_list[i]
        return np.sort(np.asarray(c() if callable(c) else c, dtype=np.uint64))

    passes = []
    start = 0
    n = len(codes_list)
    while start < n:
        union = union_sorted(None, get(start))
        end = start + 1
        while end < n and end - start < max_strains:
            cand = union_sorted(union, get(end))
            if budget is not None and projected_rows_bytes(cand.shape[0], end - start + 1) > budget:
                break
            union = cand
            end += 1
        passes.append((start, end))
        start = end
    return passes


def estimate_genome_kmers(path: str) -> int:
    """Upper bound of a genome's distinct canonical k-mers without a scan:
    the uncompressed byte size (all gzip members), else the gzip trailer,
    else the file size."""
    size = os.path.getsize(path)
    if path.endswith(".gz") and size >= 20:
        total = _gzip_total_uncompressed(path)
        if total:
            return total
        with open(path, "rb") as f:
            f.seek(-4, 2)
            isize = int.from_bytes(f.read(4), "little")
        if isize:
            return isize
    return size


@dataclass
class _StrainState:
    r_file: str
    a_file: str
    total_kmers: int
    total_informative: int
    num_marked: int = 0  # informative lines marked from the -a file


@dataclass
class _StrainKeys:
    """A strain's keys during set-up: sorted codes, its k-mer classes in key
    (first-encounter) order, and the order that sorts them."""
    codes_sorted: np.ndarray
    kmer_type: np.ndarray
    order: np.ndarray


class _UnionIndexView:
    """The part of StrainIndex that count_panel_file reads, over the union
    table (background counting)."""

    def __init__(self, table, k):
        self.table = table
        self.k = k


def passing_any_pairs(tot, inf, *, paired: bool, min_t: int, min_i: int):
    """(max_reads, S) per-read tot/inf -> (pairs,) bool: does any strain
    pass the two-threshold rule for this read or pair (reference
    src/strain_detect.c:403,406,547)?  Rows past the batch's reads are
    zero, so they never pass with thresholds >= 1.  Plain torch on the
    tensors' device: the host reads back these few KB, not the matrices."""
    if paired:
        passing = ((tot[0::2] + tot[1::2]) >= min_t) & ((inf[0::2] + inf[1::2]) >= min_i)
    else:
        passing = (tot >= min_t) & (inf >= min_i)
    return passing.any(dim=1)


def gather_passing_rows(tot, inf, sel, *, paired: bool):
    """(t1, i1, t2, i2) rows of the passing pairs ``sel`` (int64 pair
    ordinals on the tensors' device): the only part of the matrices the
    emission needs.  t2, i2 are zero for single-end reads."""
    if paired:
        return tot[2 * sel], inf[2 * sel], tot[2 * sel + 1], inf[2 * sel + 1]
    zero = torch.zeros((sel.shape[0], tot.shape[1]), dtype=tot.dtype, device=tot.device)
    return tot[sel], inf[sel], zero, zero


class MultiStrainDetector:
    """Score several strains against shared target streams in one pass."""

    # the single-strain stream plumbing, borrowed (native or Python packer)
    # as a class attribute: a bound method stored on the instance would make
    # a reference cycle, and the union rows would stay on the device after
    # the pass until the cycle collector ran
    _read_stream = StrainDetector._read_stream

    def __init__(self, strains: list[tuple[str, str]], cfg: DetectConfig | None = None,
                 stdout: IO | None = None, background_list: str | None = None,
                 prebuilt: "list[tuple[str, object, np.ndarray]] | None" = None,
                 indexes: "list | None" = None):
        """strains: (genome, scrubbed-kmer-file) pairs.  The fused
        multi-strain pipeline instead passes ``prebuilt``, (genome,
        StrainIndex, informative key indices) triples, skipping the genome
        re-scans and the scrubbed-file round trips.  ``indexes`` (exclusive
        with prebuilt) supplies each strain's StrainIndex while keeping the
        -a file marking (the detect-multi CLI hands over the ones its pass
        planner scanned, so each genome is read once)."""
        if prebuilt is not None:
            strains = [(r, None) for r, _, _ in prebuilt]
            indexes = [ix for _, ix, _ in prebuilt]
        if not 1 <= len(strains) <= MAX_STRAINS_PER_PASS:
            raise ValueError(f"1..{MAX_STRAINS_PER_PASS} strains per pass")
        self.cfg = cfg or DetectConfig()
        self.stdout = stdout if stdout is not None else sys.stdout
        self.max_reads = max_reads_capacity(self.cfg.k, self.cfg.rows, self.cfg.row_len)
        self.engine = TorchKmerEngine(self.cfg.k, self.max_reads, device=self.cfg.device)
        with stage("multi.strain_states"):
            keys = self._build_states(
                strains, indexes, [inf for _, _, inf in prebuilt] if prebuilt is not None else None
            )
        with stage("multi.union_table"):
            self._build_union(keys, background_list)

    def _build_states(self, strains, indexes, informative) -> list[_StrainKeys]:
        """Per-strain state through the single-strain constructor (the
        scrubbed-file marking and its diagnostics, or the given informative
        keys) into ``self.states``; returns each strain's keys.  Strains
        build on a worker pool; their stdout flushes in strain order."""

        def build_one(s):
            r_file, a_file = strains[s]
            buf = io.StringIO()
            try:
                det = StrainDetector(
                    r_file, a_file, self.cfg, stdout=buf,
                    index=indexes[s] if indexes is not None else None,
                    informative_keys=informative[s] if informative is not None else None,
                )
            except BaseException as e:
                e._s2_stdout = buf.getvalue()  # type: ignore[attr-defined]
                raise
            state = _StrainState(
                r_file=r_file,
                a_file=a_file,
                total_kmers=det.index.num_kmers,
                total_informative=int(np.count_nonzero(det.kmer_type == INFORMATIVE_KMER)),
                num_marked=det.num_informative_marked,
            )
            return state, _StrainKeys(det._sorted_codes, det.kmer_type, det._sorted_order), buf

        def flush(result):
            state, keys, buf = result
            self.stdout.write(buf.getvalue())
            self.states.append(state)
            out.append(keys)

        self.states: list[_StrainState] = []
        out: list[_StrainKeys] = []
        threads = strain_threads(len(strains))
        if threads > 1 and len(strains) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(threads) as ex:
                futures = [ex.submit(build_one, s) for s in range(len(strains))]
                for fu in futures:
                    try:
                        result = fu.result()
                    except BaseException as e:
                        self.stdout.write(getattr(e, "_s2_stdout", ""))
                        raise
                    flush(result)
        else:
            for s in range(len(strains)):
                try:
                    result = build_one(s)
                except BaseException as e:
                    self.stdout.write(getattr(e, "_s2_stdout", ""))
                    raise
                flush(result)
        return out

    def _build_union(self, keys: list[_StrainKeys], background_list) -> None:
        """Union of the strains' k-mers, its bucket table within the device
        budget, the shared background filter, and the rows on the device
        with every strain's two bits."""
        from concurrent.futures import ThreadPoolExecutor

        k = self.cfg.k
        n_strains = len(self.states)
        # the --device cpu route: the host library counts and classifies
        self._native_ok = self.cfg.mesh is None and _use_native_counting(self.engine)
        threads = strain_threads(n_strains)
        union = union_sorted_many([sk.codes_sorted for sk in keys], threads)
        # union position of each strain's sorted codes (sorted needles: a
        # searchsorted in key order is ~30x faster than in encounter order)
        with ThreadPoolExecutor(threads) as ex:
            pos_sorted = list(ex.map(lambda sk: np.searchsorted(union, sk.codes_sorted), keys))
        self._n_words = max(2, -(-n_strains // 16))

        mesh = None
        if self.cfg.mesh is not None:
            from strainer2_tpu_torch.parallel.sharding import make_mesh

            mesh = make_mesh(*self.cfg.mesh, devices=self.cfg.device)
        # the table shards over the mesh's index axis, on as many cards as
        # the mesh gives them
        budget = mesh_mem_budget(device_mem_budget(self.cfg.device), mesh)
        of = f" over the {self.cfg.mesh[0]}x{self.cfg.mesh[1]} mesh" if mesh else ""
        if budget is not None:
            needed = projected_rows_bytes(union.shape[0], n_strains)
            if needed > budget:
                raise RuntimeError(
                    f"multi-strain union row table needs {needed / 2**30:.2f} GiB "
                    f"({union.shape[0]:,} union keys, {n_strains} strains) but the device "
                    f"memory budget is {budget / 2**30:.2f} GiB{of}; run fewer strains per pass "
                    "(plan_strain_passes sizes passes from per-strain k-mer counts), shard the "
                    f"index over a larger mesh (--mesh DxI), or raise {DEVICE_MEM_BUDGET_ENV}"
                )
        self.table = build_bucket_table(union, k, row_width=32 + 16 * self._n_words)
        if budget is not None:
            # build_bucket_table grows h_bits on a bucket overflow, so the
            # built table can exceed the projection
            actual = self.table.table.nbytes
            if actual > budget:
                raise RuntimeError(
                    f"multi-strain union row table BUILT to {actual / 2**30:.2f} GiB "
                    f"(2**{self.table.h_bits} buckets x {self.table.table.shape[1]} lanes; the "
                    "build grew the bucket space beyond the pre-build projection for this key "
                    f"distribution) but the device memory budget is {budget / 2**30:.2f} GiB{of}; "
                    "run fewer strains per pass, shard the index over a larger mesh (--mesh "
                    f"DxI), or raise {DEVICE_MEM_BUDGET_ENV}"
                )

        if background_list:
            # one panel scan over the union, then each strain's reference
            # threshold logic (byte-identical to per-strain -g runs)
            self._background_filter_shared(union, keys, pos_sorted, background_list)
            for st, sk in zip(self.states, keys):
                st.total_informative = int(np.count_nonzero(sk.kmer_type == INFORMATIVE_KMER))

        # union meta words: word s // 16, bit 2 (s % 16) = strain s has this
        # k-mer, bit 2 (s % 16) + 1 = informative for strain s
        meta_words = np.zeros((words_for_strains(n_strains), union.shape[0]), dtype=np.uint32)
        for s, (sk, pos) in enumerate(zip(keys, pos_sorted)):
            w, sh = s // 16, np.uint32(2 * (s % 16))
            meta_words[w, pos] |= np.uint32(1) << sh
            inf = sk.kmer_type[sk.order] == INFORMATIVE_KMER
            meta_words[w, pos[inf]] |= np.uint32(1) << (sh + np.uint32(1))
        if self._native_ok:
            # the native classifier's keys and values, and the union the
            # passing reads are looked up in
            self._union_codes, self._union_meta_words = union, meta_words
        self._sharded = None
        if mesh is not None:
            # the union rows built on the host and split along the index axis
            # (JAX multi_detect.py:500-518): no card holds the whole table
            from strainer2_tpu_torch.parallel.sharding import ShardedKmerEngine

            t = self.table
            self._sharded = ShardedKmerEngine(k, mesh, t.h_bits, t.salt, t.num_slots,
                                              layout="bucket")
            slot_words = np.zeros((meta_words.shape[0], t.num_slots), dtype=np.uint32)
            slot_words[:, t.slot_of_key] = meta_words
            self._rows_dev = self._sharded.put_table(t.with_meta_words(list(slot_words)))
            return
        self._rows_dev = self._device_rows(meta_words)

    def _device_rows(self, meta_words: np.ndarray) -> torch.Tensor:
        """The union table on the device with meta word j of each key in lane
        32 + 16 j + cell of its row, scattered there (no host copy of the
        filled table)."""
        eng = self.engine
        t = self.table
        rows = torch.from_numpy(t.table).to(eng.device, copy=True)
        slot = eng.to_device(t.slot_of_key.astype(np.int64))
        flat = (slot // 16) * t.table.shape[1] + META_LANE + slot % 16
        lanes = rows.view(torch.int32).view(-1)  # CUDA torch scatters no uint32
        for j in range(meta_words.shape[0]):
            lanes[flat + 16 * j] = eng.to_device(meta_words[j].view(np.int32))
        return rows

    def _background_filter_shared(self, union: np.ndarray, keys: list[_StrainKeys], pos_sorted,
                                  background_list: str) -> None:
        """One background panel scan over the union, then each strain's
        threshold search; on the --device cpu route the host library's
        fused counter scans (JAX multi_detect.py:646-671)."""
        cfg = self.cfg
        eng = TorchKmerEngine(cfg.k, device=cfg.device)
        view = _UnionIndexView(self.table, cfg.k)
        # each rank counts its share; the sum gives every rank the same
        # demotions
        paths = host_file_partition(read_list_file(background_list), process_index(),
                                    process_count())
        nc = None
        if self._native_ok:
            try:
                nc = native.NativePanelCounter(union, self.table.slot_of_key, cfg.k)
            except (RuntimeError, MemoryError):
                nc = None
        per_slot = count_files_native_pooled(nc, paths, self.table.num_slots)
        if per_slot is None:
            counts = eng.init_counts(view)
            for path in paths:
                counts = count_panel_file(eng, view, counts, path, cfg.rows, cfg.row_len)
            per_slot = eng.finalize_counts(counts)
        per_slot = merge_across_hosts(per_slot)
        bg_union = per_slot[self.table.slot_of_key].astype(np.int64)  # union order
        for st, sk, pos in zip(self.states, keys, pos_sorted):
            bg = np.empty(sk.order.shape[0], dtype=np.int64)
            bg[sk.order] = bg_union[pos]  # back to the strain's key order
            background_demote(
                sk.kmer_type, bg, st.num_marked, cfg.fraction_background_to_remove,
                background_list, self.stdout,
            )

    def quantify_all(self, out_paths: list[str], batch_list: str,
                     checkpoint_dir: str | None = None) -> None:
        """One pass over every sample in the batch file; writes one
        kmer_hits gz file per strain.  checkpoint_dir makes the pass
        resumable at sample granularity, one payload per strain per
        sample.  In a multi-process run the samples are scored across
        ranks and rank 0 alone opens and writes the files."""
        pidx, pcount = process_index(), process_count()
        if pcount > 1 and self.cfg.mesh is not None:
            # the JAX detector's refusal (strainer2_tpu/pipeline/multi_detect.py:
            # 710-732): ranks partition samples, a mesh needs every batch
            print(
                "mesh sharding and multi-process sample partitioning cannot "
                "combine: run either one process with a device mesh, or one "
                "process per host (the default here)",
                file=sys.stderr,
            )
            raise SystemExit(1)
        n_strains = len(self.states)
        nc = self._native_multi_classifier()
        if nc is not None:
            def run_one(args, sinks):
                self._quantify_sample_native(nc, *args, sinks)
        else:
            def run_one(args, sinks):
                self._quantify_sample(*args, sinks)
        outs = [gzip.open(p, "wt", compresslevel=9) for p in out_paths] if pidx == 0 else []

        def emit(payloads):
            for o, payload in zip(outs, payloads):
                o.write(payload)

        def new_sinks():
            return [io.StringIO() for _ in range(n_strains)]

        try:
            entries = _parse_batch_entries(batch_list)
            if checkpoint_dir or pcount > 1:
                _staged_quantify(entries, run_one, new_sinks,
                                 lambda sinks: [b.getvalue() for b in sinks],
                                 emit, self.stdout, checkpoint_dir, pool_ok=nc is not None)
                return
            n_samples = sum(1 for kind, _ in entries if kind == "sample")
            threads = _detect_threads(n_samples)
            with stage("multi.score_samples"):
                if nc is not None and n_samples > 1 and threads > 1:
                    # the single-strain detector's pool: workers fill S
                    # per-strain buffers, the main thread writes them to
                    # the S gzip streams in list order
                    _run_sample_pool(entries, threads, new_sinks, run_one,
                                     lambda sinks: [b.getvalue() for b in sinks], emit,
                                     self.stdout)
                    return
                for kind, val in entries:
                    if kind == "msg":
                        self.stdout.write(val)
                    else:
                        self._quantify_sample(*val, outs)
        finally:
            for o in outs:
                o.close()

    def _native_multi_classifier(self):
        """The host library's fused multi-strain classifier over the union
        and its packed meta words (made once, kept; JAX
        multi_detect.py:519-546): word 1 goes in as ``values_hi`` above 16
        strains, words 2 and up as ``extra_words`` above 32.  None where
        the engine classifies (not the --device cpu route)."""
        if "_native_cls" not in self.__dict__:
            self._native_cls = None
            if self._native_ok:
                n_strains = len(self.states)
                words = self._union_meta_words
                try:
                    self._native_cls = native.NativeClassifier(
                        self._union_codes, words[0].view(np.int32), self.cfg.k,
                        values_hi=words[1].view(np.int32) if n_strains > 16 else None,
                        extra_words=([w.view(np.int32) for w in words[2:]]
                                     if n_strains > 32 else None),
                    )
                except (RuntimeError, MemoryError):
                    self._native_cls = None
        return self._native_cls

    def _quantify_sample_native(self, nc, f1: str, f2: str | None, ftype: int,
                                outs: list[IO]) -> None:
        """_quantify_sample on the native classifier (JAX
        multi_detect.py:549-640): per-read (n, S) rows from one fused pass;
        the pairing, thresholds, summary lines and diagnostics unchanged.
        The passing reads come back from the read extractor by ordinal, and
        each window's k-mer is looked up in the union, whose meta words say
        per strain whether it is an informative k-mer of that strain."""
        cfg = self.cfg
        k = cfg.k
        paired = ftype != NOT_PAIRED_END
        mode = 1 if ftype == IS_PAIRED_END else 2 if ftype == IS_PAIRED_END_INTERLEAVE else 0
        try:
            stream = nc.open_multi_stream(f1, f2, mode, len(self.states))
        except OSError as e:
            _exit_unreadable_sample(e, f1, f2)

        total_kmers_evaluated = 0
        total_reads_evaluated = 0
        odd_interleave = False
        base = 0
        ex1 = ex2 = None
        for lens, tot, inf in stream:
            n = lens.size
            if n % 2 and paired and ftype == IS_PAIRED_END_INTERLEAVE:
                odd_interleave = True
            ke, re_, pe1, t1, i1, t2, i2 = _aggregate_classify_chunk(lens, tot, inf, paired, k)
            total_kmers_evaluated += ke
            total_reads_evaluated += re_
            passing = ((t1 + t2) >= cfg.min_hits_for_good_match) & (
                (i1 + i2) >= cfg.min_hits_for_informative_read
            )  # (pairs, S)
            sel = np.flatnonzero(passing.any(axis=1))
            if sel.size:
                if ex1 is None:
                    ex1 = native.NativeReadExtractor(f1)
                    if ftype == IS_PAIRED_END:
                        ex2 = native.NativeReadExtractor(f2)
                reads = []  # (pair row, bases) in (pair, read) order
                for j, p in enumerate(pe1[sel]):
                    r1 = base + int(p)
                    if ftype == IS_PAIRED_END:
                        reads.append((j, ex1.read(r1 // 2, int(lens[p]))))
                        reads.append((j, ex2.read(r1 // 2, int(lens[p + 1]))))
                    else:
                        reads.append((j, ex1.read(r1, int(lens[p]))))
                        if paired:  # PEI: the mate is the next read of the same file
                            reads.append((j, ex1.read(r1 + 1, int(lens[p + 1]))))
                self._emit_native(outs, f1, reads, passing[sel],
                                  (t1[sel], i1[sel], t2[sel], i2[sel]))
            base += n
        pe2_early = stream.state == native.NativeClassifyStream.PE2_ENDED_EARLY
        for h in (ex1, ex2):
            if h is not None:
                h.close()
        stream.close()
        if pe2_early or odd_interleave:
            f2_name = f2 if ftype == IS_PAIRED_END else f1
            print(
                f"reached end of PE2 ({f2_name}) before end of PE1 ({f1}), "
                "check that file names are correct",
                file=sys.stderr,
            )
            raise SystemExit(1)
        for s, st in enumerate(self.states):
            outs[s].write("#%s\ttotal_kmer_evaluated\t%d\n" % (f1, total_kmers_evaluated))
            outs[s].write("#%s\ttotal_reads_evaluated\t%d\n" % (f1, total_reads_evaluated))
            outs[s].write("#%s\ttotal_genome_kmers\t%d\n" % (f1, st.total_kmers))
            outs[s].write("#%s\ttotal_genome_informative_kmers\t%d\n" % (f1, st.total_informative))

    def _emit_native(self, outs: list[IO], f1: str, reads: list, passing: np.ndarray,
                     sums) -> None:
        """Rows of a chunk's passing pairs from their re-read bases
        (``reads``: (pair row, bases) in (pair, read) order): each window's
        canonical k-mer is looked up in the union, whose meta words give it
        the per-strain bits K6 gives the device route."""
        k = self.cfg.k
        union = self._union_codes
        codes, valid, owner = [], [], []
        for j, bases in reads:
            ccodes, v = canonical_codes_np(bases, k)
            codes.append(ccodes)
            valid.append(v)
            owner.append(np.full(ccodes.size, j))
        codes = np.concatenate(codes)
        owner = np.concatenate(owner)
        pos = np.minimum(np.searchsorted(union, codes), union.size - 1)
        found = np.concatenate(valid) & (union[pos] == codes)
        words = np.where(found[:, None], self._union_meta_words[:, pos].T, np.uint32(0))
        self._write_rows(outs, f1, codes, owner, words, passing, sums)

    def _quantify_sample(self, f1: str, f2: str | None, ftype: int, outs: list[IO]) -> None:
        nc = self._native_multi_classifier()
        if nc is not None:
            return self._quantify_sample_native(nc, f1, f2, ftype, outs)
        cfg = self.cfg
        k = cfg.k
        paired = ftype != NOT_PAIRED_END
        t = self.table
        n_strains = len(self.states)
        total_kmers_evaluated = 0
        total_reads_evaluated = 0
        odd_interleave = False

        try:
            stream = prefetch(StrainDetector._batch_stream(self, f1, f2, ftype))
        except OSError as e:
            _exit_unreadable_sample(e, f1, f2)
        while True:
            try:
                batch = next(stream)
            except StopIteration:
                break
            except native.Pe2EndedEarlyError:
                print(
                    f"reached end of PE2 ({f2}) before end of PE1 ({f1}), "
                    "check that file names are correct",
                    file=sys.stderr,
                )
                raise SystemExit(1)
            except OSError as e:
                _exit_unreadable_sample(e, f1, f2)
            n = batch.n_reads
            # the padding reads are empty spans at the last read's end (its
            # windows are the flat run [start, start + len - k + 1)), not at
            # the window count: the sums are the same, since the windows
            # after it are padding with zero words, and K7 walks none of them
            boundaries = np.empty(self.max_reads + 1, dtype=np.int32)
            boundaries[:n] = batch.window_starts
            boundaries[n:] = batch.window_starts[n - 1] + max(0, int(batch.read_lengths[n - 1]) - k + 1)
            if n % 2 and paired and ftype == IS_PAIRED_END_INTERLEAVE:
                odd_interleave = True
            ke, re_, pe1 = _evaluated_totals(batch.read_lengths, paired, k)
            total_kmers_evaluated += ke
            total_reads_evaluated += re_
            if self._sharded is not None:
                self._sharded_batch(outs, f1, batch, boundaries, paired, pe1)
                continue
            words_d = self.engine.hit_words_batch(self._rows_dev, t.h_bits, t.salt, batch.bases,
                                                  n_strains)
            tot_d, inf_d = self.engine.strain_sums(words_d, boundaries, n_strains)
            # D2H gate: a (pairs,) bool crosses back per batch; only the
            # passing pairs' rows follow it
            n_pairs = (n - (n % 2)) // 2 if paired else n
            anyp = passing_any_pairs(
                tot_d, inf_d, paired=paired, min_t=cfg.min_hits_for_good_match,
                min_i=cfg.min_hits_for_informative_read,
            )[:n_pairs].cpu().numpy()
            sel = np.flatnonzero(anyp)
            if sel.size == 0:
                continue
            t1, i1, t2, i2 = (
                x.cpu().numpy()
                for x in gather_passing_rows(
                    tot_d, inf_d, torch.from_numpy(sel).to(tot_d.device), paired=paired
                )
            )
            passing = ((t1 + t2) >= cfg.min_hits_for_good_match) & (
                (i1 + i2) >= cfg.min_hits_for_informative_read
            )  # (passing pairs, S); row j is pair sel[j]
            self._emit_batch(outs, f1, batch, pe1[sel], paired, passing, (t1, i1, t2, i2),
                             lambda idx: words_d.view(torch.int32)[idx.to(words_d.device)]
                             .cpu().numpy().view(np.uint32))

        if odd_interleave:
            print(
                f"reached end of PE2 ({f1}) before end of PE1 ({f1}), "
                "check that file names are correct",
                file=sys.stderr,
            )
            raise SystemExit(1)
        for s, st in enumerate(self.states):
            outs[s].write("#%s\ttotal_kmer_evaluated\t%d\n" % (f1, total_kmers_evaluated))
            outs[s].write("#%s\ttotal_reads_evaluated\t%d\n" % (f1, total_reads_evaluated))
            outs[s].write("#%s\ttotal_genome_kmers\t%d\n" % (f1, st.total_kmers))
            outs[s].write("#%s\ttotal_genome_informative_kmers\t%d\n" % (f1, st.total_informative))

    def _sharded_batch(self, outs: list[IO], f1: str, batch, boundaries, paired: bool,
                       pe1: np.ndarray) -> None:
        """One batch over the mesh: the data shards' per-read partials summed
        on the host (the JAX full-matrix route, multi_detect.py:863-872),
        then the passing pairs' rows, their words read from the data shard
        that holds each window."""
        cfg = self.cfg
        n = batch.n_reads
        bases = pad_rows(batch.bases, self._sharded.n_data, 4)
        tot_p, inf_p, words = self._sharded.classify_multi_batch(
            self._rows_dev, bases, boundaries, len(self.states), with_words=True)
        tot, inf = tot_p.sum(axis=0)[:n], inf_p.sum(axis=0)[:n]
        if paired:
            t1, i1, t2, i2 = tot[pe1], inf[pe1], tot[pe1 + 1], inf[pe1 + 1]
        else:
            t1, i1 = tot, inf
            t2, i2 = np.zeros_like(t1), np.zeros_like(i1)
        passing = ((t1 + t2) >= cfg.min_hits_for_good_match) & (
            (i1 + i2) >= cfg.min_hits_for_informative_read
        )
        sel = np.flatnonzero(passing.any(axis=1))
        if not sel.size:
            return
        n_local = words[0].shape[0]

        def words_at(idx):
            out = np.empty((idx.shape[0], words[0].shape[1]), dtype=np.uint32)
            shard = (idx // n_local).numpy()
            for d in np.unique(shard):
                w = words[d].view(torch.int32)
                at = np.flatnonzero(shard == d)
                out[at] = w[(idx[torch.from_numpy(at)] - d * n_local).to(w.device)].cpu().numpy().view(
                    np.uint32)
            return out

        self._emit_batch(outs, f1, batch, pe1[sel], paired, passing[sel],
                         (t1[sel], i1[sel], t2[sel], i2[sel]), words_at)

    def _emit_batch(self, outs: list[IO], f1: str, batch, first_reads: np.ndarray, paired: bool,
                    passing: np.ndarray, sums, words_at) -> None:
        """Rows of the passing pairs of one batch, for every strain, in
        (pair, read, window) order.  A read's windows are the flat span
        [window_start, window_start + len - k + 1) of the batch, whose K6
        words already say, per strain s, whether the window's k-mer is a
        valid informative k-mer of s (bit 2 (s % 16) + 1 of word s // 16):
        the rows need no per-strain lookup, only the k-mer strings of the
        re-scanned reads.  ``words_at`` maps int64 flat window indices (a
        CPU tensor) to their (len, n_words) uint32 words."""
        k = self.cfg.k
        grouping = batch_read_grouping(batch)
        codes, spans, owner = [], [], []
        for j, r1 in enumerate(first_reads):
            for r in (r1, r1 + 1) if paired else (r1,):
                ccodes, _ = canonical_codes_np(read_codes_from_batch(batch, int(r), k, grouping), k)
                start = int(batch.window_starts[r])
                codes.append(ccodes)
                spans.append(np.arange(start, start + ccodes.size))
                owner.append(np.full(ccodes.size, j))
        codes = np.concatenate(codes)
        owner = np.concatenate(owner)
        words = words_at(torch.from_numpy(np.concatenate(spans)))
        self._write_rows(outs, f1, codes, owner, words, passing, sums)

    def _write_rows(self, outs: list[IO], f1: str, codes: np.ndarray, owner: np.ndarray,
                    words: np.ndarray, passing: np.ndarray, sums) -> None:
        """Each strain's rows: the windows (``codes``, of pair row
        ``owner``, with their (len, n_words) meta ``words``) that are
        informative k-mers of a strain the pair passes for, in window
        order."""
        k = self.cfg.k
        t1, i1, t2, i2 = sums
        for s in np.flatnonzero(passing.any(axis=0)):
            informative = (words[:, s // 16] >> np.uint32(2 * (s % 16) + 1)) & np.uint32(1)
            hits = np.flatnonzero(passing[owner, s] & (informative != 0))
            if hits.size:
                outs[s].write("".join(
                    f"{f1}\t{t1[j, s]}\t{i1[j, s]}\t{t2[j, s]}\t{i2[j, s]}\t{kmer}\n"
                    for j, kmer in zip(owner[hits], decode_codes_np(codes[hits], k))
                ))
