"""Device-only times of the kernels K1 (canonical_windows), K2
(bucket_lookup), K3 (count_step, and count_valid_step: K3 with its valid
count), K4 (classify_step), K5 (bucket_lookup_ring), K6 (multi_hit_words),
K7 (boundary_strain_sums), K8 (hit_accumulate), K9 (hit_stats), K10
(cuckoo_lookup) and the cuckoo instances of K3, K4, K8 and K9 at main-path
shapes, and the timer, data and bounds that chip_smoke.py uses for every
kernel.

    python strainer2_tpu_torch/tools/bench_kernels.py [--repo DIR] [--seed N] [--label L] \
        [--layout both|bucket|cuckoo] [--reduce | --shard | --select]

--repo names the checkout whose ``strainer2_tpu_torch`` is timed (default:
the one holding this file), so that two commits are compared in one call on
one card: unpack the other commit with ``git archive`` into a directory that
git ignores and run parent, change, change, parent.  Both use this file's
timer, data and bounds.  ``--layout bucket`` times the bucket kernels only
(a checkout without the cuckoo kernels), ``cuckoo`` K10 and the cuckoo
instances only; every cuckoo kernel runs beside its bucket twin on the
same batches and key set.  ``--reduce`` times R (shard_reduce) alone, at a
data shard's shapes of 256 x 4096 batches: K6s's words at S = 32 and 256
and K4s's scratch, over I = 2, 4 and 8 index shards' parts of seeded
words, each part a buffer of its own; beside R, torch's sum of the stacked
words and ``torch.stack`` of the parts alone (the copy the mesh made
before R).  A checkout whose R takes only the stack is timed on it.
``--shard`` times the shard-window kernels alone, in the layouts of
``--layout``: K4s (shard_classify_masks) on the ``targets`` batches and
K3s (shard_count_step) on the ``targets`` and ``count`` batches, each as
shard 0 of the table split into I = 1, 2 and 4 index shards and as its
no-probe pass (a one-bucket or one-slot shard that no window of the batch
probes: ``untouched_shard``), K4s also as a data shard's classify
program (I K4s launches, R, the sums launch), beside the one-device K4
and K3; and K6s (shard_multi_hit_words) on the ``targets`` batches at
S = 32 and 256, bucket layout only, the same way (its no-probe pass all
zero words) with a data shard's multi program (I K6s launches, R, K7),
beside the one-device K6.  ``--select`` times K4 then K4e
(classify_select_step: the passing reads and their rows chosen on the
device, as strain_detect's stage runs them, SE, thresholds 1 and 1) on the
``targets`` batches in the layouts of ``--layout``, beside K4 alone on the
same batches (``over_k4``: K4e's share of the call).

A 6.7 Mbp random genome gives the table (6.7 M keys, 64-lane rows, 5% of the
keys informative).  Three kinds of 256 x 4096 batch, 8 of each:
``count``, rows of random sequence, every other one a stretch of the
genome, 3% N bases (~39% of the windows valid, half of those hits), as
chip_smoke.py phase 2 makes its counting batches; ``phase2``, 150 bp reads
half from the genome with 3% N bases (~31% valid), as chip_smoke.py phase 2
makes its detection batches; and ``targets``, made like chip_smoke.py's
phase-4 targets and panel metagenomes: 1% of the reads from the genome,
0.1% N bases (~77% valid: 120 of the 151 windows a read spans, less the
few with an N; 1% of those hits).  K1 runs on ``count`` and ``targets``
bases; K2 and K5 (w = 8, d = 4, RING_CHUNK queries a block, as
chip_smoke.py phase 2 runs it) on the window codes of the ``count`` batches
(every window, valid or not, ~25% found: the query set of chip_smoke.py
phase 2), and on ``main`` sets, MAIN_QUERIES keys of the table each, all
present, as an ``-a`` file's k-mers are; K3 on ``count`` and
``targets``, K4 on ``phase2`` and ``targets`` (beside K3 on the same
batches: ``over_k3``, K4 - K3, the measure of a K4 form), K6 and K7 on
``phase2`` and ``targets`` at S = 16, 32, 96 and 256 strains (K7 on K6's
words), over rows widened with seeded meta words; K8, K9 and K3 with its
valid count on all three kinds at k = 20 (genome_compare's default, a
table of the same genome at k = 20) and k = 31, K9 with ``remaining`` at
half the batch's valid windows (``over_k8``, K9 - K8 on the same
batches), K3 with its valid count per batch into a tally kept across the
stream, and the tally's once-a-stream total (``valid_tally_total``,
"K3V_TOTAL") timed on its own.  The cuckoo table holds the same keys
(index/cuckoo.py's default size, (2H, 2) uint32) and, for K4, the same
classes in a slot-indexed array.

The timer is CUDA events around replays of one CUDA graph holding 5 rounds
of the 8 batches' launches, so it sees device time and no host launch cost;
the time is per wrapper call.  The bound is the least time the card could
take: the bytes the function must move (inputs read once, outputs written
once, per probed window the row's 64 bytes of key_hi lanes and, where the
key is found, its 64 bytes of key_lo lanes) over the H100's 3.35 TB/s.  In
the cuckoo layout the kernels read a slot of the table only where its
fingerprint is the query's: the bound counts the fingerprint array at
most once (min(2H bytes, a 32-byte sector for each of a valid window's
two slots)), a 32-byte table sector for each slot whose fingerprint
matched on the batch and, for K3, a count sector a hit; "unfiltered" is
the bound of the probe without the filter, two table sectors a valid
window, hit or miss.  The cuckoo lines also give the share of probed
slots whose fingerprint matched a key it is not ("false match").  A
checkout whose cuckoo kernels take no fingerprints is timed without them,
against the same bounds; ``fp`` times the fingerprint kernel once an
index.
Prints one line per kernel, batch kind and S, then one JSON line of the
same numbers; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

K = 31
ROWS, ROW_LEN = 256, 4096
GENOME_BP = 6_700_000
READ_LEN = 150
N_BATCHES = 8
ROUNDS = 5  # rounds of the N_BATCHES launches in one graph
REPLAYS = 3
S_SWEEP = (16, 32, 96, 256)
MAIN_QUERIES = 67_000  # the -a file's k-mers of chip_smoke.py's phase-4 strain, about
RING_CHUNK = 1024  # queries a K5 block (the wrapper's default)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
KEY_HALF_BYTES = 64  # the 16 key_hi (or the 16 key_lo) lanes of one bucket row
SECTOR_BYTES = 32  # the DRAM sector a cuckoo slot's 8-byte (hi, lo) pair sits in
BATCH_KINDS = {"phase2": (0.5, 0.03), "targets": (0.01, 0.001)}  # strain-read share, N rate
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

__all__ = [
    "BATCH_KINDS", "bound_ms", "graph_ms", "batch_stats", "count_batches", "detection_batches",
    "sample_reads", "multi_rows", "probe_bytes", "k1_bytes", "k2_bytes", "k3_bytes", "k4_bytes",
    "k4e_bytes", "k6_bytes", "k7_bytes", "k8_bytes", "k9_bytes", "k3v_bytes", "k10_bytes", "tally_bytes",
    "COMPARE_KS", "cuckoo_table_k", "fingerprints", "filter_stats", "fp_bytes", "fp_kw",
    "FilterStats", "shard_stats", "shard_probe_bytes", "untouched_shard",
]
COMPARE_KS = (20, 31)  # genome_compare's default k, and the port's


# ---- timer and bounds ----------------------------------------------------------

def graph_ms(fn, n_inputs: int = N_BATCHES, rounds: int = ROUNDS) -> float:
    """Device time per call of fn(i), from CUDA events around REPLAYS
    replays of one graph holding ``rounds`` rounds of fn(0..n_inputs-1)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for i in range(n_inputs):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for i in range(n_inputs):
                fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (REPLAYS * rounds * n_inputs)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


class FilterStats:
    """What a batch's cuckoo probes read through the fingerprint filter:
    probes (valid windows or queries), hits, the slots whose fingerprint
    matched (hits' slots included) and the table's slot count."""

    def __init__(self, probes: float, hits: float, matched: float, slots: int):
        self.probes, self.hits, self.matched, self.slots = probes, hits, matched, slots

    @property
    def false_match(self) -> float:
        """Share of probed slots whose fingerprint matched another key."""
        return (self.matched - self.hits) / (2 * self.probes) if self.probes else 0.0


def probe_bytes(probes: float, hits: float, layout: str = "bucket") -> float:
    """Key bytes a lookup must read.  Bucket rows: the 16 key_hi lanes of
    every probed row (a miss is settled there unless a key_hi matches),
    the 16 key_lo lanes where one does (counted as the hits).  Cuckoo
    without the filter ("unfiltered"): one 32-byte sector for each of a
    probe's two slots, hit or miss.  A FilterStats as ``probes`` counts
    the filtered cuckoo probe: fp_bytes."""
    if isinstance(probes, FilterStats):
        return fp_bytes(probes)
    if layout == "cuckoo":
        return 2 * SECTOR_BYTES * probes
    return KEY_HALF_BYTES * (probes + hits)


def fp_bytes(st: FilterStats) -> float:
    """The filtered cuckoo probe: the fingerprint array read at most once,
    min(2H bytes, a sector for each of every probe's two slots), and a
    32-byte table sector for each slot whose fingerprint matched."""
    return min(st.slots, 2 * SECTOR_BYTES * st.probes) + SECTOR_BYTES * st.matched


def k1_bytes(bases, k: int = K) -> int:
    """Bases read once, (hi, lo, valid) written: 9 bytes a window."""
    return bases.numel() + 9 * bases.shape[0] * (bases.shape[1] - k + 1)


def k2_bytes(queries: float, found: float) -> float:
    """(qhi, qlo) read, (found, slot, meta) written: 17 bytes a query; a
    probe a query, and a meta word a found one."""
    return 17 * queries + probe_bytes(queries, found) + 4 * found


def k10_bytes(queries) -> float:
    """(qhi, qlo) read, (found, slot) written: 13 bytes a query; a cuckoo
    probe a query (a FilterStats: the filtered probe)."""
    n = queries.probes if isinstance(queries, FilterStats) else queries
    return 13 * n + probe_bytes(queries, 0, "cuckoo")


def k3_bytes(bases, valid, hits: float, layout: str = "bucket") -> float:
    """Bases read, a probe per valid window, a count read and written per
    hit; the filtered cuckoo probe (``valid`` a FilterStats) a 32-byte
    count sector a hit."""
    if isinstance(valid, FilterStats):
        return bases.numel() + fp_bytes(valid) + SECTOR_BYTES * hits
    return bases.numel() + probe_bytes(valid, hits, layout) + 8 * hits


def k3v_bytes(bases, valid: float, hits: float, layout: str = "bucket") -> float:
    """K3's bytes, and the stream's int64 valid count read and written."""
    return k3_bytes(bases, valid, hits, layout) + 16


def tally_bytes(tally) -> int:
    """A tally's int64 slots read once, one int64 total written."""
    return 8 * tally.numel() + 8


def k6_bytes(bases, valid: float, hits: float, n_words: int) -> float:
    """Bases read, a probe per valid window, n_words meta words read per hit,
    n_words words written per window."""
    n_win = bases.shape[0] * (bases.shape[1] - K + 1)
    return bases.numel() + probe_bytes(valid, hits) + 4 * n_words * (hits + n_win)


def k4_bytes(bases, bounds, valid: float, hits: float, layout: str = "bucket") -> float:
    """Bases and boundaries read, a probe per valid window, a meta word per
    hit, (total, informative) int32 written per read."""
    reads = bounds.numel() - 1
    return (bases.numel() + 4 * bounds.numel() + probe_bytes(valid, hits, layout) + 4 * hits
            + 8 * reads)


def k4e_bytes(reads: int, units: float, rows: float, k: int = K) -> float:
    """K4e's own bytes beside K4's: the per-read (total, informative) read
    once (8 bytes a read), a tile's 32 bytes of informative words a passing
    unit and k bases a row read; 20 bytes a passing unit, 12 a row (code,
    read) and the two counts written."""
    return 8 * reads + (32 + 20) * units + (k + 12) * rows + 8


def k8_bytes(bases, valid, hits: float, layout: str = "bucket") -> float:
    """Bases read, a probe per valid window, the (2,) int64 accumulator read
    and written (one 32-byte sector)."""
    return bases.numel() + probe_bytes(valid, hits, layout) + 32


def k9_bytes(bases, valid: float, hits: float, layout: str = "bucket") -> float:
    """Bases read, a probe per valid window, four int32 out: the function
    needs no mask words, whatever scratch a kernel keeps."""
    return bases.numel() + probe_bytes(valid, hits, layout) + 16


def k7_bytes(words, bounds, n_strains: int) -> int:
    """The (Q, W) words and the boundaries read, two (R, S) int32 written."""
    reads = bounds.numel() - 1
    return 4 * words.numel() + 4 * bounds.numel() + 8 * reads * n_strains


# ---- data made from the seed ---------------------------------------------------

def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[..., ::-1]


def sample_reads(rng, genome: np.ndarray, n: int, strain_fraction: float) -> np.ndarray:
    """n reads of READ_LEN: a strain_fraction share sampled from ``genome``
    (either strand), the rest random sequence."""
    n_strain = int(n * strain_fraction)
    starts = rng.integers(0, genome.size - READ_LEN, size=n_strain)
    reads = rng.integers(0, 4, size=(n, READ_LEN), dtype=np.uint8)
    pos = rng.choice(n, size=n_strain, replace=False)
    strain = genome[starts[:, None] + np.arange(READ_LEN)]
    flip = rng.random(n_strain) < 0.5
    strain[flip] = revcomp(strain[flip])
    reads[pos] = strain
    return reads


def count_batches(rng, genome: np.ndarray, dev) -> list:
    """N_BATCHES (ROWS, ROW_LEN) counting batches on the device: random
    sequence, every other row a stretch of the genome, ~3% N bases."""
    import torch

    out = []
    for _ in range(N_BATCHES):
        bases = rng.integers(0, 4, size=(ROWS, ROW_LEN), dtype=np.uint8)
        for r in range(0, ROWS, 2):
            s = int(rng.integers(0, genome.size - ROW_LEN))
            bases[r] = genome[s : s + ROW_LEN]
        bases[rng.random(bases.shape) < 0.03] = 4
        out.append(torch.from_numpy(bases).to(dev))
    return out


def batch_stats(rows, h_bits: int, salt: int, bases, k: int = K) -> tuple[int, int, int]:
    """(valid windows, found queries over all windows, hits = found and
    valid) of one batch, from the plain versions."""
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops.packing import canonical_windows_plain

    hi, lo, valid = canonical_windows_plain(bases, k)
    found = L.bucket_lookup_plain(rows, h_bits, salt, hi, lo)[0]
    return int(valid.sum()), int(found.sum()), int((found & valid.bool()).sum())


def detection_batches(rng, genome: np.ndarray, kind: str, dev) -> list:
    """N_BATCHES (bases, bounds) device pairs of one kind, and their read
    counts: the first 256 x 4096 batch of 8000 reads each, bounds padded
    with the window count to max_reads_capacity + 1 entries."""
    import torch

    from strainer2_tpu_torch.io.batches import max_reads_capacity, pack_stream

    share, n_rate = BATCH_KINDS[kind]
    max_reads = max_reads_capacity(K, ROWS, ROW_LEN)
    out = []
    for _ in range(N_BATCHES):
        reads = sample_reads(rng, genome, 8000, share)
        reads[rng.random(reads.shape) < n_rate] = 4
        batch = next(pack_stream(iter(reads), K, ROWS, ROW_LEN, with_read_ids=True))
        bounds = np.full(max_reads + 1, ROWS * (ROW_LEN - K + 1), dtype=np.int32)
        bounds[: batch.n_reads] = batch.window_starts
        out.append((torch.from_numpy(batch.bases).to(dev), torch.from_numpy(bounds).to(dev),
                    batch.n_reads))
    return out


def _keys_k(genome: np.ndarray, k: int) -> np.ndarray:
    from strainer2_tpu_torch.ops.packing_np import canonical_codes_np

    codes, valid = canonical_codes_np(genome, k)
    return np.unique(codes[valid])


def table_k(genome: np.ndarray, k: int, dev):
    """The bucket table of the genome's k-mers at k (64 lanes, no meta) on
    the device, h_bits and salt."""
    import torch

    from strainer2_tpu_torch.index.bucket import build_bucket_table

    table = build_bucket_table(_keys_k(genome, k), k)
    return torch.from_numpy(table.table).to(dev), table.h_bits, table.salt


def fingerprints(hi, lo):
    """The cuckoo kernels' 8-bit slot fingerprint of keys (hi, lo), int64
    tensors holding uint32 values (ops/lookup.cuckoo_fingerprint_plain,
    pinned by tests/test_torch_cuckoo_fp.py): here, so that the batches of
    every checkout timed are counted alike."""
    from strainer2_tpu_torch.index.hashing import _mul32

    x = _mul32(hi, 0x2C1B3C6D) ^ _mul32(lo, 0x297A2D39) ^ 0x61C88647
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return (x ^ (x >> 16)) >> 24


def filter_stats(table, h_bits: int, salt: int, qhi, qlo) -> FilterStats:
    """FilterStats of cuckoo probes of (qhi, qlo) on ``table``."""
    import torch

    from strainer2_tpu_torch.index.hashing import cuckoo_slots_torch

    t = table.view(torch.int32)  # torch gathers no uint32; same bits
    h = table.shape[0] // 2
    qh = qhi.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ql = qlo.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    f = fingerprints(qh, ql)
    sh = qh ^ salt if salt else qh
    matched = hits = 0
    hit0 = None
    for which in (0, 1):
        s = cuckoo_slots_torch(sh, ql, h_bits, which) + which * h
        key = t[s].to(torch.int64) & 0xFFFFFFFF
        hit = (key[:, 0] == qh) & (key[:, 1] == ql)
        matched += int((fingerprints(key[:, 0], key[:, 1]) == f).sum())
        hits += int((hit if hit0 is None else hit & ~hit0).sum())  # a key in both slots: once
        hit0 = hit
    return FilterStats(qh.numel(), hits, matched, table.shape[0])


def batch_filter_stats(table, h_bits: int, salt: int, bases, k: int = K) -> FilterStats:
    """FilterStats of one batch's valid windows."""
    import torch

    from strainer2_tpu_torch.ops.packing import canonical_windows_plain

    hi, lo, valid = canonical_windows_plain(bases, k)
    mask = valid.reshape(-1).bool()
    return filter_stats(table, h_bits, salt, hi.view(torch.int32).reshape(-1)[mask],
                        lo.view(torch.int32).reshape(-1)[mask])


def mean_stats(stats: list) -> FilterStats:
    n = len(stats)
    return FilterStats(*(sum(getattr(x, a) for x in stats) / n
                         for a in ("probes", "hits", "matched")), stats[0].slots)


def shard_stats(layout: str, table, h: int, salt: int, lo: int, n: int, bases, fp=None) -> tuple:
    """What one index shard's probes of a batch read: (probes, hits,
    matched) over the valid windows whose bucket (cuckoo: slot, each of a
    window's two counted) lies in [lo, lo + n); hits are the windows whose
    key the shard holds, matched (cuckoo) the in-shard slots whose
    fingerprint is the window's."""
    import torch

    from strainer2_tpu_torch.index.hashing import cuckoo_slots_torch
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops.packing import canonical_windows_plain

    hi, lo_, valid = canonical_windows_plain(bases, K)
    m = valid.reshape(-1)
    qh, ql = (x.view(torch.int32).reshape(-1)[m].to(torch.int64) & 0xFFFFFFFF for x in (hi, lo_))
    shi = qh ^ salt
    if layout == "bucket":
        b = cuckoo_slots_torch(shi, ql, h, 0) - lo
        found = L.bucket_lookup_words_plain(table, h, salt, qh, ql, 1, lo)[0]
        return int(((b >= 0) & (b < n)).sum()), int(found.sum()), 0
    f = L.cuckoo_fingerprint_plain(qh, ql)
    probes = matched = 0
    fps = fp.to(torch.int64)
    for s in (cuckoo_slots_torch(shi, ql, h, 0) - lo,
              cuckoo_slots_torch(shi, ql, h, 1) + (1 << h) - lo):
        mine = (s >= 0) & (s < n)
        probes += int(mine.sum())
        matched += int((mine & (fps[torch.where(mine, s, 0)] == f)).sum())
    found = L.shard_cuckoo_lookup_plain(table, h, salt, lo, qh, ql)[0]
    return probes, int(found.sum()), matched


def shard_probe_bytes(layout: str, stats: tuple, n: int) -> float:
    """Key bytes of a shard's probes: bucket rows as ``probe_bytes``, the
    filtered cuckoo probe as ``fp_bytes`` over the shard's n slots."""
    probes, hits, matched = stats
    if layout == "bucket":
        return probe_bytes(probes, hits)
    return fp_bytes(FilterStats(probes / 2, hits, matched, n))


def untouched_shard(layout: str, table, meta, h_bits: int, salt: int, bases):
    """A one-bucket (cuckoo: one-slot) index shard of ``table`` that no
    valid window of ``bases`` probes: (lo, its rows or slots, its classes
    or None).  K4s on it is the no-probe pass: every window is settled by
    its hash alone and nothing of the table is read."""
    import torch

    from strainer2_tpu_torch.index.hashing import cuckoo_slots_torch
    from strainer2_tpu_torch.ops.packing import canonical_windows_plain

    hi, lo, valid = canonical_windows_plain(bases, K)
    m = valid.reshape(-1).bool()
    qh, ql = (x.view(torch.int32).reshape(-1)[m].to(torch.int64) & 0xFFFFFFFF for x in (hi, lo))
    sh = qh ^ salt if salt else qh
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=bases.device)
    touched[cuckoo_slots_torch(sh, ql, h_bits, 0)] = True
    if layout == "cuckoo":
        touched[cuckoo_slots_torch(sh, ql, h_bits, 1) + (1 << h_bits)] = True
    free = torch.nonzero(~touched)
    if not free.numel():
        raise ValueError("every bucket (slot) of the table is probed by the batch")
    s = int(free[0, 0])
    return s, table[s : s + 1], None if meta is None else meta[s : s + 1]


def fp_kw(L, table) -> dict:
    """The keyword that gives checkout L's cuckoo kernels the table's
    fingerprints: none where they take none."""
    return {"fp": L.cuckoo_fingerprints(table)} if hasattr(L, "cuckoo_fingerprints") else {}


def cuckoo_table_k(keys: np.ndarray, k: int, dev, kinds: np.ndarray | None = None):
    """The cuckoo table of ``keys`` on the device, h_bits, salt, and (with
    per-key ``kinds``) their slot-indexed class array on the device."""
    import torch

    from strainer2_tpu_torch.index.cuckoo import build_cuckoo

    table = build_cuckoo(keys, k)
    meta = None
    if kinds is not None:
        meta_np = np.zeros(table.num_slots, dtype=np.uint32)
        meta_np[table.slot_of_key] = kinds
        meta = torch.from_numpy(meta_np).to(dev)
    return torch.from_numpy(table.table).to(dev), table.h_bits, table.salt, meta


def _table(rng, dev):
    """Genome, its bucket table with 5% of the keys informative (64 lanes,
    on the device), h_bits, salt, the keys (sorted uint64 codes) and their
    classes."""
    import torch

    from strainer2_tpu_torch.index.bucket import build_bucket_table

    genome = rng.integers(0, 4, size=GENOME_BP, dtype=np.uint8)
    keys = _keys_k(genome, K)
    table = build_bucket_table(keys, K)
    key_kinds = np.where(rng.random(keys.size) < 0.05, 2, 1).astype(np.uint32)
    kinds = np.zeros(table.num_slots, dtype=np.uint32)
    kinds[table.slot_of_key] = key_kinds
    rows = torch.from_numpy(table.with_meta(kinds)).to(dev)
    return genome, rows, table.h_bits, table.salt, keys, key_kinds


def main_path_queries(rng, keys: np.ndarray, dev) -> list:
    """N_BATCHES (qhi, qlo) device sets of MAIN_QUERIES distinct keys drawn
    from ``keys``: all present, as the -a file's k-mers are."""
    import torch

    from strainer2_tpu_torch.ops.packing_np import split_code64_np

    out = []
    for _ in range(N_BATCHES):
        pick = keys[rng.choice(keys.size, size=MAIN_QUERIES, replace=False)]
        out.append(tuple(torch.from_numpy(x).to(dev) for x in split_code64_np(pick, K)))
    return out


def multi_rows(rows, n_words: int, seed: int):
    """The keys of ``rows`` widened to 32 + 16 max(2, n_words) lanes of
    seeded random meta words, on the device."""
    import torch

    keys = rows.view(torch.int32)[:, :32]
    width = 32 + 16 * max(2, n_words)
    gen = torch.Generator(device=rows.device)
    gen.manual_seed(seed)
    out = torch.empty((keys.shape[0], width), dtype=torch.int32, device=rows.device)
    out[:, :32] = keys
    out[:, 32:] = torch.randint(-2**31, 2**31, (keys.shape[0], width - 32), dtype=torch.int32,
                                device=rows.device, generator=gen)
    return out.view(torch.uint32)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bench(seed: int, label: str, layout: str = "both", reduce: bool = False,
          shard: bool = False, select: bool = False) -> dict:
    """Time the kernels of ``layout`` (both, bucket or cuckoo) on one seed's
    data: the same batches and keys whatever the layout; R alone with
    ``reduce``, K4s, K3s and K6s alone with ``shard``, K4 then K4e with
    ``select``."""
    import torch

    from strainer2_tpu_torch.ops.packing import canonical_windows_plain

    dev = torch.device("cuda")
    card = _card()
    result = {"label": label, "card": card}

    def report(kernel: str, key: str, ms: float, bound: float, **extra) -> None:
        result.setdefault(kernel, {})[key] = {"ms": ms, "bound_ms": bound, **extra}
        more = ""
        if "unfiltered_ms" in extra:
            more = (f", unfiltered {extra['unfiltered_ms']:.4f} ms "
                    f"(share {extra['unfiltered_ms'] / ms:.3f}), false match "
                    f"{extra['false_match']:.5f}")
        for over in ("over_k3", "over_k4", "over_k8", "stacked_ms", "stack_ms", "library_ms", "no_probe_ms",
                     "program_ms"):
            if over in extra:
                more += f", {over} {extra[over]:.4f} ms"
        print(f"[{label}] {kernel.upper()} {key}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"(share {bound / ms:.3f}){more}", flush=True)

    if reduce:
        print(f"[{label}] card: {card}", flush=True)
        reduce_kernels(report, dev, seed)
        return result
    rng = np.random.default_rng(seed)
    genome, rows, h_bits, salt, keys, key_kinds = _table(rng, dev)
    print(f"[{label}] card: {card}; table {keys.size} keys, rows {tuple(rows.shape)}", flush=True)
    batches = {kind: detection_batches(rng, genome, kind, dev) for kind in BATCH_KINDS}
    if select:
        select_kernels(layout, genome, rows, h_bits, salt, keys, key_kinds, batches["targets"],
                       report)
        return result
    if shard:
        tables = {}
        if layout != "cuckoo":
            tables["bucket"] = (rows, None, h_bits, salt)
        if layout != "bucket":
            ctable, ch, csalt, cmeta = cuckoo_table_k(keys, K, dev, key_kinds)
            tables["cuckoo"] = (ctable, cmeta, ch, csalt)
        count_bases = {"targets": [b for b, _, _ in batches["targets"]],
                       "count": count_batches(rng, genome, dev)}
        if "bucket" in tables:  # before any cuckoo launch: see shard_words_kernels
            shard_words_kernels(rows, h_bits, salt, batches, report)
        shard_kernels(tables, batches, report)
        shard_count_kernels(tables, count_bases, report)
        return result
    bases = {"count": count_batches(rng, genome, dev), "targets": [b for b, _, _ in batches["targets"]]}
    bases.update(phase2=[b for b, _, _ in batches["phase2"]])
    stats = {kind: [sum(x) / N_BATCHES for x in zip(*(batch_stats(rows, h_bits, salt, b) for b in bs))]
             for kind, bs in bases.items()}
    main_q = main_path_queries(rng, keys, dev)
    codes = [canonical_windows_plain(b, K)[:2] for b in bases["count"]]
    if layout != "cuckoo":
        bucket_kernels(rows, h_bits, salt, bases, batches, stats, codes, main_q, report)
        compare_kernels(genome, bases, report, dev)
    if layout != "bucket":
        del rows
        torch.cuda.empty_cache()
        cuckoo_kernels(genome, keys, key_kinds, bases, batches, stats, codes, main_q, report, dev)
    return result


def bucket_kernels(rows, h_bits, salt, bases, batches, stats, codes, main_q, report) -> None:
    """K1-K7 on the bucket table and the batches of each kind."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops import segsum as G
    from strainer2_tpu_torch.ops.packing import canonical_windows

    dev = rows.device
    for kind in ("count", "targets"):
        bs = bases[kind]
        ms = graph_ms(lambda i: canonical_windows(bs[i], K))
        report("k1", kind, ms, bound_ms(k1_bytes(bs[0])))
    for kind, qs in (("count", codes), ("main", main_q)):
        n = qs[0][0].numel()
        found = stats["count"][1] if kind == "count" else n
        ms = graph_ms(lambda i: L.bucket_lookup(rows, h_bits, salt, *qs[i]))
        report("k2", kind, ms, bound_ms(k2_bytes(n, found)), queries=n, found=found)
        # K5 takes whole blocks of RING_CHUNK queries: the first n_ring of each set
        n_ring = n // RING_CHUNK * RING_CHUNK
        ring = [(qh.reshape(-1)[:n_ring], ql.reshape(-1)[:n_ring]) for qh, ql in qs]
        ms = graph_ms(lambda i: L.bucket_lookup_ring(rows, h_bits, salt, *ring[i], chunk=RING_CHUNK))
        report("k5", kind, ms, bound_ms(k2_bytes(n_ring, found * n_ring / n)), queries=n_ring,
               found=found * n_ring / n)
    counts = torch.zeros(rows.shape[0] * 16, dtype=torch.uint32, device=dev)
    for kind in ("count", "targets"):
        bs = bases[kind]
        valid, _, hits = stats[kind]
        ms = graph_ms(lambda i: L.count_step(counts, rows, bs[i], h_bits, salt, K))
        report("k3", kind, ms, bound_ms(k3_bytes(bs[0], valid, hits)), valid=valid, hits=hits)
    for kind, bs in batches.items():
        valid, _, hits = stats[kind]
        ms3 = graph_ms(lambda i: L.count_step(counts, rows, bs[i][0], h_bits, salt, K))
        ms = graph_ms(lambda i: L.classify_step(rows, bs[i][0], bs[i][1], h_bits, salt, K))
        report("k4", kind, ms, bound_ms(k4_bytes(bs[0][0], bs[0][1], valid, hits)),
               over_k3=ms - ms3, valid=valid, hits=hits)
    del counts
    for n_strains in S_SWEEP:
        n_words = G.words_for_strains(n_strains)
        mrows = multi_rows(rows, n_words, seed=n_strains)
        for kind, bs in batches.items():
            valid, _, hits = stats[kind]
            key = f"{kind} S={n_strains}"
            ms = graph_ms(lambda i: G.multi_hit_words(mrows, bs[i][0], h_bits, salt, K, n_words))
            report("k6", key, ms, bound_ms(k6_bytes(bs[0][0], valid, hits, n_words)))
            words = [G.multi_hit_words(mrows, b, h_bits, salt, K, n_words) for b, _, _ in bs]
            ms = graph_ms(lambda i: G.boundary_strain_sums(words[i], bs[i][1], n_strains))
            report("k7", key, ms, bound_ms(k7_bytes(words[0], bs[0][1], n_strains)))
            del words
        del mrows
        torch.cuda.empty_cache()


def select_kernels(layout: str, genome, rows, h_bits: int, salt: int, keys, key_kinds, bs,
                   report) -> None:
    """K4 then K4e (--select) on the ``targets`` batches ``bs``, SE, thresholds
    1 and 1, in the layouts of ``layout``, beside K4 alone: the bound is
    K4's bytes and K4e's own (k4e_bytes: the batches' mean passing units
    and rows); ``over_k4`` is K4e's time."""
    from strainer2_tpu_torch.ops import lookup as L

    dev = rows.device
    stats = [sum(x) / N_BATCHES for x in zip(*(batch_stats(rows, h_bits, salt, b) for b, _, _ in bs))]
    valid, _, hits = stats
    sel_kw = [dict(n_reads=n, paired=False, min_t=1, min_i=1) for _, _, n in bs]
    steps = {}
    if layout != "cuckoo":
        steps["k4e"] = (
            lambda i: L.classify_step(rows, bs[i][0], bs[i][1], h_bits, salt, K),
            lambda i: L.classify_select_step(rows, bs[i][0], bs[i][1], h_bits, salt, K,
                                             **sel_kw[i]),
            valid)
    if layout != "bucket":
        table, ch, csalt, meta = cuckoo_table_k(keys, K, dev, key_kinds)
        fp = fp_kw(L, table)
        steps["k4e_cuckoo"] = (
            lambda i: L.cuckoo_classify_step(table, meta, bs[i][0], bs[i][1], ch, csalt, K, **fp),
            lambda i: L.cuckoo_classify_select_step(table, meta, bs[i][0], bs[i][1], ch, csalt,
                                                    K, **sel_kw[i], **fp),
            mean_stats([batch_filter_stats(table, ch, csalt, b) for b, _, _ in bs]))
    for name, (k4, k4e, probes) in steps.items():
        counts = [k4e(i).counts.tolist() for i in range(N_BATCHES)]
        units, n_rows = (sum(x) / N_BATCHES for x in zip(*counts))
        reads = sum(n for _, _, n in bs) / N_BATCHES
        ms4 = graph_ms(k4)
        ms = graph_ms(k4e)
        n_bytes = k4_bytes(bs[0][0], bs[0][1], probes, hits) + k4e_bytes(reads, units, n_rows)
        report(name, "targets", ms, bound_ms(n_bytes), over_k4=ms - ms4, k4_ms=ms4, reads=reads,
               units=units, rows=n_rows)


REDUCE_SHARDS = (2, 4, 8)  # I in --reduce


def reduce_kernels(report, dev, seed: int) -> None:
    """R at a data shard's shapes (--reduce): K6s's words at S = 32 and
    256, K4s's scratch (16 words and a count word a tile), over I parts of
    seeded words; N_BATCHES sets, so that no set sits in the L2."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops.segsum import words_for_strains

    n_win = ROWS * (ROW_LEN - K + 1)
    tiles = ROWS * -(-(ROW_LEN - K + 1) // 256)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = [(f"words S={s}", n_win * words_for_strains(s), False) for s in (32, 256)]
    for name, n, masks in shapes + [("masks", 16 * tiles, True)]:
        for n_index in REDUCE_SHARDS:
            parts = [[torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                                    generator=gen).view(torch.uint32) for _ in range(n_index)]
                     for _ in range(N_BATCHES)]
            stacks = [torch.stack([p.view(torch.int32) for p in ps]).view(torch.uint32)
                      for ps in parts]
            try:
                L.shard_reduce(parts[0], masks=masks)
                inputs = parts
            except (AttributeError, ValueError):  # an R that takes the stack alone
                inputs = stacks
            n_bytes = 4 * (n_index + 1) * n + (4 * tiles if masks else 0)
            extra = {
                "stacked_ms": graph_ms(lambda i: L.shard_reduce(stacks[i], masks=masks)),
                "stack_ms": graph_ms(lambda i: torch.stack([p.view(torch.int32)
                                                            for p in parts[i]])),
            }
            if not masks:
                extra["library_ms"] = graph_ms(
                    lambda i: stacks[i].view(torch.int32).sum(dim=0, dtype=torch.int32))
            ms = graph_ms(lambda i: L.shard_reduce(inputs[i], masks=masks))
            report("r", f"{name} I={n_index}", ms, bound_ms(n_bytes),
                   on="list" if inputs is parts else "stack", **extra)
            del parts, stacks, inputs
            torch.cuda.empty_cache()


SHARD_SWEEP = (1, 2, 4)  # I in --shard


def shard_kernels(tables: dict, batches: list, report) -> None:
    """K4s alone (--shard), on the ``targets`` batches, in each layout of
    ``tables`` (layout -> table, meta, h_bits, salt): the one-device K4,
    then at each I of SHARD_SWEEP shard 0's K4s, the no-probe pass (K4s on
    a one-bucket or one-slot shard that no window of the batch probes:
    ``untouched_shard``) and a data shard's classify program (I K4s
    launches, R, the sums launch; at I = 1 no R)."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.parallel.sharding import shard_table

    bs = batches["targets"]
    tiles = L.n_tiles(ROWS, ROW_LEN, K)
    out_bytes = 68 * tiles  # K4's scratch: 16 mask words and a count word a tile
    for layout, (table, meta, h, salt) in tables.items():
        cuckoo = layout == "cuckoo"
        name = "k4s_cuckoo" if cuckoo else "k4s"

        def masks(sh_table, sh_meta, lo, fp):
            if cuckoo:
                return lambda i: L.shard_cuckoo_classify_masks(sh_table(i), sh_meta(i), lo(i),
                                                               bs[i][0], h, salt, K, fp=fp(i))
            return lambda i: L.shard_classify_masks(sh_table(i), lo(i), bs[i][0], h, salt, K)

        def stats(lo, n, t, fp=None):
            return [sum(x) / N_BATCHES for x in zip(*(shard_stats(layout, t, h, salt, lo, n, b, fp)
                                                      for b, _, _ in bs))]

        fp_all = L.cuckoo_fingerprints(table) if cuckoo else None
        probes, hits, matched = stats(0, table.shape[0], table, fp_all)
        if cuckoo:
            one = lambda i: L.cuckoo_classify_step(table, meta, bs[i][0], bs[i][1], h, salt, K,  # noqa: E731
                                                   fp=fp_all)
        else:
            one = lambda i: L.classify_step(table, bs[i][0], bs[i][1], h, salt, K)  # noqa: E731
        n_bytes = (bs[0][0].numel() + 4 * bs[0][1].numel()
                   + shard_probe_bytes(layout, (probes, hits, matched), table.shape[0]) + 4 * hits
                   + 8 * (bs[0][1].numel() - 1))
        report("k4_cuckoo" if cuckoo else "k4", "targets", graph_ms(one), bound_ms(n_bytes))
        free = [untouched_shard(layout, table, meta, h, salt, b) for b, _, _ in bs]
        free_fp = [L.cuckoo_fingerprints(t) if cuckoo else None for _, t, _ in free]
        no_probe = masks(lambda i: free[i][1], lambda i: free[i][2], lambda i: free[i][0],
                         lambda i: free_fp[i])
        for i in range(N_BATCHES):
            if any(int(x.view(torch.int32).ne(0).sum()) for x in no_probe(i)):
                raise AssertionError(f"{name}: a window hit in a shard that holds no probed key")
        no_probe_ms = graph_ms(no_probe)
        no_probe_bound = bound_ms(bs[0][0].numel() + out_bytes)
        for n_index in SHARD_SWEEP:
            shards = shard_table(table, layout, n_index, meta)
            fps = [L.cuckoo_fingerprints(sh.table) if cuckoo else None for sh in shards]
            per = shards[0].table.shape[0]
            probes, hits, matched = stats(0, per, shards[0].table, fps[0])
            ks = [masks(lambda i, sh=sh: sh.table, lambda i, sh=sh: sh.meta,
                        lambda i, sh=sh: sh.lo, lambda i, fp=fp: fp) for sh, fp in zip(shards, fps)]

            def program(i, ks=ks):  # a data shard's classify: I K4s launches, R, the sums launch
                ms = [k4s(i) for k4s in ks]
                scratch = ms[0] if len(ms) == 1 else L.shard_reduce([m for m, _ in ms], masks=True)
                return L.classify_sums(*scratch, (ROWS, ROW_LEN), K, bs[i][1])

            n_bytes = (bs[0][0].numel() + shard_probe_bytes(layout, (probes, hits, matched), per)
                       + 4 * hits + out_bytes)
            report(name, f"targets I={n_index}", graph_ms(ks[0]), bound_ms(n_bytes),
                   no_probe_ms=no_probe_ms, no_probe_bound_ms=no_probe_bound,
                   program_ms=graph_ms(program), probes=probes, hits=hits)
            del shards, fps, ks
            torch.cuda.empty_cache()
        del free, free_fp, fp_all


def shard_count_kernels(tables: dict, bases: dict, report) -> None:
    """K3s alone (--shard), on the batches of each kind of ``bases`` (kind
    -> N_BATCHES device batches), in each layout of ``tables`` as
    ``shard_kernels`` takes them: the one-device K3, then at each I of
    SHARD_SWEEP shard 0's K3s into its own counts, beside its no-probe
    pass (K3s on a one-bucket or one-slot shard that no window of the
    batch probes: ``untouched_shard``; its counts stay zero)."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.parallel.sharding import shard_table

    for layout, (table, meta, h, salt) in tables.items():
        cuckoo = layout == "cuckoo"
        cells = 1 if cuckoo else 16  # count cells a bucket (slot) of the table

        def k3s(sh_table, lo, fp, counts, bs):
            if cuckoo:
                return lambda i: L.shard_cuckoo_count_step(counts, sh_table(i), lo(i), bs[i], h, salt,
                                                           K, fp=fp(i))
            return lambda i: L.shard_count_step(counts, sh_table(i), lo(i), bs[i], h, salt, K)

        def n_bytes(bs, lo, n, t, fp=None):
            """Bases, the probes of shard [lo, lo + n), a count read and
            written a hit (a 32-byte sector in the cuckoo layout)."""
            st = [sum(x) / N_BATCHES for x in zip(*(shard_stats(layout, t, h, salt, lo, n, b, fp)
                                                    for b in bs))]
            return bs[0].numel() + shard_probe_bytes(layout, st, n) + (32 if cuckoo else 8) * st[1]

        fp_all = L.cuckoo_fingerprints(table) if cuckoo else None
        for kind, bs in bases.items():
            counts = torch.zeros(table.shape[0] * cells, dtype=torch.uint32, device=table.device)
            if cuckoo:
                one = lambda i: L.cuckoo_count_step(counts, table, bs[i], h, salt, K, fp=fp_all)  # noqa: E731
            else:
                one = lambda i: L.count_step(counts, table, bs[i], h, salt, K)  # noqa: E731
            report("k3_cuckoo" if cuckoo else "k3", f"{kind} beside K3s", graph_ms(one),
                   bound_ms(n_bytes(bs, 0, table.shape[0], table, fp_all)))
            free = [untouched_shard(layout, table, meta, h, salt, b) for b in bs]
            free_fp = [L.cuckoo_fingerprints(t) if cuckoo else None for _, t, _ in free]
            zero = torch.zeros(cells, dtype=torch.uint32, device=table.device)
            no_probe = k3s(lambda i: free[i][1], lambda i: free[i][0], lambda i: free_fp[i], zero, bs)
            no_probe_ms = graph_ms(no_probe)
            if int(zero.view(torch.int32).ne(0).sum()):
                raise AssertionError(f"K3s {layout} {kind}: a hit counted in a shard that holds no "
                                     "probed key")
            no_probe_bound = bound_ms(bs[0].numel())
            for n_index in SHARD_SWEEP:
                shards = shard_table(table, layout, n_index)
                sh = shards[0]
                fp = L.cuckoo_fingerprints(sh.table) if cuckoo else None
                per = sh.table.shape[0]
                c = torch.zeros(per * cells, dtype=torch.uint32, device=table.device)
                ms = graph_ms(k3s(lambda i: sh.table, lambda i: sh.lo, lambda i: fp, c, bs))
                report("k3s_cuckoo" if cuckoo else "k3s", f"{kind} I={n_index}", ms,
                       bound_ms(n_bytes(bs, sh.lo, per, sh.table, fp)), no_probe_ms=no_probe_ms,
                       no_probe_bound_ms=no_probe_bound)
                del shards, sh, fp, c
                torch.cuda.empty_cache()
            del counts, free, free_fp, zero
        del fp_all


SHARD_STRAINS = (32, 256)  # K6s's S in --shard


def shard_words_kernels(rows, h: int, salt: int, batches: dict, report) -> None:
    """K6s alone (--shard), on the ``targets`` batches over ``rows``
    widened to S strains of seeded meta words (``multi_rows``), at each S
    of SHARD_STRAINS: the one-device K6, then at each I of SHARD_SWEEP
    shard 0's K6s beside its no-probe pass (K6s on a one-bucket shard that
    no window of the batch probes: ``untouched_shard``; every word zero)
    and a data shard's multi program (I K6s launches, R, K7; at I = 1 no
    R).  Bounds as chip_smoke.py phase 2c counts them: the bases, the
    shard's probes, n_words meta words read a hit and written a window.
    ``bench`` runs this before any cuckoo kernel: a cuckoo probe's L2
    window leaves the fingerprint array's lines persisting in the L2 for
    the rest of the process, and with them there K6 and K6s took 15-41%
    longer at S = 256 (PERF.md §6)."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops import segsum as G
    from strainer2_tpu_torch.parallel.sharding import shard_table

    bs = batches["targets"]
    n_win = ROWS * (ROW_LEN - K + 1)
    for n_strains in SHARD_STRAINS:
        n_words = G.words_for_strains(n_strains)
        wide = multi_rows(rows, n_words, seed=n_strains)

        def stats(lo, n, t):
            return [sum(x) / N_BATCHES for x in zip(*(shard_stats("bucket", t, h, salt, lo, n, b)
                                                      for b, _, _ in bs))]

        def n_bytes(probes, hits, n):
            return (bs[0][0].numel() + shard_probe_bytes("bucket", (probes, hits, 0), n)
                    + 4 * n_words * (hits + n_win))

        probes, hits, _ = stats(0, wide.shape[0], wide)
        report("k6", f"targets S={n_strains} beside K6s",
               graph_ms(lambda i: G.multi_hit_words(wide, bs[i][0], h, salt, K, n_words)),
               bound_ms(n_bytes(probes, hits, wide.shape[0])))
        free = [untouched_shard("bucket", wide, None, h, salt, b) for b, _, _ in bs]
        no_probe = lambda i: G.shard_multi_hit_words(free[i][1], free[i][0], bs[i][0], h, salt, K,  # noqa: E731
                                                     n_words)
        for i in range(N_BATCHES):
            if int(no_probe(i).view(torch.int32).ne(0).sum()):
                raise AssertionError(f"K6s S={n_strains}: a word set in a shard that holds no "
                                     "probed key")
        no_probe_ms = graph_ms(no_probe)
        no_probe_bound = bound_ms(bs[0][0].numel() + 4 * n_words * n_win)
        for n_index in SHARD_SWEEP:
            shards = shard_table(wide, "bucket", n_index)
            per = shards[0].table.shape[0]
            probes, hits, _ = stats(0, per, shards[0].table)
            ks = [lambda i, sh=sh: G.shard_multi_hit_words(sh.table, sh.lo, bs[i][0], h, salt, K,
                                                           n_words) for sh in shards]

            def program(i, ks=ks, n_words=n_words, n_strains=n_strains):
                # a data shard's multi program: I K6s launches, R, K7
                ws = [k6s(i).reshape(-1) for k6s in ks]
                w = ws[0] if len(ws) == 1 else L.shard_reduce(ws, masks=False)
                return G.boundary_strain_sums(w.reshape(-1, n_words), bs[i][1], n_strains)

            report("k6s", f"targets S={n_strains} I={n_index}", graph_ms(ks[0]),
                   bound_ms(n_bytes(probes, hits, per)), no_probe_ms=no_probe_ms,
                   no_probe_bound_ms=no_probe_bound, program_ms=graph_ms(program), probes=probes,
                   hits=hits)
            del shards, ks
            torch.cuda.empty_cache()
        del wide, free
        torch.cuda.empty_cache()


def compare_kernels(genome, bases: dict, report, dev) -> None:
    """K3 with its valid count (per batch, then the tally's total), K8 and
    K9 on every batch kind at COMPARE_KS, each on a table of the genome at
    that k."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L

    for k in COMPARE_KS:
        rows, h_bits, salt = table_k(genome, k, dev)
        counts = torch.zeros(rows.shape[0] * 16, dtype=torch.uint32, device=dev)
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        tally = torch.zeros(L.n_tiles(ROWS, ROW_LEN, k), dtype=torch.int64, device=dev)
        k3v = lambda i: L.count_valid_step(counts, tally, rows, bs[i], h_bits, salt, k)  # noqa: E731
        for kind, bs in bases.items():
            per = [batch_stats(rows, h_bits, salt, b, k) for b in bs]
            valid, _, hits = (sum(x) / N_BATCHES for x in zip(*per))
            key = f"{kind} k={k}"
            extra = dict(valid=valid, hits=hits)
            ms = graph_ms(k3v)
            report("k3v", key, ms, bound_ms(k3v_bytes(bs[0], valid, hits)), **extra)
            ms8 = graph_ms(lambda i: L.hit_accumulate(acc, rows, bs[i], h_bits, salt, k))
            report("k8", key, ms8, bound_ms(k8_bytes(bs[0], valid, hits)), **extra)
            ms = graph_ms(lambda i: L.hit_stats(rows, bs[i], per[i][0] // 2, h_bits, salt, k))
            report("k9", key, ms, bound_ms(k9_bytes(bs[0], valid, hits)), over_k8=ms - ms8, **extra)
        ms = graph_ms(lambda i: L.valid_tally_total(tally))
        report("k3v_total", f"k={k}", ms, bound_ms(tally_bytes(tally)), slots=tally.numel())
        del rows, counts, tally
        torch.cuda.empty_cache()


def cuckoo_kernels(genome, keys, key_kinds, bases, batches, stats, codes, main_q, report,
                   dev) -> None:
    """The fingerprint kernel once an index, K10 on the bucket K2's query
    sets, cuckoo K3 and K4 on their kinds of batch over a cuckoo table of
    the same keys and classes, and cuckoo K3 with its valid count, K8 and
    K9 on every kind at COMPARE_KS; each probing kernel's line also gives
    its unfiltered bound and the batch's false-match share."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L

    def filtered(kernel, key, ms, n_bytes, unfiltered_bytes, st, **extra):
        report(kernel, key, ms, bound_ms(n_bytes), unfiltered_ms=bound_ms(unfiltered_bytes),
               false_match=st.false_match, matched=st.matched, **extra)

    table, h_bits, salt, meta = cuckoo_table_k(keys, K, dev, key_kinds)
    fp = fp_kw(L, table)
    if fp:
        ms = graph_ms(lambda i: L.cuckoo_fingerprints(table), 1)
        report("fp", "index", ms, bound_ms(9 * table.shape[0]), slots=table.shape[0])
    for kind, qs in (("count", codes), ("main", main_q)):
        st = mean_stats([filter_stats(table, h_bits, salt, *q) for q in qs])
        ms = graph_ms(lambda i: L.cuckoo_lookup(table, h_bits, salt, *qs[i], **fp))
        filtered("k10", kind, ms, k10_bytes(st), k10_bytes(st.probes), st, queries=st.probes)
    fstats = {kind: mean_stats([batch_filter_stats(table, h_bits, salt, b) for b in bs])
              for kind, bs in bases.items()}
    counts = torch.zeros(table.shape[0], dtype=torch.uint32, device=dev)
    for kind in ("count", "targets"):
        bs, st = bases[kind], fstats[kind]
        valid, _, hits = stats[kind]
        ms = graph_ms(lambda i: L.cuckoo_count_step(counts, table, bs[i], h_bits, salt, K, **fp))
        filtered("k3_cuckoo", kind, ms, k3_bytes(bs[0], st, hits),
                 k3_bytes(bs[0], valid, hits, "cuckoo"), st, valid=valid, hits=hits)
    for kind, bs in batches.items():
        valid, _, hits = stats[kind]
        st = fstats[kind]
        ms3 = graph_ms(lambda i: L.cuckoo_count_step(counts, table, bs[i][0], h_bits, salt, K,
                                                     **fp))
        ms = graph_ms(lambda i: L.cuckoo_classify_step(table, meta, bs[i][0], bs[i][1], h_bits,
                                                       salt, K, **fp))
        filtered("k4_cuckoo", kind, ms, k4_bytes(bs[0][0], bs[0][1], st, hits),
                 k4_bytes(bs[0][0], bs[0][1], valid, hits, "cuckoo"), st, over_k3=ms - ms3,
                 valid=valid, hits=hits)
    del table, meta, counts, fp
    for k in COMPARE_KS:
        table, h_bits, salt, _ = cuckoo_table_k(_keys_k(genome, k), k, dev)
        fp = fp_kw(L, table)
        counts = torch.zeros(table.shape[0], dtype=torch.uint32, device=dev)
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        tally = torch.zeros(L.n_tiles(ROWS, ROW_LEN, k), dtype=torch.int64, device=dev)
        for kind, bs in bases.items():
            per = [L.cuckoo_hit_stats_plain(table, b, 0, h_bits, salt, k)[:2].tolist() for b in bs]
            hits, valid = (sum(x) / N_BATCHES for x in zip(*per))
            st = mean_stats([batch_filter_stats(table, h_bits, salt, b, k) for b in bs])
            key, extra = f"{kind} k={k}", dict(valid=valid, hits=hits)
            ms = graph_ms(lambda i: L.cuckoo_count_valid_step(counts, tally, table, bs[i], h_bits,
                                                              salt, k, **fp))
            filtered("k3v_cuckoo", key, ms, k3v_bytes(bs[0], st, hits),
                     k3v_bytes(bs[0], valid, hits, "cuckoo"), st, **extra)
            ms8 = graph_ms(lambda i: L.cuckoo_hit_accumulate(acc, table, bs[i], h_bits, salt, k,
                                                             **fp))
            filtered("k8_cuckoo", key, ms8, k8_bytes(bs[0], st, hits),
                     k8_bytes(bs[0], valid, hits, "cuckoo"), st, **extra)
            ms = graph_ms(lambda i: L.cuckoo_hit_stats(table, bs[i], int(per[i][1]) // 2, h_bits,
                                                       salt, k, **fp))
            filtered("k9_cuckoo", key, ms, k9_bytes(bs[0], st, hits),
                     k9_bytes(bs[0], valid, hits, "cuckoo"), st, over_k8=ms - ms8, **extra)
        del table, counts, tally, fp
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=None, help="checkout whose strainer2_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default=None)
    ap.add_argument("--layout", default="both", choices=("both", "bucket", "cuckoo"),
                    help="the kernels to time: bucket (K1-K9), cuckoo (K10 and the cuckoo "
                         "instances) or both")
    ap.add_argument("--reduce", action="store_true",
                    help="time R (shard_reduce) alone, at I = 2, 4 and 8")
    ap.add_argument("--shard", action="store_true",
                    help="time K4s (shard_classify_masks) on targets batches, K3s "
                         "(shard_count_step) on targets and count batches and K6s "
                         "(shard_multi_hit_words) on targets batches at S = 32 and 256, at "
                         "I = 1, 2 and 4, with their no-probe passes and a data shard's "
                         "classify and multi programs")
    ap.add_argument("--select", action="store_true",
                    help="time K4 then K4e (classify_select_step) on targets batches, beside "
                         "K4 alone")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        return 1
    repo = os.path.abspath(args.repo or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    sys.path.insert(0, repo)
    import strainer2_tpu_torch

    if not strainer2_tpu_torch.__file__.startswith(repo + os.sep):
        print(f"FAIL: imported {strainer2_tpu_torch.__file__}, not the package under {repo}")
        return 1
    print(json.dumps(bench(args.seed, args.label or repo, args.layout, args.reduce, args.shard,
                           args.select)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
