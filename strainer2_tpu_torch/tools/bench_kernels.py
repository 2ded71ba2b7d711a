"""Device-only times of the kernels K1 (canonical_windows), K2
(bucket_lookup), K3 (count_step, and count_valid_step: K3 with its valid
count), K4 (classify_step), K5 (bucket_lookup_ring), K6 (multi_hit_words),
K7 (boundary_strain_sums), K8 (hit_accumulate), K9 (hit_stats), K10
(cuckoo_lookup) and the cuckoo instances of K3, K4, K8 and K9 at main-path
shapes, and the timer, data and bounds that chip_smoke.py uses for every
kernel.

    python strainer2_tpu_torch/tools/bench_kernels.py [--repo DIR] [--seed N] [--label L] \
        [--layout both|bucket|cuckoo]

--repo names the checkout whose ``strainer2_tpu_torch`` is timed (default:
the one holding this file), so that two commits are compared in one call on
one card: unpack the other commit with ``git archive`` into a directory that
git ignores and run parent, change, change, parent.  Both use this file's
timer, data and bounds.  ``--layout bucket`` times the bucket kernels only
(a checkout without the cuckoo kernels), ``cuckoo`` K10 and the cuckoo
instances only; every cuckoo kernel runs beside its bucket twin on the
same batches and key set.

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
``targets``, K4 on ``phase2`` and ``targets``, K6 and K7 on ``phase2`` and
``targets`` at S = 16, 32, 96 and 256 strains (K7 on K6's words), over
rows widened with seeded meta words; K8, K9 and K3 with its valid count on
all three kinds at k = 20 (genome_compare's default, a table of the same
genome at k = 20) and k = 31, K9 with ``remaining`` at half the batch's
valid windows, K3 with its valid count per batch into a tally kept across
the stream, and the tally's once-a-stream total (``valid_tally_total``,
"K3V_TOTAL") timed on its own.  The cuckoo table holds the same keys
(index/cuckoo.py's default size, (2H, 2) uint32) and, for K4, the same
classes in a slot-indexed array.

The timer is CUDA events around replays of one CUDA graph holding 5 rounds
of the 8 batches' launches, so it sees device time and no host launch cost;
the time is per wrapper call.  The bound is the least time the card could
take: the bytes the function must move (inputs read once, outputs written
once, per probed window the row's 64 bytes of key_hi lanes and, where the
key is found, its 64 bytes of key_lo lanes; in the cuckoo layout one
32-byte sector for each of its two slots, hit or miss) over the H100's
3.35 TB/s.
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
    "k6_bytes", "k7_bytes", "k8_bytes", "k9_bytes", "k3v_bytes", "k10_bytes", "tally_bytes",
    "COMPARE_KS", "cuckoo_table_k",
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


def probe_bytes(probes: float, hits: float, layout: str = "bucket") -> float:
    """Key bytes a lookup must read.  Bucket rows: the 16 key_hi lanes of
    every probed row (a miss is settled there unless a key_hi matches),
    the 16 key_lo lanes where one does (counted as the hits).  Cuckoo: one
    32-byte sector for each of a probe's two slots, hit or miss."""
    if layout == "cuckoo":
        return 2 * SECTOR_BYTES * probes
    return KEY_HALF_BYTES * (probes + hits)


def k1_bytes(bases, k: int = K) -> int:
    """Bases read once, (hi, lo, valid) written: 9 bytes a window."""
    return bases.numel() + 9 * bases.shape[0] * (bases.shape[1] - k + 1)


def k2_bytes(queries: float, found: float) -> float:
    """(qhi, qlo) read, (found, slot, meta) written: 17 bytes a query; a
    probe a query, and a meta word a found one."""
    return 17 * queries + probe_bytes(queries, found) + 4 * found


def k10_bytes(queries: float) -> float:
    """(qhi, qlo) read, (found, slot) written: 13 bytes a query; a cuckoo
    probe a query."""
    return 13 * queries + probe_bytes(queries, 0, "cuckoo")


def k3_bytes(bases, valid: float, hits: float, layout: str = "bucket") -> float:
    """Bases read, a probe per valid window, a count read and written per hit."""
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


def k8_bytes(bases, valid: float, hits: float, layout: str = "bucket") -> float:
    """Bases read, a probe per valid window, the (2,) int64 accumulator read
    and written."""
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


def bench(seed: int, label: str, layout: str = "both") -> dict:
    """Time the kernels of ``layout`` (both, bucket or cuckoo) on one seed's
    data: the same batches and keys whatever the layout."""
    import torch

    from strainer2_tpu_torch.ops.packing import canonical_windows_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    genome, rows, h_bits, salt, keys, key_kinds = _table(rng, dev)
    card = _card()
    print(f"[{label}] card: {card}; table {keys.size} keys, rows {tuple(rows.shape)}", flush=True)
    batches = {kind: detection_batches(rng, genome, kind, dev) for kind in BATCH_KINDS}
    bases = {"count": count_batches(rng, genome, dev), "targets": [b for b, _, _ in batches["targets"]]}
    bases.update(phase2=[b for b, _, _ in batches["phase2"]])
    stats = {kind: [sum(x) / N_BATCHES for x in zip(*(batch_stats(rows, h_bits, salt, b) for b in bs))]
             for kind, bs in bases.items()}
    main_q = main_path_queries(rng, keys, dev)
    result = {"label": label, "card": card}

    def report(kernel: str, key: str, ms: float, bound: float, **extra) -> None:
        result.setdefault(kernel, {})[key] = {"ms": ms, "bound_ms": bound, **extra}
        print(f"[{label}] {kernel.upper()} {key}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"(share {bound / ms:.3f})", flush=True)

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
    del counts
    for kind, bs in batches.items():
        valid, _, hits = stats[kind]
        ms = graph_ms(lambda i: L.classify_step(rows, bs[i][0], bs[i][1], h_bits, salt, K))
        report("k4", kind, ms, bound_ms(k4_bytes(bs[0][0], bs[0][1], valid, hits)),
               valid=valid, hits=hits)
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
    """K10 on the bucket K2's query sets, cuckoo K3 and K4 on their kinds
    of batch over a cuckoo table of the same keys and classes, and cuckoo
    K3 with its valid count, K8 and K9 on every kind at COMPARE_KS."""
    import torch

    from strainer2_tpu_torch.ops import lookup as L

    table, h_bits, salt, meta = cuckoo_table_k(keys, K, dev, key_kinds)
    for kind, qs in (("count", codes), ("main", main_q)):
        n = qs[0][0].numel()
        ms = graph_ms(lambda i: L.cuckoo_lookup(table, h_bits, salt, *qs[i]))
        report("k10", kind, ms, bound_ms(k10_bytes(n)), queries=n)
    counts = torch.zeros(table.shape[0], dtype=torch.uint32, device=dev)
    for kind in ("count", "targets"):
        bs = bases[kind]
        valid, _, hits = stats[kind]
        ms = graph_ms(lambda i: L.cuckoo_count_step(counts, table, bs[i], h_bits, salt, K))
        report("k3_cuckoo", kind, ms, bound_ms(k3_bytes(bs[0], valid, hits, "cuckoo")),
               valid=valid, hits=hits)
    for kind, bs in batches.items():
        valid, _, hits = stats[kind]
        ms = graph_ms(lambda i: L.cuckoo_classify_step(table, meta, bs[i][0], bs[i][1], h_bits,
                                                       salt, K))
        report("k4_cuckoo", kind, ms,
               bound_ms(k4_bytes(bs[0][0], bs[0][1], valid, hits, "cuckoo")), valid=valid,
               hits=hits)
    del table, meta, counts
    for k in COMPARE_KS:
        table, h_bits, salt, _ = cuckoo_table_k(_keys_k(genome, k), k, dev)
        counts = torch.zeros(table.shape[0], dtype=torch.uint32, device=dev)
        acc = torch.zeros(2, dtype=torch.int64, device=dev)
        tally = torch.zeros(L.n_tiles(ROWS, ROW_LEN, k), dtype=torch.int64, device=dev)
        for kind, bs in bases.items():
            per = [L.cuckoo_hit_stats_plain(table, b, 0, h_bits, salt, k)[:2].tolist() for b in bs]
            hits, valid = (sum(x) / N_BATCHES for x in zip(*per))
            key, extra = f"{kind} k={k}", dict(valid=valid, hits=hits)
            ms = graph_ms(lambda i: L.cuckoo_count_valid_step(counts, tally, table, bs[i], h_bits,
                                                              salt, k))
            report("k3v_cuckoo", key, ms, bound_ms(k3v_bytes(bs[0], valid, hits, "cuckoo")),
                   **extra)
            ms8 = graph_ms(lambda i: L.cuckoo_hit_accumulate(acc, table, bs[i], h_bits, salt, k))
            report("k8_cuckoo", key, ms8, bound_ms(k8_bytes(bs[0], valid, hits, "cuckoo")), **extra)
            ms = graph_ms(lambda i: L.cuckoo_hit_stats(table, bs[i], int(per[i][1]) // 2, h_bits,
                                                       salt, k))
            report("k9_cuckoo", key, ms, bound_ms(k9_bytes(bs[0], valid, hits, "cuckoo")),
                   over_k8=ms - ms8, **extra)
        del table, counts, tally
        torch.cuda.empty_cache()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=None, help="checkout whose strainer2_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default=None)
    ap.add_argument("--layout", default="both", choices=("both", "bucket", "cuckoo"),
                    help="the kernels to time: bucket (K1-K9), cuckoo (K10 and the cuckoo "
                         "instances) or both")
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
    print(json.dumps(bench(args.seed, args.label or repo, args.layout)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
