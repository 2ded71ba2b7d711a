"""Membership kernels K2-K5, K8-K10 and their plain torch versions, for
the bucket layout and (K10 and the ``cuckoo_`` forms) the cuckoo layout.

Row layout and lookup contract of the JAX package (strainer2_tpu/index/
bucket.py, strainer2_tpu/ops/lookup.py): a (num_buckets, row_width) uint32
table whose rows hold 16 key_hi | 16 key_lo | 16 meta | ...; a query's
bucket is cuckoo_slots(hi ^ salt, lo, h_bits, 0); slot = bucket * 16 + the
FIRST equal cell; meta = the uint32-wrapping sum of lane 32 + cell over
every equal cell (one cell in any table ``build_bucket_table`` builds), as
the jnp ``_meta_block`` sums it.  Where not found, slot = bucket * 16 and
meta = 0, as the jnp ``bucket_lookup`` returns.

- ``bucket_lookup``   (K2): found, slot, meta per query.
- ``bucket_lookup_ring`` (K5): the same contract through a ring of bulk
  async copies of each row's key_hi lanes (the A/B twin of the Pallas
  DMA-ring lookup).
- ``bucket_lookup_words_plain``: found, slot and the first n_words meta
  words (the multi-strain probe; its kernel is fused into K6,
  ops/segsum.py).
- ``count_step``      (K3): extract -> probe -> counts[slot] += 1, in place.
- ``count_valid_step`` (K3 with a valid count): the same, and the batch's
  valid windows added into an int64 tally that stays on the device across
  a stream (strain-track); ``valid_tally_total`` reads its total once, at
  the stream's end.
- ``hit_accumulate``  (K8): extract -> probe -> (hits, valid windows) added
  to a device accumulator (genome_compare, fullmap).
- ``hit_stats``       (K9): extract -> probe -> the batch's (hits, valid
  windows), and the flat index of its ``remaining``-th valid window with
  the hits up to it (genome_compare, rapid mode).
- ``classify_step``   (K4): extract -> probe -> per-read (total,
  informative) hit counts over contiguous window spans, as differences of
  hit prefixes at the read boundaries.
- ``classify_select_step`` (K4 then K4e): the batch's passing reads or
  pairs under ``passing_any``'s rule and their rows (each informative
  window's canonical code, in read order), selected on the device from
  K4's informative bits: a ``Selection``; strain_detect's emission writes
  it as it is.
- ``gather_index``: a read boundary as an index into a prefix of
  n_windows + 1 entries, as the JAX gather reads it.
- ``passing_any``: the two-threshold pass rule per read or pair; plain
  torch on either device (elementwise over a few thousand values).

Cuckoo layout (strainer2_tpu/index/cuckoo.py, strainer2_tpu/ops/lookup.py:
39-72): a (2H, 2) uint32 table of (hi, lo) slots, H = table.shape[0] // 2;
a query's two slots are s0 = cuckoo_slots(hi ^ salt, lo, h_bits, 0) and
s1 = cuckoo_slots(hi ^ salt, lo, h_bits, 1) + H (the salt enters the hash
only: both slots are compared with the unsalted key); found where either
holds the key, slot = s0 where s0 holds it, else s1 (found or not).  A
detection class is a separate slot-indexed (2H,) uint32 ``meta`` array:
informative is meta[slot] == 2, one word, never a sum.

- ``cuckoo_fingerprints``: a byte a slot, the 8-bit fingerprint of the key
  it holds (``cuckoo_fingerprint_plain``; an empty slot holds the
  sentinel's); made once an index on the device, never saved.
- ``cuckoo_lookup``   (K10): found, slot per query.
- ``cuckoo_count_step``, ``cuckoo_count_valid_step``,
  ``cuckoo_classify_step``, ``cuckoo_classify_select_step``,
  ``cuckoo_hit_accumulate``, ``cuckoo_hit_stats``: K3, K3 with its valid
  count, K4, K4 then K4e, K8 and K9 with the two-slot probe, same
  contracts (count buffers of 2H cells).

The cuckoo kernels take the table's fingerprints (``fp=``) and read a slot
of the table only where its fingerprint is the query's
(``cuckoo_lookup_filtered_plain`` is that probe in torch).  A fingerprint
is a function of the key, so the filter loses no hit: the results are
those of the unfiltered probe, and the plain versions are that probe.

Index shards of a (data, index) mesh (parallel/sharding.py): a shard holds
a contiguous block of whole buckets, or of slots, of the table, and its
shard-window kernels (K3s, K4s) probe only the keys whose bucket or slot
lies in it, as JAX's ``_bucket_local_lookup`` and ``_local_lookup``
(strainer2_tpu/parallel/sharding.py:53-78, :209-233) do:

- ``shard_count_step`` (K3s), ``shard_cuckoo_count_step``: K3 into the
  shard's private counts, indexed by local slot;
- ``shard_classify_masks`` (K4s), ``shard_cuckoo_classify_masks``: K4's
  probe launch, its scratch (mask and count words a tile) out;
- ``shard_reduce`` (R): the shards' scratch ORed (and recounted), or K6s's
  words added, on the data shard's first device, each part read where it
  lies: the psum over the index axis;
- ``classify_sums``: K4's second launch on such scratch.

Each kernel wrapper launches its CUDA kernel on a CUDA tensor and runs the
plain version on a CPU tensor; nothing else takes the plain path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from strainer2_tpu_torch.constants import INFORMATIVE_KMER, MAX_K
from strainer2_tpu_torch.index.hashing import _mul32, cuckoo_slots_torch
from strainer2_tpu_torch.ops import _build
from strainer2_tpu_torch.ops.packing import canonical_windows_plain
from strainer2_tpu_torch.utils.observability import stage

__all__ = [
    "bucket_lookup",
    "bucket_lookup_plain",
    "bucket_lookup_ring",
    "bucket_lookup_words_plain",
    "count_step",
    "count_step_plain",
    "count_valid_step",
    "count_valid_step_plain",
    "valid_tally_total",
    "valid_tally_total_plain",
    "n_tiles",
    "hit_accumulate",
    "hit_accumulate_plain",
    "hit_stats",
    "hit_stats_plain",
    "classify_step",
    "classify_step_plain",
    "classify_select_step",
    "classify_select_step_plain",
    "Selection",
    "gather_index",
    "passing_any",
    "cuckoo_fingerprint_plain",
    "cuckoo_fingerprints",
    "cuckoo_fingerprints_plain",
    "cuckoo_lookup",
    "cuckoo_lookup_plain",
    "cuckoo_lookup_filtered_plain",
    "cuckoo_count_step",
    "cuckoo_count_step_plain",
    "cuckoo_count_valid_step",
    "cuckoo_count_valid_step_plain",
    "cuckoo_classify_step",
    "cuckoo_classify_step_plain",
    "cuckoo_classify_select_step",
    "cuckoo_classify_select_step_plain",
    "cuckoo_hit_accumulate",
    "cuckoo_hit_accumulate_plain",
    "cuckoo_hit_stats",
    "cuckoo_hit_stats_plain",
    "shard_cuckoo_lookup_plain",
    "shard_count_step",
    "shard_cuckoo_count_step",
    "shard_classify_masks",
    "shard_classify_masks_plain",
    "shard_cuckoo_classify_masks",
    "shard_cuckoo_classify_masks_plain",
    "shard_reduce",
    "shard_reduce_plain",
    "classify_sums",
    "classify_sums_plain",
]

KEYS_PER_BUCKET = 16
META_LANE = 32
_GATHER_ELEMS = 1 << 24  # row lanes gathered per block of queries in the plain lookup
_MASK32 = 0xFFFFFFFF
TILE = 256  # windows a block of K3, K4, K8 and K9


def n_tiles(n_rows: int, length: int, k: int) -> int:
    """256-window tiles of a (n_rows, length) batch at k: each row's
    windows are padded to whole tiles."""
    return n_rows * max(0, -(-(length - k + 1) // TILE))


# ---- plain versions -------------------------------------------------------

def bucket_lookup_words_plain(rows: torch.Tensor, h_bits: int, salt: int,
                              qhi: torch.Tensor, qlo: torch.Tensor, n_words: int, lo: int = 0):
    """(found bool, slot int32, [meta word 0 .. n_words-1] uint32), shapes
    of qhi: the JAX ``bucket_lookup_words`` (strainer2_tpu/ops/lookup.py:181).
    Word j of a found key is the uint32-wrapping sum of lane 32 + 16 j + cell
    over its equal cells; 0 where not found.

    With ``lo``, rows are an index shard: buckets [lo, lo + len(rows)) of
    the table, as JAX's ``_bucket_local_lookup(_words)``
    (strainer2_tpu/parallel/sharding.py:209-262) reads them: a key whose
    bucket lies outside them is not found, and slot is the shard's local
    slot (local bucket * 16 + cell) where found."""
    blocks = (rows.shape[1] - META_LANE) // KEYS_PER_BUCKET
    if n_words > blocks:
        raise ValueError(f"{n_words} meta words > {blocks} blocks in a {rows.shape[1]}-lane row")
    shape = qhi.shape
    qh = qhi.reshape(-1).to(torch.int64) & _MASK32
    ql = qlo.reshape(-1).to(torch.int64) & _MASK32
    n = qh.shape[0]
    dev = qh.device
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    words = torch.zeros((n_words, n), dtype=torch.int32, device=dev)
    lanes = META_LANE + KEYS_PER_BUCKET * n_words
    rows32 = rows.view(torch.int32)[:, :lanes]  # torch gathers no uint32; same bits
    step = max(1, _GATHER_ELEMS // lanes)
    for s in range(0, n, step):
        h, l = qh[s : s + step], ql[s : s + step]
        bucket = cuckoo_slots_torch(h ^ salt, l, h_bits, 0) - lo
        mine = (bucket >= 0) & (bucket < rows.shape[0])
        bucket = torch.where(mine, bucket, 0)
        row = rows32[bucket]  # the one random access
        keys = row[:, : 2 * KEYS_PER_BUCKET].to(torch.int64) & _MASK32
        eq = (keys[:, :KEYS_PER_BUCKET] == h[:, None]) & (keys[:, KEYS_PER_BUCKET:] == l[:, None])
        eq &= mine[:, None]
        hit = eq.any(dim=1)
        cell = torch.argmax(eq.to(torch.int32), dim=1)  # first maximal cell
        found[s : s + step] = hit
        slot[s : s + step] = bucket * KEYS_PER_BUCKET + cell
        for j in range(n_words):
            block = row[:, META_LANE + KEYS_PER_BUCKET * j : META_LANE + KEYS_PER_BUCKET * (j + 1)]
            total = torch.where(eq, block.to(torch.int64) & _MASK32, 0).sum(dim=1)
            words[j, s : s + step] = ((total + 2**31) & _MASK32) - 2**31  # wrapped, as int32 bits
    return (
        found.reshape(shape),
        slot.to(torch.int32).reshape(shape),
        [w.view(torch.uint32).reshape(shape) for w in words],
    )


def bucket_lookup_plain(rows: torch.Tensor, h_bits: int, salt: int,
                        qhi: torch.Tensor, qlo: torch.Tensor):
    """(found bool, slot int32, meta uint32), shapes of qhi."""
    found, slot, words = bucket_lookup_words_plain(rows, h_bits, salt, qhi, qlo, 1)
    return found, slot, words[0]


def _window_queries(bases, k):
    """Flat indices of the valid windows of ``bases``, their (hi, lo) codes
    as int64 and the batch's window count: only valid windows are probed,
    which keeps the plain path cheap on the mostly-padding batches of small
    inputs."""
    hi, lo, valid = canonical_windows_plain(bases, k)
    idx = torch.nonzero(valid.reshape(-1))[:, 0]
    qhi, qlo = (x.view(torch.int32).reshape(-1)[idx].to(torch.int64) & _MASK32 for x in (hi, lo))
    return idx, qhi, qlo, valid.numel()


def valid_hits_plain(rows, bases, h_bits, salt, k, n_words: int = 1, lo: int = 0):
    """Flat indices of valid windows, their bucket lookups (found, slot,
    [meta words]; in the index shard from bucket ``lo`` where ``rows`` is
    one) and the window count."""
    idx, qhi, qlo, n = _window_queries(bases, k)
    found, slot, words = bucket_lookup_words_plain(rows, h_bits, salt, qhi, qlo, n_words, lo)
    return idx, found, slot, words, n


def cuckoo_valid_hits_plain(table, bases, h_bits, salt, k, meta=None, lo=None):
    """valid_hits_plain in the cuckoo layout: the meta word is meta[slot]
    (0 where not found), and there is none without ``meta``; with ``lo``,
    ``table`` and ``meta`` are the index shard from slot lo
    (shard_cuckoo_lookup_plain)."""
    idx, qhi, qlo, n = _window_queries(bases, k)
    if lo is None:
        found, slot = cuckoo_lookup_plain(table, h_bits, salt, qhi, qlo)
    else:
        found, slot = shard_cuckoo_lookup_plain(table, h_bits, salt, lo, qhi, qlo)
    words = []
    if meta is not None:
        m = meta.view(torch.int32)[slot.to(torch.int64)]
        words = [torch.where(found, m, 0).view(torch.uint32)]
    return idx, found, slot, words, n


def _count_plain(counts, tally, lookups):
    """counts[slot] += 1 for every valid hit window, in place (uint32 wraps:
    the add runs on an int32 view, whose two's-complement wrap is the same
    bits); with a tally, the batch's valid windows added into its slot 0."""
    idx, found, slot, _, _ = lookups
    hits = slot[found].to(torch.int64)
    counts.view(torch.int32).index_add_(0, hits, torch.ones_like(hits, dtype=torch.int32))
    if tally is not None:
        tally[0] += idx.numel()
    return counts


def _accumulate_plain(acc, lookups):
    idx, found, _, _, _ = lookups
    acc += torch.stack([found.sum(), torch.tensor(idx.numel(), device=acc.device)]).to(torch.int64)
    return acc


def _stats_plain(lookups, remaining: int, dev):
    idx, found, _, _, n = lookups
    hit = torch.zeros(n, dtype=torch.int32, device=dev)
    valid = torch.zeros_like(hit)
    hit[idx] = found.to(torch.int32)
    valid[idx] = 1
    cum_hit = torch.cumsum(hit, 0, dtype=torch.int32)
    cum_valid = torch.cumsum(valid, 0, dtype=torch.int32)
    target = torch.tensor([remaining], dtype=torch.int32, device=dev)
    pos = torch.searchsorted(cum_valid, target).to(torch.int64)[0]
    crossed = pos < n
    hits_at = torch.where(crossed, cum_hit[torch.clamp(pos, max=n - 1)], 0)
    return torch.stack([cum_hit[n - 1], cum_valid[n - 1], hits_at,
                        torch.where(crossed, pos, -1)]).to(torch.int32)


def _classify_plain(lookups, boundaries, dev):
    idx, found, _, (meta,), n_windows = lookups
    hit = torch.zeros(n_windows, dtype=torch.int32, device=dev)
    inf = torch.zeros_like(hit)
    hit[idx] = found.to(torch.int32)
    inf[idx] = (found & (meta.to(torch.int64) == INFORMATIVE_KMER)).to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    cum_hit = torch.cat([zero, torch.cumsum(hit, 0, dtype=torch.int32)])
    cum_inf = torch.cat([zero, torch.cumsum(inf, 0, dtype=torch.int32)])
    b = gather_index(boundaries, n_windows)
    b0, b1 = b[:-1], b[1:]
    return cum_hit[b1] - cum_hit[b0], cum_inf[b1] - cum_inf[b0]


def count_step_plain(counts, rows, bases, h_bits: int, salt: int, k: int, lo: int = 0):
    """counts[slot] += 1 for every valid hit window, in place.  With ``lo``,
    ``rows`` is the index shard of buckets from lo and counts its private
    (len(rows) * 16,) cells: the JAX ``_count_body_bucket``
    (strainer2_tpu/parallel/sharding.py:304-314)."""
    return _count_plain(counts, None, valid_hits_plain(rows, bases, h_bits, salt, k, lo=lo))


def count_valid_step_plain(counts, tally, rows, bases, h_bits: int, salt: int, k: int):
    """count_step_plain, and the batch's valid windows added into slot 0 of
    the int64 ``tally``, both in place: the JAX ``_count_valid_step_bucket``
    (strainer2_tpu/pipeline/engine.py:330) with its per-batch scalar summed
    over the stream.  Only the tally's total is the contract (the kernel
    adds each tile into a slot of its own)."""
    return _count_plain(counts, tally, valid_hits_plain(rows, bases, h_bits, salt, k))


def valid_tally_total_plain(tally):
    """The int64 total of a valid-window tally, a 0-d tensor."""
    return tally.sum()


def hit_accumulate_plain(acc, rows, bases, h_bits: int, salt: int, k: int):
    """acc (2,) int64 += (hits, valid windows) of ``bases``, in place: the
    JAX ``_hit_accum_bucket`` (strainer2_tpu/pipeline/engine.py:343), in
    int64 lanes where the JAX program has int32 ones."""
    return _accumulate_plain(acc, valid_hits_plain(rows, bases, h_bits, salt, k))


def hit_stats_plain(rows, bases, remaining: int, h_bits: int, salt: int, k: int):
    """int32 (4,): (batch hits, batch valid windows, hits at the crossing,
    flat index of the crossing), as the JAX ``_stats_from_masks``
    (strainer2_tpu/pipeline/engine.py:261) computes them: the crossing is
    the first flat window row * W + col whose inclusive valid prefix
    reaches ``remaining`` (searchsorted, left), -1 with 0 hits where the
    batch ends first; hits are the inclusive hit prefix there."""
    return _stats_plain(valid_hits_plain(rows, bases, h_bits, salt, k), remaining, bases.device)


def gather_index(boundaries: torch.Tensor, n_windows: int) -> torch.Tensor:
    """int64 indices into a prefix of n_windows + 1 entries, read as a JAX
    gather reads them: a negative boundary counts from the end, then the
    index is clamped to [0, n_windows]."""
    b = boundaries.to(torch.int64)
    return torch.where(b < 0, b + n_windows + 1, b).clamp(0, n_windows)


def classify_step_plain(rows, bases, boundaries, h_bits: int, salt: int, k: int):
    """Per-read (total, informative) int32 hits, shape (len(boundaries) - 1,):
    differences of one prefix sum at ``boundaries``, as the JAX program
    computes them (indices read as its gather reads them)."""
    return _classify_plain(valid_hits_plain(rows, bases, h_bits, salt, k), boundaries,
                           bases.device)


# ---- plain versions, cuckoo layout ----------------------------------------

def cuckoo_lookup_plain(table, h_bits: int, salt: int, qhi, qlo):
    """(found bool, slot int32), shapes of qhi: the JAX ``cuckoo_lookup``
    (strainer2_tpu/ops/lookup.py:39-72) on a (2H, 2) uint32 table."""
    shape = qhi.shape
    qh = qhi.reshape(-1).to(torch.int64) & _MASK32
    ql = qlo.reshape(-1).to(torch.int64) & _MASK32
    h = table.shape[0] // 2
    t = table.view(torch.int32)  # torch gathers no uint32; same bits
    shi = qh ^ salt if salt else qh
    s0 = cuckoo_slots_torch(shi, ql, h_bits, 0)
    s1 = cuckoo_slots_torch(shi, ql, h_bits, 1) + h
    r0, r1 = (t[s].to(torch.int64) & _MASK32 for s in (s0, s1))
    hit0 = (r0[:, 0] == qh) & (r0[:, 1] == ql)
    hit1 = (r1[:, 0] == qh) & (r1[:, 1] == ql)
    slot = torch.where(hit0, s0, s1)
    return (hit0 | hit1).reshape(shape), slot.to(torch.int32).reshape(shape)


def shard_cuckoo_lookup_plain(table, h_bits: int, salt: int, lo: int, qhi, qlo):
    """(found bool, local slot int32), shapes of qhi: the JAX
    ``_local_lookup`` (strainer2_tpu/parallel/sharding.py:53-78) of the
    index shard ``table``, slots [lo, lo + len(table)) of a (2H, 2) table,
    H = 2**h_bits.  Found where one of the key's slots inside the shard
    holds it; the slot is s1's where both do (JAX's loop lets an s1 match
    overwrite an s0 one; ``cuckoo_lookup_plain`` picks s0), 0 where
    neither does."""
    shape = qhi.shape
    qh = qhi.reshape(-1).to(torch.int64) & _MASK32
    ql = qlo.reshape(-1).to(torch.int64) & _MASK32
    n = table.shape[0]
    t = table.view(torch.int32)
    shi = qh ^ salt if salt else qh
    hit = torch.zeros(qh.shape, dtype=torch.bool, device=qh.device)
    slot = torch.zeros(qh.shape, dtype=torch.int64, device=qh.device)
    for s in (cuckoo_slots_torch(shi, ql, h_bits, 0) - lo,
              cuckoo_slots_torch(shi, ql, h_bits, 1) + (1 << h_bits) - lo):
        mine = (s >= 0) & (s < n)
        safe = torch.where(mine, s, 0)
        r = t[safe].to(torch.int64) & _MASK32
        match = mine & (r[:, 0] == qh) & (r[:, 1] == ql)
        hit |= match
        slot = torch.where(match, safe, slot)
    return hit.reshape(shape), slot.to(torch.int32).reshape(shape)


def cuckoo_fingerprint_plain(hi, lo):
    """The 8-bit slot fingerprint of keys (hi, lo), int64 tensors holding
    uint32 values: the top byte of a hash of the unsalted key with
    multipliers and a finalizer of its own (the kernels'
    ``cuckoo_fingerprint``), so that it does not follow the slot hash."""
    x = _mul32(hi, 0x2C1B3C6D) ^ _mul32(lo, 0x297A2D39) ^ 0x61C88647
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return (x ^ (x >> 16)) >> 24


def cuckoo_fingerprints_plain(table):
    """(2H,) uint8: the fingerprint of every slot's (hi, lo) pair, empty
    slots included."""
    t = table.view(torch.int32).to(torch.int64) & _MASK32
    return cuckoo_fingerprint_plain(t[:, 0], t[:, 1]).to(torch.uint8)


def cuckoo_lookup_filtered_plain(table, fp, h_bits: int, salt: int, qhi, qlo):
    """The kernels' probe in torch: (found, slot) as ``cuckoo_lookup_plain``
    gives them, from fingerprints ``fp`` first, a slot of the table read
    only where its fingerprint is the query's; and the number of slots so
    read, (found, slot, reads)."""
    shape = qhi.shape
    qh = qhi.reshape(-1).to(torch.int64) & _MASK32
    ql = qlo.reshape(-1).to(torch.int64) & _MASK32
    h = table.shape[0] // 2
    t = table.view(torch.int32)
    shi = qh ^ salt if salt else qh
    s0 = cuckoo_slots_torch(shi, ql, h_bits, 0)
    s1 = cuckoo_slots_torch(shi, ql, h_bits, 1) + h
    f = cuckoo_fingerprint_plain(qh, ql)
    fps = fp.to(torch.int64)
    hits = []
    for s in (s0, s1):
        match = fps[s] == f
        read = s[match]  # the table is read at these slots only
        slot_key = t[read].to(torch.int64) & _MASK32
        hit = torch.zeros_like(match)
        hit[match] = (slot_key[:, 0] == qh[match]) & (slot_key[:, 1] == ql[match])
        hits.append((hit, int(read.numel())))
    (hit0, r0), (hit1, r1) = hits
    slot = torch.where(hit0, s0, s1)
    return (hit0 | hit1).reshape(shape), slot.to(torch.int32).reshape(shape), r0 + r1


def cuckoo_count_step_plain(counts, table, bases, h_bits: int, salt: int, k: int, lo=None):
    """The JAX ``_count_step`` + ``accumulate_counts``
    (strainer2_tpu/pipeline/engine.py:301): counts (2H,) uint32, in place.
    With ``lo``, ``table`` is the index shard of slots from lo and counts
    its (len(table),) cells: the JAX ``_count_body``
    (strainer2_tpu/parallel/sharding.py:167-176)."""
    return _count_plain(counts, None, cuckoo_valid_hits_plain(table, bases, h_bits, salt, k,
                                                              lo=lo))


def cuckoo_count_valid_step_plain(counts, tally, table, bases, h_bits: int, salt: int, k: int):
    """The JAX ``_count_valid_step`` (strainer2_tpu/pipeline/engine.py:294),
    its valid windows added into slot 0 of ``tally``, as
    count_valid_step_plain."""
    return _count_plain(counts, tally, cuckoo_valid_hits_plain(table, bases, h_bits, salt, k))


def cuckoo_hit_accumulate_plain(acc, table, bases, h_bits: int, salt: int, k: int):
    """The JAX ``_hit_accum`` (strainer2_tpu/pipeline/engine.py:279), in
    int64 lanes."""
    return _accumulate_plain(acc, cuckoo_valid_hits_plain(table, bases, h_bits, salt, k))


def cuckoo_hit_stats_plain(table, bases, remaining: int, h_bits: int, salt: int, k: int):
    """The JAX ``_hit_stats`` (strainer2_tpu/pipeline/engine.py:284), as
    hit_stats_plain."""
    return _stats_plain(cuckoo_valid_hits_plain(table, bases, h_bits, salt, k), remaining,
                        bases.device)


def cuckoo_classify_step_plain(table, meta, bases, boundaries, h_bits: int, salt: int, k: int):
    """The JAX ``_classify_step`` (strainer2_tpu/pipeline/engine.py:307):
    per-read (total, informative) hits, informative where meta[slot] == 2."""
    return _classify_plain(cuckoo_valid_hits_plain(table, bases, h_bits, salt, k, meta),
                           boundaries, bases.device)


# ---- plain versions, index shards of a (data, index) mesh -------------------
#
# A shard holds buckets [lo, lo + len(rows)) of the bucket rows, or slots
# [lo, lo + len(table)) of the cuckoo table (parallel/sharding.py); its
# count buffer has a cell per local slot.  K4s writes K4's scratch, 16 mask
# words (8 of hit bits, 8 of informative bits, a bit a window of a
# 256-window tile) and a count word (hits << 16 | informative) a tile; R
# reduces I shards' scratch (or K6s's words) on the data shard's first
# device, and classify_sums is K4's second launch on such scratch.

def _pack_bits(plane):
    """(tiles, 256) bool -> (tiles, 8) uint32 words, window j of a tile at
    bit j % 32 of word j // 32 (as __ballot_sync packs a warp's)."""
    bits = plane.reshape(plane.shape[0], TILE // 32, 32).to(torch.int64)
    w = (bits << torch.arange(32, device=plane.device)).sum(dim=2)
    return (((w + 2**31) & _MASK32) - 2**31).to(torch.int32).view(torch.uint32)


def _tile_masks(lookups, bases, k: int):
    """K4's scratch of a batch from its valid-window lookups: (16 * tiles,)
    mask words and (tiles,) count words, uint32."""
    idx, found, _, (meta,), n_windows = lookups
    n_rows, length = bases.shape
    w = length - k + 1
    tpr = -(-w // TILE)
    planes = []
    for bit in (found, found & (meta.to(torch.int64) == INFORMATIVE_KMER)):
        flat = torch.zeros(n_windows, dtype=torch.bool, device=bases.device)
        flat[idx] = bit
        tiled = torch.zeros((n_rows, tpr * TILE), dtype=torch.bool, device=bases.device)
        tiled[:, :w] = flat.reshape(n_rows, w)
        planes.append(tiled.reshape(-1, TILE))
    masks = torch.cat([_pack_bits(p) for p in planes], dim=1).reshape(-1)
    return masks, _tile_counts(masks)


def _tile_counts(masks):
    """(tiles,) uint32 count words hits << 16 | informative of K4's mask
    words, by popcount."""
    w = masks.view(torch.int32).to(torch.int64).reshape(-1, 2, TILE // 32) & _MASK32
    pop = torch.zeros_like(w)
    for b in range(32):
        pop += (w >> b) & 1
    n = pop.sum(dim=2)
    return ((n[:, 0] << 16) | n[:, 1]).to(torch.int32).view(torch.uint32)


def shard_classify_masks_plain(rows, lo: int, bases, h_bits: int, salt: int, k: int):
    """The probe and class planes of the JAX ``_classify_body_bucket``
    (strainer2_tpu/parallel/sharding.py:317-326) of the shard of with-meta
    rows from bucket ``lo``, as K4's scratch: (masks, counts)."""
    return _tile_masks(valid_hits_plain(rows, bases, h_bits, salt, k, lo=lo), bases, k)


def shard_cuckoo_classify_masks_plain(table, meta, lo: int, bases, h_bits: int, salt: int,
                                      k: int):
    """The probe and class planes of the JAX ``_classify_body``
    (strainer2_tpu/parallel/sharding.py:179-190) of the shard of slots from
    ``lo`` with its classes ``meta``, as K4's scratch: (masks, counts)."""
    return _tile_masks(cuckoo_valid_hits_plain(table, bases, h_bits, salt, k, meta, lo=lo),
                       bases, k)


def _reduce_parts(parts, masks: bool) -> list:
    """R's parts as a list of I >= 2 one-dimensional uint32 tensors of one
    length n, each with unit stride: ``parts`` is such a sequence, or a
    contiguous (I, n) uint32 tensor whose rows are the parts."""
    if isinstance(parts, torch.Tensor):
        if parts.dtype != torch.uint32 or parts.dim() != 2 or not parts.is_contiguous():
            raise ValueError("parts must be a contiguous (shards, n) uint32 tensor")
        parts = list(parts.unbind(0))
    else:
        parts = list(parts)
        if any(not isinstance(p, torch.Tensor) or p.dtype != torch.uint32 or p.dim() != 1
               or p.stride(0) != 1 or p.shape != parts[0].shape for p in parts):
            raise ValueError("parts must be 1-D uint32 tensors of one length, each with unit "
                             "stride")
    if len(parts) < 2:
        raise ValueError(f"R reduces 2 or more shards' parts, got {len(parts)}")
    if masks and parts[0].shape[0] % 16:
        raise ValueError(f"{parts[0].shape[0]} mask words are not whole 16-word tiles")
    return parts


def shard_reduce_plain(parts, *, masks: bool):
    """R: the I shards' uint32 buffers (a sequence of 1-D parts, or their
    (I, n) stack) reduced over the index axis. Masks: their OR and its
    count words, (masks, counts); else the uint32-wrapping sum of K6s's
    words, (n,)."""
    p64 = [p.view(torch.int32).to(torch.int64) & _MASK32 for p in _reduce_parts(parts, masks)]
    out = p64[0]
    for x in p64[1:]:
        out = out | x if masks else out + x
    out = (((out + 2**31) & _MASK32) - 2**31).to(torch.int32).view(torch.uint32)
    return (out, _tile_counts(out)) if masks else out


def classify_sums_plain(masks, counts, n_rows: int, length: int, k: int, boundaries):
    """K4's per-read (total, informative) int32 from its scratch of an
    (n_rows, length) batch: differences of the hit and informative prefixes
    at ``boundaries`` (read as a JAX gather reads them); ``counts`` are the
    masks' own and not read."""
    w = length - k + 1
    tpr = -(-w // TILE)
    m = masks.view(torch.int32).to(torch.int64).reshape(n_rows * tpr, 2, TILE // 32, 1) & _MASK32
    bits = ((m >> torch.arange(32, device=masks.device)) & 1).reshape(n_rows, tpr, 2, TILE)
    planes = bits.permute(2, 0, 1, 3).reshape(2, n_rows, tpr * TILE)[:, :, :w].reshape(2, -1)
    cum = torch.nn.functional.pad(torch.cumsum(planes, dim=1), (1, 0))
    b = gather_index(boundaries, n_rows * w)
    d = (cum[:, b[1:]] - cum[:, b[:-1]]).to(torch.int32)
    return d[0], d[1]


def passing_any(tot, inf, *, paired: bool, min_t: int, min_i: int):
    """Per-pair (paired) or per-read pass mask of the detection thresholds
    (strainer2_tpu/pipeline/detect.py:148-157); padded reads are zero, so
    they never pass with thresholds >= 1."""
    if paired:
        return ((tot[0::2] + tot[1::2]) >= min_t) & ((inf[0::2] + inf[1::2]) >= min_i)
    return (tot >= min_t) & (inf >= min_i)


class Selection(NamedTuple):
    """K4e's selection of a batch: ``counts`` int32 (2,), the passing units
    (reads, or pairs) and their rows; ``sums`` int32 (units, 5), each
    passing unit's (r1, t1, i1, t2, i2) in order, r1 its first read (t2 =
    i2 = 0 for a read); ``codes`` int64 (the bits of the uint64 canonical
    code) and ``ords`` int32, a row each: the informative windows of the
    passing units' reads in read and window order, and each one's read.
    Only the first counts[0] sums and counts[1] rows are the contract."""

    counts: torch.Tensor
    sums: torch.Tensor
    codes: torch.Tensor
    ords: torch.Tensor


def _select_plain(lookups, bases, boundaries, k: int, n_reads: int, paired: bool,
                  min_t: int, min_i: int) -> Selection:
    """K4e on a batch's valid-window lookups (classify_step_plain's):
    ``passing_any`` over the first n_reads reads (their n_reads // 2 pairs
    where paired), and each passing read's informative windows, found by
    the read whose boundaries hold them (boundaries non-decreasing)."""
    idx, found, _, (meta,), n_windows = lookups
    dev = bases.device
    tot, inf = _classify_plain(lookups, boundaries, dev)
    per = 2 if paired else 1
    n = n_reads // per * per
    ok = passing_any(tot[:n], inf[:n], paired=paired, min_t=min_t, min_i=min_i)
    units = torch.nonzero(ok)[:, 0]
    r1 = units * per
    zero = torch.zeros_like(r1, dtype=torch.int32)
    sums = torch.stack([r1.to(torch.int32), tot[r1], inf[r1],
                        tot[r1 + 1] if paired else zero, inf[r1 + 1] if paired else zero], dim=1)
    x = idx[found & (meta.to(torch.int64) == INFORMATIVE_KMER)]
    read = torch.searchsorted(gather_index(boundaries[: n + 1], n_windows), x, right=True) - 1
    inside = (read >= 0) & (read < n)
    keep = torch.zeros_like(inside)
    keep[inside] = ok[read[inside] // per]
    x, read = x[keep], read[keep]
    hi, lo, _ = canonical_windows_plain(bases, k)
    hi, lo = ((t.view(torch.int32).reshape(-1)[x].to(torch.int64) & _MASK32) for t in (hi, lo))
    codes = (hi << (2 * min(k, 16))) | lo
    counts = torch.tensor([units.numel(), x.numel()], dtype=torch.int32, device=dev)
    return Selection(counts, sums, codes, read.to(torch.int32))


def classify_select_step_plain(rows, bases, boundaries, h_bits: int, salt: int, k: int, *,
                               n_reads: int, paired: bool, min_t: int, min_i: int) -> Selection:
    """K4 then K4e in torch on the bucket rows with meta: the Selection of
    the batch's first n_reads reads, from classify_step_plain's lookups."""
    return _select_plain(valid_hits_plain(rows, bases, h_bits, salt, k), bases, boundaries, k,
                         n_reads, paired, min_t, min_i)


def cuckoo_classify_select_step_plain(table, meta, bases, boundaries, h_bits: int, salt: int,
                                      k: int, *, n_reads: int, paired: bool, min_t: int,
                                      min_i: int) -> Selection:
    """classify_select_step_plain in the cuckoo layout (meta the slots'
    classes), from cuckoo_classify_step_plain's lookups."""
    return _select_plain(cuckoo_valid_hits_plain(table, bases, h_bits, salt, k, meta), bases,
                         boundaries, k, n_reads, paired, min_t, min_i)


# ---- kernel wrappers ------------------------------------------------------

def _check_rows(rows: torch.Tensor, h_bits: int) -> None:
    if rows.dtype != torch.uint32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (num_buckets, row_width) uint32 table")
    width = rows.shape[1]
    if width < 48 or width % KEYS_PER_BUCKET:
        raise ValueError(f"row width {width} is not a multiple of 16 holding a meta block")
    if rows.shape[0] != 1 << h_bits:
        raise ValueError(f"{rows.shape[0]} rows != 2**h_bits ({1 << h_bits})")
    if h_bits > 27:
        raise ValueError(f"h_bits {h_bits} > 27: slot ids would overflow int32")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")


def _check_bases(bases: torch.Tensor, k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if bases.dtype != torch.uint8 or bases.dim() != 2 or not bases.is_contiguous():
        raise ValueError("bases must be a contiguous (rows, L) uint8 tensor")
    if bases.shape[1] < k:
        raise ValueError(f"row length {bases.shape[1]} < k {k}")
    if bases.shape[0] > 65535:
        raise ValueError(f"{bases.shape[0]} rows > 65535")


def _check_windows(bases: torch.Tensor, k: int) -> None:
    n_rows, length = bases.shape
    if n_rows * (length - k + 1) >= 2**31:
        raise ValueError(f"{n_rows} x {length - k + 1} windows do not fit int32 offsets")


def _on_cuda(name: str, *tensors) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: tensors must all be on the CPU or on one CUDA device, got {sorted(str(t.device) for t in tensors)}")


def bucket_lookup(rows, h_bits: int, salt: int, qhi, qlo):
    """Kernel K2 on CUDA tensors, the plain version on CPU tensors.

    rows (num_buckets, row_width) uint32; qhi, qlo uint32 of any one shape.
    Returns (found bool, slot int32, meta uint32) of that shape."""
    if not _on_cuda("bucket_lookup", rows, qhi, qlo):
        return bucket_lookup_plain(rows, h_bits, salt, qhi, qlo)
    _check_rows(rows, h_bits)
    if qhi.shape != qlo.shape or qhi.dtype != torch.uint32 or qlo.dtype != torch.uint32:
        raise ValueError("qhi and qlo must be uint32 tensors of one shape")
    qh, ql = qhi.contiguous(), qlo.contiguous()
    found = torch.empty(qh.shape, dtype=torch.bool, device=qh.device)
    slot = torch.empty(qh.shape, dtype=torch.int32, device=qh.device)
    meta = torch.empty(qh.shape, dtype=torch.uint32, device=qh.device)
    if qh.numel():
        _build.call(
            "bucket_lookup", qh.device, rows.data_ptr(), rows.shape[1], h_bits,
            salt, qh.data_ptr(), ql.data_ptr(), qh.numel(), found.data_ptr(),
            slot.data_ptr(), meta.data_ptr(),
        )
    return found, slot, meta


def _check_ring_args(n: int, w: int, d: int, chunk: int) -> None:
    """bucket_lookup_pallas_manual's checks (pallas_lookup.py:228-231), then
    the ring kernel's own bounds: w rows a group held by a team of at most
    32 lanes (two rows a lane at most), at most 8 groups in flight, and a
    ring's D x w x 64 bytes of stages and D mbarriers within the 48 KiB a
    block gets by default."""
    if chunk % w:
        raise ValueError("chunk must be a multiple of w")
    if n % chunk:
        raise ValueError(f"query count {n} must be a multiple of chunk={chunk}")
    if not (1 <= w <= 64 and 1 <= d <= 8 and w * d <= 256):
        raise ValueError(f"ring shape w={w}, d={d} outside 1 <= w <= 64, 1 <= d <= 8, w * d <= 256")


def bucket_lookup_ring(rows, h_bits: int, salt: int, qhi, qlo, *,
                       w: int = 8, d: int = 4, chunk: int = 1024):
    """Kernel K5 on CUDA tensors, the plain version on CPU tensors.

    The contract of ``bucket_lookup`` (K2), resolved by a block per
    ``chunk`` queries, split over rings that each keep up to ``d`` groups
    of ``w`` key_hi copies in flight.  Where not found it returns K2's
    (jnp's) slot = bucket * 16 and meta = 0; the Pallas kernel returns
    bucket * 16 + 16 there."""
    _check_ring_args(qhi.numel(), w, d, chunk)
    if not _on_cuda("bucket_lookup_ring", rows, qhi, qlo):
        return bucket_lookup_plain(rows, h_bits, salt, qhi, qlo)
    _check_rows(rows, h_bits)
    if qhi.shape != qlo.shape or qhi.dtype != torch.uint32 or qlo.dtype != torch.uint32:
        raise ValueError("qhi and qlo must be uint32 tensors of one shape")
    qh, ql = qhi.contiguous(), qlo.contiguous()
    found = torch.empty(qh.shape, dtype=torch.bool, device=qh.device)
    slot = torch.empty(qh.shape, dtype=torch.int32, device=qh.device)
    meta = torch.empty(qh.shape, dtype=torch.uint32, device=qh.device)
    if qh.numel():
        _build.call(
            "bucket_lookup_ring", qh.device, rows.data_ptr(), rows.shape[1], h_bits,
            salt, qh.data_ptr(), ql.data_ptr(), qh.numel(), w, d, chunk,
            found.data_ptr(), slot.data_ptr(), meta.data_ptr(),
        )
    return found, slot, meta


def count_step(counts, rows, bases, h_bits: int, salt: int, k: int):
    """Kernel K3 on CUDA tensors, the plain version on CPU tensors.

    counts (num_buckets * 16,) uint32 is updated in place and returned."""
    if not _on_cuda("count_step", counts, rows, bases):
        return count_step_plain(counts, rows, bases, h_bits, salt, k)
    _check_rows(rows, h_bits)
    _check_bases(bases, k)
    _check_counts(counts, rows)
    if bases.shape[0]:
        _build.call(
            "count_step", bases.device, counts.data_ptr(), rows.data_ptr(),
            rows.shape[1], h_bits, salt, bases.data_ptr(), bases.shape[0],
            bases.shape[1], k,
        )
    return counts


def _check_boundaries(boundaries: torch.Tensor) -> None:
    if boundaries.dtype != torch.int32 or boundaries.dim() != 1 or not boundaries.is_contiguous():
        raise ValueError("boundaries must be a contiguous 1-D int32 tensor")
    if boundaries.shape[0] < 1:
        raise ValueError("boundaries must hold max_reads + 1 entries")


def _k4(rows, bases, boundaries, h_bits: int, salt: int, k: int):
    """K4's checks and two launches on the bucket rows: (masks, total,
    informative), the mask words its scratch (``_scratch``) kept for K4e."""
    _check_rows(rows, h_bits)
    _check_bases(bases, k)
    _check_boundaries(boundaries)
    _check_windows(bases, k)
    max_reads = boundaries.shape[0] - 1
    masks, counts = _scratch(bases, k)
    tot = torch.empty(max_reads, dtype=torch.int32, device=bases.device)
    inf = torch.empty_like(tot)
    if max_reads:
        _build.call(
            "classify_step", bases.device, rows.data_ptr(), rows.shape[1], h_bits,
            salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k, boundaries.data_ptr(),
            max_reads, masks.data_ptr(), counts.data_ptr(), tot.data_ptr(), inf.data_ptr(),
        )
    return masks, tot, inf


def classify_step(rows, bases, boundaries, h_bits: int, salt: int, k: int):
    """Kernel K4 on CUDA tensors, the plain version on CPU tensors.

    boundaries (max_reads + 1,) int32: each read's first flat window index
    (row * width + col), padded with the batch's window count.
    Returns (total, informative) int32, shape (max_reads,).  The kernel
    runs in two launches that one call issues together, over scratch of 16
    mask words and one count word a 256-window tile: the probe to hit and
    informative words and counts, then a thread a read that scans the
    tiles' counts and takes the differences at its boundaries, chained to
    the probe launch by programmatic dependent launch."""
    if not _on_cuda("classify_step", rows, bases, boundaries):
        return classify_step_plain(rows, bases, boundaries, h_bits, salt, k)
    _, tot, inf = _k4(rows, bases, boundaries, h_bits, salt, k)
    return tot, inf

def _check_counts(counts: torch.Tensor, rows: torch.Tensor) -> None:
    if counts.dtype != torch.uint32 or counts.dim() != 1 or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous 1-D uint32 tensor")
    if counts.shape[0] != rows.shape[0] * KEYS_PER_BUCKET:
        raise ValueError(f"counts has {counts.shape[0]} cells, table has {rows.shape[0] * KEYS_PER_BUCKET} slots")


def _check_tally(tally: torch.Tensor, slots: int) -> None:
    if tally.dtype != torch.int64 or tally.dim() != 1 or not tally.is_contiguous():
        raise ValueError("tally must be a contiguous 1-D int64 tensor")
    if tally.shape[0] < slots:
        raise ValueError(f"tally has {tally.shape[0]} slots, the batch has {slots} tiles")


def count_valid_step(counts, tally, rows, bases, h_bits: int, salt: int, k: int):
    """Kernel K3 with its valid count on CUDA tensors, the plain version on
    CPU tensors.

    counts as in ``count_step``, updated in place and returned; the batch's
    valid windows are added into ``tally``, a contiguous int64 tensor of at
    least ``n_tiles(rows, length, k)`` slots for the largest batch of the
    stream, zeroed once by the caller: each 256-window tile adds into a
    slot of its own (no atomic, no memset, no per-batch reduction), so
    calls that share a tally must be ordered on one stream.  Read the
    total once, with ``valid_tally_total``."""
    if not _on_cuda("count_valid_step", counts, tally, rows, bases):
        return count_valid_step_plain(counts, tally, rows, bases, h_bits, salt, k)
    _check_rows(rows, h_bits)
    _check_bases(bases, k)
    _check_counts(counts, rows)
    _check_tally(tally, n_tiles(*bases.shape, k))
    if bases.shape[0]:
        _build.call(
            "count_valid_step", bases.device, counts.data_ptr(), rows.data_ptr(),
            rows.shape[1], h_bits, salt, bases.data_ptr(), bases.shape[0],
            bases.shape[1], k, tally.data_ptr(),
        )
    return counts


def valid_tally_total(tally):
    """The tally's total as a 0-d int64 tensor on its device: a one-block
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not _on_cuda("valid_tally_total", tally):
        return valid_tally_total_plain(tally)
    _check_tally(tally, 0)
    if tally.shape[0] >= 2**31:
        raise ValueError(f"{tally.shape[0]} tally slots do not fit an int count")
    total = torch.empty((), dtype=torch.int64, device=tally.device)
    _build.call("valid_tally_total", tally.device, tally.data_ptr(), tally.shape[0],
                total.data_ptr())
    return total


def hit_accumulate(acc, rows, bases, h_bits: int, salt: int, k: int):
    """Kernel K8 on CUDA tensors, the plain version on CPU tensors.

    acc (2,) int64 (hits, valid windows) is added to in place and returned."""
    if not _on_cuda("hit_accumulate", acc, rows, bases):
        return hit_accumulate_plain(acc, rows, bases, h_bits, salt, k)
    _check_rows(rows, h_bits)
    _check_bases(bases, k)
    if acc.dtype != torch.int64 or acc.shape != (2,) or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous (2,) int64 tensor")
    if bases.shape[0]:
        _build.call(
            "hit_accumulate", bases.device, acc.data_ptr(), rows.data_ptr(), rows.shape[1],
            h_bits, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
        )
    return acc


def hit_stats(rows, bases, remaining: int, h_bits: int, salt: int, k: int):
    """Kernel K9 on CUDA tensors, the plain version on CPU tensors.

    ``remaining`` is a host int (int32 range).  Returns int32 (4,) on the
    device: (batch hits, batch valid windows, hits at the crossing, flat
    index row * W + col of the crossing or -1), as ``hit_stats_plain``.
    The kernel runs over scratch of 16 mask words and one count word a
    256-window tile, in two launches that one call issues together: the
    probe to masks and counts, then one block that finds the crossing,
    started early by programmatic dependent launch."""
    if not -2**31 <= remaining < 2**31:
        raise ValueError(f"remaining {remaining} is outside the int32 range")
    if not _on_cuda("hit_stats", rows, bases):
        return hit_stats_plain(rows, bases, remaining, h_bits, salt, k)
    _check_rows(rows, h_bits)
    _check_bases(bases, k)
    n_rows, length = bases.shape
    if n_rows < 1:
        raise ValueError("bases must hold at least one row")
    _check_windows(bases, k)
    tiles = n_tiles(n_rows, length, k)
    masks = torch.empty(16 * tiles, dtype=torch.int32, device=bases.device)
    tile_counts = torch.empty(tiles, dtype=torch.int32, device=bases.device)
    out = torch.empty(4, dtype=torch.int32, device=bases.device)
    _build.call(
        "hit_stats", bases.device, rows.data_ptr(), rows.shape[1], h_bits, salt,
        bases.data_ptr(), n_rows, length, k, remaining, masks.data_ptr(),
        tile_counts.data_ptr(), out.data_ptr(),
    )
    return out


# ---- kernel wrappers, cuckoo layout ----------------------------------------

def _check_cuckoo_table(table: torch.Tensor, h_bits: int) -> None:
    if (table.dtype != torch.uint32 or table.dim() != 2 or table.shape[1] != 2
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (2H, 2) uint32 cuckoo table")
    if table.shape[0] % 2 or table.shape[0] < 2 << h_bits:
        raise ValueError(f"{table.shape[0]} slots is not 2H with H >= 2**h_bits ({1 << h_bits})")
    if table.shape[0] > 2**31:
        raise ValueError(f"{table.shape[0]} slots: slot ids would overflow int32")
    if table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned")


def _check_slot_array(name: str, a: torch.Tensor, table: torch.Tensor) -> None:
    """A slot-indexed uint32 array (counts, meta) of the table's 2H cells."""
    if a.dtype != torch.uint32 or a.dim() != 1 or not a.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D uint32 tensor")
    if a.shape[0] != table.shape[0]:
        raise ValueError(f"{name} has {a.shape[0]} cells, table has {table.shape[0]} slots")


def _check_fp(fp, table: torch.Tensor) -> None:
    """The table's slot fingerprints, as ``cuckoo_fingerprints`` makes them."""
    if fp is None:
        raise ValueError("the cuckoo kernels take the table's slot fingerprints: "
                         "fp=cuckoo_fingerprints(table)")
    if (fp.dtype != torch.uint8 or fp.dim() != 1 or not fp.is_contiguous()
            or fp.device != table.device):
        raise ValueError("fp must be a contiguous 1-D uint8 tensor on the table's device")
    if fp.shape[0] != table.shape[0]:
        raise ValueError(f"fp has {fp.shape[0]} fingerprints, table has {table.shape[0]} slots")


def cuckoo_fingerprints(table):
    """The fingerprint kernel on a CUDA table, the plain version on a CPU
    one: (2H,) uint8, a byte a slot.  On the card it also raises the
    persisting-L2 set-aside to the array's size (at most the card's most),
    for the L2 window the cuckoo kernels put on it."""
    if not _on_cuda("cuckoo_fingerprints", table):
        return cuckoo_fingerprints_plain(table)
    if (table.dtype != torch.uint32 or table.dim() != 2 or table.shape[1] != 2
            or not table.is_contiguous() or table.data_ptr() % 8):
        raise ValueError("table must be a contiguous, 8-byte aligned (2H, 2) uint32 cuckoo table")
    fp = torch.empty(table.shape[0], dtype=torch.uint8, device=table.device)
    if table.shape[0]:
        _build.call("cuckoo_fingerprints", table.device, table.data_ptr(), table.shape[0],
                    fp.data_ptr())
    return fp


def cuckoo_lookup(table, h_bits: int, salt: int, qhi, qlo, *, fp=None):
    """Kernel K10 on CUDA tensors, the plain version on CPU tensors.

    table (2H, 2) uint32 and, on the card, its fingerprints ``fp``; qhi,
    qlo uint32 of any one shape.  Returns (found bool, slot int32) of that
    shape."""
    if not _on_cuda("cuckoo_lookup", table, qhi, qlo):
        return cuckoo_lookup_plain(table, h_bits, salt, qhi, qlo)
    _check_cuckoo_table(table, h_bits)
    _check_fp(fp, table)
    if qhi.shape != qlo.shape or qhi.dtype != torch.uint32 or qlo.dtype != torch.uint32:
        raise ValueError("qhi and qlo must be uint32 tensors of one shape")
    qh, ql = qhi.contiguous(), qlo.contiguous()
    found = torch.empty(qh.shape, dtype=torch.bool, device=qh.device)
    slot = torch.empty(qh.shape, dtype=torch.int32, device=qh.device)
    if qh.numel():
        _build.call(
            "cuckoo_lookup", qh.device, table.data_ptr(), fp.data_ptr(), h_bits,
            table.shape[0] // 2, salt,
            qh.data_ptr(), ql.data_ptr(), qh.numel(), found.data_ptr(), slot.data_ptr(),
        )
    return found, slot


def cuckoo_count_step(counts, table, bases, h_bits: int, salt: int, k: int, *, fp=None):
    """K3 with the two-slot probe on CUDA tensors (``fp`` the table's
    fingerprints), the plain version on CPU tensors.  counts (2H,) uint32
    is updated in place and returned."""
    if not _on_cuda("cuckoo_count_step", counts, table, bases):
        return cuckoo_count_step_plain(counts, table, bases, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_fp(fp, table)
    _check_bases(bases, k)
    _check_slot_array("counts", counts, table)
    if bases.shape[0]:
        _build.call(
            "cuckoo_count_step", bases.device, counts.data_ptr(), table.data_ptr(),
            fp.data_ptr(), h_bits,
            table.shape[0] // 2, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
        )
    return counts


def cuckoo_count_valid_step(counts, tally, table, bases, h_bits: int, salt: int, k: int, *,
                            fp=None):
    """K3 with its valid count and the two-slot probe on CUDA tensors
    (``fp`` the table's fingerprints), the plain version on CPU tensors:
    the tally contract of ``count_valid_step``."""
    if not _on_cuda("cuckoo_count_valid_step", counts, tally, table, bases):
        return cuckoo_count_valid_step_plain(counts, tally, table, bases, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_fp(fp, table)
    _check_bases(bases, k)
    _check_slot_array("counts", counts, table)
    _check_tally(tally, n_tiles(*bases.shape, k))
    if bases.shape[0]:
        _build.call(
            "cuckoo_count_valid_step", bases.device, counts.data_ptr(), table.data_ptr(),
            fp.data_ptr(), h_bits,
            table.shape[0] // 2, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
            tally.data_ptr(),
        )
    return counts


def cuckoo_hit_accumulate(acc, table, bases, h_bits: int, salt: int, k: int, *, fp=None):
    """K8 with the two-slot probe on CUDA tensors (``fp`` the table's
    fingerprints), the plain version on CPU tensors: acc (2,) int64 (hits,
    valid windows) is added to in place."""
    if not _on_cuda("cuckoo_hit_accumulate", acc, table, bases):
        return cuckoo_hit_accumulate_plain(acc, table, bases, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_fp(fp, table)
    _check_bases(bases, k)
    if acc.dtype != torch.int64 or acc.shape != (2,) or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous (2,) int64 tensor")
    if bases.shape[0]:
        _build.call(
            "cuckoo_hit_accumulate", bases.device, acc.data_ptr(), table.data_ptr(),
            fp.data_ptr(), h_bits,
            table.shape[0] // 2, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
        )
    return acc


def cuckoo_hit_stats(table, bases, remaining: int, h_bits: int, salt: int, k: int, *, fp=None):
    """K9 with the two-slot probe on CUDA tensors (``fp`` the table's
    fingerprints), the plain version on CPU tensors: int32 (4,) as
    ``hit_stats`` returns, in its two launches."""
    if not -2**31 <= remaining < 2**31:
        raise ValueError(f"remaining {remaining} is outside the int32 range")
    if not _on_cuda("cuckoo_hit_stats", table, bases):
        return cuckoo_hit_stats_plain(table, bases, remaining, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_fp(fp, table)
    _check_bases(bases, k)
    if bases.shape[0] < 1:
        raise ValueError("bases must hold at least one row")
    _check_windows(bases, k)
    tiles = n_tiles(*bases.shape, k)
    masks = torch.empty(16 * tiles, dtype=torch.int32, device=bases.device)
    tile_counts = torch.empty(tiles, dtype=torch.int32, device=bases.device)
    out = torch.empty(4, dtype=torch.int32, device=bases.device)
    _build.call(
        "cuckoo_hit_stats", bases.device, table.data_ptr(), fp.data_ptr(), h_bits,
        table.shape[0] // 2, salt,
        bases.data_ptr(), bases.shape[0], bases.shape[1], k, remaining, masks.data_ptr(),
        tile_counts.data_ptr(), out.data_ptr(),
    )
    return out


def _cuckoo_k4(table, meta, bases, boundaries, h_bits: int, salt: int, k: int, fp):
    """``_k4`` with the two-slot probe and a gather of meta[slot]."""
    _check_cuckoo_table(table, h_bits)
    _check_fp(fp, table)
    _check_slot_array("meta", meta, table)
    _check_bases(bases, k)
    _check_boundaries(boundaries)
    _check_windows(bases, k)
    max_reads = boundaries.shape[0] - 1
    masks, counts = _scratch(bases, k)
    tot = torch.empty(max_reads, dtype=torch.int32, device=bases.device)
    inf = torch.empty_like(tot)
    if max_reads:
        _build.call(
            "cuckoo_classify_step", bases.device, table.data_ptr(), fp.data_ptr(),
            meta.data_ptr(), h_bits, table.shape[0] // 2, salt, bases.data_ptr(),
            bases.shape[0], bases.shape[1], k, boundaries.data_ptr(), max_reads,
            masks.data_ptr(), counts.data_ptr(), tot.data_ptr(), inf.data_ptr(),
        )
    return masks, tot, inf


def cuckoo_classify_step(table, meta, bases, boundaries, h_bits: int, salt: int, k: int, *,
                         fp=None):
    """K4 with the two-slot probe and a gather of meta[slot] on CUDA
    tensors (``fp`` the table's fingerprints), the plain version on CPU
    tensors.

    meta (2H,) uint32, the slot-indexed k-mer class; boundaries as in
    ``classify_step``.  Returns (total, informative) int32, (max_reads,),
    in ``classify_step``'s two launches."""
    if not _on_cuda("cuckoo_classify_step", table, meta, bases, boundaries):
        return cuckoo_classify_step_plain(table, meta, bases, boundaries, h_bits, salt, k)
    _, tot, inf = _cuckoo_k4(table, meta, bases, boundaries, h_bits, salt, k, fp)
    return tot, inf


def _check_select(bases, boundaries, n_reads: int) -> None:
    if not 0 <= n_reads <= boundaries.shape[0] - 1:
        raise ValueError(f"n_reads {n_reads} outside [0, {boundaries.shape[0] - 1}] (max_reads)")
    if bases.data_ptr() % 4:
        raise ValueError("bases must be 4-byte aligned")


def _select(masks, tot, inf, bases, boundaries, k: int, n_reads: int, paired: bool, min_t: int,
            min_i: int) -> Selection:
    """K4e's launch on K4's scratch (masks) and sums (tot, inf), chained by
    PDL to K4's launches before it on the stream."""
    n_rows, length = bases.shape
    dev = bases.device
    n_windows = n_rows * (length - k + 1)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    sums = torch.empty((max(n_reads // (2 if paired else 1), 1), 5), dtype=torch.int32,
                       device=dev)
    codes = torch.empty(n_windows, dtype=torch.int64, device=dev)
    ords = torch.empty(n_windows, dtype=torch.int32, device=dev)
    with stage("engine.select"):
        _build.call("classify_select", dev, masks.data_ptr(), bases.data_ptr(), n_rows, length, k,
                    boundaries.data_ptr(), tot.data_ptr(), inf.data_ptr(), n_reads, int(paired),
                    min_t, min_i, counts.data_ptr(), sums.data_ptr(), codes.data_ptr(),
                    ords.data_ptr())
    return Selection(counts, sums, codes, ords)


def classify_select_step(rows, bases, boundaries, h_bits: int, salt: int, k: int, *,
                         n_reads: int, paired: bool, min_t: int, min_i: int) -> Selection:
    """K4 then K4e on CUDA tensors, the plain version on CPU tensors.

    K4's two launches (``classify_step``'s kernels) into scratch kept here,
    then K4e on their mask words and per-read sums: the Selection of the
    batch's first ``n_reads`` reads (``boundaries`` as ``classify_step``
    takes them, non-decreasing), read by read or, where ``paired``, pair by
    pair ((2j, 2j + 1) for j < n_reads // 2), under ``passing_any``'s rule.
    K4e's launch (on the CPU the whole plain version) runs in an
    ``engine.select`` stage."""
    if not _on_cuda("classify_select_step", rows, bases, boundaries):
        with stage("engine.select"):
            return classify_select_step_plain(rows, bases, boundaries, h_bits, salt, k,
                                              n_reads=n_reads, paired=paired, min_t=min_t,
                                              min_i=min_i)
    _check_select(bases, boundaries, n_reads)
    return _select(*_k4(rows, bases, boundaries, h_bits, salt, k), bases, boundaries, k,
                   n_reads, paired, min_t, min_i)


def cuckoo_classify_select_step(table, meta, bases, boundaries, h_bits: int, salt: int, k: int,
                                *, n_reads: int, paired: bool, min_t: int, min_i: int,
                                fp=None) -> Selection:
    """classify_select_step in the cuckoo layout: ``cuckoo_classify_step``'s
    two launches (``fp`` the table's fingerprints, ``meta`` its slots'
    classes), then K4e, which reads their masks as it reads the bucket
    layout's; the plain version on CPU tensors."""
    if not _on_cuda("cuckoo_classify_select_step", table, meta, bases, boundaries):
        with stage("engine.select"):
            return cuckoo_classify_select_step_plain(table, meta, bases, boundaries, h_bits,
                                                     salt, k, n_reads=n_reads, paired=paired,
                                                     min_t=min_t, min_i=min_i)
    _check_select(bases, boundaries, n_reads)
    return _select(*_cuckoo_k4(table, meta, bases, boundaries, h_bits, salt, k, fp), bases,
                   boundaries, k, n_reads, paired, min_t, min_i)


# ---- kernel wrappers, index shards --------------------------------------------

def _check_shard_rows(rows: torch.Tensor, lo: int, h_bits: int) -> None:
    """An index shard of bucket rows: whole buckets [lo, lo + len(rows)) of a
    table of 2**h_bits."""
    if rows.dtype != torch.uint32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (shard buckets, row_width) uint32 tensor")
    width = rows.shape[1]
    if width < 48 or width % KEYS_PER_BUCKET:
        raise ValueError(f"row width {width} is not a multiple of 16 holding a meta block")
    if h_bits > 27:
        raise ValueError(f"h_bits {h_bits} > 27: slot ids would overflow int32")
    if not 0 <= lo or lo + rows.shape[0] > 1 << h_bits:
        raise ValueError(f"shard buckets [{lo}, {lo + rows.shape[0]}) outside the table's "
                         f"{1 << h_bits}")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")


def _check_shard_table(table: torch.Tensor, lo: int, h_bits: int) -> None:
    """An index shard of a cuckoo table: slots [lo, lo + len(table)) of 2H,
    H = 2**h_bits."""
    if (table.dtype != torch.uint32 or table.dim() != 2 or table.shape[1] != 2
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous (shard slots, 2) uint32 cuckoo shard")
    if h_bits > 29 or not 0 <= lo or lo + table.shape[0] > 2 << h_bits:
        raise ValueError(f"shard slots [{lo}, {lo + table.shape[0]}) outside the table's "
                         f"{2 << h_bits}")
    if table.data_ptr() % 8:
        raise ValueError("table must be 8-byte aligned")


def shard_count_step(counts, rows, lo: int, bases, h_bits: int, salt: int, k: int):
    """K3s on CUDA tensors, the plain version on CPU tensors: K3 over the
    index shard ``rows`` (buckets from ``lo``).  counts (len(rows) * 16,)
    uint32, the shard's private cells, is updated in place and returned."""
    if not _on_cuda("shard_count_step", counts, rows, bases):
        return count_step_plain(counts, rows, bases, h_bits, salt, k, lo)
    _check_shard_rows(rows, lo, h_bits)
    _check_bases(bases, k)
    _check_counts(counts, rows)
    if bases.shape[0]:
        _build.call(
            "shard_count_step", bases.device, counts.data_ptr(), rows.data_ptr(),
            rows.shape[1], h_bits, salt, lo, rows.shape[0], bases.data_ptr(), bases.shape[0],
            bases.shape[1], k,
        )
    return counts


def shard_cuckoo_count_step(counts, table, lo: int, bases, h_bits: int, salt: int, k: int, *,
                            fp=None):
    """K3s in the cuckoo layout on CUDA tensors (``fp`` the shard's slot
    fingerprints), the plain version on CPU tensors: counts (len(table),)
    uint32, in place."""
    if not _on_cuda("shard_cuckoo_count_step", counts, table, bases):
        return cuckoo_count_step_plain(counts, table, bases, h_bits, salt, k, lo)
    _check_shard_table(table, lo, h_bits)
    _check_fp(fp, table)
    _check_bases(bases, k)
    _check_slot_array("counts", counts, table)
    if bases.shape[0]:
        _build.call(
            "shard_cuckoo_count_step", bases.device, counts.data_ptr(), table.data_ptr(),
            fp.data_ptr(), h_bits, 1 << h_bits, salt, lo, table.shape[0], bases.data_ptr(),
            bases.shape[0], bases.shape[1], k,
        )
    return counts


def _scratch(bases, k: int):
    """K4's mask and count words for a batch, uint32 on its device."""
    tiles = n_tiles(*bases.shape, k)
    return (torch.empty(16 * tiles, dtype=torch.uint32, device=bases.device),
            torch.empty(tiles, dtype=torch.uint32, device=bases.device))


def shard_classify_masks(rows, lo: int, bases, h_bits: int, salt: int, k: int):
    """K4s on CUDA tensors, the plain version on CPU tensors: K4's probe
    launch over the index shard of with-meta ``rows`` (buckets from
    ``lo``).  Returns K4's scratch of the batch, (masks (16 * tiles,),
    counts (tiles,)) uint32: a window's hit and informative bits are set
    only where the shard holds its key."""
    if not _on_cuda("shard_classify_masks", rows, bases):
        return shard_classify_masks_plain(rows, lo, bases, h_bits, salt, k)
    _check_shard_rows(rows, lo, h_bits)
    _check_bases(bases, k)
    _check_windows(bases, k)
    masks, counts = _scratch(bases, k)
    if bases.shape[0]:
        _build.call(
            "shard_classify_masks", bases.device, rows.data_ptr(), rows.shape[1], h_bits, salt,
            lo, rows.shape[0], bases.data_ptr(), bases.shape[0], bases.shape[1], k,
            masks.data_ptr(), counts.data_ptr(),
        )
    return masks, counts


def shard_cuckoo_classify_masks(table, meta, lo: int, bases, h_bits: int, salt: int, k: int, *,
                                fp=None):
    """K4s in the cuckoo layout on CUDA tensors (``fp`` the shard's slot
    fingerprints, ``meta`` its (len(table),) uint32 classes), the plain
    version on CPU tensors: K4's scratch as ``shard_classify_masks``."""
    if not _on_cuda("shard_cuckoo_classify_masks", table, meta, bases):
        return shard_cuckoo_classify_masks_plain(table, meta, lo, bases, h_bits, salt, k)
    _check_shard_table(table, lo, h_bits)
    _check_fp(fp, table)
    _check_slot_array("meta", meta, table)
    _check_bases(bases, k)
    _check_windows(bases, k)
    masks, counts = _scratch(bases, k)
    if bases.shape[0]:
        _build.call(
            "shard_cuckoo_classify_masks", bases.device, table.data_ptr(), fp.data_ptr(),
            meta.data_ptr(), h_bits, 1 << h_bits, salt, lo, table.shape[0], bases.data_ptr(),
            bases.shape[0], bases.shape[1], k, masks.data_ptr(), counts.data_ptr(),
        )
    return masks, counts


def shard_reduce(parts, *, masks: bool):
    """Kernel R on CUDA tensors, the plain version on CPU ones: the
    reduction over the index axis of the I >= 2 shards' buffers on the data
    shard's first device, read where they lie: ``parts`` a sequence of 1-D
    uint32 tensors of one length n (views at any word offset), or a
    contiguous (I, n) uint32 tensor whose rows are the parts.
    masks=True: K4s's mask words ORed and their tiles' count words
    recounted, (masks (n,), counts (n / 16,)); masks=False: K6s's words
    added in uint32, (n,)."""
    parts = _reduce_parts(parts, masks)
    if not _on_cuda("shard_reduce", *parts):
        return shard_reduce_plain(parts, masks=masks)
    n, dev = parts[0].shape[0], parts[0].device
    out = torch.empty(n, dtype=torch.uint32, device=dev)
    counts = torch.empty(n // 16 if masks else 0, dtype=torch.uint32, device=dev)
    if n:
        ptrs = (ctypes.c_void_p * len(parts))(*(p.data_ptr() for p in parts))
        _build.call("shard_reduce", dev, ctypes.addressof(ptrs), len(parts), n, int(masks),
                    out.data_ptr(), counts.data_ptr())
    return (out, counts) if masks else out


def classify_sums(masks, counts, bases_shape: tuple, k: int, boundaries):
    """K4's second launch (``classify_sums_kernel``) on CUDA tensors, the
    plain version on CPU tensors: per-read (total, informative) int32,
    (len(boundaries) - 1,), from K4's scratch (masks, counts) of an (n_rows,
    length) batch, chained by PDL to the launch before it on the stream."""
    n_rows, length = bases_shape
    if boundaries.dtype != torch.int32 or boundaries.dim() != 1 or not boundaries.is_contiguous():
        raise ValueError("boundaries must be a contiguous 1-D int32 tensor")
    if boundaries.shape[0] < 1:
        raise ValueError("boundaries must hold max_reads + 1 entries")
    tiles = n_tiles(n_rows, length, k)
    if masks.shape != (16 * tiles,) or counts.shape != (tiles,):
        raise ValueError(f"scratch of {tuple(masks.shape)} masks and {tuple(counts.shape)} counts "
                         f"for {tiles} tiles")
    if not _on_cuda("classify_sums", masks, counts, boundaries):
        return classify_sums_plain(masks, counts, n_rows, length, k, boundaries)
    max_reads = boundaries.shape[0] - 1
    tot = torch.empty(max_reads, dtype=torch.int32, device=masks.device)
    inf = torch.empty_like(tot)
    if max_reads:
        _build.call("classify_sums", masks.device, masks.data_ptr(), counts.data_ptr(), n_rows,
                    length, k, boundaries.data_ptr(), max_reads, tot.data_ptr(), inf.data_ptr())
    return tot, inf
