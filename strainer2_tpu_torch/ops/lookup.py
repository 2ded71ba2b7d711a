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

- ``cuckoo_lookup``   (K10): found, slot per query.
- ``cuckoo_count_step``, ``cuckoo_count_valid_step``,
  ``cuckoo_classify_step``, ``cuckoo_hit_accumulate``,
  ``cuckoo_hit_stats``: K3, K3 with its valid count, K4, K8 and K9 with
  the two-slot probe, same contracts (count buffers of 2H cells).

Each kernel wrapper launches its CUDA kernel on a CUDA tensor and runs the
plain version on a CPU tensor; nothing else takes the plain path.
"""

from __future__ import annotations

import torch

from strainer2_tpu_torch.constants import INFORMATIVE_KMER, MAX_K
from strainer2_tpu_torch.index.hashing import cuckoo_slots_torch
from strainer2_tpu_torch.ops import _build
from strainer2_tpu_torch.ops.packing import canonical_windows_plain

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
    "gather_index",
    "passing_any",
    "cuckoo_lookup",
    "cuckoo_lookup_plain",
    "cuckoo_count_step",
    "cuckoo_count_step_plain",
    "cuckoo_count_valid_step",
    "cuckoo_count_valid_step_plain",
    "cuckoo_classify_step",
    "cuckoo_classify_step_plain",
    "cuckoo_hit_accumulate",
    "cuckoo_hit_accumulate_plain",
    "cuckoo_hit_stats",
    "cuckoo_hit_stats_plain",
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
                              qhi: torch.Tensor, qlo: torch.Tensor, n_words: int):
    """(found bool, slot int32, [meta word 0 .. n_words-1] uint32), shapes
    of qhi: the JAX ``bucket_lookup_words`` (strainer2_tpu/ops/lookup.py:181).
    Word j of a found key is the uint32-wrapping sum of lane 32 + 16 j + cell
    over its equal cells; 0 where not found."""
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
        bucket = cuckoo_slots_torch(h ^ salt, l, h_bits, 0)
        row = rows32[bucket]  # the one random access
        keys = row[:, : 2 * KEYS_PER_BUCKET].to(torch.int64) & _MASK32
        eq = (keys[:, :KEYS_PER_BUCKET] == h[:, None]) & (keys[:, KEYS_PER_BUCKET:] == l[:, None])
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


def valid_hits_plain(rows, bases, h_bits, salt, k, n_words: int = 1):
    """Flat indices of valid windows, their bucket lookups (found, slot,
    [meta words]) and the window count."""
    idx, qhi, qlo, n = _window_queries(bases, k)
    found, slot, words = bucket_lookup_words_plain(rows, h_bits, salt, qhi, qlo, n_words)
    return idx, found, slot, words, n


def cuckoo_valid_hits_plain(table, bases, h_bits, salt, k, meta=None):
    """valid_hits_plain in the cuckoo layout: the meta word is meta[slot]
    (0 where not found), and there is none without ``meta``."""
    idx, qhi, qlo, n = _window_queries(bases, k)
    found, slot = cuckoo_lookup_plain(table, h_bits, salt, qhi, qlo)
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


def count_step_plain(counts, rows, bases, h_bits: int, salt: int, k: int):
    """counts[slot] += 1 for every valid hit window, in place."""
    return _count_plain(counts, None, valid_hits_plain(rows, bases, h_bits, salt, k))


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


def cuckoo_count_step_plain(counts, table, bases, h_bits: int, salt: int, k: int):
    """The JAX ``_count_step`` + ``accumulate_counts``
    (strainer2_tpu/pipeline/engine.py:301): counts (2H,) uint32, in place."""
    return _count_plain(counts, None, cuckoo_valid_hits_plain(table, bases, h_bits, salt, k))


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


def passing_any(tot, inf, *, paired: bool, min_t: int, min_i: int):
    """Per-pair (paired) or per-read pass mask of the detection thresholds
    (strainer2_tpu/pipeline/detect.py:148-157); padded reads are zero, so
    they never pass with thresholds >= 1."""
    if paired:
        return ((tot[0::2] + tot[1::2]) >= min_t) & ((inf[0::2] + inf[1::2]) >= min_i)
    return (tot >= min_t) & (inf >= min_i)


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


def classify_step(rows, bases, boundaries, h_bits: int, salt: int, k: int):
    """Kernel K4 on CUDA tensors, the plain version on CPU tensors.

    boundaries (max_reads + 1,) int32: each read's first flat window index
    (row * width + col), padded with the batch's window count.
    Returns (total, informative) int32, shape (max_reads,).  The kernel
    runs in three launches (probe to hit masks and tile counts, prefix
    scan, per-read differences) over scratch of 16 mask words and 4 counts
    a 256-window tile."""
    if not _on_cuda("classify_step", rows, bases, boundaries):
        return classify_step_plain(rows, bases, boundaries, h_bits, salt, k)
    _check_rows(rows, h_bits)
    _check_bases(bases, k)
    if boundaries.dtype != torch.int32 or boundaries.dim() != 1 or not boundaries.is_contiguous():
        raise ValueError("boundaries must be a contiguous 1-D int32 tensor")
    if boundaries.shape[0] < 1:
        raise ValueError("boundaries must hold max_reads + 1 entries")
    _check_windows(bases, k)
    max_reads = boundaries.shape[0] - 1
    n_rows, length = bases.shape
    tiles = n_tiles(n_rows, length, k)
    tot = torch.empty(max_reads, dtype=torch.int32, device=bases.device)
    inf = torch.empty_like(tot)
    if max_reads:
        masks = torch.empty(2 * 8 * tiles, dtype=torch.int32, device=bases.device)
        counts = torch.empty(4 * tiles + 2, dtype=torch.int32, device=bases.device)
        _build.call(
            "classify_step", bases.device, rows.data_ptr(), rows.shape[1], h_bits,
            salt, bases.data_ptr(), n_rows, length, k, boundaries.data_ptr(), max_reads,
            masks.data_ptr(), counts.data_ptr(), tot.data_ptr(), inf.data_ptr(),
        )
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


def cuckoo_lookup(table, h_bits: int, salt: int, qhi, qlo):
    """Kernel K10 on CUDA tensors, the plain version on CPU tensors.

    table (2H, 2) uint32; qhi, qlo uint32 of any one shape.  Returns
    (found bool, slot int32) of that shape."""
    if not _on_cuda("cuckoo_lookup", table, qhi, qlo):
        return cuckoo_lookup_plain(table, h_bits, salt, qhi, qlo)
    _check_cuckoo_table(table, h_bits)
    if qhi.shape != qlo.shape or qhi.dtype != torch.uint32 or qlo.dtype != torch.uint32:
        raise ValueError("qhi and qlo must be uint32 tensors of one shape")
    qh, ql = qhi.contiguous(), qlo.contiguous()
    found = torch.empty(qh.shape, dtype=torch.bool, device=qh.device)
    slot = torch.empty(qh.shape, dtype=torch.int32, device=qh.device)
    if qh.numel():
        _build.call(
            "cuckoo_lookup", qh.device, table.data_ptr(), h_bits, table.shape[0] // 2, salt,
            qh.data_ptr(), ql.data_ptr(), qh.numel(), found.data_ptr(), slot.data_ptr(),
        )
    return found, slot


def cuckoo_count_step(counts, table, bases, h_bits: int, salt: int, k: int):
    """K3 with the two-slot probe on CUDA tensors, the plain version on CPU
    tensors.  counts (2H,) uint32 is updated in place and returned."""
    if not _on_cuda("cuckoo_count_step", counts, table, bases):
        return cuckoo_count_step_plain(counts, table, bases, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_bases(bases, k)
    _check_slot_array("counts", counts, table)
    if bases.shape[0]:
        _build.call(
            "cuckoo_count_step", bases.device, counts.data_ptr(), table.data_ptr(), h_bits,
            table.shape[0] // 2, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
        )
    return counts


def cuckoo_count_valid_step(counts, tally, table, bases, h_bits: int, salt: int, k: int):
    """K3 with its valid count and the two-slot probe on CUDA tensors, the
    plain version on CPU tensors: the tally contract of
    ``count_valid_step``."""
    if not _on_cuda("cuckoo_count_valid_step", counts, tally, table, bases):
        return cuckoo_count_valid_step_plain(counts, tally, table, bases, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_bases(bases, k)
    _check_slot_array("counts", counts, table)
    _check_tally(tally, n_tiles(*bases.shape, k))
    if bases.shape[0]:
        _build.call(
            "cuckoo_count_valid_step", bases.device, counts.data_ptr(), table.data_ptr(), h_bits,
            table.shape[0] // 2, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
            tally.data_ptr(),
        )
    return counts


def cuckoo_hit_accumulate(acc, table, bases, h_bits: int, salt: int, k: int):
    """K8 with the two-slot probe on CUDA tensors, the plain version on CPU
    tensors: acc (2,) int64 (hits, valid windows) is added to in place."""
    if not _on_cuda("cuckoo_hit_accumulate", acc, table, bases):
        return cuckoo_hit_accumulate_plain(acc, table, bases, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_bases(bases, k)
    if acc.dtype != torch.int64 or acc.shape != (2,) or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous (2,) int64 tensor")
    if bases.shape[0]:
        _build.call(
            "cuckoo_hit_accumulate", bases.device, acc.data_ptr(), table.data_ptr(), h_bits,
            table.shape[0] // 2, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
        )
    return acc


def cuckoo_hit_stats(table, bases, remaining: int, h_bits: int, salt: int, k: int):
    """K9 with the two-slot probe on CUDA tensors, the plain version on CPU
    tensors: int32 (4,) as ``hit_stats`` returns, in its two launches."""
    if not -2**31 <= remaining < 2**31:
        raise ValueError(f"remaining {remaining} is outside the int32 range")
    if not _on_cuda("cuckoo_hit_stats", table, bases):
        return cuckoo_hit_stats_plain(table, bases, remaining, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_bases(bases, k)
    if bases.shape[0] < 1:
        raise ValueError("bases must hold at least one row")
    _check_windows(bases, k)
    tiles = n_tiles(*bases.shape, k)
    masks = torch.empty(16 * tiles, dtype=torch.int32, device=bases.device)
    tile_counts = torch.empty(tiles, dtype=torch.int32, device=bases.device)
    out = torch.empty(4, dtype=torch.int32, device=bases.device)
    _build.call(
        "cuckoo_hit_stats", bases.device, table.data_ptr(), h_bits, table.shape[0] // 2, salt,
        bases.data_ptr(), bases.shape[0], bases.shape[1], k, remaining, masks.data_ptr(),
        tile_counts.data_ptr(), out.data_ptr(),
    )
    return out


def cuckoo_classify_step(table, meta, bases, boundaries, h_bits: int, salt: int, k: int):
    """K4 with the two-slot probe and a gather of meta[slot] on CUDA
    tensors, the plain version on CPU tensors.

    meta (2H,) uint32, the slot-indexed k-mer class; boundaries as in
    ``classify_step``.  Returns (total, informative) int32, (max_reads,)."""
    if not _on_cuda("cuckoo_classify_step", table, meta, bases, boundaries):
        return cuckoo_classify_step_plain(table, meta, bases, boundaries, h_bits, salt, k)
    _check_cuckoo_table(table, h_bits)
    _check_slot_array("meta", meta, table)
    _check_bases(bases, k)
    if boundaries.dtype != torch.int32 or boundaries.dim() != 1 or not boundaries.is_contiguous():
        raise ValueError("boundaries must be a contiguous 1-D int32 tensor")
    if boundaries.shape[0] < 1:
        raise ValueError("boundaries must hold max_reads + 1 entries")
    _check_windows(bases, k)
    max_reads = boundaries.shape[0] - 1
    tiles = n_tiles(*bases.shape, k)
    tot = torch.empty(max_reads, dtype=torch.int32, device=bases.device)
    inf = torch.empty_like(tot)
    if max_reads:
        masks = torch.empty(2 * 8 * tiles, dtype=torch.int32, device=bases.device)
        counts = torch.empty(4 * tiles + 2, dtype=torch.int32, device=bases.device)
        _build.call(
            "cuckoo_classify_step", bases.device, table.data_ptr(), meta.data_ptr(), h_bits,
            table.shape[0] // 2, salt, bases.data_ptr(), bases.shape[0], bases.shape[1], k,
            boundaries.data_ptr(), max_reads, masks.data_ptr(), counts.data_ptr(),
            tot.data_ptr(), inf.data_ptr(),
        )
    return tot, inf
