"""Single-probe bucketed membership table — the fast path on v5e.

Measured fact (docs/PERFORMANCE.md): XLA serializes random access per
*index*, but the slice width fetched per index is essentially free.  The
bucket layout exploits this: one hash selects a bucket row that carries
16 candidate keys *and* their metadata, so membership + slot + k-mer class
all resolve from a single gathered row — one serialized access per query
instead of the cuckoo path's four plane gathers.

Row layout, (num_buckets, row_width) uint32 (row_width defaults to 64):
    [ 16 x key_hi | 16 x key_lo | 16 x meta | 16 x meta | ... ]
i.e. two key blocks followed by (row_width - 32) / 16 meta blocks of 32
bits per key each.  The default 64-lane row carries 2 meta blocks (64
meta bits/key, the 32-strain detection layout); wider rows carry more
meta blocks for the same single serialized gather — slice width is
nearly free on v5e (docs/PERFORMANCE.md), which is what makes >32-strain
single-pass detection pay.
Empty cells hold 0xFFFFFFFF in both key planes (impossible for k <= 31).
slot id of bucket b, cell j = b * 16 + j; count buffers are (B*16 + 1,)
with the trailing cell as the scatter drop target.

Construction is a vectorized host pass (hash -> stable sort by bucket ->
rank within bucket); a salt retry handles the (astronomically rare at
load <= 4/16) bucket overflow.

Host twin of ``strainer2_tpu.index.bucket``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

import numpy as np

from strainer2_tpu_torch.index.hashing import cuckoo_slots
from strainer2_tpu_torch.ops.packing_np import split_code64_np

__all__ = ["BucketTable", "build_bucket_table", "KEYS_PER_BUCKET", "ROW_WIDTH"]

KEYS_PER_BUCKET = 16
ROW_WIDTH = 64
EMPTY = np.uint32(0xFFFFFFFF)
_MAX_SALT_ATTEMPTS = 16


class BucketBuildError(RuntimeError):
    pass


class BucketTable:
    """Built table + key->slot mapping (same contract as CuckooTable)."""

    layout = "bucket"

    def __init__(self, table: np.ndarray, slot_of_key: np.ndarray, h_bits: int, salt: int):
        self.table = table  # (2**h_bits, ROW_WIDTH) uint32
        self.slot_of_key = slot_of_key  # (N,) int32, bucket*16 + cell
        self.h_bits = h_bits  # log2(num_buckets)
        self.salt = salt

    @property
    def num_slots(self) -> int:
        return self.table.shape[0] * KEYS_PER_BUCKET

    def with_meta(self, per_slot_meta: np.ndarray) -> np.ndarray:
        """Copy of the row table with the meta block filled from a
        slot-indexed array (e.g. k-mer class for detection)."""
        out = self.table.copy()
        out[:, 32:48] = (
            np.asarray(per_slot_meta, dtype=np.uint32).reshape(-1, KEYS_PER_BUCKET)
        )
        return out

    def with_meta2(self, per_slot_lo: np.ndarray, per_slot_hi: np.ndarray) -> np.ndarray:
        """Copy of the row table with BOTH meta blocks filled (64 meta
        bits per key: lanes 32:48 = lo word, 48:64 = hi word).  Resolved
        together by ops.lookup.bucket_lookup_wide from the same single
        gathered row — the 32-strain-per-pass layout."""
        return self.with_meta_words([per_slot_lo, per_slot_hi])

    @property
    def meta_blocks(self) -> int:
        """Number of 16-lane meta blocks the row layout carries."""
        return (self.table.shape[1] - 32) // KEYS_PER_BUCKET

    def with_meta_words(self, per_slot_words: "list[np.ndarray]") -> np.ndarray:
        """Copy of the row table with the first len(words) meta blocks
        filled from slot-indexed uint32 arrays (word j -> lanes
        32+16j : 48+16j).  All words of the matched key resolve from the
        same single gathered row (ops.lookup.bucket_lookup_words) — the
        >32-strain-per-pass layout packs 2 bits per strain across as many
        words as the row width allows (16 strains per word)."""
        if len(per_slot_words) > self.meta_blocks:
            raise ValueError(
                f"{len(per_slot_words)} meta words > {self.meta_blocks} "
                f"blocks in a {self.table.shape[1]}-lane row"
            )
        out = self.table.copy()
        for j, w in enumerate(per_slot_words):
            lo = 32 + 16 * j
            out[:, lo : lo + 16] = (
                np.asarray(w, dtype=np.uint32).reshape(-1, KEYS_PER_BUCKET)
            )
        return out


def build_bucket_table(
    codes: np.ndarray, k: int, h_bits: int | None = None, row_width: int = ROW_WIDTH
) -> BucketTable:
    """Vectorized bucket placement for unique uint64 ``codes``.

    row_width (a multiple of 16, >= 64) sets how many 16-lane meta blocks
    the rows carry: (row_width - 32) // 16 blocks = 16 strains each for
    multi-strain passes; the default 64-lane row carries 2."""
    codes = np.asarray(codes, dtype=np.uint64)
    if row_width < 64 or row_width % KEYS_PER_BUCKET:
        raise ValueError(f"row_width must be a multiple of 16 >= 64, got {row_width}")
    n = codes.shape[0]
    if h_bits is None:
        # mean bucket load ~<= 3.3 => overflow probability ~1e-8 per bucket
        h_bits = max(4, int(np.ceil(np.log2(max(n, 1) / 3.3))))

    from strainer2_tpu_torch.native import build_bucket_native

    hi, lo = split_code64_np(codes, k)
    for attempt in range(_MAX_SALT_ATTEMPTS):
        salt = attempt * 0x9E3779B9 & 0xFFFFFFFF
        native = build_bucket_native(codes, k, h_bits, salt, row_width)
        if native is not None:
            if native == "retry":
                if attempt % 4 == 3:
                    h_bits += 1
                continue
            table, slot_of_key = native
            return BucketTable(table, slot_of_key, h_bits, salt)
        shi = hi ^ np.uint32(salt) if salt else hi
        bucket = cuckoo_slots(shi, lo, h_bits, 0).astype(np.int64)
        per_bucket = np.bincount(bucket, minlength=1 << h_bits)
        if per_bucket.max(initial=0) > KEYS_PER_BUCKET:
            if attempt % 4 == 3:
                h_bits += 1  # pathological key set: grow occasionally
            continue
        order = np.argsort(bucket, kind="stable")
        offsets = np.zeros((1 << h_bits) + 1, dtype=np.int64)
        np.cumsum(per_bucket, out=offsets[1:])
        cell = np.arange(n, dtype=np.int64) - offsets[bucket[order]]
        slot_of_key = np.empty(n, dtype=np.int32)
        slot_of_key[order] = (bucket[order] * KEYS_PER_BUCKET + cell).astype(np.int32)

        table = np.full((1 << h_bits, row_width), EMPTY, dtype=np.uint32)
        flat_hi = table[:, 0:16].reshape(-1)
        flat_lo = table[:, 16:32].reshape(-1)
        flat_hi[slot_of_key] = hi
        flat_lo[slot_of_key] = lo
        table[:, 0:16] = flat_hi.reshape(-1, 16)
        table[:, 16:32] = flat_lo.reshape(-1, 16)
        table[:, 32:] = 0
        return BucketTable(table, slot_of_key, h_bits, salt)
    raise BucketBuildError(f"bucket table build failed for n={n}")
