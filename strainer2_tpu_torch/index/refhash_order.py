"""Replay of the reference's hash-table row order for bit-identical output.

Every table the reference prints is in BIO_hash slot order: djb2 of the
k-mer string mod capacity, linear probing, capacity doubling (with rehash
in old-slot order) once the pre-insert key count reaches capacity/2
(reference src/BIO_hash.c:111-139 insert+expand trigger, 39-61 expand,
208-216 djb2, src/kmer_scrub_count.c:134-156 slot-order printing).

The TPU engine stores k-mers as packed codes in first-encounter order; this
module simulates the reference insertion sequence over those codes at
output time — an O(N) host post-pass completely off the hot path — and
returns the permutation mapping first-encounter order to printed row order.

A native C++ implementation is preferred when built (strainer2_tpu/native);
this Python version is the fallback and the oracle for it.

Host twin of ``strainer2_tpu.index.refhash_order``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

import numpy as np

from strainer2_tpu_torch.constants import REFERENCE_HASH_INITIAL_CAPACITY

__all__ = ["djb2_codes", "reference_row_order", "reference_initial_capacity"]

_ASCII = np.array([65, 67, 71, 84], dtype=np.uint32)  # 'A' 'C' 'G' 'T'


def reference_initial_capacity(requested: int) -> int:
    """BIO_initHash size clamping (reference src/BIO_hash.c:14-22)."""
    if requested == 0:
        return 1000  # DEFAULT_HASH_SIZE
    if requested < 10:
        return 10  # MINIMUM_HASH_SIZE
    return requested


def djb2_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Vectorized djb2 of the ACGT string of each packed code (uint32).

    djb2 is linear in the characters: h = 5381*33^k + sum c_i * 33^(k-1-i)
    (mod 2^32), so the whole key set hashes in k vector passes.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    acc = np.zeros(codes.shape, dtype=np.uint32)
    for i in range(k):
        c = _ASCII[((codes >> np.uint64(2 * (k - 1 - i))) & np.uint64(3)).astype(np.int64)]
        acc += c * np.uint32(pow(33, k - 1 - i, 1 << 32))
    return acc + np.uint32((5381 * pow(33, k, 1 << 32)) & 0xFFFFFFFF)


def reference_row_order(
    codes: np.ndarray,
    k: int,
    initial_capacity: int = REFERENCE_HASH_INITIAL_CAPACITY,
) -> np.ndarray:
    """Permutation p with codes[p] = reference printed row order.

    ``codes`` must be the distinct canonical k-mers in first-encounter
    (i.e. reference insertion) order.  Uses the native C++ replay when
    built (~100x the Python fallback below).
    """
    from strainer2_tpu_torch.native import reference_row_order_native

    native = reference_row_order_native(codes, k, initial_capacity)
    if native is not None:
        return native

    n = codes.shape[0]
    hashes = djb2_codes(codes, k).tolist()
    m = reference_initial_capacity(initial_capacity)

    table = [-1] * m
    count = 0  # h->N before the current insert

    def insert(key_idx: int, tbl: list, cap: int) -> None:
        slot = hashes[key_idx] % cap
        while tbl[slot] != -1:
            slot += 1
            if slot == cap:
                slot = 0
        tbl[slot] = key_idx

    for i in range(n):
        insert(i, table, m)
        if count >= m // 2:
            # expand: double capacity, reinsert in old slot order
            new_m = m * 2
            new_table = [-1] * new_m
            re_count = 0
            for key_idx in table:
                if key_idx != -1:
                    insert(key_idx, new_table, new_m)
                    # reference re-checks the growth trigger during rehash
                    if re_count >= new_m // 2:
                        raise RuntimeError("nested expand during rehash")
                    re_count += 1
            table, m = new_table, new_m
        count += 1

    return np.fromiter((i for i in table if i != -1), dtype=np.int64, count=n)
