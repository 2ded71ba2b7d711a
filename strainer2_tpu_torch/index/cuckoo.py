"""Host-side construction of the 2-choice cuckoo membership table.

Keys are 62-bit packed canonical k-mers stored as two uint32 planes in a
(2*H, 2) array (rows [0, H) are hash-1 slots, rows [H, 2*H) hash-2 slots),
so membership is exactly two probes a query: no probe chains, no strings.

Construction runs on the host (build is the cold path): the native C++
builder when the host library is there, else a vectorized greedy
"first-wins" placement that fills ~95% of keys in a few NumPy rounds, the
small remainder through a classic eviction loop.  The table layout and
hash functions are fixed by index/hashing.py, so both builders give the
same table for the same salt.

Host twin of ``strainer2_tpu.index.cuckoo``: a copy with its imports pointed
at this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py and tests/test_torch_cuckoo.py pin it to the
original.
"""

from __future__ import annotations

import numpy as np

from strainer2_tpu_torch.index.hashing import cuckoo_slots
from strainer2_tpu_torch.ops.packing_np import split_code64_np

__all__ = ["CuckooTable", "CuckooBuildError", "build_cuckoo", "EMPTY_SENTINEL"]

EMPTY_SENTINEL = np.uint32(0xFFFFFFFF)

_MAX_EVICTION_CHAIN = 500
_MAX_SEED_ATTEMPTS = 8


class CuckooBuildError(RuntimeError):
    pass


class CuckooTable:
    """Built table + key->slot mapping.

    Attributes
    ----------
    table: (2*H, 2) uint32; columns are (hi, lo) planes; empty slots hold
        (EMPTY_SENTINEL, EMPTY_SENTINEL), which cannot collide with a real
        key for k <= 31 (hi < 2**30).
    slot_of_key: (N,) int32 row index in ``table`` for each input key.
    h_bits: log2 of per-table size H.
    salt: uint32 mixed into both hash functions (bumped on rare build
        failure; the device lookup must use the same salt).
    """

    layout = "cuckoo"

    def __init__(self, table: np.ndarray, slot_of_key: np.ndarray, h_bits: int, salt: int):
        self.table = table
        self.slot_of_key = slot_of_key
        self.h_bits = h_bits
        self.salt = salt

    @property
    def num_slots(self) -> int:
        return self.table.shape[0]


def _salted(hi: np.ndarray, salt: int) -> np.ndarray:
    return hi ^ np.uint32(salt) if salt else hi


def build_cuckoo(codes: np.ndarray, k: int, h_bits: int | None = None) -> CuckooTable:
    """Build the cuckoo table for unique uint64 ``codes``.

    h_bits defaults to the smallest table with total load factor <= 0.42
    (comfortably below the 2-ary cuckoo threshold of 0.5).
    """
    codes = np.asarray(codes, dtype=np.uint64)
    n = codes.shape[0]
    if h_bits is None:
        h_bits = max(4, int(np.ceil(np.log2(max(n, 1) / 0.84))))

    from strainer2_tpu_torch.native import build_cuckoo_native

    hi, lo = split_code64_np(codes, k)
    for attempt in range(_MAX_SEED_ATTEMPTS):
        salt = attempt * 0x9E3779B9 & 0xFFFFFFFF
        native = build_cuckoo_native(codes, k, h_bits, salt)
        if native is None:  # library unavailable: Python builder
            try:
                table, slot_of_key = _try_build(hi, lo, h_bits, salt)
                return CuckooTable(table, slot_of_key, h_bits, salt)
            except CuckooBuildError:
                pass
        elif native != "retry":
            table, slot_of_key = native
            return CuckooTable(table, slot_of_key, h_bits, salt)
        if attempt % 2 == 1:
            h_bits += 1  # grow every other retry
    raise CuckooBuildError(f"cuckoo build failed for n={n} after retries")


def _try_build(hi: np.ndarray, lo: np.ndarray, h_bits: int, salt: int):
    n = hi.shape[0]
    h = 1 << h_bits
    shi = _salted(hi, salt)
    s0 = cuckoo_slots(shi, lo, h_bits, 0).astype(np.int64)
    s1 = cuckoo_slots(shi, lo, h_bits, 1).astype(np.int64) + h

    key_at_slot = np.full(2 * h, -1, dtype=np.int64)  # key index or -1
    slot_of_key = np.full(n, -1, dtype=np.int64)

    # --- vectorized greedy rounds: each key tries its two slots, first
    # writer wins (np.unique picks first occurrence in index order).
    pending = np.arange(n, dtype=np.int64)
    for _ in range(6):
        if pending.size == 0:
            break
        for cand in (s0, s1):
            if pending.size == 0:
                break
            slots = cand[pending]
            free = key_at_slot[slots] < 0
            idx_free = pending[free]
            slots_free = slots[free]
            uniq_slots, first_idx = np.unique(slots_free, return_index=True)
            winners = idx_free[first_idx]
            key_at_slot[uniq_slots] = winners
            slot_of_key[winners] = uniq_slots
            pending = pending[slot_of_key[pending] < 0]

    # --- eviction loop for the residue (both candidate slots occupied).
    for key in pending.tolist():
        cur = int(key)
        target = int(s0[cur])
        for _step in range(_MAX_EVICTION_CHAIN):
            displaced = int(key_at_slot[target])
            key_at_slot[target] = cur
            slot_of_key[cur] = target
            if displaced < 0:
                break
            # displaced key moves to its other slot
            cur = displaced
            a, b = int(s0[cur]), int(s1[cur])
            target = b if slot_of_key[cur] == a else a
        else:
            raise CuckooBuildError("eviction chain exceeded limit")

    table = np.full((2 * h, 2), EMPTY_SENTINEL, dtype=np.uint32)
    occ = key_at_slot >= 0
    table[occ, 0] = hi[key_at_slot[occ]]
    table[occ, 1] = lo[key_at_slot[occ]]
    return table, slot_of_key.astype(np.int32)
