"""Host (NumPy) twins of the device packing kernels — jax-free.

Host twin of ``strainer2_tpu.ops.packing_np``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

import numpy as np

from strainer2_tpu_torch.constants import INVALID_BASE

__all__ = [
    "encode_ascii_np",
    "split_code64_np",
    "merge_code64_np",
    "decode_codes_np",
    "canonical_codes_np",
]


def _ascii_code_table() -> np.ndarray:
    table = np.full(256, INVALID_BASE, dtype=np.uint8)
    for codes, value in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("Tt", 3)):
        for ch in codes:
            table[ord(ch)] = value
    return table


_ASCII_TABLE = _ascii_code_table()


def encode_ascii_np(ascii_bytes: np.ndarray) -> np.ndarray:
    """Host (NumPy) twin of :func:`strainer2_tpu.ops.packing.encode_ascii`."""
    return _ASCII_TABLE[np.ascontiguousarray(ascii_bytes).view(np.uint8)]


def split_code64_np(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """uint64 codes -> (hi, lo) uint32 planes (host side)."""
    n_lo = min(k, 16)
    codes = codes.astype(np.uint64)
    lo = (codes & np.uint64((1 << (2 * n_lo)) - 1)).astype(np.uint32)
    hi = (codes >> np.uint64(2 * n_lo)).astype(np.uint32)
    return hi, lo


def merge_code64_np(hi: np.ndarray, lo: np.ndarray, k: int) -> np.ndarray:
    """(hi, lo) uint32 planes -> uint64 codes (host side)."""
    n_lo = min(k, 16)
    return (hi.astype(np.uint64) << np.uint64(2 * n_lo)) | lo.astype(np.uint64)


def decode_codes_matrix_np(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 packed codes -> (n, k) uint8 ASCII matrix (host side).

    Chunked: the naive broadcast builds an (n, k) uint64 intermediate
    (gigabytes at strain scale) — decode 256k rows at a time instead.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    shifts = np.arange(k - 1, -1, -1, dtype=np.uint64) * np.uint64(2)
    ascii_tab = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = np.empty((codes.shape[0], k), dtype=np.uint8)
    step = 1 << 18
    for s in range(0, codes.shape[0], step):
        block = codes[s : s + step]
        base_idx = ((block[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
        out[s : s + step] = ascii_tab[base_idx]
    return out


def decode_codes_np(codes: np.ndarray, k: int) -> list[str]:
    """uint64 packed codes -> ACGT strings (host side, for output writers)."""
    chars = decode_codes_matrix_np(codes, k)
    return [bytes(row).decode("ascii") for row in chars]


def canonical_codes_np(base_codes: np.ndarray, k: int):
    """Host (NumPy) twin of :func:`strainer2_tpu.ops.packing.canonical_windows`
    for one sequence.

    Used off the hot path (e.g. re-scanning the rare reads that pass
    detection thresholds to emit their informative windows).  Returns
    (codes uint64, valid bool) over the L-k+1 windows; empty for L < k.
    """
    b = np.asarray(base_codes, dtype=np.uint8)
    length = b.shape[0]
    if length < k:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    win = np.lib.stride_tricks.sliding_window_view(b, k)
    valid = (win < INVALID_BASE).all(axis=1)
    weights = np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64)
    two_bit = (win & np.uint8(3)).astype(np.uint64)
    fwd = (two_bit * weights).sum(axis=1, dtype=np.uint64)
    rc = ((np.uint64(3) - two_bit)[:, ::-1] * weights).sum(axis=1, dtype=np.uint64)
    return np.where(fwd >= rc, fwd, rc), valid
