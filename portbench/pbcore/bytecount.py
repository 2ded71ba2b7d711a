"""Bytes a step has to move, counted from its inputs and answers alone.

The same count holds for the bucket or the cuckoo layout, or any later
layout or fusion: inputs read once (one byte a base, 4 B a read boundary),
one 32 B sector a valid window's table probe, one 32 B sector a counted
hit (counting), and the outputs written once: the engine's per-read
(total, informative) int32 pair, times S strains for the multi-strain
step.  A step's least time is its bytes over the device's peak bandwidth
(``peaks.py``); it moves so little arithmetic that bandwidth bounds it.

A driver gives its step's count as ``step_bytes(stats, cell)``, built from
these functions or, for a new stage entry, from its own.
"""

from __future__ import annotations

SECTOR = 32  # bytes of one DRAM sector
BOUNDARY = 4  # bytes of one read boundary (int32)
SUMS = 8  # bytes of one read's (total, informative) int32 pair


def classify_bytes(st, n_strains: int = 1) -> int:
    """Classification of S strains: K4 and its gate at S = 1, K6/K7 above,
    or what replaces them."""
    return st.bases + BOUNDARY * st.reads + SECTOR * st.valid + SUMS * n_strains * st.reads


def count_bytes(st) -> int:
    """Panel counting (K3, or what replaces it): bases, a probe a valid
    window, a count sector a hit."""
    return st.bases + SECTOR * st.valid + SECTOR * st.hits

