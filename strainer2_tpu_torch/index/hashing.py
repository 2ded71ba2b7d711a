"""Hash mixing shared by host-side index construction and device lookup.

All arithmetic is uint32 so the exact same expression runs under NumPy
(index build), JAX on TPU (lookup kernels), and the C++ host library
(native cuckoo builder) with bit-identical results.

This replaces the reference's djb2-string-hash + linear-probe table
(reference src/BIO_hash.c:208-216,131-132): probing chains of unbounded
length are hostile to a vector machine, so the TPU index is a 2-choice
cuckoo table — membership is exactly two dependent-free gathers per query.

Host twin of ``strainer2_tpu.index.hashing``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = ["mix32", "cuckoo_slots", "mix32_torch", "cuckoo_slots_torch", "NUM_HASHES"]

NUM_HASHES = 2

# Distinct odd multipliers per hash function (host and device must agree).
_H_CONST = (
    (np.uint32(0x9E3779B1), np.uint32(0x85EBCA77), np.uint32(0xC2B2AE3D)),
    (np.uint32(0x27D4EB2F), np.uint32(0x165667B1), np.uint32(0xD3A2646D)),
)

_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)


def mix32(x):
    """Full-avalanche 32-bit finalizer (works on np or jnp uint32 arrays)."""
    x = x ^ (x >> 16)
    x = x * _M1
    x = x ^ (x >> 15)
    x = x * _M2
    x = x ^ (x >> 16)
    return x


def cuckoo_slots(hi, lo, h_bits: int, which: int):
    """Slot of (hi, lo) in table ``which`` (0 or 1) of size 2**h_bits.

    hi/lo: uint32 arrays (matching np/jnp namespaces).
    """
    a, b, c = _H_CONST[which]
    x = (hi * a) ^ (lo * b) ^ c
    x = mix32(x)
    return x >> np.uint32(32 - h_bits) if h_bits < 32 else x


# ---- torch twins (plain versions of the hash the CUDA kernels inline) ----
#
# torch's CPU build has no uint32 shifts or compares, so these compute in
# int64 on values below 2**32.  A 32x32-bit product can pass 2**63, so
# _mul32 multiplies by the two 16-bit halves of the constant: every partial
# product stays below 2**48 and the result is the uint32 product mod 2**32,
# bit for bit the numpy expression above.

_MASK32 = 0xFFFFFFFF


def _mul32(x, m: int):
    """(x * m) mod 2**32 for an int64 tensor x in [0, 2**32)."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def mix32_torch(x):
    """``mix32`` on an int64 tensor holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, int(_M1))
    x = x ^ (x >> 15)
    x = _mul32(x, int(_M2))
    return x ^ (x >> 16)


def cuckoo_slots_torch(hi, lo, h_bits: int, which: int):
    """``cuckoo_slots`` on int64 tensors holding uint32 values; int64 out."""
    a, b, c = (int(v) for v in _H_CONST[which])
    x = _mul32(hi, a) ^ _mul32(lo, b) ^ c
    x = mix32_torch(x)
    return x >> (32 - h_bits) if h_bits < 32 else x
