"""Multi-strain classification kernels K6-K7 and their plain torch versions.

The multi-strain detector (pipeline/multi_detect.py) packs two bits per
strain into the union table's meta words: word s // 16, bit 2 (s % 16) =
strain s has the k-mer, bit 2 (s % 16) + 1 = it is informative for s.  One
probe per window answers every strain of the pass:

- ``multi_hit_words`` (K6): per window of a (rows, L) batch, the first
  ``n_words`` meta words of the matched key, 0 on a miss or an invalid
  window; (Q, n_words) uint32, window-major.  This is the JAX
  ``multi_detect._classify_multi`` up to its segment sum (canonical
  windows, ``bucket_lookup_words`` / ``bucket_lookup``, hit mask).
- ``shard_multi_hit_words`` (K6s): K6 over an index shard of the union
  rows of a (data, index) mesh (parallel/sharding.py): the words of the
  windows whose key the shard holds, 0 elsewhere, for R to add.
- ``boundary_strain_sums`` (K7): per read r = window span [b[r], b[r+1])
  and strain s, the windows with the present bit set (tot) and with the
  informative bit set (inf); two (R, S) int32 matrices, exactly the JAX
  ``ops.segsum.boundary_strain_sums``.  The JAX version's SWAR counters and
  two-level chunked prefix vectorise a TPU's lanes; the result is the same
  integers.

Each kernel wrapper launches its CUDA kernel on CUDA tensors and runs the
plain version on CPU tensors; nothing else takes the plain path.
"""

from __future__ import annotations

import torch

from strainer2_tpu_torch.ops import _build
from strainer2_tpu_torch.ops.lookup import (
    KEYS_PER_BUCKET,
    META_LANE,
    _check_bases,
    _check_rows,
    _check_shard_rows,
    _on_cuda,
    gather_index,
    valid_hits_plain,
)

__all__ = [
    "multi_hit_words",
    "multi_hit_words_plain",
    "shard_multi_hit_words",
    "boundary_strain_sums",
    "boundary_strain_sums_plain",
    "words_for_strains",
]


def words_for_strains(n_strains: int) -> int:
    """Meta words a pass of ``n_strains`` reads per window: ceil(S / 16),
    one for S <= 16 (the JAX branch at multi_detect.py:1039-1051)."""
    return max(1, -(-n_strains // KEYS_PER_BUCKET))


# ---- plain versions -------------------------------------------------------

def multi_hit_words_plain(rows, bases, h_bits: int, salt: int, k: int, n_words: int,
                          lo: int = 0):
    """(Q, n_words) uint32 masked meta words, Q = rows * (L - k + 1).  With
    ``lo``, ``rows`` is the index shard of union rows from bucket lo, and a
    word is 0 where the shard does not hold the key: the JAX
    ``_bucket_local_lookup_words`` in ``_classify_multi_body_bucket``
    (strainer2_tpu/parallel/sharding.py:236-291) before its psum."""
    idx, found, _, words, n_windows = valid_hits_plain(rows, bases, h_bits, salt, k, n_words, lo)
    out = torch.zeros((n_windows, n_words), dtype=torch.int32, device=bases.device)
    if idx.numel():
        # int32 views: CUDA torch indexes no uint32 tensor (same bits)
        out[idx[found]] = torch.stack([w.view(torch.int32) for w in words], dim=1)[found]
    return out.view(torch.uint32)


def boundary_strain_sums_plain(words, boundaries, n_strains: int):
    """(tot, inf), each (R, S) int32: differences of per-strain prefix sums
    at the boundaries (read as a JAX gather reads them, as K7 does).  The bit
    planes are (strains, Q), so each prefix sum runs along the contiguous
    last axis (a cumsum down the first axis of a (Q, 16) plane is a serial
    scan per column on CUDA)."""
    q, n_words = words.shape
    w64 = words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = gather_index(boundaries, q)
    b0, b1 = b[:-1], b[1:]
    n_reads = b0.shape[0]
    tot = torch.zeros((n_reads, n_strains), dtype=torch.int32, device=words.device)
    inf = torch.zeros_like(tot)
    for j in range(n_words):
        n_j = min(KEYS_PER_BUCKET, n_strains - KEYS_PER_BUCKET * j)
        if n_j <= 0:
            break
        shifts = 2 * torch.arange(n_j, dtype=torch.int64, device=words.device)[:, None]
        word = w64[:, j].contiguous()[None, :]
        for bit, dst in ((0, tot), (1, inf)):
            plane = (word >> (shifts + bit)) & 1  # (n_j, Q)
            cum = torch.nn.functional.pad(torch.cumsum(plane, dim=1), (1, 0))
            dst[:, KEYS_PER_BUCKET * j : KEYS_PER_BUCKET * j + n_j] = (cum[:, b1] - cum[:, b0]).T.to(torch.int32)
    return tot, inf


# ---- kernel wrappers ------------------------------------------------------

def multi_hit_words(rows, bases, h_bits: int, salt: int, k: int, n_words: int):
    """Kernel K6 on CUDA tensors, the plain version on CPU tensors.

    rows (2**h_bits, 32 + 16 W) uint32 with W >= n_words meta blocks;
    bases (rows, L) uint8.  Returns (Q, n_words) uint32."""
    blocks = (rows.shape[1] - META_LANE) // KEYS_PER_BUCKET
    if not 1 <= n_words <= blocks:
        raise ValueError(f"n_words {n_words} outside [1, {blocks}] for a {rows.shape[1]}-lane row")
    if not _on_cuda("multi_hit_words", rows, bases):
        return multi_hit_words_plain(rows, bases, h_bits, salt, k, n_words)
    _check_rows(rows, h_bits)
    _check_bases(bases, k)
    n_rows, length = bases.shape
    words = torch.empty((n_rows * (length - k + 1), n_words), dtype=torch.uint32, device=bases.device)
    if n_rows:
        _build.call(
            "multi_hit_words", bases.device, rows.data_ptr(), rows.shape[1], h_bits, salt,
            bases.data_ptr(), n_rows, length, k, n_words, words.data_ptr(),
        )
    return words


def shard_multi_hit_words(rows, lo: int, bases, h_bits: int, salt: int, k: int, n_words: int):
    """Kernel K6s on CUDA tensors, the plain version on CPU tensors: K6 over
    the index shard ``rows`` of the union rows (buckets from ``lo``).
    Returns (Q, n_words) uint32, 0 where the shard does not hold a
    window's key; R adds the shards' words (``lookup.shard_reduce``)."""
    blocks = (rows.shape[1] - META_LANE) // KEYS_PER_BUCKET
    if not 1 <= n_words <= blocks:
        raise ValueError(f"n_words {n_words} outside [1, {blocks}] for a {rows.shape[1]}-lane row")
    if not _on_cuda("shard_multi_hit_words", rows, bases):
        return multi_hit_words_plain(rows, bases, h_bits, salt, k, n_words, lo)
    _check_shard_rows(rows, lo, h_bits)
    _check_bases(bases, k)
    n_rows, length = bases.shape
    words = torch.empty((n_rows * (length - k + 1), n_words), dtype=torch.uint32, device=bases.device)
    if n_rows:
        _build.call(
            "shard_multi_hit_words", bases.device, rows.data_ptr(), rows.shape[1], h_bits, salt,
            lo, rows.shape[0], bases.data_ptr(), n_rows, length, k, n_words, words.data_ptr(),
        )
    return words


def boundary_strain_sums(words, boundaries, n_strains: int):
    """Kernel K7 on CUDA tensors, the plain version on CPU tensors.

    words (Q, W) uint32 from ``multi_hit_words``; boundaries (R + 1,) int32
    ascending window offsets in [0, Q] (duplicates = empty reads, padding =
    Q).  Returns (tot, inf), each (R, n_strains) int32.  The kernel takes
    W <= 16 words a window (256 strains, MAX_STRAINS_PER_PASS)."""
    if words.dtype != torch.uint32 or words.dim() != 2 or not words.is_contiguous():
        raise ValueError("words must be a contiguous (Q, n_words) uint32 tensor")
    if not 1 <= n_strains <= KEYS_PER_BUCKET * words.shape[1]:
        raise ValueError(f"n_strains {n_strains} outside [1, {KEYS_PER_BUCKET * words.shape[1]}]")
    if boundaries.dtype != torch.int32 or boundaries.dim() != 1 or boundaries.shape[0] < 1:
        raise ValueError("boundaries must be a 1-D int32 tensor of R + 1 offsets")
    if not _on_cuda("boundary_strain_sums", words, boundaries):
        return boundary_strain_sums_plain(words, boundaries, n_strains)
    if words.shape[1] > KEYS_PER_BUCKET:
        raise ValueError(f"{words.shape[1]} words a window > {KEYS_PER_BUCKET}: the kernel sums at most 256 strains")
    if words.numel() >= 2**31:
        raise ValueError(f"{words.numel()} words do not fit int32 offsets")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    b = boundaries.contiguous()
    n_reads = b.shape[0] - 1
    tot = torch.empty((n_reads, n_strains), dtype=torch.int32, device=words.device)
    inf = torch.empty_like(tot)
    if n_reads:
        _build.call(
            "strain_sums", words.device, words.data_ptr(), words.shape[0], words.shape[1],
            b.data_ptr(), n_reads, n_strains, tot.data_ptr(), inf.data_ptr(),
        )
    return tot, inf
