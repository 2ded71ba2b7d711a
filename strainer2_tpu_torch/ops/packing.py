"""Canonical k-mer window extraction: kernel K1 and its plain torch version.

Same representation as the JAX package (strainer2_tpu/ops/packing.py): a
k-mer (k <= 32) packs MSB-first with A=0 < C=1 < G=2 < T=3, canonical =
max(forward, reverse complement), forward on ties, stored as two uint32
planes split at a base boundary (lo = last min(k, 16) bases, hi = the
rest).  ``valid`` is True where all k bases are below INVALID_BASE.

``canonical_windows`` runs the CUDA kernel on a CUDA tensor and the plain
version on a CPU tensor.  Both pack an invalid base as ``b & 3``, so they
agree on every window; the JAX functions agree with them where valid.
"""

from __future__ import annotations

import torch

from strainer2_tpu_torch.constants import INVALID_BASE, MAX_K
from strainer2_tpu_torch.ops import _build

__all__ = ["canonical_windows", "canonical_windows_plain"]


def _check(bases: torch.Tensor, k: int) -> int:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if bases.dim() != 2:
        raise ValueError(f"bases must be (rows, L), got shape {tuple(bases.shape)}")
    if bases.shape[1] < k:
        raise ValueError(f"sequence length {bases.shape[1]} < k {k}")
    return bases.shape[1] - k + 1


def canonical_windows_plain(bases: torch.Tensor, k: int):
    """(hi uint32, lo uint32, valid bool), each (rows, L - k + 1).

    Loops over the k bases of a window, shifting whole (rows, width) planes:
    int64 arithmetic on 32-bit planes, because torch's CPU build has no
    uint32 shifts or compares."""
    width = _check(bases, k)
    b = bases.to(torch.int64)
    ok = b < INVALID_BASE
    two = b & 3
    comp = 3 - two
    n_lo = min(k, 16)

    def pack(src, positions):
        acc = torch.zeros((b.shape[0], width), dtype=torch.int64, device=b.device)
        for i in positions:
            acc = (acc << 2) | src[:, i : i + width]
        return acc

    fhi = pack(two, range(0, k - n_lo))
    flo = pack(two, range(k - n_lo, k))
    # reverse complement: base i of the window lands at bit 2*i of the rc code
    rhi = pack(comp, reversed(range(n_lo, k)))
    rlo = pack(comp, reversed(range(0, n_lo)))
    valid = ok[:, 0:width].clone()
    for i in range(1, k):
        valid &= ok[:, i : i + width]
    fwd_wins = (fhi > rhi) | ((fhi == rhi) & (flo >= rlo))
    hi = torch.where(fwd_wins, fhi, rhi).to(torch.uint32)
    lo = torch.where(fwd_wins, flo, rlo).to(torch.uint32)
    return hi, lo, valid


def canonical_windows(bases: torch.Tensor, k: int):
    """Kernel K1 on a CUDA tensor, the plain version on a CPU tensor.

    bases: (rows, L) uint8 base codes (0..3, or >= INVALID_BASE).
    Returns (hi uint32, lo uint32, valid bool), each (rows, L - k + 1).
    """
    if bases.device.type == "cpu":
        return canonical_windows_plain(bases, k)
    if bases.device.type != "cuda":
        raise ValueError(f"canonical_windows: unsupported device {bases.device}")
    width = _check(bases, k)
    if bases.dtype != torch.uint8 or not bases.is_contiguous():
        raise ValueError("canonical_windows: bases must be contiguous uint8")
    rows = bases.shape[0]
    if rows > 65535:
        raise ValueError(f"canonical_windows: {rows} rows > 65535")
    hi = torch.empty((rows, width), dtype=torch.uint32, device=bases.device)
    lo = torch.empty_like(hi)
    valid = torch.empty((rows, width), dtype=torch.bool, device=bases.device)
    if rows:
        _build.call(
            "canonical_windows", bases.device, bases.data_ptr(), rows,
            bases.shape[1], k, hi.data_ptr(), lo.data_ptr(), valid.data_ptr(),
        )
    return hi, lo, valid
