"""Dense fixed-shape packing of variable-length sequences for the device.

TPU-first layout: instead of padding each read to a bucketed length (wasted
FLOPs, many compiled shapes), reads/contigs are packed *contiguously* into a
fixed (rows, row_len) uint8 buffer with a single INVALID_BASE separator
between reads.  Every length-k window of the buffer is extracted on device;
windows that straddle a read boundary or padding contain the invalid code
and are masked out automatically by the packer's validity plane.  One batch
shape => one XLA compilation, zero per-read padding waste.

Sequences longer than a row (genome contigs) are split across rows — and,
for counting streams, across buffers — with a k-1 base overlap halo so no
window is lost or duplicated: the k-mer analogue of sequence-parallel
context splitting (SURVEY.md §2.7).

For detection, each read's valid windows form one contiguous span of the
flattened window axis (halo continuation keeps spans unbroken), so per-read
hit counts are differences of a cumulative sum at the recorded
window_starts boundaries — the per-read loops of reference
src/strain_detect.c:443-541 collapse into one vectorized cumsum plus a
boundary gather, with no scatter at all.

Host twin of ``strainer2_tpu.io.batches``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from strainer2_tpu_torch.constants import INVALID_BASE
from strainer2_tpu_torch.ops.packing_np import encode_ascii_np

__all__ = ["PackedBatch", "pack_stream", "read_codes_from_batch", "batch_read_grouping", "DEFAULT_ROWS", "DEFAULT_ROW_LEN"]

DEFAULT_ROWS = 256
DEFAULT_ROW_LEN = 4096


@dataclass
class PackedBatch:
    """One device-ready buffer of packed sequences.

    bases: (rows, row_len) uint8, values 0..3 or INVALID_BASE.
    read_id: (rows, row_len) int32 batch-local read index at each position,
        -1 on separators/padding; None unless with_read_ids.
    n_reads: number of reads packed into this batch.
    read_lengths: (n_reads,) int64 original sequence lengths (also records
        reads shorter than k, which occupy no buffer space but matter for
        the reference's evaluated-read statistics).
    window_starts: (n_reads,) int64 flat index (row * width + col, width =
        row_len - k + 1) of each read's first window.  Because rows
        continue a split read with a k-1 halo, a read's valid windows form
        ONE contiguous flat span, so per-read reductions are differences
        of a cumulative sum at these boundaries — no scatter needed.
    """

    bases: np.ndarray
    read_id: np.ndarray | None
    n_reads: int
    read_lengths: np.ndarray
    window_starts: np.ndarray | None = None


class _Packer:
    def __init__(self, k: int, rows: int, row_len: int, with_read_ids: bool,
                 max_reads: int | None = None):
        if row_len < 2 * k:
            raise ValueError("row_len must be at least 2*k")
        self.k = k
        self.rows = rows
        self.row_len = row_len
        self.with_read_ids = with_read_ids
        self.max_reads = max_reads
        self._reset()

    def _reset(self):
        self.bases = np.full((self.rows, self.row_len), INVALID_BASE, dtype=np.uint8)
        self.ids = (
            np.full((self.rows, self.row_len), -1, dtype=np.int32)
            if self.with_read_ids
            else None
        )
        self.row = 0
        self.col = 0
        self.lengths: list[int] = []
        self.win_starts: list[int] = []

    def emit(self) -> PackedBatch | None:
        if not self.lengths:
            return None
        out = PackedBatch(
            bases=self.bases,
            read_id=self.ids,
            n_reads=len(self.lengths),
            read_lengths=np.asarray(self.lengths, dtype=np.int64),
            window_starts=(
                np.asarray(self.win_starts, dtype=np.int64)
                if self.with_read_ids
                else None
            ),
        )
        self._reset()
        return out

    def capacity_left(self) -> int:
        """Bases placeable without splitting across a buffer boundary."""
        in_row = self.row_len - self.col
        if in_row < self.k:
            in_row = 0
        later_rows = max(0, self.rows - self.row - 1)
        return in_row + later_rows * (self.row_len - (self.k - 1))

    def add(self, codes: np.ndarray) -> Iterator[PackedBatch]:
        """Place one encoded read; yields completed batches if the read is
        split across buffers (counting streams only)."""
        rid = len(self.lengths)
        self.lengths.append(int(codes.shape[0]))
        width = self.row_len - self.k + 1
        n = codes.shape[0]
        if n < self.k:
            # no windows; boundary collapses onto the next read's span
            self.win_starts.append(self.row * width + min(self.col, width))
            return
        pos = 0
        first = True
        while pos < n:
            if self.row_len - self.col < self.k:
                self.row += 1
                self.col = 0
            if self.row >= self.rows:
                if self.with_read_ids:
                    raise ValueError(
                        "read does not fit in one buffer; increase rows/row_len "
                        "for read-id (detection) streams"
                    )
                batch = self.emit()
                if batch is not None:
                    yield batch
                rid = 0
                self.lengths = [0]  # continuation fragment, stats not double-counted
                self.win_starts = [0]
            if not first:
                pos -= self.k - 1  # overlap halo: boundary windows exist exactly once
            else:
                self.win_starts.append(self.row * width + self.col)
            first = False
            take = min(n - pos, self.row_len - self.col)
            r, c = self.row, self.col
            self.bases[r, c : c + take] = codes[pos : pos + take]
            if self.ids is not None:
                self.ids[r, c : c + take] = rid
            self.col += take
            pos += take
        # separator between reads (positions already INVALID_BASE)
        if self.row_len - self.col >= 1:
            self.col += 1
        else:
            self.row += 1
            self.col = 0


def max_reads_capacity(k: int, rows: int = DEFAULT_ROWS, row_len: int = DEFAULT_ROW_LEN) -> int:
    """Static bound on reads per batch used for segment-sum shapes.

    Reads with >= k bases consume at least k+1 positions, but sub-k reads
    consume none, so the bound is enforced by the packer rather than
    derived purely from geometry; this value is the enforced default.
    """
    return rows * ((row_len + k) // (k + 1))


def pack_stream(
    seqs: Iterable[bytes | np.ndarray],
    k: int,
    rows: int = DEFAULT_ROWS,
    row_len: int = DEFAULT_ROW_LEN,
    with_read_ids: bool = False,
    group_size: int = 1,
    max_reads: int | None = None,
) -> Iterator[PackedBatch]:
    """Pack an iterable of sequences into device-ready PackedBatches.

    group_size=2 keeps consecutive sequences (PE mates) in one batch so
    paired-end aggregation never crosses a batch boundary.  max_reads caps
    reads per batch (keeps segment-sum shapes static for detection).
    """
    if max_reads is None and with_read_ids:
        max_reads = max_reads_capacity(k, rows, row_len)
    packer = _Packer(k, rows, row_len, with_read_ids, max_reads)
    group: list[np.ndarray] = []

    def place(gr: list[np.ndarray]) -> Iterator[PackedBatch]:
        need = sum(g.shape[0] for g in gr if g.shape[0] >= k) + len(gr)
        over_reads = (
            packer.max_reads is not None
            and len(packer.lengths) + len(gr) > packer.max_reads
        )
        if packer.lengths and (packer.capacity_left() < need or over_reads):
            batch = packer.emit()
            if batch is not None:
                yield batch
        for g in gr:
            yield from packer.add(g)

    for seq in seqs:
        if isinstance(seq, np.ndarray):
            codes = seq
        else:
            codes = encode_ascii_np(np.frombuffer(seq, dtype=np.uint8))
        group.append(codes)
        if len(group) >= group_size:
            yield from place(group)
            group = []
    if group:
        yield from place(group)
    batch = packer.emit()
    if batch is not None:
        yield batch


def batch_read_grouping(batch: PackedBatch):
    """Precompute per-read position lists for :func:`read_codes_from_batch`.

    The packer places reads in increasing read-id order along the row-major
    buffer (separators/padding are -1), so the id plane restricted to valid
    positions is already non-decreasing: dropping the -1s IS the stable
    sort, no argsort needed.
    """
    flat = batch.read_id.reshape(-1)
    order = np.flatnonzero(flat >= 0).astype(np.int64)
    sorted_ids = flat[order]
    return order, sorted_ids


def read_codes_from_batch(batch: PackedBatch, rid: int, k: int, grouping=None) -> np.ndarray:
    """Reconstruct one read's encoded bases from the packed buffer.

    Rows continuing a split read re-emit a k-1 base halo; those duplicate
    positions are dropped so the result equals the original encoded read.
    Used to re-scan the rare reads that pass detection thresholds without
    retaining every raw read on the host.
    """
    if grouping is None:
        grouping = batch_read_grouping(batch)
    order, sorted_ids = grouping
    # scalar must match the array dtype: a Python int promotes the whole
    # sorted array to a fresh int64 copy on every call
    rid_t = sorted_ids.dtype.type(rid)
    lo = int(np.searchsorted(sorted_ids, rid_t))
    hi = int(np.searchsorted(sorted_ids, rid_t, side="right"))
    pos = order[lo:hi]
    bases = batch.bases.reshape(-1)[pos]
    rows = pos // batch.bases.shape[1]
    transitions = np.flatnonzero(np.diff(rows)) + 1
    if transitions.size:
        keep = np.ones(pos.size, dtype=bool)
        for s in transitions.tolist():
            keep[s : s + k - 1] = False
        bases = bases[keep]
    return bases
