"""The C++ host data plane (readers, packer, table builders, writers).

Re-exports the ctypes bindings of ``strainer2_tpu.native``, which import no
jax, and adds a ``NativePackStream`` that yields this package's
``PackedBatch`` (the original's iterator imports the JAX package's batch
module, whose package ``__init__`` imports jax).

If the library cannot be built (it needs make, g++ and zlib headers),
``available()`` is False and callers use the pure-Python readers: a host
fallback, not a device one.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from strainer2_tpu.native import (  # noqa: F401  (re-exported)
    NativeClassifier,
    NativePanelCounter,
    Pe2EndedEarlyError,
    available,
    build_bucket_native,
    format_scrub_rows,
    parse_hits_native,
    parse_scrub_table_native,
    reference_row_order_native,
    unique_encounter_native,
)
from strainer2_tpu.native import NativePackStream as _NativePackStream

__all__ = [
    "pack_file",
    "NativeClassifier",
    "NativePackStream",
    "NativePanelCounter",
    "Pe2EndedEarlyError",
    "available",
    "build_bucket_native",
    "format_scrub_rows",
    "parse_hits_native",
    "parse_scrub_table_native",
    "reference_row_order_native",
    "unique_encounter_native",
]


class _SplitSequencePending(Exception):
    pass


class NativePackStream(_NativePackStream):
    """Iterator of this package's PackedBatch over the native reader/packer
    (the same s2_open_pack_stream / s2_next_batch calls as the original).

    A counting stream with a sequence that does not fit in one buffer (a
    contig of more than about rows x row_len bases) makes s2_next_batch
    return -3 once the tail of that sequence is placed: the library keeps
    the split sequence pending and then refuses to place it a second time
    (strainer2_tpu/native/strainer2_host.cc, s2_next_batch).  The batches it gave
    until then are right, so the stream goes on from there with the
    pure-Python packer, which yields the same batches, skipping the ones
    already given."""

    def __iter__(self) -> Iterator:
        yielded = 0
        try:
            for batch in self._native_batches():
                yielded += 1
                yield batch
        except _SplitSequencePending:
            from strainer2_tpu_torch.io.batches import pack_stream
            from strainer2_tpu_torch.io.fastx import read_fastx

            seqs = (rec.seq for path in self.paths for rec in read_fastx(path))
            for i, batch in enumerate(pack_stream(seqs, self.k, self.rows, self.row_len)):
                if i >= yielded:
                    yield batch

    def _native_batches(self) -> Iterator:
        from strainer2_tpu_torch.io.batches import PackedBatch

        try:
            while True:
                bases = np.empty((self.rows, self.row_len), dtype=np.uint8)
                ids = (
                    np.empty((self.rows, self.row_len), dtype=np.int32)
                    if self.with_read_ids
                    else np.empty((1, 1), dtype=np.int32)
                )
                lengths = np.empty(self._max_reads_cap + self.rows, dtype=np.int64)
                wstarts = (
                    np.empty(self._max_reads_cap + self.rows, dtype=np.int64)
                    if self.with_read_ids
                    else np.empty(1, dtype=np.int64)
                )
                n = self._lib.s2_next_batch(
                    self._s, bases.ctypes.data, ids.ctypes.data,
                    lengths.ctypes.data, wstarts.ctypes.data,
                )
                if n == -3 and not self.with_read_ids and len(self.paths) == 1:
                    raise _SplitSequencePending
                if n == -2:
                    raise ValueError(
                        "read does not fit in one buffer; increase rows/row_len "
                        "for read-id (detection) streams"
                    )
                if n < 0:
                    self._raise_stream_error()
                if n == 0:
                    return
                yield PackedBatch(
                    bases=bases,
                    read_id=ids if self.with_read_ids else None,
                    n_reads=int(n),
                    read_lengths=lengths[:n].copy(),
                    window_starts=wstarts[:n].copy() if self.with_read_ids else None,
                )
        finally:
            self.close()

    def _raise_stream_error(self):
        import ctypes

        buf = ctypes.create_string_buffer(4096)
        kind = self._lib.s2_stream_error(self._s, buf, 4096)
        path = buf.value.decode()
        if kind == 2:
            raise Pe2EndedEarlyError(path)
        err = OSError(f"could not read file {path}")
        err.filename = path
        if path in self.paths:
            err.s2_which_read = self.paths.index(path) + 1
        raise err


def pack_file(path: str, k: int, rows: int, row_len: int) -> Iterator:
    """Packed counting batches (no read ids) of one FASTA/FASTQ file: the
    native reader/packer when the library is built, the pure-Python twin
    otherwise."""
    if available():
        return NativePackStream([path], k, rows, row_len)
    from strainer2_tpu_torch.io.batches import pack_stream
    from strainer2_tpu_torch.io.fastx import read_fastx

    return pack_stream((rec.seq for rec in read_fastx(path)), k, rows=rows, row_len=row_len)
