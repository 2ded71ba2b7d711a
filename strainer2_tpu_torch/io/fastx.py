"""Streaming FASTA/FASTQ(.gz) record reader (pure-Python data plane).

Functional twin of the reference's kseq parser (reference src/kseq.h:171-211
instantiated over zlib so plain and gzip files are transparent).  The native
C++ reader in strainer2_tpu/native is the production path; this module is
the always-available fallback and the behavior oracle for it.

kseq semantics reproduced exactly (pinned by tests/test_edge_cases.py):

- record start: skip BYTES (not lines) until a '>' or '@' marker; a file
  with no marker yields zero records, silently;
- sequence lines accumulate until a line starting with '>', '@' (next
  record) or '+' (quality); blank lines are skipped;
- a gzip stream truncated mid-file reads as a clean EOF (zlib's gzread
  just stops; reference exit status 0) — NOT an exception;
- a record truncated before its '+' line is yielded as-is (kseq returns
  the partial sequence); a record truncated in or after its '+' line is
  DROPPED and parsing stops (kseq returns -2 and every reference caller
  loops `while (kseq_read(...) >= 0)`, reference src/genome_compare.c:203);
- quality bytes are counted until they reach the sequence length; a
  mismatch (including overshoot) drops the record and stops (kseq -2).

Yields raw sequence bytes; case-folding and base validation happen in the
2-bit encoder (reference uppercases via BIO_stringToUpper and rejects only
'N' per window; our encoder maps every non-ACGT byte to the invalid code).

Host twin of ``strainer2_tpu.io.fastx``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

import gzip
import io
import zlib
from typing import Iterator, NamedTuple

__all__ = ["FastxRecord", "read_fastx", "open_maybe_gzip"]


class FastxRecord(NamedTuple):
    name: bytes
    seq: bytes


def open_maybe_gzip(path: str, mode: str = "rb"):
    """Open plain or gzip file transparently (like zlib's gzopen).

    Raises on decode errors mid-stream (Python gzip semantics — what the
    reference's PYTHON scripts see); the FASTX reader wraps this with
    kseq's tolerant stop instead (see _TolerantReader)."""
    if "r" in mode:
        f = open(path, "rb")
        magic = f.read(2)
        f.seek(0)
        if magic == b"\x1f\x8b":
            return io.BufferedReader(gzip.GzipFile(fileobj=f))
        return io.BufferedReader(f)
    raise ValueError("open_maybe_gzip is read-only")


class _TolerantReader:
    """readline() source that turns mid-stream gzip decode errors into a
    clean EOF — zlib's gzread semantics, which the reference's kseq loops
    inherit (a truncated .gz panel file counts its decodable prefix and
    the binary exits 0; verified against the reference build).

    Buffers over raw .read() calls itself: Python's BufferedReader.readline
    raises EOFError mid-fill and LOSES the already-decoded partial data,
    whereas gzread hands over every decodable byte first — GzipFile.read
    returns available output before the failing call, so catching per read
    preserves the full decodable prefix."""

    _CHUNK = 1 << 16

    def __init__(self, f):
        self._f = f
        self._buf = bytearray()
        self._eof = False

    def readline(self) -> bytes:
        while not self._eof:
            i = self._buf.find(b"\n")
            if i >= 0:
                line = bytes(self._buf[: i + 1])
                del self._buf[: i + 1]
                return line
            try:
                # read1: at most one decompression step — GzipFile.read(n)
                # loops an internal BufferedReader fill that discards the
                # decoded partial data when the truncation error fires
                chunk = self._f.read1(self._CHUNK)
            except (EOFError, zlib.error, gzip.BadGzipFile, OSError):
                chunk = b""
            if not chunk:
                self._eof = True
                break
            self._buf += chunk
        if self._buf:  # final newline-less line (kseq reads it too)
            line = bytes(self._buf)
            self._buf.clear()
            return line
        return b""

    def close(self) -> None:
        try:
            self._f.close()
        except (EOFError, zlib.error, gzip.BadGzipFile, OSError):
            pass


def _open_tolerant(path: str) -> "_TolerantReader":
    """Open for kseq-style reading: the BARE GzipFile (no BufferedReader —
    its refill loop discards decoded data when a truncation error fires
    mid-fill; read1 on the bare object hands the partial chunk over
    first, like gzread)."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return _TolerantReader(gzip.GzipFile(fileobj=f))
    return _TolerantReader(f)


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Iterate records of a FASTA or FASTQ file (auto-detected per record,
    multiline ok, mixed files ok — kseq semantics throughout).

    Name is the header up to the first whitespace (kseq)."""
    f = _open_tolerant(path)
    try:
        yield from _read_kseq(f)
    finally:
        f.close()


def _header_name(line: bytes) -> bytes:
    return line.split(None, 1)[0] if line.strip() else b""


def _read_kseq(f) -> Iterator[FastxRecord]:
    pending_header: bytes | None = None  # header REST (after marker char)
    while True:
        # ---- record start: byte-wise scan to the next '>'/'@' marker ----
        if pending_header is None:
            hdr_rest = None
            while True:
                raw = f.readline()
                if not raw:
                    return
                cut = [i for i in (raw.find(b">"), raw.find(b"@")) if i >= 0]
                if cut:
                    hdr_rest = raw[min(cut) + 1 :]
                    break
        else:
            hdr_rest = pending_header
            pending_header = None
        if hdr_rest == b"":  # marker was the very last byte: kseq's name
            return  # read hits EOF -> -1, no record
        name = _header_name(hdr_rest.rstrip(b"\r\n"))

        # ---- sequence lines until '>', '@', '+' or EOF ----
        chunks: list[bytes] = []
        qual_marker = False
        next_header: bytes | None = None
        while True:
            raw = f.readline()
            if not raw:
                break
            c = raw[:1]
            if c in (b">", b"@"):
                next_header = raw[1:]
                break
            if c == b"+":
                if not raw.endswith(b"\n"):
                    return  # EOF inside the '+' line: kseq -2, drop + stop
                qual_marker = True
                break
            line = raw.rstrip(b"\r\n")
            if line:
                chunks.append(line)
        seq = b"".join(chunks)

        if not qual_marker:
            # FASTA record — or a FASTQ truncated before '+': kseq yields it
            yield FastxRecord(name, seq)
            pending_header = next_header
            continue

        # ---- quality: whole lines until the length reaches len(seq) ----
        qlen = 0
        while qlen < len(seq):
            raw = f.readline()
            if not raw:
                break
            qlen += len(raw.rstrip(b"\r\n"))
        if qlen != len(seq):
            return  # kseq -2: truncated/mismatched quality drops + stops
        yield FastxRecord(name, seq)
        pending_header = None
