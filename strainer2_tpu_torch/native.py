"""The C++ host data plane (readers, packer, table construction, parsers, the
CPU counter and classifiers the checks compare with, and genome_compare's
string engine).

The library is the port's own copy of the JAX package's host library
(``csrc/host/strainer2_host.cc``).  It is compiled at first use with
``g++ -O3 -std=c++17 -fPIC -shared -lz`` into ``build/strainer2_tpu_torch/``
beside the package (ignored by git), named by a hash of the source and the
flags, and loaded with ctypes.  Each process compiles into a temporary file
of its own and renames it into place, so processes that start together do
not collide.

If the library cannot be built (it needs g++ and zlib's headers),
``available()`` is False and callers use the pure-Python readers: a host
fallback, not a device one; ``build_error`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "pack_file",
    "NativeClassifier",
    "NativeComparer",
    "NativePackStream",
    "NativePanelCounter",
    "Pe2EndedEarlyError",
    "available",
    "build_bucket_native",
    "build_cuckoo_native",
    "format_scrub_rows",
    "parse_hits_native",
    "parse_scrub_table_native",
    "reference_row_order_native",
    "unique_encounter_native",
]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "host", "strainer2_host.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "strainer2_tpu_torch")
_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_LIBS = ["-lz"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_STR = ctypes.c_char_p
# entry point: (restype, argtypes)
_SIGNATURES = {
    "s2_open_pack_stream": (_P, [ctypes.POINTER(_STR), _I, _I, _I, _I, _I, _I, _I, _LL]),
    "s2_next_batch": (_LL, [_P] * 5),
    "s2_stream_error": (_I, [_P, _STR, _I]),
    "s2_close_pack_stream": (None, [_P]),
    "s2_reference_row_order": (_I, [_P, _LL, _I, _LL, _P]),
    "s2_build_bucket_w": (_I, [_P, _LL, _I, _I, ctypes.c_uint32, _P, _P, _I]),
    "s2_build_cuckoo": (_I, [_P, _LL, _I, _I, ctypes.c_uint32, _P, _P]),
    "s2_unique_encounter": (_LL, [_P, _LL, _P, _P]),
    "s2_format_scrub_rows": (_LL, [_P, _LL] + [_P] * 5 + [_LL, _LL, _I]),
    "s2_parse_scrub_open": (_P, [_STR]),
    "s2_parse_scrub_rows": (_LL, [_P]),
    "s2_parse_scrub_blob_size": (_LL, [_P]),
    "s2_parse_scrub_has_drug": (_I, [_P]),
    "s2_parse_scrub_fill": (None, [_P] * 7),
    "s2_parse_scrub_close": (None, [_P]),
    "s2_parse_hits_open": (_P, [_STR]),
    "s2_parse_hits_rows": (_LL, [_P]),
    "s2_parse_hits_names": (_LL, [_P]),
    "s2_parse_hits_names_blob": (_LL, [_P]),
    "s2_parse_hits_comments_blob": (_LL, [_P]),
    "s2_parse_hits_fill": (None, [_P] * 7),
    "s2_parse_hits_close": (None, [_P]),
    "s2_count_build": (_P, [_P, _P, _LL]),
    "s2_count_build2": (_P, [_P, _P, _P, _LL]),
    "s2_count_build_multi": (_P, [_P, _P, _LL, _I]),
    "s2_count_file": (_LL, [_P, _STR, _I, _P]),
    "s2_count_free": (None, [_P]),
    "s2_open_classify": (_P, [_STR, _STR, _I, _I, _P]),
    "s2_classify_ok": (_I, [_P]),
    "s2_classify_next": (_LL, [_P, _P, _P, _P, _LL]),
    "s2_classify_multi_next": (_LL, [_P, _P, _P, _P, _LL, _I]),
    "s2_classify_state": (_I, [_P]),
    "s2_close_classify": (None, [_P]),
    "s2_compare_build": (_P, [_STR, _I]),
    "s2_compare_size": (_LL, [_P]),
    "s2_compare_score": (_I, [_P, _STR, _LL, ctypes.c_double, _P, _P]),
    "s2_compare_free": (None, [_P]),
}

_lock = threading.Lock()
_lib = None
_tried = False
build_error: str | None = None  # why the library is unavailable, if it is


class Pe2EndedEarlyError(IOError):
    """PE2 stream ended before PE1 (reference src/strain_detect.c:501-504)."""


def library_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS + _LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libstrainer2host_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _SRC, *_LIBS],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = library_path()
        try:
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except subprocess.CalledProcessError as e:
            build_error = f"g++ failed ({e.returncode}): {e.stderr[-2000:]}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            build_error = f"{type(e).__name__}: {e}"
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def reference_row_order_native(codes: np.ndarray, k: int, initial_capacity: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    out = np.empty(codes.shape[0], dtype=np.int64)
    rc = lib.s2_reference_row_order(
        codes.ctypes.data, codes.shape[0], k, initial_capacity, out.ctypes.data
    )
    if rc != 0:
        raise RuntimeError("native reference_row_order failed")
    return out


def format_scrub_rows(codes, c0, c1, c2, c3, k: int) -> bytes | None:
    """Format count-table rows for [0, n); returns bytes or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = codes.shape[0]
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    c0 = np.ascontiguousarray(c0, dtype=np.uint32)
    c1 = np.ascontiguousarray(c1, dtype=np.uint32)
    c2 = np.ascontiguousarray(c2, dtype=np.uint32)
    c3p = None
    if c3 is not None:
        c3 = np.ascontiguousarray(c3, dtype=np.uint32)
        c3p = c3.ctypes.data
    cap = n * (k + 50) + 1024
    buf = ctypes.create_string_buffer(cap)
    nb = lib.s2_format_scrub_rows(
        buf, cap, codes.ctypes.data, c0.ctypes.data, c1.ctypes.data,
        c2.ctypes.data, c3p, 0, n, k,
    )
    if nb < 0:
        raise RuntimeError("scrub row buffer overflow")
    return buf.raw[:nb]


class NativePackStream:
    """Iterator of this package's PackedBatch over the native reader/packer.

    mode 0 reads the files one after another, mode 1 interleaves two (PE).
    A counting stream (no read ids) splits a sequence longer than one
    buffer across buffers exactly as ``io.batches.pack_stream`` does."""

    def __init__(self, paths: Sequence[str], k: int, rows: int, row_len: int,
                 mode: int = 0, with_read_ids: bool = False, group_size: int = 1,
                 max_reads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self.paths = list(paths)
        self.k, self.rows, self.row_len = k, rows, row_len
        self.with_read_ids = with_read_ids
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._max_reads_cap = max_reads if max_reads else rows * row_len
        self._s = lib.s2_open_pack_stream(
            arr, len(paths), mode, k, rows, row_len, int(with_read_ids),
            group_size, max_reads,
        )

    def __iter__(self) -> Iterator:
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

    def close(self):
        if self._s:
            self._lib.s2_close_pack_stream(self._s)
            self._s = None


def pack_file(path: str, k: int, rows: int, row_len: int) -> Iterator:
    """Packed counting batches (no read ids) of one FASTA/FASTQ file: the
    native reader/packer when the library is built, the pure-Python twin
    otherwise."""
    if available():
        return NativePackStream([path], k, rows, row_len)
    from strainer2_tpu_torch.io.batches import pack_stream
    from strainer2_tpu_torch.io.fastx import read_fastx

    return pack_stream((rec.seq for rec in read_fastx(path)), k, rows=rows, row_len=row_len)


def unique_encounter_native(codes: np.ndarray):
    """(unique codes in first-encounter order, occurrence counts) or None."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    out_codes = np.empty(codes.shape[0], dtype=np.uint64)
    out_counts = np.empty(codes.shape[0], dtype=np.uint32)
    m = lib.s2_unique_encounter(
        codes.ctypes.data, codes.shape[0], out_codes.ctypes.data, out_counts.ctypes.data
    )
    if m < 0:
        raise MemoryError("unique_encounter: hash table allocation failed")
    return out_codes[:m].copy(), out_counts[:m].copy()


def build_bucket_native(codes: np.ndarray, k: int, h_bits: int, salt: int,
                        row_width: int = 64):
    """(table (2**h_bits, row_width) uint32, slot_of_key int32), "retry" on
    bucket overflow, or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    table = np.empty(((1 << h_bits), row_width), dtype=np.uint32)
    slot_of_key = np.empty(codes.shape[0], dtype=np.int32)
    rc = lib.s2_build_bucket_w(
        codes.ctypes.data, codes.shape[0], k, h_bits, salt,
        table.ctypes.data, slot_of_key.ctypes.data, row_width,
    )
    if rc != 0:
        return "retry"
    return table, slot_of_key


def build_cuckoo_native(codes: np.ndarray, k: int, h_bits: int, salt: int):
    """(table (2H, 2) uint32, slot_of_key int32), "retry" on an eviction
    chain past its limit (the caller retries with a new salt), or None when
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    table = np.full((2 << h_bits, 2), 0xFFFFFFFF, dtype=np.uint32)
    slot_of_key = np.empty(codes.shape[0], dtype=np.int32)
    rc = lib.s2_build_cuckoo(
        codes.ctypes.data, codes.shape[0], k, h_bits, salt,
        table.ctypes.data, slot_of_key.ctypes.data,
    )
    if rc != 0:
        return "retry"
    return table, slot_of_key


def parse_scrub_table_native(path: str):
    """Parse one kmer_scrub_count TSV into contiguous columns.

    Returns (blob uint8, offsets int64 (n+1), c1, c2, c3, c4 int64 arrays,
    has_drug) — keys in row order as blob[offsets[i]:offsets[i+1]] — or
    None when the library is unavailable.  Raises ValueError on a data row
    with fewer than 4 columns (mirrors the Python parser's IndexError).
    """
    lib = _load()
    if lib is None:
        return None
    h = lib.s2_parse_scrub_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        n = lib.s2_parse_scrub_rows(h)
        if n == -2:
            raise OSError(f"corrupt or truncated gzip stream in {path}")
        if n < 0:
            raise ValueError(f"malformed scrub-count row in {path}")
        blob = np.empty(lib.s2_parse_scrub_blob_size(h), dtype=np.uint8)
        offsets = np.empty(n + 1, dtype=np.int64)
        cols = [np.empty(n, dtype=np.int64) for _ in range(4)]
        lib.s2_parse_scrub_fill(
            h, blob.ctypes.data, offsets.ctypes.data,
            *[c.ctypes.data for c in cols],
        )
        has_drug = bool(lib.s2_parse_scrub_has_drug(h))
        return blob, offsets, cols[0], cols[1], cols[2], cols[3], has_drug
    finally:
        lib.s2_parse_scrub_close(h)


def parse_hits_native(path: str):
    """Parse one strain_detect kmer_hits file into columns.

    Returns (names, name_idx int32, totals int64, codes uint64, comments
    str): distinct column-0 strings in first-encounter order, per-row name
    index / t1+t2 total / 2-bit k-mer code, and the raw '#' summary lines.
    Returns None when the library is unavailable OR the strict parser hit
    a row it cannot represent (non-ACGT or mixed-length k-mer, non-numeric
    count, unreadable file) — the caller must then fall back to the
    Python per-line parse, which defines the canonical behavior for those
    inputs."""
    lib = _load()
    if lib is None:
        return None
    h = lib.s2_parse_hits_open(path.encode())
    if not h:
        return None
    try:
        n = lib.s2_parse_hits_rows(h)
        if n < 0:
            return None
        n_names = lib.s2_parse_hits_names(h)
        name_idx = np.empty(n, dtype=np.int32)
        totals = np.empty(n, dtype=np.int64)
        codes = np.empty(n, dtype=np.uint64)
        names_blob = np.empty(lib.s2_parse_hits_names_blob(h), dtype=np.uint8)
        name_offsets = np.empty(n_names + 1, dtype=np.int64)
        comments = np.empty(lib.s2_parse_hits_comments_blob(h), dtype=np.uint8)
        lib.s2_parse_hits_fill(
            h, name_idx.ctypes.data, totals.ctypes.data, codes.ctypes.data,
            names_blob.ctypes.data, name_offsets.ctypes.data,
            comments.ctypes.data,
        )
        blob = names_blob.tobytes()
        names = [
            blob[name_offsets[i]:name_offsets[i + 1]].decode()
            for i in range(n_names)
        ]
        return names, name_idx, totals, codes, comments.tobytes().decode()
    finally:
        lib.s2_parse_hits_close(h)


class NativePanelCounter:
    """Fused scan+lookup+count over one panel file on the CPU, with the
    counting semantics of the device engine (canonical-max windows, exact
    membership, integer adds into slot-indexed counts): bit-identical."""

    def __init__(self, codes: np.ndarray, slot_of_key: np.ndarray, k: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self.k = k
        codes = np.ascontiguousarray(codes, dtype=np.uint64)
        slots = np.ascontiguousarray(slot_of_key, dtype=np.int32)
        self._h = lib.s2_count_build(codes.ctypes.data, slots.ctypes.data, codes.shape[0])
        if not self._h:
            raise MemoryError("native count table allocation failed")

    def count_file(self, counts: np.ndarray, path: str) -> int:
        """In-place counts[slot] += hits; returns valid windows evaluated."""
        assert counts.dtype == np.uint32 and counts.flags.c_contiguous
        n = self._lib.s2_count_file(self._h, path.encode(), self.k, counts.ctypes.data)
        if n < 0:
            raise OSError(f"could not read file {path}")
        return int(n)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.s2_count_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeClassifier:
    """Per-read (length, total_hits, informative_hits) classifier over a
    sample's read stream on the CPU, with the per-k-mer class
    (NON_INFORMATIVE/INFORMATIVE) as the hash value."""

    def __init__(self, codes: np.ndarray, kmer_type: np.ndarray, k: int,
                 values_hi: np.ndarray | None = None,
                 extra_words: "list[np.ndarray] | None" = None):
        """values_hi (optional): second 32-bit value word per key —
        strains 16..31 of the multi-strain meta.  extra_words (optional):
        value words 2+ for >32-strain passes (16 strains per word)."""
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self.k = k
        codes = np.ascontiguousarray(codes, dtype=np.uint64)
        values = np.ascontiguousarray(kmer_type, dtype=np.int32)
        n = codes.shape[0]
        if extra_words:
            hi = np.zeros(n, np.int32) if values_hi is None else values_hi
            words = np.ascontiguousarray(np.stack([values, hi] + list(extra_words)), dtype=np.int32)
            self._h = lib.s2_count_build_multi(codes.ctypes.data, words.ctypes.data, n, words.shape[0])
        elif values_hi is None:
            self._h = lib.s2_count_build(codes.ctypes.data, values.ctypes.data, n)
        else:
            hi = np.ascontiguousarray(values_hi, dtype=np.int32)
            self._h = lib.s2_count_build2(codes.ctypes.data, values.ctypes.data, hi.ctypes.data, n)
        if not self._h:
            raise MemoryError("native classify table allocation failed")

    def open_stream(self, f1: str, f2: str | None, mode: int,
                    chunk: int = 1 << 16) -> "NativeClassifyStream":
        """mode: 0 = SE, 1 = PE two-file, 2 = PEI interleaved."""
        return NativeClassifyStream(self, f1, f2, mode, chunk)

    def open_multi_stream(self, f1: str, f2: str | None, mode: int, n_strains: int,
                          chunk: int = 1 << 15) -> "NativeClassifyStream":
        """Multi-strain variant: yields (lens, tot (n, S), inf (n, S))
        chunks; the hash values must be the packed per-strain meta words."""
        return NativeClassifyStream(self, f1, f2, mode, chunk, n_strains=n_strains)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.s2_count_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeClassifyStream:
    """Chunks of per-read rows of one sample; ``state`` after the last
    chunk tells a clean end from PE2 ending early."""

    PE2_ENDED_EARLY = 3

    def __init__(self, owner: NativeClassifier, f1, f2, mode, chunk, n_strains=None):
        self._lib = owner._lib
        self._owner = owner  # keeps the hash table alive while streaming
        self.chunk = chunk
        self.n_strains = n_strains
        self._s = self._lib.s2_open_classify(
            f1.encode(), f2.encode() if f2 else None, mode, owner.k, owner._h
        )
        bad = self._lib.s2_classify_ok(self._s)
        if bad:
            self._lib.s2_close_classify(self._s)
            self._s = None
            path = f1 if bad == 1 else f2
            err = OSError(f"could not read file {path}")
            err.filename = path
            err.s2_which_read = bad
            raise err

    def __iter__(self):
        # no close at the end: the caller reads .state afterwards
        S = self.n_strains
        while True:
            lens = np.empty(self.chunk, dtype=np.int64)
            shape = (self.chunk,) if S is None else (self.chunk, S)
            tot = np.empty(shape, dtype=np.uint32)
            inf = np.empty(shape, dtype=np.uint32)
            if S is None:
                n = self._lib.s2_classify_next(
                    self._s, lens.ctypes.data, tot.ctypes.data, inf.ctypes.data, self.chunk)
            else:
                n = self._lib.s2_classify_multi_next(
                    self._s, lens.ctypes.data, tot.ctypes.data, inf.ctypes.data, self.chunk, S)
            if n <= 0:
                return
            yield lens[:n], tot[:n], inf[:n]

    @property
    def state(self) -> int:
        return self._lib.s2_classify_state(self._s) if self._s else 0

    def close(self):
        if getattr(self, "_s", None):
            self._lib.s2_close_classify(self._s)
            self._s = None

    def __del__(self):
        self.close()


class NativeComparer:
    """Arbitrary-k genome_compare string engine: the CPU default, the k > 32
    engine on either device, and the independent check of the device path.

    Native twin of pipeline.compare._HostSetComparer (reference
    src/genome_compare.c:271-354, 475-521): canonical = max(fwd, IUPAC rc)
    on raw uppercased characters, N windows skipped, hybrid rapid mode.
    A copy of strainer2_tpu.native.NativeComparer.
    """

    def __init__(self, a_file: str, k: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self._s = lib.s2_compare_build(a_file.encode(), k)
        if not self._s:
            # a null handle is an unreadable file or an allocation failure
            # mid-build: tell them apart, so that an OOM is not reported as
            # a missing file
            try:
                open(a_file, "rb").close()
            except OSError:
                raise OSError(f"could not read file {a_file}")
            raise MemoryError("native compare table allocation failed")

    @property
    def num_kmers(self) -> int:
        return int(self._lib.s2_compare_size(self._s))

    def score(self, path: str, max_seeds: int, threshold: float) -> tuple[int, int]:
        hits = ctypes.c_longlong()
        misses = ctypes.c_longlong()
        rc = self._lib.s2_compare_score(
            self._s, path.encode(), max_seeds, threshold,
            ctypes.byref(hits), ctypes.byref(misses),
        )
        if rc != 0:
            raise OSError(f"could not read file {path}")
        return int(hits.value), int(misses.value)

    def close(self):
        if getattr(self, "_s", None):
            self._lib.s2_compare_free(self._s)
            self._s = None

    def __del__(self):
        self.close()
