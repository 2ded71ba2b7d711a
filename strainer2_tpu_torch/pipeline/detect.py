"""strain_detect stage on the torch engine.

Port of ``strainer2_tpu.pipeline.detect`` (reference src/strain_detect.c):

1. index every canonical k-mer of the strain genome (NON_INFORMATIVE);
2. mark the -a file's k-mers informative: each line's canonical code is
   probed in the device table with the lookup kernel (K2);
3. optional background filter: count informative k-mers across background
   metagenomes with the count kernel (K3) and demote the most frequent
   ~half;
4. for every target sample (SE / PE / PEI), per-read total and informative
   hits come from the classify kernel (K4), and the select kernel (K4e)
   picks the reads or pairs that pass and their rows (each informative
   window's canonical code) from K4's informative bits; two counts cross
   back a batch, the sums and codes only where a read or pair passes, and
   the host formats and writes them.  The mesh route sums its data
   shards' per-read vectors on the host and re-scans the passing reads
   there (``_emit_sums``).

Emission, summary lines and diagnostics are the JAX package's host code,
copied, so the output bytes are the same.  Samples run one after another.
On ``--device cpu`` (the plain engine on the CPU, the host library built,
STRAINER2_NATIVE_COUNT not 0) the JAX package's CPU route is taken
instead: the background panel is counted by the host library's fused
counter, each sample is classified by its fused per-read classifier, the
passing reads are read back by ordinal with its read extractor, and
several samples are scored at once on a thread pool (up to 8,
STRAINER2_DETECT_THREADS) whose output is written in list order, byte for
byte the sequential run's on every stream, failures included.
With a checkpoint directory each finished sample's payload is saved
(pipeline/progress.py) and a restarted run replays it instead of scoring
it again.  In a multi-process run (parallel/distributed.py) the
background panel and the target samples are split across processes by
size; the counts are summed and the payloads gathered, and process 0
writes the output, byte-identical to one process.  With ``mesh=(D, I)``
one process classifies over a (data, index) device mesh
(parallel/sharding.py: the shard-window kernels K4s, then R and K4's sums
launch on each data shard), byte-identical to one device; a mesh and a
multi-process run cannot combine, as in the JAX stage.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import IO, Iterator

import numpy as np
import torch

from strainer2_tpu_torch import native
from strainer2_tpu_torch.constants import (
    BACKGROUND_FRACTION_TO_REMOVE,
    DEFAULT_K,
    INFORMATIVE_KMER,
    IS_PAIRED_END,
    IS_PAIRED_END_INTERLEAVE,
    NON_INFORMATIVE_KMER,
    NOT_PAIRED_END,
)
from strainer2_tpu_torch.index.build import StrainIndex
from strainer2_tpu_torch.io.batches import (
    batch_read_grouping,
    max_reads_capacity,
    pack_stream,
    read_codes_from_batch,
)
from strainer2_tpu_torch.io.fastx import open_maybe_gzip, read_fastx
from strainer2_tpu_torch.ops.packing_np import (
    canonical_codes_np,
    decode_codes_np,
    encode_ascii_np,
)
from strainer2_tpu_torch.parallel.distributed import (
    gather_blobs,
    host_file_partition,
    initialize,
    merge_across_hosts,
    partition_by_size,
    process_count,
    process_index,
)
from strainer2_tpu_torch.parallel.sharding import pad_rows
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
from strainer2_tpu_torch.pipeline.scrub_count import (
    _use_native_counting,
    count_files_native_pooled,
    count_panel_file,
    read_list_file,
)
from strainer2_tpu_torch.utils.observability import count, stage
from strainer2_tpu_torch.utils.prefetch import prefetch

__all__ = [
    "DetectConfig",
    "StrainDetector",
    "run_detect",
    "get_file_type",
    "background_demote",
    "strain_threads",
]


@dataclass
class DetectConfig:
    k: int = DEFAULT_K
    rows: int = 256
    row_len: int = 4096
    min_hits_for_good_match: int = 1  # reference src/strain_detect.c:406
    min_hits_for_informative_read: int = 1  # reference src/strain_detect.c:403
    fraction_background_to_remove: float = BACKGROUND_FRACTION_TO_REMOVE
    device: str = "cuda"
    layout: str = "bucket"  # table layout of the index the detector builds
    # (data, index) device mesh for sharded classification over ``device``
    # (parallel/sharding.py make_mesh); None = one device
    mesh: tuple[int, int] | None = None


def get_file_type(token: str) -> int:
    """Batch-file sample type tokens (reference src/strain_detect.c:728-747)."""
    if token in ("SE", "se"):
        return NOT_PAIRED_END
    if token in ("PE", "pe"):
        return IS_PAIRED_END
    if token in ("PEI", "pei", "IPE", "ipe"):
        return IS_PAIRED_END_INTERLEAVE
    return -1


def strain_threads(n_strains: int) -> int:
    """Worker count for independent per-strain work (index builds):
    min(cores, 8, n); STRAINER2_STRAIN_THREADS overrides (1 = sequential).
    A copy of strainer2_tpu.pipeline.multi_scrub.strain_threads, whose
    module imports jax."""
    import os

    env = os.environ.get("STRAINER2_STRAIN_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(os.cpu_count() or 1, 8, n_strains))


def _exit_unreadable_sample(exc: OSError, f1: str, f2: str | None) -> None:
    """Reference exit on an unreadable target file, with its (read1)/(read2)
    message (reference src/strain_detect.c:418-431)."""
    import os

    path = getattr(exc, "filename", None)
    which = getattr(exc, "s2_which_read", None)
    if which is None and path is not None:
        which = 2 if (f2 is not None and path == f2) else 1
    if path is None:
        if f2 is not None and os.path.exists(f1) and not os.path.exists(f2):
            which, path = 2, f2
        else:
            which, path = 1, f1
    reason = getattr(exc, "strerror", None)
    if not reason:
        try:  # recover the OS-level reason the way the reference's strerror does
            open(path, "rb").close()
            reason = str(exc)
        except OSError as probe:
            reason = probe.strerror or str(probe)
    print(
        "could not read file (read%d) %s in quantify_hits_PE() (error: %s)"
        % (which, path, reason),
        file=sys.stderr,
    )
    raise SystemExit(1)


def _evaluated_totals(lens, paired: bool, k: int):
    """Per-batch summary tallies: a pure function of read LENGTHS
    (reference src/strain_detect.c:444,497)."""
    wins = np.maximum(lens - k + 1, 0) * (lens >= k)
    kmers_evaluated = int(wins.sum())
    n = lens.shape[0]
    if paired:
        pe1 = np.arange(0, n - (n % 2), 2)
        reads_evaluated = int(np.count_nonzero(lens[pe1] >= k))
    else:
        pe1 = np.arange(n)
        reads_evaluated = int(np.count_nonzero(lens >= k))
    return kmers_evaluated, reads_evaluated, pe1


def _aggregate_classify_chunk(lens, tot, inf, paired: bool, k: int):
    """Pair-split one chunk of per-read (length, total, informative) rows."""
    kmers_evaluated, reads_evaluated, pe1 = _evaluated_totals(lens, paired, k)
    if paired:
        return (kmers_evaluated, reads_evaluated, pe1,
                tot[pe1], inf[pe1], tot[pe1 + 1], inf[pe1 + 1])
    zero = np.zeros_like(tot)
    return kmers_evaluated, reads_evaluated, pe1, tot, inf, zero, zero


def _parse_batch_entries(batch_list: str) -> list:
    """Batch-list lines as ordered entries: ("sample", (f1, f2, ftype)) or
    ("msg", stdout_text) for malformed lines, in list order."""
    entries: list = []
    with open(batch_list) as f:
        for raw in f:
            line = raw.rstrip("\n")
            fields = [t for t in line.split("\t") if t != ""]
            token = fields[0] if fields else line
            ftype = get_file_type(token)
            if ftype < 0:
                entries.append(("msg", "unknown file type skipping line (%s)\n" % token))
                continue
            if len(fields) < 2:
                entries.append(("msg", "ERROR: no first file specified for %s\n" % token))
                continue
            if ftype == IS_PAIRED_END and len(fields) < 3:
                entries.append(
                    ("msg", "ERROR: no second file specified for PE: %s\n" % token)
                )
                continue
            f2 = fields[2] if ftype == IS_PAIRED_END else None
            entries.append(("sample", (fields[1], f2, ftype)))
    return entries


def _sample_sizes(samples) -> list[int]:
    """Bytes on disk of each (f1, f2, type) sample (0 where unreadable)."""
    import os

    sizes = []
    for f1, f2, _ftype in samples:
        n = 0
        for path in (f1, f2):
            if path:
                try:
                    n += os.path.getsize(path)
                except OSError:
                    pass
        sizes.append(n)
    return sizes


def _pack_results(results: dict) -> bytes:
    """One rank's scored samples as a blob: a json header (ordinals,
    tokens, payload lengths), a NUL, then every payload, zlib-compressed."""
    import json
    import zlib

    ordinals = sorted(results)
    raws, lengths, tokens = [], [], []
    for o in ordinals:
        payloads, token = results[o]
        rs = [p.encode("utf-8") for p in payloads]
        raws.extend(rs)
        lengths.append([len(r) for r in rs])
        tokens.append(list(token))
    header = json.dumps({"o": ordinals, "t": tokens, "l": lengths}).encode()
    return header + b"\0" + zlib.compress(b"".join(raws), 1)


def _unpack_results(blobs: list[bytes]) -> dict:
    """Every rank's scored samples, ordinal -> (payloads, token)."""
    import json
    import zlib

    merged: dict = {}
    for blob in blobs:
        head, _, comp = blob.partition(b"\0")
        h = json.loads(head.decode())
        raw = zlib.decompress(comp)
        off = 0
        for o, tok, lens in zip(h["o"], h["t"], h["l"]):
            ps = []
            for n in lens:
                ps.append(raw[off : off + n].decode("utf-8"))
                off += n
            merged[o] = (ps, tuple(tok))
    return merged


def _run_sample_pool(entries, threads: int, new_sink, run_one, payload_of,
                     emit, stdout) -> None:
    """Samples scored at once on a thread pool, observed as the sequential
    loop (JAX strainer2_tpu/pipeline/detect.py:187-250).

    ``run_one(sample_args, sink)`` writes a sample into a fresh ``sink``
    (the classify table it reads is shared and read-only); the main thread
    takes the entries in list order: stdout messages are written at their
    place, payloads (``payload_of(sink)``) through ``emit``.  Each worker's
    stderr is captured per sample, so an error run is exact: a failing
    sample's partial output and its diagnostics are written after every
    earlier sample's output, as the sequential loop writes its rows before
    it raises; nothing after it is written (later messages included), and
    the run exits 1.
    """
    import concurrent.futures
    from collections import deque

    tee = _ThreadStderrTee(sys.stderr)
    samples = [val for kind, val in entries if kind == "sample"]

    def work(args):
        sink = new_sink()
        ebuf = tee.capture()
        outcome = None
        try:
            run_one(args, sink)
        except SystemExit as e:
            outcome = e.code if e.code is not None else 0
        except BaseException as e:  # raised again in list order below
            outcome = e
        finally:
            tee.uncapture()
        # the payload even of a failure: the sequential loop has written the
        # failing sample's rows when it raises
        return payload_of(sink), ebuf.getvalue(), outcome

    old_stderr = sys.stderr
    sys.stderr = tee
    try:
        with concurrent.futures.ThreadPoolExecutor(threads) as ex:
            futs: deque = deque()
            idx = 0
            try:
                for kind, val in entries:
                    if kind == "msg":
                        stdout.write(val)
                        continue
                    while idx < len(samples) and len(futs) < threads + 2:
                        futs.append(ex.submit(work, samples[idx]))
                        idx += 1
                    payload, errtxt, outcome = futs.popleft().result()
                    emit(payload)
                    if errtxt:
                        old_stderr.write(errtxt)
                    if outcome is not None:
                        if isinstance(outcome, BaseException):
                            raise outcome
                        raise SystemExit(outcome)
            finally:
                ex.shutdown(wait=True, cancel_futures=True)
    finally:
        sys.stderr = old_stderr


def _detect_threads(n_samples: int) -> int:
    """Worker threads for scoring samples at once (STRAINER2_DETECT_THREADS
    overrides; default min(cores, 8, samples)).  Each sample in flight
    holds its uncompressed output: 1 streams."""
    import os

    env = os.environ.get("STRAINER2_DETECT_THREADS")
    if env is not None:
        return max(1, min(int(env), n_samples))
    return max(1, min(os.cpu_count() or 1, 8, n_samples))


class _ThreadStderrTee:
    """A sys.stderr stand-in that sends each worker thread's writes to a
    buffer of its own while it is capturing; every other thread (the main
    thread, a prefetch thread, the stage timers) writes to the real
    stream."""

    def __init__(self, real):
        import threading

        self.real = real
        self._local = threading.local()

    def capture(self):
        import io

        buf = io.StringIO()
        self._local.buf = buf
        return buf

    def uncapture(self):
        self._local.buf = None

    def write(self, s):
        buf = getattr(self._local, "buf", None)
        return (buf if buf is not None else self.real).write(s)

    def flush(self):
        buf = getattr(self._local, "buf", None)
        if buf is None:
            self.real.flush()


def _staged_quantify(entries, run_one, new_sink, payload_of, emit, stdout,
                     checkpoint_dir: str | None = None, pool_ok: bool = False) -> None:
    """Sample-granular staged scoring: multi-process detection and detect
    resume, the form of ``strainer2_tpu.pipeline.detect._staged_quantify``.

    Each sample is scored by ``run_one(args, sink)`` into a fresh in-memory
    ``sink``; ``payload_of(sink)`` is its payloads, one text per output
    stream.  In a multi-process run each rank scores a size-balanced share
    of the samples (partition_by_size over the target files' sizes), one
    after another; the payloads are gathered (gather_blobs) and replayed in
    batch-list order, and rank 0 alone writes stdout messages and payloads.
    In one process a sample's payload is written as soon as it is scored.

    Output bytes, stdout message order and failure position are those of
    the streaming loop: a failing sample's partial payload is emitted,
    nothing after it is, and every rank exits non-zero (the real exception
    on the rank that scored the sample, SystemExit elsewhere).

    With ``checkpoint_dir`` each finished sample's payload is saved
    (DetectCheckpoint; under checkpoint_dir/rank<i> in a multi-process
    run, so that shares cannot interleave) and a resumed run replays a
    stored payload (same ordinal, same (f1, f2, type) key) instead of
    scoring it.

    With ``pool_ok`` (the native classifier of the ``--device cpu`` route)
    a rank scores its samples on the thread pool of ``_run_sample_pool``:
    results are taken in order, a worker's stderr is captured and written
    at its sample's place, and the first failure stops the rank."""
    import concurrent.futures
    import os
    from collections import deque

    from strainer2_tpu_torch.pipeline.progress import DetectCheckpoint

    pidx, pcount = process_index(), process_count()
    samples = [val for kind, val in entries if kind == "sample"]
    mine = (partition_by_size(_sample_sizes(samples), pidx, pcount) if pcount > 1
            else range(len(samples)))
    ckpt = None
    if checkpoint_dir:
        ckpt = DetectCheckpoint(
            os.path.join(checkpoint_dir, f"rank{pidx}") if pcount > 1 else checkpoint_dir
        )

    results: dict[int, tuple[list, tuple]] = {}
    local_exc: dict[int, BaseException] = {}
    cursor = [0, 0]  # next entry to replay, its sample ordinal

    def replay() -> None:
        """Write the entries in batch-list order up to the first sample not
        scored yet; raise at a failed sample."""
        pos, si = cursor
        while pos < len(entries):
            kind, val = entries[pos]
            if kind == "sample":
                if si not in results:
                    break
                payloads, token = results.pop(si)
                if pidx == 0:
                    emit(payloads)
                if token[0] != "ok":
                    exc = local_exc.get(si)
                    if exc is not None:
                        raise exc  # this rank scored it: the real exception
                    raise SystemExit(token[1])
                si += 1
            elif pidx == 0:
                stdout.write(val)
            pos += 1
            cursor[:] = pos, si

    keys = {o: DetectCheckpoint.sample_key(*samples[o]) if ckpt else None for o in mine}
    stored = {o: ckpt.get(o, keys[o]) for o in mine} if ckpt else {}
    todo = [o for o in mine if stored.get(o) is None]
    threads = _detect_threads(len(todo)) if pool_ok else 1
    tee = _ThreadStderrTee(sys.stderr) if threads > 1 and len(todo) > 1 else None

    def work(o):
        sink = new_sink()
        token = ("ok",)
        ebuf = tee.capture() if tee is not None else None
        try:
            run_one(samples[o], sink)
        except SystemExit as e:
            code = e.code if e.code is not None else 0
            token = ("exit", code if isinstance(code, int) else 1)
        except BaseException as e:  # raised again at its batch position
            local_exc[o] = e  # one key a task: no lock needed
            token = ("exc", 1)
        finally:
            if tee is not None:
                tee.uncapture()
        # the payload even of a failure: the streaming loop has written
        # the failing sample's rows when it raises
        return payload_of(sink), token, ebuf.getvalue() if ebuf is not None else ""

    old_stderr = sys.stderr
    ex = concurrent.futures.ThreadPoolExecutor(threads) if tee is not None else None
    futs: deque = deque()
    nxt = 0  # next todo entry to submit
    if tee is not None:
        sys.stderr = tee
    try:
        with stage("detect.score_samples"):
            for o in mine:
                if pcount == 1:
                    replay()
                if stored.get(o) is not None:
                    results[o] = (stored[o], ("ok",))
                    continue
                if ex is None:
                    payloads, token, errtxt = work(o)
                else:
                    while nxt < len(todo) and len(futs) < threads + 2:
                        futs.append(ex.submit(work, todo[nxt]))
                        nxt += 1
                    payloads, token, errtxt = futs.popleft().result()
                    if errtxt:
                        old_stderr.write(errtxt)
                results[o] = (payloads, token)
                if token != ("ok",):
                    break  # later samples are never replayed
                if ckpt is not None:
                    ckpt.record(o, keys[o], payloads)
    finally:
        if ex is not None:
            ex.shutdown(wait=True, cancel_futures=True)
        sys.stderr = old_stderr
    if pcount > 1:
        with stage("detect.gather_payloads"):
            results = _unpack_results(gather_blobs(_pack_results(results)))
    replay()
    if cursor[0] < len(entries):
        # every sample before the first failure is there by construction
        # (a rank stops scoring only after its own failure)
        raise RuntimeError(f"staged detection: sample {cursor[1]} missing from the results")


def _cached_index(index_cache, k: int):
    """The index an ``--index-cache`` holds (StrainIndex.save of either
    package writes the same npz), in its own layout, where its k is the
    run's; None where there is no such file or its k is another, and the
    run builds the index and overwrites it.  The JAX package
    (strainer2_tpu/pipeline/detect.py:485-496) reuses only a cache of its
    engine's layout, which off the TPU is the cuckoo layout its CLIs
    write."""
    import os

    if index_cache and os.path.exists(index_cache):
        idx = StrainIndex.load(index_cache)
        if idx.k == k:
            return idx
    return None


class StrainDetector:
    """The indexed strain state shared across target samples."""

    def __init__(self, r_file: str, a_file: str | None, cfg: DetectConfig | None = None,
                 stdout: IO | None = None, index_cache: str | None = None,
                 index: StrainIndex | None = None,
                 informative_keys: np.ndarray | None = None):
        """a_file marks informative k-mers from the scrubbed-k-mer file.
        The fused pipeline instead passes a prebuilt ``index`` plus
        ``informative_keys`` (key indices in first-encounter order),
        skipping the genome re-scan and the k-mer string round trip."""
        self.cfg = cfg or DetectConfig()
        self.stdout = stdout if stdout is not None else sys.stdout
        if index is None:
            with stage("detect.index_build"):
                index = _cached_index(index_cache, self.cfg.k)
        # the engine takes the layout of the index it is given or finds on
        # disk; one it builds is in the configured layout
        self.engine = TorchKmerEngine(
            self.cfg.k,
            max_reads_capacity(self.cfg.k, self.cfg.rows, self.cfg.row_len),
            device=self.cfg.device,
            layout=index.layout if index is not None else self.cfg.layout,
        )
        if index is None:
            with stage("detect.index_build"):
                index = StrainIndex.from_fasta(r_file, self.engine, self.cfg.rows,
                                               self.cfg.row_len)
                if index_cache and process_index() == 0:  # one writer of a shared path
                    index.save(index_cache)
        self.index = index
        # per-key k-mer class; genome k-mers start NON_INFORMATIVE
        self.kmer_type = np.full(self.index.num_kmers, NON_INFORMATIVE_KMER, np.uint32)
        self._sorted_order = np.argsort(self.index.codes, kind="stable")
        self._sorted_codes = self.index.codes[self._sorted_order]
        if informative_keys is not None:
            keys = np.asarray(informative_keys, dtype=np.int64)
            self.kmer_type[keys] = INFORMATIVE_KMER
            self.num_informative_marked = int(keys.size)
        else:
            if a_file is None:
                raise ValueError("either a_file or informative_keys is required")
            self.num_informative_marked = self._mark_scrubbed(a_file)

    # ---- stage 2: mark informative k-mers ----
    def _key_pos(self, codes: np.ndarray) -> np.ndarray:
        """Map codes to key indices (first-encounter order), -1 if absent
        (a host search, as the JAX package marks the -a file: no table is
        built for it)."""
        pos = np.searchsorted(self._sorted_codes, codes)
        pos = np.clip(pos, 0, self._sorted_codes.size - 1)
        ok = self._sorted_codes[pos] == codes
        out = np.where(ok, self._sorted_order[pos], -1)
        return out.astype(np.int64)

    def _mark_scrubbed(self, a_file: str) -> int:
        """Mark the -a file's k-mers informative; diagnostics stay in line
        order as the reference prints them (reference
        src/strain_detect.c:687-716)."""
        k = self.cfg.k
        lines: list[bytes] = []
        with open_maybe_gzip(a_file) as f:
            for raw in f:
                if not raw.startswith(b"#"):
                    lines.append(raw.rstrip(b"\n"))
        good = [ln for ln in lines if len(ln) == k]
        idx = np.full(len(good), -1, dtype=np.int64)
        if good:
            mat = encode_ascii_np(
                np.frombuffer(b"".join(good), dtype=np.uint8)
            ).reshape(len(good), k)
            valid = (mat < 4).all(axis=1)
            weights = np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64)
            two = (mat & np.uint8(3)).astype(np.uint64)
            fwd = (two * weights).sum(axis=1, dtype=np.uint64)
            rc = ((np.uint64(3) - two)[:, ::-1] * weights).sum(axis=1, dtype=np.uint64)
            ccodes = np.where(fwd >= rc, fwd, rc)
            idx = np.where(valid, self._key_pos(ccodes), -1)

        n_marked = 0
        gi = 0
        for ln in lines:
            if len(ln) != k:
                self.stdout.write(
                    "error string length in the scrubbed kmer file (%s) must be the "
                    "same size as the kmer length (scrubbed kmer, scrubbed kmer len, "
                    "seed len): %s, %d, %d\n"
                    % (a_file, ln.decode("ascii", "replace"), len(ln), k)
                )
                continue
            key = idx[gi]
            gi += 1
            if key >= 0:
                self.kmer_type[key] = INFORMATIVE_KMER
                n_marked += 1
            else:
                self.stdout.write(
                    "error could not find informative kmer %s in the total kmer list\n"
                    % ln.decode("ascii", "replace")
                )
        return n_marked

    # ---- stage 3: background filter ----
    def background_filter(self, background_list: str) -> None:
        """Demote informative k-mers frequent in background metagenomes
        (reference src/strain_detect.c:160-240; stats lines go to stdout).
        The background panel is counted on the device with the count
        kernel, or on the ``--device cpu`` route by the host library's
        fused counter on a thread pool; in a multi-process run each rank
        counts its size-balanced share and the per-key counts are summed,
        so that every rank demotes the same k-mers."""
        cfg = self.cfg
        paths = host_file_partition(read_list_file(background_list), process_index(),
                                    process_count())
        nc = (self.index.native_counter()
              if cfg.mesh is None and _use_native_counting(self.engine) else None)
        counts_np = count_files_native_pooled(nc, paths, self.index.table.num_slots)
        if counts_np is None:
            counts = self.engine.init_counts(self.index)
            for path in paths:
                counts = count_panel_file(self.engine, self.index, counts, path, cfg.rows,
                                          cfg.row_len)
            counts_np = self.engine.finalize_counts(counts)
        bg_counts = merge_across_hosts(self.index.key_values(counts_np))
        bg_counts = bg_counts.astype(np.int64)
        background_demote(
            self.kmer_type, bg_counts, self.num_informative_marked,
            cfg.fraction_background_to_remove, background_list, self.stdout,
        )

    # ---- stage 4: quantify ----
    def _finalize_meta(self):
        """Classification table, built on the device: the bucket rows with
        the k-mer class in meta lanes 32:48 (BucketTable.with_meta's result,
        without a host copy of the table); in the cuckoo layout the slots
        as they are, the class a separate slot-indexed array, as
        strainer2_tpu/pipeline/detect.py:675-677 keeps it."""
        t = self.index.table
        eng = self.engine
        self._sharded = None
        self.total_genome_kmers = self.index.num_kmers
        self.total_genome_informative = int(
            np.count_nonzero(self.kmer_type == INFORMATIVE_KMER)
        )
        if self.cfg.mesh is not None:
            self._finalize_meta_sharded()
            return
        meta = torch.zeros(t.num_slots, dtype=torch.int32, device=eng.device)
        meta[eng.to_device(t.slot_of_key.astype(np.int64))] = eng.to_device(
            self.kmer_type.astype(np.int32)
        )
        if self.index.layout == "bucket":
            rows = eng.table_for(self.index).clone()
            rows.view(torch.int32)[:, 32:48] = meta.view(-1, 16)
            self._classify_table, self._meta_dev = rows, None
        else:
            self._classify_table, self._meta_dev = eng.table_for(self.index), meta.view(torch.uint32)

    def _finalize_meta_sharded(self):
        """The classification table over the (data, index) mesh (JAX
        detect.py:685-720): the with-meta bucket rows, or the cuckoo slots
        and their slot-indexed classes, split along the index axis; the
        per-read partials of the data shards are summed on the host."""
        from strainer2_tpu_torch.parallel.sharding import ShardedKmerEngine, make_mesh

        d, i = self.cfg.mesh
        t = self.index.table
        self._sharded = ShardedKmerEngine(
            self.cfg.k, make_mesh(d, i, devices=self.cfg.device), t.h_bits, t.salt, t.num_slots,
            layout=self.index.layout,
        )
        meta = self.index.slot_values(self.kmer_type)
        if self.index.layout == "bucket":
            self._classify_table = self._sharded.put_table(t.with_meta(meta))
        else:
            self._classify_table = self._sharded.put_table(t.table, meta)
        self._meta_dev = None

    def quantify_all(self, out_path: str, batch_list: str | None = None,
                     b_file: str | None = None, b_file2: str | None = None,
                     file_type: int = NOT_PAIRED_END, checkpoint_dir: str | None = None,
                     gzip_output: bool = True) -> None:
        """Process all target samples and write the hits file (gzip, or
        plain TSV with gzip_output=False; the row bytes are the same).
        checkpoint_dir makes a -B batch run resumable at sample
        granularity (DetectCheckpoint).  In a multi-process run the -B
        samples are scored across ranks and rank 0 alone opens and writes
        ``out_path`` (ranks share it; a second open would truncate it); a
        single -b sample is rank 0's alone."""
        import gzip
        import io

        def open_hits():
            return gzip.open(out_path, "wt", compresslevel=9) if gzip_output else open(out_path, "w")

        pidx, pcount = process_index(), process_count()
        if pcount > 1 and self.cfg.mesh is not None:
            # the JAX stage's refusal (strainer2_tpu/pipeline/detect.py:760-769)
            print(
                "mesh sharding and multi-process sample partitioning cannot "
                "combine: run either one process with a device mesh, or one "
                "process per host (the default here)",
                file=sys.stderr,
            )
            raise SystemExit(1)
        self._finalize_meta()
        nc = self._native_classifier()
        if nc is not None:
            def run_one(args, sink):
                self._quantify_sample_native(nc, *args, sink)
        else:
            def run_one(args, sink):
                self._quantify_sample(*args, sink)
        if batch_list is not None and (pcount > 1 or checkpoint_dir):
            out = open_hits() if pidx == 0 else None
            try:
                _staged_quantify(
                    _parse_batch_entries(batch_list), run_one,
                    io.StringIO, lambda sink: [sink.getvalue()],
                    (lambda payloads: out.write(payloads[0])) if out is not None
                    else (lambda payloads: None),
                    self.stdout, checkpoint_dir, pool_ok=nc is not None,
                )
            finally:
                if out is not None:
                    out.close()
            return
        if pidx != 0:
            return  # single-sample mode: rank 0 owns the only sample
        with open_hits() as out, stage("detect.score_samples"):
            if batch_list is None:
                self._quantify_sample(b_file, b_file2, file_type, out)
                return
            entries = _parse_batch_entries(batch_list)
            n_samples = sum(1 for kind, _ in entries if kind == "sample")
            threads = _detect_threads(n_samples)
            if nc is not None and n_samples > 1 and threads > 1:
                _run_sample_pool(entries, threads, io.StringIO, run_one,
                                 lambda sink: sink.getvalue(), out.write, self.stdout)
                return
            # stdout warnings interleave with samples exactly as the
            # reference's streaming loop emits them
            for kind, val in entries:
                if kind == "msg":
                    self.stdout.write(val)
                else:
                    self._quantify_sample(*val, out)

    # ---- per-sample hot loop ----
    def _read_stream(self, f1: str, f2: str | None, ftype: int) -> Iterator[bytes]:
        if ftype == IS_PAIRED_END:
            it1, it2 = read_fastx(f1), read_fastx(f2)
            for rec1 in it1:
                try:
                    rec2 = next(it2)
                except StopIteration:
                    print(
                        f"reached end of PE2 ({f2}) before end of PE1 ({f1}), "
                        "check that file names are correct",
                        file=sys.stderr,
                    )
                    raise SystemExit(1)
                yield rec1.seq
                yield rec2.seq
        else:
            for rec in read_fastx(f1):
                yield rec.seq

    def _batch_stream(self, f1: str, f2: str | None, ftype: int):
        """Packed batches of one sample: native reader/packer when built,
        the Python twin otherwise."""
        cfg = self.cfg
        group = 2 if ftype != NOT_PAIRED_END else 1
        if native.available():
            if ftype == IS_PAIRED_END:
                paths, mode = [f1, f2], 1
            else:
                paths, mode = [f1], 0
            return native.NativePackStream(
                paths, cfg.k, cfg.rows, cfg.row_len, mode=mode,
                with_read_ids=True, group_size=group, max_reads=self.engine.max_reads,
            )
        seqs = (
            encode_ascii_np(np.frombuffer(s, dtype=np.uint8))
            for s in self._read_stream(f1, f2, ftype)
        )
        return pack_stream(
            seqs, cfg.k, rows=cfg.rows, row_len=cfg.row_len,
            with_read_ids=True, group_size=group,
        )

    def _native_classifier(self):
        """The host library's fused per-read classifier over this strain's
        classes (made once, kept) on the ``--device cpu`` route; None where
        the engine classifies (a CUDA device, a mesh, or
        STRAINER2_NATIVE_COUNT=0)."""
        if "_native_cls" not in self.__dict__:
            self._native_cls = None
            if self._sharded is None and _use_native_counting(self.engine):
                try:
                    self._native_cls = native.NativeClassifier(self.index.codes, self.kmer_type,
                                                               self.cfg.k)
                except (RuntimeError, MemoryError):
                    self._native_cls = None
        return self._native_cls

    def _quantify_sample_native(self, nc, f1: str, f2: str | None, ftype: int,
                                out: IO) -> None:
        """_quantify_sample on the native classifier (JAX
        strainer2_tpu/pipeline/detect.py:898-977): the same pair thresholds,
        summary lines and emission; the per-read rows come from one fused
        pass, and the passing reads back from the read extractor by their
        ordinal in the file (a PE sample's mates are read ``r1 // 2`` of
        each file, a PEI mate the next read of the same file)."""
        cfg = self.cfg
        k = cfg.k
        paired = ftype != NOT_PAIRED_END
        mode = 1 if ftype == IS_PAIRED_END else 2 if ftype == IS_PAIRED_END_INTERLEAVE else 0
        try:
            stream = nc.open_stream(f1, f2, mode)
        except OSError as e:
            _exit_unreadable_sample(e, f1, f2)

        total_kmers_evaluated = 0
        total_reads_evaluated = 0
        odd_interleave = False
        base = 0
        ex1 = ex2 = None
        for lens, tot, inf in stream:
            n = lens.size
            if n % 2 and paired and ftype == IS_PAIRED_END_INTERLEAVE:
                odd_interleave = True
            with stage("detect.emit"):
                ke, re_, pe1, t1, i1, t2, i2 = _aggregate_classify_chunk(lens, tot, inf, paired,
                                                                         k)
                total_kmers_evaluated += ke
                total_reads_evaluated += re_
                passing = np.flatnonzero(((t1 + t2) >= cfg.min_hits_for_good_match) & (
                    (i1 + i2) >= cfg.min_hits_for_informative_read
                ))
                count("detect.emit_reads", t1.size)
                count("detect.reads_passing", passing.size)
                emit_items = []
                for j in passing:
                    r1 = base + int(pe1[j])
                    prefix = f"{f1}\t{t1[j]}\t{i1[j]}\t{t2[j]}\t{i2[j]}\t"
                    if ex1 is None:
                        ex1 = native.NativeReadExtractor(f1)
                        if ftype == IS_PAIRED_END:
                            ex2 = native.NativeReadExtractor(f2)
                    if ftype == IS_PAIRED_END:
                        emit_items.append((prefix, ex1.read(r1 // 2, int(lens[pe1[j]]))))
                        emit_items.append((prefix, ex2.read(r1 // 2, int(lens[pe1[j] + 1]))))
                    else:
                        emit_items.append((prefix, ex1.read(r1, int(lens[pe1[j]]))))
                        if paired:  # PEI: the mate is the next read of the same file
                            emit_items.append((prefix,
                                               ex1.read(r1 + 1, int(lens[pe1[j] + 1]))))
                self._emit_rows_batch(out, emit_items)
            base += n
        pe2_early = stream.state == native.NativeClassifyStream.PE2_ENDED_EARLY
        for h in (ex1, ex2):
            if h is not None:
                h.close()
        stream.close()
        if pe2_early or odd_interleave:
            f2_name = f2 if ftype == IS_PAIRED_END else f1
            print(
                f"reached end of PE2 ({f2_name}) before end of PE1 ({f1}), "
                "check that file names are correct",
                file=sys.stderr,
            )
            raise SystemExit(1)

        out.write("#%s\ttotal_kmer_evaluated\t%d\n" % (f1, total_kmers_evaluated))
        out.write("#%s\ttotal_reads_evaluated\t%d\n" % (f1, total_reads_evaluated))
        out.write("#%s\ttotal_genome_kmers\t%d\n" % (f1, self.total_genome_kmers))
        out.write(
            "#%s\ttotal_genome_informative_kmers\t%d\n" % (f1, self.total_genome_informative)
        )

    def _quantify_sample(self, f1: str, f2: str | None, ftype: int, out: IO) -> None:
        nc = self._native_classifier()
        if nc is not None:
            return self._quantify_sample_native(nc, f1, f2, ftype, out)
        cfg = self.cfg
        k = cfg.k
        paired = ftype != NOT_PAIRED_END
        t = self.index.table
        total_kmers_evaluated = 0
        total_reads_evaluated = 0
        odd_interleave = False
        n_windows = cfg.rows * (cfg.row_len - k + 1)
        max_reads = self.engine.max_reads

        try:
            stream = prefetch(self._batch_stream(f1, f2, ftype))
        except OSError as e:
            _exit_unreadable_sample(e, f1, f2)
        while True:
            try:
                batch = next(stream)
            except StopIteration:
                break
            except native.Pe2EndedEarlyError:
                print(
                    f"reached end of PE2 ({f2}) before end of PE1 ({f1}), "
                    "check that file names are correct",
                    file=sys.stderr,
                )
                raise SystemExit(1)
            except OSError as e:
                _exit_unreadable_sample(e, f1, f2)
            n = batch.n_reads
            boundaries = np.full(max_reads + 1, n_windows, dtype=np.int32)
            boundaries[:n] = batch.window_starts
            lens = batch.read_lengths
            if n % 2 and paired and ftype == IS_PAIRED_END_INTERLEAVE:
                odd_interleave = True
            ke, re_, _ = _evaluated_totals(lens, paired, k)
            total_kmers_evaluated += ke
            total_reads_evaluated += re_
            if self._sharded is not None:
                # rows padded to the data axis (JAX detect.py:1022-1041); the
                # data shards' partials summed here
                tot_p, inf_p = self._sharded.classify_batch(
                    self._classify_table, pad_rows(batch.bases, self._sharded.n_data, 4),
                    boundaries,
                )
                self._emit_sums(out, f1, batch, lens, paired, tot_p.sum(axis=0)[:n],
                                inf_p.sum(axis=0)[:n])
                continue
            # K4 then K4e choose the passing reads or pairs and their rows
            # on the device; the gate reads back their two counts, and
            # the sums and codes follow only where a read or pair passes
            sel = self.engine.classify_select_batch(
                self._classify_table, t.h_bits, t.salt, batch.bases, boundaries, n_reads=n,
                paired=paired, min_t=cfg.min_hits_for_good_match,
                min_i=cfg.min_hits_for_informative_read, meta=self._meta_dev,
            )
            with stage("engine.gate_readback"):
                n_pass, n_rows = sel.counts.tolist()
            if not n_pass:
                continue
            count("detect.gate_passed")
            count("detect.select_batches")
            with stage("engine.d2h"):
                sums, codes = self.engine.selection_to_host(sel, n_pass, n_rows)
            self._emit_selected(out, f1, n // 2 if paired else n, n_pass, sums, codes)

        if odd_interleave:
            print(
                f"reached end of PE2 ({f1}) before end of PE1 ({f1}), "
                "check that file names are correct",
                file=sys.stderr,
            )
            raise SystemExit(1)

        # per-file summary comment lines (reference src/strain_detect.c:633-636)
        out.write("#%s\ttotal_kmer_evaluated\t%d\n" % (f1, total_kmers_evaluated))
        out.write("#%s\ttotal_reads_evaluated\t%d\n" % (f1, total_reads_evaluated))
        out.write("#%s\ttotal_genome_kmers\t%d\n" % (f1, self.total_genome_kmers))
        out.write(
            "#%s\ttotal_genome_informative_kmers\t%d\n" % (f1, self.total_genome_informative)
        )

    def _emit_sums(self, out: IO, f1: str, batch, lens, paired: bool, tot, inf) -> None:
        """The rows of a batch's passing reads or pairs from its per-read
        (total, informative) hits."""
        with stage("detect.emit"):
            cfg = self.cfg
            k = cfg.k
            _, _, pe1, t1, i1, t2, i2 = _aggregate_classify_chunk(lens, tot, inf, paired, k)
            passing = ((t1 + t2) >= cfg.min_hits_for_good_match) & (
                (i1 + i2) >= cfg.min_hits_for_informative_read
            )
            pass_idx = np.flatnonzero(passing)
            count("detect.emit_reads", t1.size)
            count("detect.reads_passing", pass_idx.size)
            if not pass_idx.size:
                return
            grouping = batch_read_grouping(batch)
            emit_items = []
            for j in pass_idx:
                r1 = int(pe1[j])
                prefix = f"{f1}\t{t1[j]}\t{i1[j]}\t{t2[j]}\t{i2[j]}\t"
                emit_items.append((prefix, read_codes_from_batch(batch, r1, k, grouping)))
                if paired:
                    emit_items.append((prefix, read_codes_from_batch(batch, r1 + 1, k,
                                                                     grouping)))
            self._emit_rows_batch(out, emit_items)

    def _emit_selected(self, out: IO, f1: str, n_units: int, n_pass: int, sums, codes) -> None:
        """The rows of a batch's passing reads or pairs from K4e's
        selection: each passing unit's (r1, t1, i1, t2, i2) and the codes
        of its i1 + i2 informative windows, in read order; nothing is
        rescanned or searched."""
        with stage("detect.emit"):
            count("detect.emit_reads", n_units)
            count("detect.reads_passing", n_pass)
            if not codes.size:
                return
            with stage("detect.emit.write"):
                prefixes = [f"{f1}\t{t1}\t{i1}\t{t2}\t{i2}\t"
                            for _, t1, i1, t2, i2 in sums.tolist()]
                unit = np.repeat(np.arange(len(prefixes)), sums[:, 2] + sums[:, 4])
                if unit.size != codes.size:
                    raise RuntimeError(f"{codes.size} selected rows for {unit.size} "
                                       "informative hits")
                kmers = decode_codes_np(codes, self.cfg.k)
                out.write("".join([prefixes[u] + s + "\n" for u, s in zip(unit.tolist(), kmers)]))
            count("detect.rows", codes.size)

    _EMIT_WINDOW_BUDGET = 1 << 21  # bounds transient memory per lookup

    def _emit_rows_batch(self, out: IO, items: list) -> None:
        """Emission for all passing reads of one batch: one canonical re-scan
        per read, one vectorised key lookup per bounded sub-batch; rows print
        in (read, window) order (reference src/strain_detect.c:554-623)."""
        start = 0
        windows = 0
        for i, (_, bases) in enumerate(items):
            windows += max(bases.shape[0] - self.cfg.k + 1, 0)
            if windows >= self._EMIT_WINDOW_BUDGET:
                self._emit_rows_slice(out, items[start : i + 1])
                start, windows = i + 1, 0
        if start < len(items):
            self._emit_rows_slice(out, items[start:])

    def _emit_rows_slice(self, out: IO, items: list) -> None:
        k = self.cfg.k
        ccodes_list = []
        valid_list = []
        spans = []
        with stage("detect.emit.rescan"):
            for _, bases in items:
                cc, v = canonical_codes_np(bases, k)
                ccodes_list.append(cc)
                valid_list.append(v)
                spans.append(cc.size)
        if not spans or sum(spans) == 0:
            return
        with stage("detect.emit.lookup"):
            ccodes = np.concatenate(ccodes_list)
            valid = np.concatenate(valid_list)
            idx = self._key_pos(ccodes)
            informative = valid & (idx >= 0)
            if informative.any():
                informative &= (
                    np.where(idx >= 0, self.kmer_type[np.maximum(idx, 0)], 0)
                    == INFORMATIVE_KMER
                )
        off = 0
        rows = 0
        with stage("detect.emit.write"):
            for (prefix, _), n in zip(items, spans):
                hits = np.flatnonzero(informative[off : off + n])
                if hits.size:
                    for s in decode_codes_np(ccodes[off + hits], k):
                        out.write(prefix + s + "\n")
                    rows += hits.size
                off += n
        count("detect.rows", rows)


def background_demote(kmer_type, bg_counts, num_inform, fraction, list_name, stdout):
    """The reference's background threshold search + demotion (reference
    src/strain_detect.c:160-240) on per-key arrays; mutates kmer_type."""
    kmer_to_keep = int(num_inform * fraction)
    stdout.write(
        "#removing %f proportion of %s kmers; informative %d keep at least %d\n"
        % (fraction, list_name, num_inform, kmer_to_keep)
    )
    informative = kmer_type == INFORMATIVE_KMER
    inf_bg = bg_counts[informative]
    if inf_bg.size > num_inform:
        print("Error: too many background kmers", file=sys.stderr)
        raise SystemExit(1)

    desc = np.sort(inf_bg)[::-1]
    max_kmer_to_keep = 1
    if kmer_to_keep >= 1 and desc.size >= kmer_to_keep and desc[kmer_to_keep - 1] > max_kmer_to_keep:
        max_kmer_to_keep = int(desc[kmer_to_keep - 1])
    while int(np.count_nonzero(inf_bg >= max_kmer_to_keep)) > kmer_to_keep:
        max_kmer_to_keep += 1

    demote = informative & (bg_counts >= max_kmer_to_keep)
    kmer_type[demote] = NON_INFORMATIVE_KMER
    stdout.write(
        "#final_threshold %d removes %d background kmers %d removed\n"
        % (
            max_kmer_to_keep,
            int(np.count_nonzero(inf_bg >= max_kmer_to_keep)),
            int(np.count_nonzero(demote)),
        )
    )


def run_detect(r_file: str, a_file: str, out_path: str, batch_list: str | None = None,
               b_file: str | None = None, b_file2: str | None = None,
               file_type: int = NOT_PAIRED_END, background_list: str | None = None,
               cfg: DetectConfig | None = None, stdout: IO | None = None,
               index_cache: str | None = None, checkpoint_dir: str | None = None,
               gzip_output: bool = True) -> StrainDetector:
    """Full strain_detect stage; checkpoint_dir makes the batch run
    resumable at sample granularity.

    Multi-process (the JAX_COORDINATOR_ADDRESS launch contract, one process
    per card): every rank builds the same detector, the background panel
    and the -B samples are split across ranks, and rank 0 writes the
    output and stdout, byte-identical to one process."""
    pidx, pcount = initialize()
    if pcount > 1 and pidx != 0:
        # rank 0 owns the observable streams (stats lines print once)
        from strainer2_tpu_torch.pipeline.fused import _NullTextSink

        stdout = _NullTextSink()
    det = StrainDetector(r_file, a_file, cfg, stdout=stdout, index_cache=index_cache)
    if background_list:
        det.background_filter(background_list)
    det.quantify_all(out_path, batch_list=batch_list, b_file=b_file, b_file2=b_file2,
                     file_type=file_type, checkpoint_dir=checkpoint_dir,
                     gzip_output=gzip_output)
    return det
