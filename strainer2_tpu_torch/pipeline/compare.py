"""genome_compare stage on the torch engine: ANI-like k-mer containment.

Port of ``strainer2_tpu.pipeline.compare`` (reference src/main.c:28-115 +
src/genome_compare.c:242-354): hash every canonical k-mer of genome -a (set
semantics, variable k, default 20), then stream each query file counting
canonical-window hits and misses against the set.

Rapid ("hybrid") mode follows the reference's subsample-then-escalate
control flow exactly: after the max_seeds-th evaluated (non-N) window, if
the hit fraction exceeds the threshold the whole query is scanned
("fullmap"), otherwise scanning stops and the partial tallies are printed
(reference src/genome_compare.c:327-340).

Engines:

- k <= 32 on ``cuda``: the device path. Fullmap batches add into an int64
  (hits, evaluated) accumulator on the card (kernel K8), read once a file;
  undecided rapid-mode batches return four int32 scalars (kernel K9), the
  crossing located on the card, so the decision falls at exactly the
  reference's window and no per-window mask crosses to the host.
- ``cpu``: the C++ string engine ``NativeComparer`` by default, as the JAX
  package off the TPU; ``STRAINER2_NATIVE_COMPARE=0`` runs the device path
  with the kernels' plain torch versions.
- k > 32 on either device: the string engine (packed codes hold k <= 32),
  ``NativeComparer``, or the pure-Python ``_HostSetComparer`` with
  ``STRAINER2_NATIVE_COMPARE=0``.

The device path masks windows with any non-ACGT letter; the string engines
keep IUPAC letters other than N as the reference does, so the two agree on
ACGTN data.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import IO

from strainer2_tpu_torch import native
from strainer2_tpu_torch.constants import MAX_K
from strainer2_tpu_torch.index.build import StrainIndex
from strainer2_tpu_torch.io.batches import DEFAULT_ROW_LEN, DEFAULT_ROWS
from strainer2_tpu_torch.io.fastx import read_fastx
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine, resolve_device
from strainer2_tpu_torch.pipeline.scrub_count import read_list_file
from strainer2_tpu_torch.utils.prefetch import prefetch

__all__ = ["CompareConfig", "GenomeComparer", "run_genome_compare"]

DEFAULT_SEED = 20  # reference src/main.c:11
CLONE_MODE = (50_000, 0.1)  # reference src/main.c:13,16
STRAIN_MODE = (100_000, 0.05)  # reference src/main.c:14,15


@dataclass
class CompareConfig:
    k: int = DEFAULT_SEED
    rows: int = DEFAULT_ROWS
    row_len: int = DEFAULT_ROW_LEN
    max_seeds: int = 0  # 0 = scan everything
    threshold_for_fullmap: float = 0.1  # reference src/main.c:17
    device: str = "cuda"


def _c_fraction(hits: int, misses: int) -> str:
    """%f rendering incl. the reference's 0/0 case (x86 0.0/0.0 -> -nan)."""
    denom = hits + misses
    if denom == 0:
        return "-nan"
    return "%.6f" % (hits / denom)


_COMP_BYTES = bytes.maketrans(b"ABCDGHKMNRSTUVWXY", b"TVGHCD.KNYSAABWXR")


def _canonical_bytes(window: bytes) -> bytes:
    """Canonical form for arbitrary-length char windows (max(fwd, rc),
    forward wins ties — strcmp semantics, any IUPAC letters pass through
    like the reference's string path)."""
    rc = window.translate(_COMP_BYTES)[::-1]
    return window if window >= rc else rc


class _HostSetComparer:
    """Pure-Python string-set engine: the oracle of NativeComparer, and the
    k > 32 engine with STRAINER2_NATIVE_COMPARE=0.  Matches the reference's
    arbitrary-seed behaviour exactly, including windows with non-ACGT
    letters other than N."""

    def __init__(self, a_file: str, k: int):
        self.k = k
        self.kmers: set[bytes] = set()
        for rec in read_fastx(a_file):
            seq = rec.seq.upper()
            for i in range(len(seq) - k + 1):
                w = seq[i : i + k]
                if b"N" not in w:
                    self.kmers.add(_canonical_bytes(w))

    def score(self, path: str, max_seeds: int, threshold: float) -> tuple[int, int]:
        k = self.k
        hits = 0
        misses = 0
        fullmap = max_seeds == 0
        for rec in read_fastx(path):
            seq = rec.seq.upper()
            if len(seq) < k:
                continue
            for i in range(len(seq) - k + 1):
                w = seq[i : i + k]
                if b"N" not in w:
                    if _canonical_bytes(w) in self.kmers:
                        hits += 1
                    else:
                        misses += 1
                if max_seeds and hits + misses >= max_seeds and not fullmap:
                    if hits / (hits + misses) > threshold:
                        fullmap = True
                    else:
                        return hits, misses
        return hits, misses


class GenomeComparer:
    def __init__(self, a_file: str, cfg: CompareConfig | None = None):
        self.cfg = cfg or CompareConfig()
        self.a_file = a_file
        self.engine = None
        self.index = None
        self._host = None

        native_ok = os.environ.get("STRAINER2_NATIVE_COMPARE", "1") != "0"
        if self.cfg.k > MAX_K:
            # beyond the packed-code range: the exact string engine
            if native_ok:
                try:
                    self._host = native.NativeComparer(a_file, self.cfg.k)
                except (RuntimeError, OSError):
                    self._host = None  # unreadable or unavailable: Python path
            if self._host is None:
                self._host = _HostSetComparer(a_file, self.cfg.k)
            return
        device = resolve_device(self.cfg.device)
        if native_ok and device.type == "cpu":
            # on the CPU the native string engine beats the plain torch
            # probes at any k, as it beats the XLA CPU path in the JAX package
            try:
                self._host = native.NativeComparer(a_file, self.cfg.k)
                return
            except (RuntimeError, OSError):
                self._host = None
        self.engine = TorchKmerEngine(self.cfg.k, device=device)
        # set semantics: the reference inserts each canonical k-mer once
        # (reference src/genome_compare.c:475-521)
        self.index = StrainIndex.from_fasta(a_file, self.engine, self.cfg.rows, self.cfg.row_len)

    def _result(self, path: str, hits: int, misses: int, out: IO) -> tuple[int, int]:
        out.write(f"{self.a_file}\t{path}\t{hits}\t{misses}\t{_c_fraction(hits, misses)}\n")
        return hits, misses

    def score_query(self, path: str, out: IO) -> tuple[int, int]:
        """Score one query file; prints the reference's result line."""
        cfg = self.cfg
        if self._host is not None:
            try:
                hits, misses = self._host.score(path, cfg.max_seeds, cfg.threshold_for_fullmap)
            except OSError:
                # surface the same error the streaming reader would raise
                next(iter(read_fastx(path)), None)
                raise
            return self._result(path, hits, misses, out)

        engine, t = self.engine, self.index.table
        table = engine.table_for(self.index)
        hits = 0
        evaluated = 0
        fullmap = cfg.max_seeds == 0
        decided = fullmap
        acc = engine.init_accumulator()
        batches = iter(native.pack_file(path, cfg.k, cfg.rows, cfg.row_len))
        # undecided: one batch at a time, four scalars back from each
        while not decided:
            batch = next(batches, None)
            if batch is None:
                break
            bh, bv, hits_at, pos = engine.hit_stats(
                table, t.h_bits, t.salt, batch.bases, cfg.max_seeds - evaluated
            ).tolist()
            if pos < 0:
                hits += bh
                evaluated += bv
                continue
            # totals at exactly the max_seeds-th evaluated window
            # (reference src/genome_compare.c:327-340)
            hits_at_total = hits + hits_at
            eval_at = cfg.max_seeds
            frac = hits_at_total / eval_at if eval_at else 0.0
            decided = True
            if frac > cfg.threshold_for_fullmap:
                fullmap = True
                # the rest of THIS batch still counts (the reference keeps
                # scanning in place): the whole batch folds in
                hits += bh
                evaluated += bv
            else:
                hits, evaluated = hits_at_total, eval_at
                batches.close()
        if fullmap:
            # the rest of the file on the accumulator, packed ahead on a thread
            for batch in prefetch(batches):
                engine.hit_accumulate(acc, table, t.h_bits, t.salt, batch.bases)
        if fullmap or not decided:
            acc_hits, acc_evaluated = acc.tolist()  # one (2,) readback a file
            hits += acc_hits
            evaluated += acc_evaluated
        return self._result(path, hits, evaluated - hits, out)


def _exit_unreadable_query(path: str) -> None:
    # reference src/genome_compare.c:289; the reference's handling of an
    # unreadable -a file is a hang (GEN_read_seq_file has no error check,
    # src/genome_compare.c:460-461): this port raises instead, as the JAX
    # package does
    print(f"could not read file {path} in GEN_calculate_coverage()", file=sys.stderr)
    raise SystemExit(1)


def _compare_threads(n_paths: int) -> int:
    """Threads for scoring a list with the native engine
    (STRAINER2_COMPARE_THREADS overrides the core count; at most 8)."""
    want = int(os.environ.get("STRAINER2_COMPARE_THREADS", "0")) or (os.cpu_count() or 1)
    return max(1, min(want, 8, n_paths))


def run_genome_compare(
    a_file: str,
    b_file: str | None = None,
    b_list: str | None = None,
    cfg: CompareConfig | None = None,
    print_header: bool = False,
    out: IO | None = None,
) -> None:
    out = out if out is not None else sys.stdout
    if print_header:
        out.write("a_file\tb_file\thits\tmisses\tfrac\n")
    comparer = GenomeComparer(a_file, cfg)

    if b_file:
        try:
            comparer.score_query(b_file, out)
        except OSError:
            _exit_unreadable_query(b_file)
        return
    if not b_list:
        return
    try:
        paths = read_list_file(b_list)
    except OSError:
        # reference src/genome_compare.c:251
        print(f"could not read file {b_list} in GEN_all_coverage()", file=sys.stderr)
        raise SystemExit(1)
    threads = _compare_threads(len(paths))
    if isinstance(comparer._host, native.NativeComparer) and threads > 1:
        # the native string engine scores queries concurrently (the key set
        # is read-only; results are printed in list order, byte-identical
        # to the sequential loop); the Python engine is GIL-bound
        import concurrent.futures

        c = comparer.cfg

        def score(path):
            try:
                return comparer._host.score(path, c.max_seeds, c.threshold_for_fullmap)
            except OSError as e:
                return e

        with concurrent.futures.ThreadPoolExecutor(threads) as ex:
            results = list(ex.map(score, paths))
        for path, res in zip(paths, results):
            if isinstance(res, OSError):
                _exit_unreadable_query(path)
            comparer._result(path, *res, out)
        return
    for path in paths:
        try:
            comparer.score_query(path, out)
        except OSError:
            _exit_unreadable_query(path)
