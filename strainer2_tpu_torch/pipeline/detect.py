"""strain_detect stage on the torch engine.

Port of ``strainer2_tpu.pipeline.detect`` (reference src/strain_detect.c):

1. index every canonical k-mer of the strain genome (NON_INFORMATIVE);
2. mark the -a file's k-mers informative: each line's canonical code is
   probed in the device table with the lookup kernel (K2);
3. optional background filter: count informative k-mers across background
   metagenomes with the count kernel (K3) and demote the most frequent
   ~half;
4. for every target sample (SE / PE / PEI), per-read total and informative
   hits come from the classify kernel (K4); only when the device pass mask
   says a read or pair passes do the per-read vectors cross back to the
   host, where the passing reads are re-scanned to emit their rows.

Emission, summary lines and diagnostics are the JAX package's host code,
copied, so the output bytes are the same.  Samples run one after another.
With a checkpoint directory each finished sample's payload is saved
(pipeline/progress.py) and a restarted run replays it instead of scoring
it again.  There is no device mesh and no multi-process run.
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
from strainer2_tpu_torch.ops.lookup import passing_any
from strainer2_tpu_torch.ops.packing_np import (
    canonical_codes_np,
    decode_codes_np,
    encode_ascii_np,
)
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
from strainer2_tpu_torch.pipeline.scrub_count import count_panel_file, read_list_file
from strainer2_tpu_torch.utils.observability import stage
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


def _staged_quantify(entries, run_one, new_sink, payload_of, emit, stdout,
                     checkpoint_dir: str) -> None:
    """Sample-granular resumable scoring, the single-process form of
    ``strainer2_tpu.pipeline.detect._staged_quantify``.

    Entries are taken in batch-list order: a stdout message is written
    where it stands; a sample whose payload the checkpoint holds (same
    ordinal, same (f1, f2, type) key) is replayed without scoring; any
    other is scored by ``run_one(args, sink)`` into a fresh in-memory
    ``sink``, its payloads (``payload_of(sink)``, one text per output
    stream) are recorded and then emitted.  Output bytes, stdout warning
    interleaving and failure position are those of the streaming loop: a
    failing sample's partial payload is emitted, nothing after it is, and
    its exception (or exit) propagates unrecorded."""
    from strainer2_tpu_torch.pipeline.progress import DetectCheckpoint

    ckpt = DetectCheckpoint(checkpoint_dir)
    ordinal = 0
    with stage("detect.score_samples"):
        for kind, val in entries:
            if kind == "msg":
                stdout.write(val)
                continue
            key = DetectCheckpoint.sample_key(*val)
            payloads = ckpt.get(ordinal, key)
            if payloads is None:
                sink = new_sink()
                try:
                    run_one(val, sink)
                except BaseException:
                    # the streaming loop has written these rows when it raises
                    emit(payload_of(sink))
                    raise
                payloads = payload_of(sink)
                ckpt.record(ordinal, key, payloads)
            emit(payloads)
            ordinal += 1


def _load_or_build_index(r_file, engine, cfg, index_cache):
    """Build the strain index, or reuse a cached one whose k and layout are
    the engine's (StrainIndex.save of either package writes the same npz),
    as strainer2_tpu/pipeline/detect.py:485-496 does; any other is rebuilt
    and overwritten."""
    import os

    if index_cache and os.path.exists(index_cache):
        idx = StrainIndex.load(index_cache)
        if idx.k == cfg.k and idx.layout == engine.layout:
            return idx
    idx = StrainIndex.from_fasta(r_file, engine, cfg.rows, cfg.row_len)
    if index_cache:
        idx.save(index_cache)
    return idx


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
        self.engine = TorchKmerEngine(
            self.cfg.k,
            max_reads_capacity(self.cfg.k, self.cfg.rows, self.cfg.row_len),
            device=self.cfg.device,
            layout=index.layout if index is not None else self.cfg.layout,
        )
        if index is not None:
            self.index = index
        else:
            with stage("detect.index_build"):
                self.index = _load_or_build_index(r_file, self.engine, self.cfg, index_cache)
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
        kernel."""
        cfg = self.cfg
        counts = self.engine.init_counts(self.index)
        for path in read_list_file(background_list):
            counts = count_panel_file(self.engine, self.index, counts, path, cfg.rows, cfg.row_len)
        bg_counts = self.index.key_values(self.engine.finalize_counts(counts)).astype(np.int64)
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
        self.total_genome_kmers = self.index.num_kmers
        self.total_genome_informative = int(
            np.count_nonzero(self.kmer_type == INFORMATIVE_KMER)
        )

    def quantify_all(self, out_path: str, batch_list: str | None = None,
                     b_file: str | None = None, b_file2: str | None = None,
                     file_type: int = NOT_PAIRED_END, checkpoint_dir: str | None = None,
                     gzip_output: bool = True) -> None:
        """Process all target samples and write the hits file (gzip, or
        plain TSV with gzip_output=False; the row bytes are the same).
        checkpoint_dir makes a -B batch run resumable at sample
        granularity (DetectCheckpoint)."""
        import gzip
        import io

        self._finalize_meta()
        out = gzip.open(out_path, "wt", compresslevel=9) if gzip_output else open(out_path, "w")
        if batch_list is not None and checkpoint_dir:
            with out:
                _staged_quantify(
                    _parse_batch_entries(batch_list),
                    lambda args, sink: self._quantify_sample(*args, sink),
                    io.StringIO, lambda sink: [sink.getvalue()],
                    lambda payloads: out.write(payloads[0]),
                    self.stdout, checkpoint_dir,
                )
            return
        with out, stage("detect.score_samples"):
            if batch_list is None:
                self._quantify_sample(b_file, b_file2, file_type, out)
                return
            # stdout warnings interleave with samples exactly as the
            # reference's streaming loop emits them
            for kind, val in _parse_batch_entries(batch_list):
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

    def _quantify_sample(self, f1: str, f2: str | None, ftype: int, out: IO) -> None:
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
            tot_d, inf_d = self.engine.classify_batch(
                self._classify_table, t.h_bits, t.salt, batch.bases, boundaries,
                meta=self._meta_dev,
            )
            # D2H gate: one bool crosses back per batch; the per-read
            # vectors follow only when a read or pair passes (the skipped
            # emission would have written nothing)
            n_pairs = (n - (n % 2)) // 2 if paired else n
            any_d = passing_any(
                tot_d, inf_d, paired=paired,
                min_t=cfg.min_hits_for_good_match,
                min_i=cfg.min_hits_for_informative_read,
            )
            lens = batch.read_lengths
            if n % 2 and paired and ftype == IS_PAIRED_END_INTERLEAVE:
                odd_interleave = True
            if not bool(any_d[:n_pairs].any()):
                ke, re_, _ = _evaluated_totals(lens, paired, k)
                total_kmers_evaluated += ke
                total_reads_evaluated += re_
                continue
            tot = tot_d[:n].cpu().numpy()
            inf = inf_d[:n].cpu().numpy()
            ke, re_, pe1, t1, i1, t2, i2 = _aggregate_classify_chunk(lens, tot, inf, paired, k)
            total_kmers_evaluated += ke
            total_reads_evaluated += re_

            passing = ((t1 + t2) >= cfg.min_hits_for_good_match) & (
                (i1 + i2) >= cfg.min_hits_for_informative_read
            )
            pass_idx = np.flatnonzero(passing)
            grouping = batch_read_grouping(batch) if pass_idx.size else None
            emit_items = []
            for j in pass_idx:
                r1 = int(pe1[j])
                prefix = f"{f1}\t{t1[j]}\t{i1[j]}\t{t2[j]}\t{i2[j]}\t"
                emit_items.append((prefix, read_codes_from_batch(batch, r1, k, grouping)))
                if paired:
                    emit_items.append(
                        (prefix, read_codes_from_batch(batch, r1 + 1, k, grouping))
                    )
            self._emit_rows_batch(out, emit_items)

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
        for _, bases in items:
            cc, v = canonical_codes_np(bases, k)
            ccodes_list.append(cc)
            valid_list.append(v)
            spans.append(cc.size)
        if not spans or sum(spans) == 0:
            return
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
        for (prefix, _), n in zip(items, spans):
            hits = np.flatnonzero(informative[off : off + n])
            if hits.size:
                for s in decode_codes_np(ccodes[off + hits], k):
                    out.write(prefix + s + "\n")
            off += n


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
    resumable at sample granularity."""
    det = StrainDetector(r_file, a_file, cfg, stdout=stdout, index_cache=index_cache)
    if background_list:
        det.background_filter(background_list)
    det.quantify_all(out_path, batch_list=batch_list, b_file=b_file, b_file2=b_file2,
                     file_type=file_type, checkpoint_dir=checkpoint_dir,
                     gzip_output=gzip_output)
    return det
