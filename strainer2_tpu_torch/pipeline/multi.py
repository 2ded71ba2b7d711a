"""Multi-genome library modes on the torch engine: pangenome tracks, k-mer
matrix, strain-track.

Port of ``strainer2_tpu.pipeline.multi``, the reference's library-only
modes (kept behind commented-out Makefile targets, reference
src/Makefile:12):

- pangenome (reference src/genome_compare.c:651-744): hash every genome of
  a list with occurrence counts, then write a per-window count track for
  one (or every) genome, plus an optional count histogram.
- k-mer matrix (reference src/genome_compare.c:600-648): k-mer x file
  occurrence-count matrix with the reference's hardcoded row filters; each
  file counts through kernel K3 (``count_panel_file``).
- strain-track (reference src/genome_compare.c:747-864): hash many strain
  genomes, keep k-mers unique across the union, count one metagenome
  against them through K3 with its valid-window count, and report
  per-strain usage plus a scale-normalized abundance table.

Union indexes are first-encounter scans of the genomes (kernel K1), as
StrainIndex is.  Track and matrix output is written on the host, in the
reference's hash-slot order where it prints in that order (the djb2
replay, index/refhash_order.py).
"""

from __future__ import annotations

import io
import sys
from dataclasses import dataclass
from typing import IO

import numpy as np

from strainer2_tpu_torch.constants import DEFAULT_K
from strainer2_tpu_torch.index.build import StrainIndex, scan_file_codes
from strainer2_tpu_torch.index.refhash_order import reference_row_order
from strainer2_tpu_torch.io.batches import DEFAULT_ROW_LEN, DEFAULT_ROWS, pack_stream
from strainer2_tpu_torch.io.fastx import read_fastx
from strainer2_tpu_torch.ops.packing_np import canonical_codes_np, decode_codes_np, encode_ascii_np
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
from strainer2_tpu_torch.pipeline.scrub_count import count_panel_file, read_list_file

__all__ = [
    "UnionIndex",
    "build_union_index",
    "run_pangenome",
    "run_kmer_matrix",
    "run_strain_track",
    "unique_name_suffix",
    "write_count_track",
]


def unique_name_suffix(original: str, part1: str, suffix: str) -> str:
    """Output path `<name>_<part1>.<suffix>` (reference
    src/genome_compare.c:867-876)."""
    return f"{original}_{part1}.{suffix}"


@dataclass
class UnionIndex:
    """Union of canonical k-mers over many genome files."""

    index: StrainIndex  # codes in first-encounter order across the file list
    occurrences: np.ndarray  # total occurrences across all files


def build_union_index(paths: list[str], engine: TorchKmerEngine) -> UnionIndex:
    scans = [scan_file_codes(p, engine) for p in paths]
    scan = np.concatenate([s for s in scans if s.size] or [np.empty(0, np.uint64)])
    index = StrainIndex.from_scan_codes(scan, k=engine.k, layout=engine.layout)
    return UnionIndex(index=index, occurrences=index.genome_counts.astype(np.int64))


def _key_lookup_maps(index: StrainIndex):
    order = np.argsort(index.codes, kind="stable")
    return index.codes[order], order


def _positions(sorted_codes, sorted_to_key, ccodes):
    pos = np.searchsorted(sorted_codes, ccodes)
    pos = np.clip(pos, 0, max(sorted_codes.size - 1, 0))
    ok = sorted_codes[pos] == ccodes
    return np.where(ok, sorted_to_key[pos], -1)


# IUPAC complements as the reference defines them (reference
# src/BIO_sequence.c:203-213, including the K->'.' quirk); only rows the
# canonical orientation of N-containing windows can reach matter here.
_COMPLEMENT = str.maketrans("ABCDGHKMNRSTUVWXY", "TVGHCD.KNYSAABWXR")


def _orient_string(window: str) -> str:
    """Reference orient_string for raw char windows (incl. N/IUPAC chars):
    compare fwd vs revcomp char-by-char, forward wins ties
    (reference src/genome_compare.c:1100-1141)."""
    n = len(window)
    for j in range(n):
        c = window[j]
        rc = window[n - 1 - j].translate(_COMPLEMENT)
        if c > rc:
            return window
        if rc > c:
            return window.translate(_COMPLEMENT)[::-1]
    return window  # palindrome


def write_count_track(
    genome_path: str,
    index: StrainIndex,
    per_key_counts: np.ndarray,
    out: IO,
    k: int,
) -> tuple[int, int, int]:
    """Per-window `kmer<TAB>count` track of one genome against an index
    (reference GEN_print_coverage_to_ref, src/genome_compare.c:524-599):
    -1 for windows absent from the index, -2 for windows containing N
    (printed as the *oriented raw string*, N characters included).

    Returns (used_seeds, possible_seeds, total_counts).
    """
    sorted_codes, sorted_to_key = _key_lookup_maps(index)
    used = 0
    possible = 0
    total = 0
    for rec in read_fastx(genome_path):
        seq = rec.seq.decode("ascii", "replace").upper()
        codes = encode_ascii_np(np.frombuffer(rec.seq, dtype=np.uint8))
        if codes.shape[0] < k:
            continue
        ccodes, valid = canonical_codes_np(codes, k)
        idx = _positions(sorted_codes, sorted_to_key, ccodes)
        kmers = decode_codes_np(ccodes, k)
        counts = np.where(idx >= 0, per_key_counts[np.maximum(idx, 0)], -1)
        for w in range(ccodes.shape[0]):
            if not valid[w]:
                out.write(f"{_orient_string(seq[w : w + k])}\t-2\n")
            elif idx[w] < 0:
                out.write(f"{kmers[w]}\t-1\n")
            else:
                c = int(counts[w])
                out.write(f"{kmers[w]}\t{c}\n")
                total += c
                possible += 1
                if c > 0:
                    used += 1
    return used, possible, total


def run_pangenome(
    a_list: str,
    ref_file: str | None = None,
    write_dist: bool = False,
    k: int = DEFAULT_K,
    out: IO | None = None,
    device="cuda",
    layout: str = "bucket",
) -> None:
    """Pangenome mode (reference src/genome_compare.c:651-744)."""
    out = out if out is not None else sys.stdout
    engine = TorchKmerEngine(k, device=device, layout=layout)
    paths = read_list_file(a_list)
    for p in paths:
        print(f"hashing {p}", file=sys.stderr)
    union = build_union_index(paths, engine)

    targets = [ref_file] if ref_file else paths
    for path in targets:
        outfile = unique_name_suffix(path, "", "pangenome")
        out.write(f"file {path} to {outfile}\n")
        with open(outfile, "w") as f:
            f.write(f"#{path}\n")
            f.write(f"#output to {outfile}\n")
            f.write(f"#pangenome_size\t{len(paths)}\n")
            _, _, total = write_count_track(path, union.index, union.occurrences, f, k)
            f.write(f"#total_counts\t{total}\n")

    if write_dist:
        outfile = unique_name_suffix(a_list, "", "pangenome_dist")
        out.write(f"writing dist to {outfile}\n")
        order = reference_row_order(union.index.codes, k)
        counts = union.occurrences[order]
        with open(outfile, "w") as f:
            for c in counts:
                if c > 0:
                    f.write(f"{int(c)}\n")


def run_kmer_matrix(
    a_list: str,
    k: int = DEFAULT_K,
    out: IO | None = None,
    min_sum: int = 4,
    min_instances: int = 2,
    max_instances: int = 5,
    device="cuda",
    rows: int = DEFAULT_ROWS,
    row_len: int = DEFAULT_ROW_LEN,
    layout: str = "bucket",
) -> None:
    """k-mer x file count matrix (reference src/genome_compare.c:600-648;
    row filters hardcoded there at 45-77).  Batch geometry and table layout
    change no output byte."""
    out = out if out is not None else sys.stdout
    engine = TorchKmerEngine(k, device=device, layout=layout)
    paths = read_list_file(a_list)
    union = build_union_index(paths, engine)
    index = union.index

    cols = []
    for i, path in enumerate(paths):
        print(f"reading file {path}\t{i + 1} of {len(paths)}", file=sys.stderr)
        counts = count_panel_file(engine, index, engine.init_counts(index), path, rows, row_len)
        cols.append(index.key_values(engine.finalize_counts(counts)).astype(np.int64))
    mat = np.stack(cols, axis=1)  # (num_kmers, num_files)

    out.write("kmer" + "".join(f"\t{p}" for p in paths) + "\n")
    sums = mat.sum(axis=1)
    instances = (mat > 0).sum(axis=1)
    keep = (sums >= min_sum) & (instances >= min_instances) & (instances < max_instances)
    order = reference_row_order(index.codes, k)
    keep_in_order = order[keep[order]]
    kmers = decode_codes_np(index.codes[keep_in_order], k)
    for s, row in zip(kmers, mat[keep_in_order]):
        out.write(s + "".join(f"\t{int(v)}" for v in row) + "\n")


def run_strain_track(
    a_list: str,
    b_file: str,
    k: int = DEFAULT_K,
    print_track: bool = True,
    max_reads: int = 0,
    out: IO | None = None,
    device="cuda",
    rows: int = DEFAULT_ROWS,
    row_len: int = DEFAULT_ROW_LEN,
    layout: str = "bucket",
) -> None:
    """Strain-track mode (reference src/genome_compare.c:747-864): keep
    k-mers unique across all strains, count one metagenome against them,
    and print per-strain usage + scale-normalized abundances.  Batch
    geometry and table layout change no output byte."""
    out = out if out is not None else sys.stdout
    engine = TorchKmerEngine(k, device=device, layout=layout)
    paths = read_list_file(a_list)
    union = build_union_index(paths, engine)

    # the reference hashes with default 0 / increment 1, so count > 0 means
    # the k-mer occurred more than once; those are eliminated
    # (eliminate_nonunique_keys, reference src/genome_compare.c:91-113)
    unique_mask = union.occurrences == 1
    n_total = union.index.num_kmers
    n_nonunique = int(np.count_nonzero(~unique_mask))
    print(
        "eliminate nonunique %d of %d (%f)"
        % (n_nonunique, n_total, n_nonunique / n_total if n_total else 0.0),
        file=sys.stderr,
    )
    surviving = StrainIndex.from_scan_codes(union.index.codes[unique_mask], k=k, layout=layout)

    # count the metagenome on the device (GEN_metagenome_coverage_to_ref,
    # reference src/genome_compare.c:356-441, incl. its max_reads quirk of
    # processing max_reads + 2 reads)
    t = surviving.table
    table = engine.table_for(surviving)
    counts = engine.init_counts(surviving)

    def read_stream():
        for i, rec in enumerate(read_fastx(b_file)):
            if max_reads and i > max_reads + 1:
                return
            yield rec.seq

    # the valid windows stay on the device in an int64 tally (exact on any
    # stream), totalled and read once at the end
    tally = engine.init_valid_tally(rows, row_len)
    for batch in pack_stream(read_stream(), k, rows=rows, row_len=row_len):
        counts = engine.count_batch_with_valid(counts, tally, table, t.h_bits, t.salt, batch.bases)
    non_n_windows = engine.valid_total(tally)
    per_key = surviving.key_values(engine.finalize_counts(counts)).astype(np.int64)
    num_matches = int(per_key.sum())

    results = []
    for path in paths:
        if print_track:
            outfile = unique_name_suffix(path, b_file, "strain_track")
            print(f"output to {outfile}", file=sys.stderr)
            with open(outfile, "w") as f:
                used, possible, total = write_count_track(path, surviving, per_key, f, k)
                f.write(f"#total_counts\t{total}\n")
                f.write(f"{path}\n")
                f.write(f"{non_n_windows}\n")
        else:
            used, possible, total = write_count_track(path, surviving, per_key, io.StringIO(), k)
        results.append((path, used, possible, total))

    scale_sum = sum(r[3] / r[2] for r in results if r[2])
    out.write(
        "#query\ttarget\tused_seeds\tpossible_seeds\tseed_counts\tmetagenomic_counts\t"
        "frac_used_seeds\tfrac_counts\tfrac_matches\tscaled_matches\n"
    )
    last_possible = results[-1][2] if results else 1
    for path, used, possible, total in results:
        # NOTE: frac_used_seeds divides by the LAST strain's possible_seeds,
        # reproducing the reference's stale-variable bug
        # (reference src/genome_compare.c:851 uses `possible_seeds`, not SR[i])
        out.write(
            "%s\t%s\t%d\t%d\t%d\t%d\t%f\t%f\t%f\t%f\n"
            % (
                path,
                b_file,
                used,
                possible,
                total,
                non_n_windows,
                used / last_possible if last_possible else 0.0,
                total / non_n_windows if non_n_windows else 0.0,
                total / num_matches if num_matches else 0.0,
                (total / possible) / scale_sum if possible and scale_sum else 0.0,
            )
        )
