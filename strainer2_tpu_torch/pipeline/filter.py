"""Informative-k-mer selection (kmer_scrub_filter equivalent).

Reimplements the reference script's semantics exactly but vectorized
(reference scripts/kmer_scrub_filter.py):

- joint scrub (default): score every strain k-mer by max(pangenome
  frequency, metagenome frequency), sort descending with *stable* tie
  order (= input row order), and remove top scorers while
  (1 - (n_scrubbed+1)/all_kmers) > min_fraction.  Because the score is
  monotone along the sorted order, the removal count is a single
  vectorized comparison.  Survivors print in input row order (the
  reference's dict-insertion order).
- drug scrub: first delete k-mers seen in co-occurring strains
  (drug count > 0), aborting if < 2*min_fraction remain.
- independent scrub: per-panel count thresholds via the reference's
  escalating-threshold loop (including its stderr progress lines).

The stage consumes either the textual scrub-count table (CLI drop-in) or
in-memory arrays straight from the scrub-count stage (no TSV round trip).

Host twin of ``strainer2_tpu.pipeline.filter``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import IO, Sequence

import numpy as np

from strainer2_tpu_torch.io.fastx import open_maybe_gzip

__all__ = ["ScrubTable", "parse_scrub_tables", "run_filter"]


class KeyRows:
    """Row-ordered key strings stored as one contiguous byte blob.

    Duck-types the parts of list[bytes] the filter stage uses, without
    materializing millions of Python bytes objects (the reference table has
    one row per strain k-mer).
    """

    __slots__ = ("blob", "offsets")

    def __init__(self, blob: np.ndarray, offsets: np.ndarray):
        self.blob = blob  # (total_bytes,) uint8
        self.offsets = offsets  # (n+1,) int64

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    def __getitem__(self, i: int) -> bytes:
        return self.blob[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def __iter__(self):
        blob, offsets = self.blob, self.offsets
        for i in range(len(self)):
            yield blob[offsets[i] : offsets[i + 1]].tobytes()

    def __eq__(self, other) -> bool:
        if isinstance(other, KeyRows):
            return np.array_equal(self.offsets, other.offsets) and np.array_equal(
                self.blob, other.blob
            )
        return list(self) == list(other)

    def take(self, idx: np.ndarray) -> list[bytes]:
        return [self[int(i)] for i in idx]

    def join_lines(self, idx: np.ndarray) -> bytes:
        """Selected keys, one per line (fixed-width fast path when all keys
        share a length, as kmer_scrub_count output always does)."""
        widths = np.diff(self.offsets)
        if widths.size and (widths == widths[0]).all():
            w = int(widths[0])
            mat = self.blob.reshape(-1, w)[idx]
            out = np.empty((mat.shape[0], w + 1), dtype=np.uint8)
            out[:, :w] = mat
            out[:, w] = ord("\n")
            return out.tobytes()
        return b"".join(self[int(i)] + b"\n" for i in idx)


class CodeKeyRows(KeyRows):
    """KeyRows over packed 2-bit codes: rows decode to ACGT strings only on
    access.  The filter math never reads key strings, so with this view
    only the kept ~1% of rows is ever rendered — decoding all 6.7M rows
    upfront was the dominant cost of the fused filter stage."""

    __slots__ = ("codes", "k")

    def __init__(self, codes: np.ndarray, k: int):
        self.codes = np.asarray(codes, dtype=np.uint64)
        self.k = k

    def __len__(self) -> int:
        return self.codes.shape[0]

    def _matrix(self, idx) -> np.ndarray:
        from strainer2_tpu_torch.ops.packing_np import decode_codes_matrix_np

        return decode_codes_matrix_np(self.codes[idx], self.k)

    def __getitem__(self, i: int) -> bytes:
        return self._matrix(slice(int(i), int(i) + 1)).tobytes()

    def __iter__(self):
        chunk = 1 << 18
        for start in range(0, len(self), chunk):
            for row in self._matrix(slice(start, start + chunk)):
                yield row.tobytes()

    def __eq__(self, other) -> bool:
        if isinstance(other, CodeKeyRows):
            return self.k == other.k and np.array_equal(self.codes, other.codes)
        return list(self) == list(other)

    def take(self, idx: np.ndarray) -> list[bytes]:
        return [bytes(r) for r in self._matrix(np.asarray(idx, dtype=np.int64))]

    def join_lines(self, idx: np.ndarray) -> bytes:
        mat = self._matrix(np.asarray(idx, dtype=np.int64))
        out = np.empty((mat.shape[0], self.k + 1), dtype=np.uint8)
        out[:, : self.k] = mat
        out[:, self.k] = ord("\n")
        return out.tobytes()


@dataclass
class ScrubTable:
    """Parsed scrub-count input in row order."""

    keys: "list[bytes] | KeyRows"  # k-mer strings, file row order
    strain: np.ndarray  # int64 reference_count per row
    pan: np.ndarray  # pangenome counts (possibly summed over files)
    meta: np.ndarray  # metagenome counts (summed over files)
    drug_mask: np.ndarray  # bool, True where any file had drug_count > 0
    has_drug: bool
    # Union-hash sizes for the stats lines when multi-file key columns
    # differ: the reference reports len(pangenome_hash) etc. over the
    # UNION of all files' keys (kmer_scrub_filter.py:187-189,225,230),
    # which exceeds the per-row columns above (restricted to the last
    # file's keys).  None = columns and union coincide (the usual case).
    stat_pan_keys: "int | None" = None
    stat_meta_keys: "int | None" = None
    stat_drug_keys: "int | None" = None


def _parse_one_native(path: str):
    """(KeyRows, c1..c4, has_drug) via the C++ parser, or None."""
    from strainer2_tpu_torch.native import parse_scrub_table_native

    parsed = parse_scrub_table_native(path)
    if parsed is None:
        return None
    blob, offsets, c1, c2, c3, c4, has_drug = parsed
    return KeyRows(blob, offsets), c1, c2, c3, c4, has_drug


def _parse_one(path: str):
    keys: list[bytes] = []
    c1: list[int] = []
    c2: list[int] = []
    c3: list[int] = []
    c4: list[int] = []
    has_drug = False
    with open_maybe_gzip(path) as f:
        for raw in f:
            if raw.startswith(b"#"):
                continue
            parts = raw.rstrip(b"\n").split(b"\t")
            keys.append(parts[0])
            c1.append(int(parts[1]))
            c2.append(int(parts[2]))
            c3.append(int(parts[3]))
            if len(parts) == 5:
                has_drug = True
                c4.append(int(parts[4]))
            else:
                c4.append(0)
    return (
        keys,
        np.asarray(c1, dtype=np.int64),
        np.asarray(c2, dtype=np.int64),
        np.asarray(c3, dtype=np.int64),
        np.asarray(c4, dtype=np.int64),
        has_drug,
    )


def parse_scrub_tables(paths: Sequence[str]) -> ScrubTable:
    """Parse one or more scrub-count tables, accumulating panel counts.

    Multi-file semantics follow the reference: pangenome/metagenome counts
    sum across files; the strain rows must agree between consecutive files
    from the third file onward (reference kmer_scrub_filter.py:168-201,
    including its off-by-one that never compares file 2 against file 1).
    """
    if not paths:
        sys.exit("error: no scrub-count files to parse")
    # Fast path: native parse + element-wise aggregation.  Valid whenever
    # every file carries the same key column (guaranteed for tables written
    # by kmer_scrub_count over one strain — the reference's own multi-file
    # contract, which it enforces by the strain-hash equality check).
    parsed = []
    for path in paths:
        one = _parse_one_native(path)
        if one is None:
            parsed = None
            break
        parsed.append(one)
    if parsed is not None:
        keys0 = parsed[0][0]
        if all(p[0] == keys0 for p in parsed[1:]):
            strain = parsed[-1][1]
            for i in range(2, len(parsed)):
                # reference compares from the third file onward (its
                # off-by-one never checks file 2 against file 1)
                if not np.array_equal(parsed[i][1], parsed[i - 1][1]):
                    sys.exit(
                        "error: input files do not have identical hash and strain hash values."
                    )
            pan = np.sum([p[2] for p in parsed], axis=0, dtype=np.int64)
            meta = np.sum([p[3] for p in parsed], axis=0, dtype=np.int64)
            drug_mask = np.zeros(len(keys0), dtype=bool)
            has_drug = False
            for p in parsed:
                if p[5]:
                    has_drug = True
                    drug_mask |= p[4] > 0
            return ScrubTable(keys0, strain, pan, meta, drug_mask, has_drug)
        # key columns differ: fall through to the dict path with the
        # already-parsed columns
        pre = [(list(p[0]), p[1], p[2], p[3], p[4], p[5]) for p in parsed]
    else:
        pre = None

    agg_pan: dict[bytes, int] = {}
    agg_meta: dict[bytes, int] = {}
    agg_drugmask: dict[bytes, bool] = {}
    has_drug = False
    prev_strain: dict[bytes, int] | None = None
    keys: list[bytes] = []
    strain = None

    for i, path in enumerate(paths):
        if i > 1:
            prev_strain = dict(zip(keys, strain.tolist()))
        keys, c1, c2, c3, c4, hd = pre[i] if pre is not None else _parse_one(path)
        strain = c1
        has_drug = has_drug or hd
        for key, v in zip(keys, c2.tolist()):
            if v > 0:
                agg_pan[key] = agg_pan.get(key, 0) + v
        for key, v in zip(keys, c3.tolist()):
            if v > 0:
                agg_meta[key] = agg_meta.get(key, 0) + v
        if hd:
            for key, m, v in zip(keys, c3.tolist(), c4.tolist()):
                if v > 0:
                    agg_drugmask[key] = True
        if i > 1 and dict(zip(keys, strain.tolist())) != prev_strain:
            sys.exit("error: input files do not have identical hash and strain hash values.")

    pan = np.asarray([agg_pan.get(k, 0) for k in keys], dtype=np.int64)
    meta = np.asarray([agg_meta.get(k, 0) for k in keys], dtype=np.int64)
    drug_mask = np.asarray([agg_drugmask.get(k, False) for k in keys], dtype=bool)
    return ScrubTable(
        keys, strain, pan, meta, drug_mask, has_drug,
        stat_pan_keys=len(agg_pan), stat_meta_keys=len(agg_meta),
        stat_drug_keys=len(agg_drugmask) if has_drug else None,
    )


def _fmt(x: float) -> str:
    return str(float(x))


def run_filter(
    table: ScrubTable,
    min_fraction: float = 0.04,
    independent: bool = False,
    out: IO = None,
    err: IO = None,
    return_indices: bool = False,
) -> "list[bytes] | tuple[list[bytes], np.ndarray]":
    """Apply the scrub filter; writes the reference-format report + kept
    k-mers to ``out`` and returns the kept k-mers (input row order).
    With return_indices, also returns the kept row indices — the fused
    pipeline maps those straight to strain-index keys, skipping the
    k-mer-string round trip."""
    out = out if out is not None else sys.stdout
    err = err if err is not None else sys.stderr

    all_kmers = len(table.keys)
    num_pan = (
        table.stat_pan_keys
        if table.stat_pan_keys is not None
        else int(np.count_nonzero(table.pan))
    )
    num_meta = (
        table.stat_meta_keys
        if table.stat_meta_keys is not None
        else int(np.count_nonzero(table.meta))
    )
    out.write(
        "#total kmers in strain:%d,%d pangenome: %d metagenome: %d\n"
        % (all_kmers, all_kmers, num_pan, num_meta)
    )

    alive = np.ones(all_kmers, dtype=bool)
    drug_scrubbed = 0
    if table.has_drug:
        num_drug = (
            table.stat_drug_keys
            if table.stat_drug_keys is not None
            else int(np.count_nonzero(table.drug_mask))
        )
        out.write("#total kmers cross drug:%d\n" % num_drug)
        alive &= ~table.drug_mask
        remaining = int(np.count_nonzero(alive))
        drug_scrubbed = all_kmers - remaining
        frac_rem = float(remaining / float(all_kmers))
        out.write("#fraction kmers remaining drug post scrub:%s\n" % _fmt(frac_rem))
        out.write("#drug_scrubbed kmers:%d\n" % drug_scrubbed)
        if frac_rem < min_fraction * 2:
            raise RuntimeError(
                "ERROR: too few kmers remain after drug scrub. Are your drug strains too similar?"
            )

    if independent:
        alive = _independent_scrub(table, alive, min_fraction, all_kmers, err)
    else:
        alive = _joint_scrub(table, alive, min_fraction, all_kmers, drug_scrubbed)

    kept_idx = np.flatnonzero(alive)
    out.write("#post scrub kmers %d out of %d\n" % (kept_idx.size, all_kmers))
    if isinstance(table.keys, KeyRows):
        kept = table.keys.take(kept_idx)
        out.write(table.keys.join_lines(kept_idx).decode("ascii"))
    else:
        kept = [table.keys[int(i)] for i in kept_idx]
        out.write("".join(k.decode("ascii") + "\n" for k in kept))
    if return_indices:
        return kept, kept_idx
    return kept


def _joint_scrub(table, alive, min_fraction, all_kmers, drug_scrubbed):
    pan_sum = float(table.pan.sum())
    meta_sum = float(table.meta.sum())
    # frequencies; a panel with zero total would divide by zero in the
    # reference too (only reachable when no k-mer was ever counted)
    pan_f = table.pan / pan_sum if pan_sum else np.zeros_like(table.pan, dtype=float)
    meta_f = table.meta / meta_sum if meta_sum else np.zeros_like(table.meta, dtype=float)
    score = np.maximum(np.maximum(meta_f, pan_f), 0.0)

    # candidates = still-alive keys, sorted by score desc, ties in row order
    cand = np.flatnonzero(alive)
    order = cand[np.argsort(-score[cand], kind="stable")]
    # remove while (1 - (n+1)/all) > min_fraction, n starting at drug_scrubbed;
    # monotone -> closed form count
    n = drug_scrubbed + np.arange(order.size, dtype=np.float64)
    removed = (1.0 - (n + 1.0) / all_kmers) > min_fraction
    alive = alive.copy()
    alive[order[removed]] = False
    return alive


def _independent_scrub(table, alive, min_fraction, all_kmers, err):
    alive = alive.copy()
    for vals_all in (table.pan, table.meta):
        # the reference iterates the per-panel hash: only keys with count>0
        vals = vals_all[vals_all > 0]
        threshold = _scrub_max_kmers(min_fraction, vals, all_kmers, err)
        alive &= ~(vals_all > threshold)
    return alive


def _scrub_max_kmers(min_frac, vals, total_kmers, err) -> int:
    """Escalating count threshold (reference kmer_scrub_filter.py:30-58),
    including its stderr progress lines."""
    svals = np.sort(vals)
    min_count = -1
    fraction_kept = -1.0
    while fraction_kept < min_frac:
        min_count += 1
        hits = int(vals.size - np.searchsorted(svals, min_count, side="right"))
        fraction_kept = 1 - hits / float(total_kmers)
        err.write("kept " + _fmt(fraction_kept) + " with threshold " + str(min_count) + "\n")
    n_scrub = int(vals.size - np.searchsorted(svals, min_count, side="right"))
    err.write(
        "threshold was %d left with %d out of %s that will be scrubbed\n"
        % (min_count, n_scrub, _fmt(float(total_kmers)))
    )
    return min_count
