"""Coverage/depth metrics (coverage_depth equivalent).

Faithful reimplementation of the reference script's semantics (reference
scripts/coverage_depth.py): rows of the strain_detect hits file whose
total k-mer count (PE1+PE2) strictly exceeds min_kmer_hits contribute to
per-metagenome depth (all rows) and coverage (distinct k-mers); the '#'
summary lines provide the denominators.  Output row order follows the
reference's dict-insertion order: metagenomes with hits first (row order),
then zero-hit metagenomes in summary-line order.

The hits file is parsed by the native columnar reader when available
(native.parse_hits_native: bulk gzread + memchr + 2-bit k-mer encode; the
per-(sample,kmer) uniqueness then reduces to a numpy lexsort instead of a
Python set of strings) — the per-line Python parse remains both the
fallback and the behavioral oracle, and results are identical
(tests/test_modes_parity.py runs both).  STRAINER2_NATIVE_COVERAGE=0
forces the Python path for A/B checks.

Host twin of ``strainer2_tpu.pipeline.coverage``: a copy with its imports pointed at
this package, because importing any module under the JAX package's
``io``/``index``/``ops`` runs a package ``__init__`` that imports jax.
tests/test_torch_host.py pins it to the original.
"""

from __future__ import annotations

import os
import re
import sys
from typing import IO

from strainer2_tpu_torch.io.fastx import open_maybe_gzip

__all__ = ["run_coverage_depth"]

_HEADER = (
    "strain_name\tspecies_name\tgenus_name\tgenome_num_total_kmers\t"
    "genome_num_informative_kmers\tmetagenome\tnum_metagenomic_reads\t"
    "num_metagenome_kmers\tunique_observed_informative_kmers\t"
    "total_observed_informative_kmers\tkmer_coverage\tkmer_depth\t"
    "kmer_depth_per_20B_kmer\tbackground"
)

KMER_SCALE_CONSTANT = 2_000_000_000  # reference coverage_depth.py:258


def _strain_names(kmer_hits_file: str) -> tuple[str, str, str]:
    strain = re.sub(r".kmer_hits.gz$", "", os.path.basename(kmer_hits_file))
    pieces = strain.split("_")
    species = pieces[0] + "_" + pieces[1] if len(pieces) > 1 else strain
    return strain, species, pieces[0]


def _parse_comment(line: str, kmer_eval, read_eval, genome_kmer, genome_inf):
    pieces = line.rstrip().split("\t")
    sample = re.sub("^#", "", os.path.basename(pieces[0]))
    variable, value = pieces[1], int(pieces[2])
    if variable == "total_kmer_evaluated":
        kmer_eval[sample] = value
    elif variable == "total_reads_evaluated":
        read_eval[sample] = value
    elif variable == "total_genome_kmers":
        genome_kmer[sample] = value
    elif variable == "total_genome_informative_kmers":
        genome_inf[sample] = value


def _tally_python(kmer_hits_file: str, min_kmer_hits: int):
    """The reference-shaped per-line parse — fallback and oracle."""
    depth: dict[str, int] = {}
    coverage: dict[str, int] = {}
    seen_unique: set[str] = set()
    kmer_eval: dict[str, int] = {}
    read_eval: dict[str, int] = {}
    genome_kmer: dict[str, int] = {}
    genome_inf: dict[str, int] = {}

    with open_maybe_gzip(kmer_hits_file) as f:
        for raw in f:
            line = raw.decode()
            if not line.startswith("#"):
                content = line.rstrip("\n").split("\t")
                sample = os.path.basename(content[0])
                total_kmer = int(content[1]) + int(content[3])
                kmer_seq = content[5]
                # strict '>' — reference coverage_depth.py:89
                if total_kmer > min_kmer_hits:
                    uniq = sample + kmer_seq
                    if uniq not in seen_unique:
                        coverage[sample] = coverage.get(sample, 0) + 1
                        seen_unique.add(uniq)
                    depth[sample] = depth.get(sample, 0) + 1
            else:
                _parse_comment(line, kmer_eval, read_eval, genome_kmer, genome_inf)
    return depth, coverage, kmer_eval, read_eval, genome_kmer, genome_inf


def _tally_native(kmer_hits_file: str, min_kmer_hits: int):
    """Columnar fast path; None -> caller uses _tally_python.

    Reproduces the per-line path exactly: samples key by basename (two
    paths sharing a basename merge, as the reference does), depth/coverage
    dict order = first PASSING row per sample, coverage = distinct
    (sample, kmer) among passing rows."""
    if os.environ.get("STRAINER2_NATIVE_COVERAGE", "1") == "0":
        return None
    from strainer2_tpu_torch.native import parse_hits_native

    parsed = parse_hits_native(kmer_hits_file)
    if parsed is None:
        return None
    import numpy as np

    names, name_idx, totals, codes, comments = parsed
    merged: dict[str, int] = {}
    remap = np.empty(max(len(names), 1), dtype=np.int32)
    for i, nm in enumerate(names):
        remap[i] = merged.setdefault(os.path.basename(nm), len(merged))
    mnames = list(merged)
    rows_m = remap[name_idx]
    mask = totals > min_kmer_hits

    depth_counts = np.bincount(rows_m[mask], minlength=len(mnames))
    ms, mc = rows_m[mask], codes[mask]
    # dict-insertion order of the per-line path: first passing row/sample
    u, first = np.unique(ms, return_index=True)
    order = u[np.argsort(first)]
    if ms.size:
        o = np.lexsort((mc, ms))
        ss, cc = ms[o], mc[o]
        newpair = np.empty(ss.size, dtype=bool)
        newpair[0] = True
        newpair[1:] = (ss[1:] != ss[:-1]) | (cc[1:] != cc[:-1])
        cov_counts = np.bincount(ss[newpair], minlength=len(mnames))
    else:
        cov_counts = np.zeros(len(mnames), dtype=np.int64)

    depth = {mnames[i]: int(depth_counts[i]) for i in order}
    coverage = {mnames[i]: int(cov_counts[i]) for i in order}
    kmer_eval: dict[str, int] = {}
    read_eval: dict[str, int] = {}
    genome_kmer: dict[str, int] = {}
    genome_inf: dict[str, int] = {}
    for line in comments.splitlines():
        _parse_comment(line, kmer_eval, read_eval, genome_kmer, genome_inf)
    return depth, coverage, kmer_eval, read_eval, genome_kmer, genome_inf


def run_coverage_depth(
    kmer_hits_file: str,
    min_kmer_hits: int = 1,
    background_metagenomes_file: str | None = None,
    out: IO | None = None,
) -> None:
    out = out if out is not None else sys.stdout

    tallies = _tally_native(kmer_hits_file, min_kmer_hits)
    if tallies is None:
        tallies = _tally_python(kmer_hits_file, min_kmer_hits)
    depth, coverage, kmer_eval, read_eval, genome_kmer, genome_inf = tallies

    # metagenomes with stats but no passing rows get explicit zeros, in
    # stats order (reference coverage_depth.py:121-124)
    for sample in kmer_eval:
        if not depth.get(sample):
            coverage[sample] = 0
            depth[sample] = 0

    background = set()
    if background_metagenomes_file:
        with open(background_metagenomes_file) as f:
            background = {line.rstrip("\n") for line in f}

    strain, species, genus = _strain_names(kmer_hits_file)

    out.write(_HEADER + "\n")
    for sample in depth:
        n_depth = depth.get(sample, -1)
        n_cov = coverage.get(sample, -1)
        n_eval = kmer_eval.get(sample, -1)
        # gated on kmer_eval membership; defaultdict semantics give 0 when
        # the reads line is absent (reference coverage_depth.py:247-248)
        n_reads = read_eval.get(sample, 0) if sample in kmer_eval else -1
        n_gk = genome_kmer.get(sample, -1)
        n_gi = genome_inf.get(sample, -1)

        kmer_coverage = n_cov / float(n_gi)
        kmer_depth = n_depth / float(n_gi)
        if n_eval == 0:
            depth_scale = 0
        else:
            depth_scale = kmer_depth * (KMER_SCALE_CONSTANT / float(n_eval))

        bg = 1 if sample in background else 0
        out.write(
            f"{strain}\t{species}\t{genus}\t{n_gk}\t{n_gi}\t{sample}\t{n_reads}\t"
            f"{n_eval}\t{n_cov}\t{n_depth}\t{kmer_coverage}\t{kmer_depth}\t"
            f"{depth_scale}\t{bg}\n"
        )
