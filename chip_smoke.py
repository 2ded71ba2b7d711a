#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (strainer2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--keep DIR] [--profile DIR]

Phases; any failure exits non-zero and no result line is printed:

1. set-up: the card's name and power limit, whether the C++ host library
   built (``native_host``), and the CUDA kernels' build time;
2. kernels vs plain versions on the card, at main-path shapes: a 256 x 4096
   batch with ~3% invalid bases against a 6.7 M-key strain table, for K1,
   K3 and K4 also batches made like the phase-4 targets (0.1% N), and for
   K2 also sets of present keys as strain_detect probes them; K8, K9 and
   K3 with its valid count on the counting and target-like batches at
   k = 20 and 31, K9 with ``remaining`` at 0, 1, the batch's valid total
   and one past it, K3 with its valid count's tally total
   (``valid_tally_total``) beside one torch.sum; the cuckoo layout's
   kernels on the same batches over a cuckoo table of the same keys: K10
   (``cuckoo_lookup``) on the counting batches' window codes and on the
   present-key sets, the cuckoo instances of K3 and K4 on their batches,
   of K8, K9 and K3 with its valid count at k = 20 and 31 (K9 at the same
   ``remaining`` edges), and every cuckoo kernel at k = 32 on batches with
   a poly-T run (the empty-slot sentinel window); every
   output must be exactly equal (all values are integers); kernel times
   device-only (CUDA events around a CUDA-graph replay,
   strainer2_tpu_torch/tools/bench_kernels.py) and from a loop of
   launches, plain times from the loop; each kernel's bound from the bytes
   its inputs make it move;
3. mini goldens: the four port CLIs with --device cuda on
   tests/golden/mini, byte-compared with the reference binaries' outputs;
   the fused ``strainer2_tools pipeline`` to the same goldens, and
   ``pipeline-multi`` on two strains byte-identical per strain to the
   staged CLIs (coverage against ``coverage_depth`` on the fused hits);
   the six ``gc_*`` goldens through ``genome_compare`` (k = 17, 20 and 40,
   rapid, strain mode, one query with a header) and the ``modes/`` goldens
   through ``strainer2_tools pangenome``, ``kmer-matrix`` and
   ``strain-track``; then, in the cuckoo layout through the stage APIs,
   run_scrub_count, strain_detect (and coverage_depth on its hits), the
   gc_* cases at k <= 32 and strain-track, to the same goldens;
4. real size, the "strain vs metagenomes, joint scrub + detect" run of the
   README: a 6.7 Mbp strain, background genomes, metagenome panels and two
   target samples made from --seed, cut in depth (printed); the four CLIs
   run on the GPU; the panel counts are checked against the C++
   NativePanelCounter and the detection rows against the C++
   NativeClassifier (both independent of the CUDA path);
2b. the lookup A/B tool (``python -m strainer2_tpu_torch.tools.bench_lookup``)
   on a 6.7 M-key table at 64-, 128- and 288-lane rows, 4 M lookups a
   step: every ring variant of K5 exactly equal to K2 and to the plain
   lookup, K10 on a cuckoo table of the same keys equal to the plain
   cuckoo lookup and to K2's found keys, M lookups/s of each; then K6 and K7 at S = 16, 32, 96 and 256 strains on phase 2's key set
   with seeded meta words and its detection batches, each exactly equal to
   its plain version;
5. launch counts of the seventeen kernels on their paths (phase 4 for K1,
   K3 and K4, the A/B tool for K2, K5 and K10, phase 6 for K6 and K7,
   phase 9 for K8, K9 and K3 with its valid count and its tally total,
   phase 10 for the cuckoo K3, K4, K8 and K9, phase 3's cuckoo
   strain-track for the cuckoo K3 with its valid count; each must be >
   0; no CLI path
   probes a key set with K2 since the -a file's k-mers are marked by a
   host search), a check that neither jax nor the JAX package
   (strainer2_tpu) was imported, one JSON line of per-kernel results (each
   naming the path its launches were counted on), then the result line;
6. real size, multi-strain: 32 strains made from the phase-4 genome with
   seeded SNPs (rate 0.002), each with a seeded 1% sample of its own
   k-mers as its scrubbed set, run through ``strainer2_tools detect-multi``
   on the GPU against the phase-4 targets, with its per-strain set-up
   (``multi.strain_states``) timed on a line of its own; strains 0, 15 and
   31 are byte-compared with single-strain ``strain_detect`` runs, and
   every strain's hit rows with what the C++ ``NativeClassifier`` predicts;
7. real size, single strain, fused: ``strainer2_tools pipeline`` on the
   phase-4 data at phase 4's -m, every artifact byte-identical to phase
   4's (coverage against ``coverage_depth`` on its own hits); then the
   same run with --checkpoint in a child process killed (SIGKILL) once
   the panel checkpoint lists a finished file, run again and killed once
   the detect checkpoint holds sample 0, run a third time to the end: its
   artifacts equal the uninterrupted run's; the time of one checkpoint
   record of the real-size count buffer; peak RSS of strain_detect with
   and without --checkpoint (child processes);
8. real size, multi-strain, fused: ``pipeline-multi`` on 8 strains (the
   phase-4 genome and the first 7 strains of phase 6), intermediates
   written: strain 0's artifacts equal phase 7's, and for strains 3 and 7
   the count columns equal the C++ ``NativePanelCounter``'s and the hit
   rows the C++ ``NativeClassifier``'s prediction from the strain's own
   scrubbed file; peak device memory;
9. real size, containment: ``genome_compare`` with -a the phase-4 strain
   (k = 20) against the 10 background genomes and the 8 panel
   metagenomes, fullmap, in strain mode (-S) and with -r 3000000 -t 0.02;
   every line equal to the C++ ``NativeComparer``'s on this host (the
   data is ACGTN only: the device path masks windows with other IUPAC
   letters, which the string engine keeps); then ``strainer2_tools
   strain-track -n`` of the first TRACK_STRAINS strains of phase 6 against
   a metagenome made like the phase-4 panels with 1% of its reads from
   each of those strains, each strain's used, possible and counted seeds
   and the valid windows equal to what the C++ ``NativePanelCounter``
   counts on the k-mers unique to one strain (found here with numpy);
10. real size, the cuckoo layout: the phase-4 strain's cuckoo index built
   on the card (K1, then the native builder), every key checked to sit at
   one of its two slots; run_scrub_count, strain_detect and genome_compare
   fullmap and -S with layout="cuckoo" through the stage APIs, each
   byte-identical to phases 4 and 9, with walls and windows/s (idle share
   with --profile); a strain_detect run on the saved npz as its
   --index-cache reuses it unwritten (bytes and mtime).

Phases run in the order 1, 2, 2b, 3, 4, 7, 6, 8, 9, 10, 5.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 31
ROWS, ROW_LEN = 256, 4096
STRAIN_BP = 6_700_000
STRAIN_CONTIGS = 20
READ_LEN = 150
# real size cut in depth to fit the run (the README's configuration has
# 50 metagenomes of tens of millions of reads each)
N_GENOMES, GENOME_BP = 10, 5_000_000
N_METAGENOMES, METAGENOME_READS = 8, 500_000
TARGET_SE_READS, TARGET_PE_PAIRS = 1_000_000, 500_000
STRAIN_READ_FRACTION = 0.01
MIN_FRACTION = 0.01
N_BATCHES = 8  # distinct inputs per kernel in phase 2
ROW_WIDTHS = (64, 128, 288)  # lookup A/B rows: detection, 96 strains, 256 strains
S_SWEEP = (16, 32, 96, 256)  # strains per pass in the K6/K7 checks
MULTI_STRAINS = 32
SNP_RATE = 0.002  # tools/make_scale_data.py's default
INFORMATIVE_FRACTION = 0.01
MULTI_CHECKED = (0, 15, 31)  # strains byte-compared with single runs
FUSED_STRAINS = 8  # phase 8: the phase-4 genome and the first 7 of phase 6
FUSED_CHECKED = (3, 7)  # phase-8 strains checked against the C++ counters
COMPARE_K = 20  # genome_compare's default k (phase 9)
# phase 9's genome_compare runs: argv, and the (max_seeds, threshold) they set
COMPARE_RUNS = {"fullmap": ([], 0, 0.1), "strain mode": (["-S"], 100_000, 0.05),
                "rapid 3M": (["-r", "3000000", "-t", "0.02"], 3_000_000, 0.02)}
TRACK_STRAINS = 4  # phase 9: the first strains of phase 6 in strain-track
RECORD_REPS = 3  # timed checkpoint records in phase 7
RING_DEFAULT = "ring8x4"  # bucket_lookup_pallas_manual's defaults w=8, d=4
RING_CHUNK = 1024  # queries per K5 block in phase 2 (the wrapper's default)
# lookups per A/B step: at the tool's default 262,144 a step is ~20 us of
# device work, below the host's issue time per launch, so the chain would
# time the host; 4 M keep the device the slower side
AB_QUERIES = 4_194_304
_CU = "strainer2_tpu_torch/csrc/"
SOURCES = {
    "canonical_windows": _CU + "strainer2_kernels.cu",
    "bucket_lookup": _CU + "strainer2_kernels.cu",
    "count_step": _CU + "strainer2_kernels.cu",
    "classify_step": _CU + "strainer2_kernels.cu",
    "bucket_lookup_ring": _CU + "strainer2_multi.cu",
    "multi_hit_words": _CU + "strainer2_multi.cu",
    "strain_sums": _CU + "strainer2_multi.cu",
    "hit_accumulate": _CU + "strainer2_kernels.cu",
    "hit_stats": _CU + "strainer2_kernels.cu",
    "count_valid_step": _CU + "strainer2_kernels.cu",
    "valid_tally_total": _CU + "strainer2_kernels.cu",
    "cuckoo_lookup": _CU + "strainer2_kernels.cu",
    "cuckoo_count_step": _CU + "strainer2_kernels.cu",
    "cuckoo_count_valid_step": _CU + "strainer2_kernels.cu",
    "cuckoo_classify_step": _CU + "strainer2_kernels.cu",
    "cuckoo_hit_accumulate": _CU + "strainer2_kernels.cu",
    "cuckoo_hit_stats": _CU + "strainer2_kernels.cu",
}
REPLACES = {
    "canonical_windows": "strainer2_tpu/ops/pallas_kernels.py:127",
    "bucket_lookup": "strainer2_tpu/ops/pallas_lookup.py:93",
    "count_step": "strainer2_tpu/pipeline/engine.py:324",
    "classify_step": "strainer2_tpu/pipeline/engine.py:353",
    "bucket_lookup_ring": "strainer2_tpu/ops/pallas_lookup.py:211",
    "multi_hit_words": "strainer2_tpu/ops/lookup.py:181",
    "strain_sums": "strainer2_tpu/ops/segsum.py:126",
    "hit_accumulate": "strainer2_tpu/pipeline/engine.py:343",
    "hit_stats": "strainer2_tpu/pipeline/engine.py:348",
    "count_valid_step": "strainer2_tpu/pipeline/engine.py:330",
    # the JAX strain-track adds each batch's valid scalar on the host; the
    # port totals its device tally once a stream
    "valid_tally_total": "strainer2_tpu/pipeline/multi.py:284",
    # the cuckoo layout (the JAX package's default off the TPU)
    "cuckoo_lookup": "strainer2_tpu/ops/lookup.py:39",
    "cuckoo_count_step": "strainer2_tpu/pipeline/engine.py:301",
    "cuckoo_count_valid_step": "strainer2_tpu/pipeline/engine.py:294",
    "cuckoo_classify_step": "strainer2_tpu/pipeline/engine.py:307",
    "cuckoo_hit_accumulate": "strainer2_tpu/pipeline/engine.py:279",
    "cuckoo_hit_stats": "strainer2_tpu/pipeline/engine.py:284",
}
DEVICE = "cuda"
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---- data made from the seed -------------------------------------------------

def write_fasta(path: str, contigs: list[np.ndarray], prefix: str) -> None:
    with open(path, "wb") as f:
        for i, c in enumerate(contigs):
            f.write(f">{prefix}_{i}\n".encode())
            a = _ACGT[c]
            for s in range(0, a.size, 80):
                f.write(a[s : s + 80].tobytes() + b"\n")


def write_reads(path: str, reads: np.ndarray, n_rate: float, rng) -> None:
    """reads (n, L) base codes -> FASTA with fixed-width names r000000000."""
    n, length = reads.shape
    rec = np.empty((n, 12 + length + 1), dtype=np.uint8)
    rec[:, 0:2] = np.frombuffer(b">r", np.uint8)
    ids = np.arange(n, dtype=np.int64)
    for p in range(9):
        rec[:, 10 - p] = 48 + (ids // 10**p) % 10
    rec[:, 11] = 10
    a = _ACGT[reads]
    a[rng.random(a.shape) < n_rate] = ord("N")
    rec[:, 12 : 12 + length] = a
    rec[:, -1] = 10
    rec.tofile(path)


def make_dataset(d: str, rng) -> dict:
    from strainer2_tpu_torch.tools.bench_kernels import sample_reads

    t0 = time.perf_counter()
    genome = rng.integers(0, 4, size=STRAIN_BP, dtype=np.uint8)
    write_fasta(os.path.join(d, "strain.fna"), np.array_split(genome, STRAIN_CONTIGS), "strain")
    windows = {"panel": 0, "targets": 0}
    genomes = []
    for g in range(N_GENOMES):
        seq = rng.integers(0, 4, size=GENOME_BP, dtype=np.uint8)
        # ~30% of each background genome shares 10 kbp blocks with the strain
        for s in rng.choice(GENOME_BP // 10_000, size=GENOME_BP // 10_000 * 3 // 10, replace=False):
            src = int(rng.integers(0, STRAIN_BP - 10_000))
            seq[s * 10_000 : (s + 1) * 10_000] = genome[src : src + 10_000]
        p = os.path.join(d, f"genome{g}.fna")
        write_fasta(p, [seq], f"genome{g}")
        genomes.append(p)
        windows["panel"] += GENOME_BP - K + 1
    metas = []
    for m in range(N_METAGENOMES):
        p = os.path.join(d, f"meta{m}.fasta")
        write_reads(p, sample_reads(rng, genome, METAGENOME_READS, STRAIN_READ_FRACTION), 0.001, rng)
        metas.append(p)
        windows["panel"] += METAGENOME_READS * (READ_LEN - K + 1)
    write_reads(os.path.join(d, "target_SE.fasta"),
                sample_reads(rng, genome, TARGET_SE_READS, STRAIN_READ_FRACTION), 0.001, rng)
    mate1 = sample_reads(rng, genome, TARGET_PE_PAIRS, STRAIN_READ_FRACTION)
    # mate 2 is random sequence: a pair passes on its first mate's hits
    write_reads(os.path.join(d, "target_PE1.fasta"), mate1, 0.001, rng)
    write_reads(os.path.join(d, "target_PE2.fasta"),
                rng.integers(0, 4, size=mate1.shape, dtype=np.uint8), 0.001, rng)
    windows["targets"] = (TARGET_SE_READS + 2 * TARGET_PE_PAIRS) * (READ_LEN - K + 1)
    for name, paths in (("genomes.txt", genomes), ("metagenomes.txt", metas)):
        with open(os.path.join(d, name), "w") as f:
            f.write("".join(p + "\n" for p in paths))
    with open(os.path.join(d, "targets.txt"), "w") as f:
        f.write(f"SE\t{d}/target_SE.fasta\n")
        f.write(f"PE\t{d}/target_PE1.fasta\t{d}/target_PE2.fasta\n")
    print(f"data: strain {STRAIN_BP} bp in {STRAIN_CONTIGS} contigs; -A {N_GENOMES} x "
          f"{GENOME_BP} bp; -B {N_METAGENOMES} x {METAGENOME_READS} reads; targets SE "
          f"{TARGET_SE_READS} reads + PE {TARGET_PE_PAIRS} pairs of {READ_LEN} bp, "
          f"{STRAIN_READ_FRACTION:.0%} strain reads; made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"cuts (depth only): -B {N_METAGENOMES} metagenomes of {METAGENOME_READS} reads "
          f"where the README configuration has 50 of tens of millions; targets "
          f"{TARGET_SE_READS} SE reads and {TARGET_PE_PAIRS} PE pairs", flush=True)
    return {"genome": genome, "genomes": genomes, "metas": metas, "windows": windows}


# ---- phase 2: kernels vs plain versions --------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn(i), i cycling over the N_BATCHES inputs."""
    import torch

    fn(0)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i % N_BATCHES)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    import torch

    err = 0
    for x, y in zip(a, b):
        x64 = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF if x.dtype == torch.uint32 else x.to(torch.int64)
        y64 = y.view(torch.int32).to(torch.int64) & 0xFFFFFFFF if y.dtype == torch.uint32 else y.to(torch.int64)
        if x64.shape != y64.shape:
            fail(f"shape {tuple(x64.shape)} != {tuple(y64.shape)}")
        if x64.numel():
            err = max(err, int((x64 - y64).abs().max()))
    return err


def timed(name: str, kern, plain, bound: float, note: str = "") -> dict:
    """Device-only (graph replay) and loop times of kern, loop time of plain,
    printed beside the bound; the kernel's results entry."""
    from strainer2_tpu_torch.tools.bench_kernels import graph_ms

    ms = graph_ms(kern, N_BATCHES)
    loop_ms, plain_ms = cuda_ms(kern, 5 * N_BATCHES), cuda_ms(plain, N_BATCHES)
    print(f"time {name}: device {ms:.4f} ms (graph replay), loop {loop_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.3f} of it){note}", flush=True)
    return {"ms": ms, "loop_ms": loop_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def checked(name: str, kern, plain) -> int:
    """max_abs_err of kern against plain over the N_BATCHES inputs; fails
    on any."""
    import torch

    err = 0
    for i in range(N_BATCHES):
        out, ref = kern(i), plain(i)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(out, ref))
    print(f"check {name}: max_abs_err {err} over {N_BATCHES} batches", flush=True)
    if err != 0:
        fail(f"{name} disagrees with its plain version (max_abs_err {err})")
    return err


def check_kernels(d: str, data: dict, rng, dev, seed: int) -> dict:
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops.packing import canonical_windows, canonical_windows_plain
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.tools.bench_kernels import (
        BATCH_KINDS, MAIN_QUERIES, batch_stats, bound_ms, count_batches, detection_batches,
        k1_bytes, k2_bytes, k3_bytes, k4_bytes, main_path_queries,
    )

    genome = data["genome"]
    engine = TorchKmerEngine(K, device=dev)
    index = StrainIndex.from_fasta(os.path.join(d, "strain.fna"), engine)
    t = index.table
    kinds = np.where(rng.random(index.num_kmers) < 0.05, 2, 1).astype(np.uint32)
    rows = engine.to_device(t.with_meta(index.slot_values(kinds)))
    print(f"table: {index.num_kmers} keys, h_bits {t.h_bits}, rows {tuple(rows.shape)} "
          f"({rows.numel() * 4 / 2**20:.0f} MiB), counts {t.num_slots * 4 / 2**20:.0f} MiB",
          flush=True)

    # N_BATCHES distinct inputs, rotated through while timing, so the probes
    # touch 8x more table rows than the 50 MB L2 holds, as a stream of new
    # batches does; every kernel is checked on every input
    # counting batches: every other row from the strain genome, ~3% invalid
    count_in = [(b, *canonical_windows(b, K)[:2]) for b in count_batches(rng, genome, dev)]
    # detection batches: "phase2" as this check has made them (3% N), "targets" made
    # like the phase-4 targets (0.1% N)
    detect = {kind: detection_batches(rng, genome, kind, dev) for kind in BATCH_KINDS}
    counts = engine.init_counts(index)
    counts_plain = engine.init_counts(index)
    h, salt = t.h_bits, t.salt
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    c_stats = [batch_stats(rows, h, salt, b) for b, _, _ in count_in]
    c_valid, c_found, c_hits = (mean(x) for x in zip(*c_stats))
    n_win = count_in[0][1].numel()
    n_ring = n_win // RING_CHUNK * RING_CHUNK
    ring_q = [(x[1].reshape(-1)[:n_ring], x[2].reshape(-1)[:n_ring]) for x in count_in]
    print(f"count batches: {c_valid:.0f} valid windows, {c_hits:.0f} hits of {n_win} windows a "
          f"batch (means over {N_BATCHES})", flush=True)

    cases = {
        "canonical_windows": (
            lambda i: canonical_windows(count_in[i][0], K),
            lambda i: canonical_windows_plain(count_in[i][0], K),
            k1_bytes(count_in[0][0])),
        "bucket_lookup": (
            lambda i: L.bucket_lookup(rows, h, salt, count_in[i][1], count_in[i][2]),
            lambda i: L.bucket_lookup_plain(rows, h, salt, count_in[i][1], count_in[i][2]),
            k2_bytes(n_win, c_found)),
        # both count buffers start at zero and take the same batches in turn
        "count_step": (
            lambda i: (L.count_step(counts, rows, count_in[i][0], h, salt, K),),
            lambda i: (L.count_step_plain(counts_plain, rows, count_in[i][0], h, salt, K),),
            k3_bytes(count_in[0][0], c_valid, c_hits)),
        "bucket_lookup_ring": (
            lambda i: L.bucket_lookup_ring(rows, h, salt, *ring_q[i], chunk=RING_CHUNK),
            lambda i: L.bucket_lookup_plain(rows, h, salt, *ring_q[i]),
            k2_bytes(n_ring, c_found * n_ring / n_win)),
    }
    results = {}
    for name, (kern, plain, n_bytes) in cases.items():
        err = checked(name, kern, plain)
        results[name] = dict(timed(name, kern, plain, bound_ms(n_bytes)), max_abs_err=err)

    detect_stats = {kind: [mean(x) for x in zip(*(batch_stats(rows, h, salt, b) for b, _, _ in batches))]
                    for kind, batches in detect.items()}
    # K3 on target-like bases too (as the panel metagenomes are: 1% strain
    # reads, 0.1% N); both count buffers start at zero
    t_counts, t_counts_plain = engine.init_counts(index), engine.init_counts(index)
    targets = [b for b, _, _ in detect["targets"]]
    kern = lambda i: (L.count_step(t_counts, rows, targets[i], h, salt, K),)  # noqa: E731
    plain = lambda i: (L.count_step_plain(t_counts_plain, rows, targets[i], h, salt, K),)  # noqa: E731
    err = checked("count_step targets", kern, plain)
    d_valid, _, d_hits = detect_stats["targets"]
    results["count_step"]["targets"] = dict(
        timed("count_step targets", kern, plain, bound_ms(k3_bytes(targets[0], d_valid, d_hits)),
              f"; {d_valid:.0f} valid windows, {d_hits:.0f} hits a batch"),
        max_abs_err=err)
    results["count_step"]["max_abs_err"] = max(results["count_step"]["max_abs_err"], err)
    del t_counts, t_counts_plain
    # K1 on target-like bases; K2 on sets of present keys, as strain_detect
    # probes its -a file's k-mers (one launch a strain)
    kern = lambda i: canonical_windows(targets[i], K)  # noqa: E731
    plain = lambda i: canonical_windows_plain(targets[i], K)  # noqa: E731
    k1_err = checked("canonical_windows targets", kern, plain)
    results["canonical_windows"]["targets"] = dict(
        timed("canonical_windows targets", kern, plain, bound_ms(k1_bytes(targets[0]))),
        max_abs_err=k1_err)
    main_q = main_path_queries(np.random.default_rng([seed, 2]), index.codes, dev)
    kern = lambda i: L.bucket_lookup(rows, h, salt, *main_q[i])  # noqa: E731
    plain = lambda i: L.bucket_lookup_plain(rows, h, salt, *main_q[i])  # noqa: E731
    k2_err = checked("bucket_lookup main", kern, plain)
    if not all(bool(kern(i)[0].all()) for i in range(N_BATCHES)):
        fail("bucket_lookup main: a key of the table was not found")
    results["bucket_lookup"]["main"] = dict(
        timed("bucket_lookup main", kern, plain, bound_ms(k2_bytes(MAIN_QUERIES, MAIN_QUERIES)),
              f"; {MAIN_QUERIES} present keys a set"),
        max_abs_err=k2_err)
    for name, e in (("canonical_windows", k1_err), ("bucket_lookup", k2_err)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
    for kind, batches in detect.items():
        kern = lambda i: L.classify_step(rows, batches[i][0], batches[i][1], h, salt, K)  # noqa: E731
        plain = lambda i: L.classify_step_plain(rows, batches[i][0], batches[i][1], h, salt, K)  # noqa: E731
        err = checked(f"classify_step {kind}", kern, plain)
        d_valid, _, d_hits = detect_stats[kind]
        n_reads = mean([n for _, _, n in batches])
        note = (f"; {n_reads:.0f} reads, {d_valid:.0f} valid windows ({d_valid / n_win:.3f}), "
                f"{d_hits:.0f} hits a batch")
        res = dict(timed(f"classify_step {kind}", kern, plain,
                         bound_ms(k4_bytes(batches[0][0], batches[0][1], d_valid, d_hits)), note),
                   max_abs_err=err, valid_share=d_valid / n_win)
        if kind == "phase2":
            results["classify_step"] = res
        else:
            results["classify_step"][kind] = res
    return results, {"index": index, "detect": detect, "detect_stats": detect_stats, "rows": rows,
                     "count": [b for b, _, _ in count_in], "kinds": kinds,
                     "count_codes": [(qh, ql) for _, qh, ql in count_in], "main_q": main_q,
                     "count_stats": (c_valid, c_hits)}


def check_cuckoo_kernels(ctx: dict, dev) -> dict:
    """Phase 2, the cuckoo layout: K10 and the cuckoo K3 and K4 against their
    plain versions on phase 2's batches and query sets, over a cuckoo table
    of the phase-4 strain's keys and classes (the class a slot-indexed
    array); K10 on the ``count`` window codes and the ``main`` sets of
    present keys (all found)."""
    import torch

    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.tools.bench_kernels import (
        MAIN_QUERIES, bound_ms, k3_bytes, k4_bytes, k10_bytes,
    )

    index = ctx["index"]
    cidx = StrainIndex(k=K, codes=index.codes, genome_counts=index.genome_counts, layout_="cuckoo")
    ct = cidx.table
    table = torch.from_numpy(ct.table).to(dev)
    meta = torch.from_numpy(cidx.slot_values(ctx["kinds"])).to(dev)
    h, salt = ct.h_bits, ct.salt
    print(f"cuckoo table: {index.num_kmers} keys, 2 x 2^{h} slots ({table.numel() * 4 / 2**20:.0f} "
          f"MiB), salt {salt}", flush=True)
    codes, main_q, bases = ctx["count_codes"], ctx["main_q"], ctx["count"]
    targets = [b for b, _, _ in ctx["detect"]["targets"]]
    c_valid, c_hits = ctx["count_stats"]
    n_win = codes[0][0].numel()
    counts, counts_plain = (torch.zeros(ct.num_slots, dtype=torch.uint32, device=dev) for _ in range(2))
    t_counts, t_counts_plain = (torch.zeros(ct.num_slots, dtype=torch.uint32, device=dev)
                                for _ in range(2))
    d_valid, _, d_hits = ctx["detect_stats"]["targets"]
    # name: {label: (kernel, plain, bytes)}; the first label is the headline
    cases = {
        "cuckoo_lookup": {
            "count": (lambda i: L.cuckoo_lookup(table, h, salt, *codes[i]),
                      lambda i: L.cuckoo_lookup_plain(table, h, salt, *codes[i]), k10_bytes(n_win)),
            "main": (lambda i: L.cuckoo_lookup(table, h, salt, *main_q[i]),
                     lambda i: L.cuckoo_lookup_plain(table, h, salt, *main_q[i]),
                     k10_bytes(MAIN_QUERIES))},
        # each pair of count buffers starts at zero and takes the same batches in turn
        "cuckoo_count_step": {
            "count": (lambda i: (L.cuckoo_count_step(counts, table, bases[i], h, salt, K),),
                      lambda i: (L.cuckoo_count_step_plain(counts_plain, table, bases[i], h, salt, K),),
                      k3_bytes(bases[0], c_valid, c_hits, "cuckoo")),
            "targets": (lambda i: (L.cuckoo_count_step(t_counts, table, targets[i], h, salt, K),),
                        lambda i: (L.cuckoo_count_step_plain(t_counts_plain, table, targets[i], h,
                                                             salt, K),),
                        k3_bytes(targets[0], d_valid, d_hits, "cuckoo"))},
        "cuckoo_classify_step": {
            kind: (lambda i, bs=bs: L.cuckoo_classify_step(table, meta, bs[i][0], bs[i][1], h, salt, K),
                   lambda i, bs=bs: L.cuckoo_classify_step_plain(table, meta, bs[i][0], bs[i][1], h,
                                                                 salt, K),
                   k4_bytes(bs[0][0], bs[0][1], *ctx["detect_stats"][kind][::2], "cuckoo"))
            for kind, bs in ctx["detect"].items()},
    }
    out = {}
    for name, by_label in cases.items():
        for label, (kern, plain, n_bytes) in by_label.items():
            err = checked(f"{name} {label}", kern, plain)
            res = dict(timed(f"{name} {label}", kern, plain, bound_ms(n_bytes)), max_abs_err=err)
            if name not in out:
                out[name] = res
            else:
                out[name][label] = res
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    if not all(bool(L.cuckoo_lookup(table, h, salt, *main_q[i])[0].all()) for i in range(N_BATCHES)):
        fail("cuckoo_lookup main: a key of the table was not found")
    if not int(counts.view(torch.int32).ne(0).sum()) or not int(t_counts.view(torch.int32).ne(0).sum()):
        fail("cuckoo_count_step: no hit counted")
    return out


def check_compare_kernels(d: str, ctx: dict, dev) -> dict:
    """Phase 2: K8, K9 and K3 with its valid count, and their cuckoo
    instances over a cuckoo table of the same keys, against their plain
    versions on phase 2's counting and target-like batches, on the
    phase-4 strain's index at k = 20 and 31; K9 at every ``remaining``
    edge of each batch. K3 with its valid count is checked on its counts
    and its tally's total (kernel against plain, after each batch), timed
    per batch without the total; the total (``valid_tally_total``) is
    checked and timed on its own, beside one torch.sum of the tally.
    Then every cuckoo kernel at k = 32 on counting batches with a poly-T
    run, whose windows are the empty-slot sentinel."""
    import torch

    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.tools.bench_kernels import (
        COMPARE_KS, batch_stats, bound_ms, graph_ms, k3v_bytes, k8_bytes, k9_bytes, tally_bytes,
    )

    kinds = {"count": ctx["count"], "targets": [b for b, _, _ in ctx["detect"]["targets"]]}
    out = {name: {} for name in ("hit_accumulate", "hit_stats", "count_valid_step",
                                 "valid_tally_total", "cuckoo_hit_accumulate", "cuckoo_hit_stats",
                                 "cuckoo_count_valid_step")}
    for k in COMPARE_KS:
        if k == K:
            index = ctx["index"]
        else:
            index = StrainIndex.from_fasta(os.path.join(d, "strain.fna"), TorchKmerEngine(k, device=dev))
        t = index.table
        h, salt = t.h_bits, t.salt
        rows = torch.from_numpy(t.table).to(dev)
        cuckoo, cuckoo_table = cuckoo_hit_cases(index, dev)
        k9_tables = {"hit_stats": (rows, h, salt), "cuckoo_hit_stats": cuckoo_table}
        for kind, bs in kinds.items():
            per = [batch_stats(rows, h, salt, b, k) for b in bs]
            valid, _, hits = (sum(x) / N_BATCHES for x in zip(*per))
            label = f"{kind} k={k}"
            note = f"; {valid:.0f} valid windows, {hits:.0f} hits a batch"
            acc, acc_plain = (torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(2))
            counts, counts_plain = (torch.zeros(t.num_slots, dtype=torch.uint32, device=dev)
                                    for _ in range(2))
            tally, tally_plain = (torch.zeros(L.n_tiles(ROWS, ROW_LEN, k), dtype=torch.int64,
                                              device=dev) for _ in range(2))
            k3v = lambda i: L.count_valid_step(counts, tally, rows, bs[i], h, salt, k)  # noqa: E731
            k3v_plain = lambda i: L.count_valid_step_plain(  # noqa: E731
                counts_plain, tally_plain, rows, bs[i], h, salt, k)
            # name: (checked kernel, checked plain, bytes[, timed kernel, timed plain])
            cases = {
                "hit_accumulate": (
                    lambda i: (L.hit_accumulate(acc, rows, bs[i], h, salt, k),),
                    lambda i: (L.hit_accumulate_plain(acc_plain, rows, bs[i], h, salt, k),),
                    k8_bytes(bs[0], valid, hits)),
                "count_valid_step": (
                    lambda i: (k3v(i), L.valid_tally_total(tally)),
                    lambda i: (k3v_plain(i), L.valid_tally_total_plain(tally_plain)),
                    k3v_bytes(bs[0], valid, hits),
                    lambda i: (k3v(i),),
                    lambda i: (k3v_plain(i),)),
                "hit_stats": (
                    lambda i: (L.hit_stats(rows, bs[i], per[i][0] // 2, h, salt, k),),
                    lambda i: (L.hit_stats_plain(rows, bs[i], per[i][0] // 2, h, salt, k),),
                    k9_bytes(bs[0], valid, hits)),
            }
            cases.update(cuckoo(bs, per, k, valid, hits))
            for name, (kern, plain, n_bytes, *timed_fns) in cases.items():
                err = checked(f"{name} {label}", kern, plain)
                if name in k9_tables:
                    err = max(err, check_remaining_edges(name, k9_tables[name], bs, per, k, label))
                out[name][label] = dict(timed(f"{name} {label}", *(timed_fns or (kern, plain)),
                                              bound_ms(n_bytes), note), max_abs_err=err)
            if int(acc[0]) <= 0 or not int(counts.view(torch.int32).ne(0).sum()):
                fail(f"hit_accumulate / count_valid_step {label}: no hit counted")
            # the kernel's tally after the timed stream, every slot in use
            kern = lambda i: (L.valid_tally_total(tally),)  # noqa: E731
            plain = lambda i: (L.valid_tally_total_plain(tally),)  # noqa: E731
            err = checked(f"valid_tally_total {label}", kern, plain)
            library_ms = graph_ms(lambda i: tally.sum(), N_BATCHES)
            out["valid_tally_total"][label] = dict(
                timed(f"valid_tally_total {label}", kern, plain, bound_ms(tally_bytes(tally)),
                      f"; {tally.numel()} slots; torch.sum {library_ms:.4f} ms"),
                max_abs_err=err, library_ms=library_ms)
            if k == COMPARE_K and kind == "targets":
                device_work(lambda: (L.hit_stats(rows, bs[0], per[0][0] // 2, h, salt, k), k3v(0)))
            del counts, counts_plain, tally, tally_plain
        del rows, index, cuckoo, cuckoo_table, k9_tables
        torch.cuda.empty_cache()
    check_poly_t(d, ctx, dev)
    return out


def cuckoo_hit_cases(index, dev):
    """The cuckoo K8, K9 and K3 with its valid count over a cuckoo table of
    ``index``'s keys: a function of (batches, their batch_stats, k, valid,
    hits) that gives check_compare_kernels' cases, and the table as
    (slots, h_bits, salt)."""
    import torch

    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.tools.bench_kernels import k3v_bytes, k8_bytes, k9_bytes

    ct = StrainIndex(k=index.k, codes=index.codes, genome_counts=index.genome_counts,
                     layout_="cuckoo").table
    table = torch.from_numpy(ct.table).to(dev)
    h, salt = ct.h_bits, ct.salt

    def cases(bs, per, k, valid, hits):
        acc, acc_plain = (torch.zeros(2, dtype=torch.int64, device=dev) for _ in range(2))
        counts, counts_plain = (torch.zeros(ct.num_slots, dtype=torch.uint32, device=dev)
                                for _ in range(2))
        tally, tally_plain = (torch.zeros(L.n_tiles(ROWS, ROW_LEN, k), dtype=torch.int64,
                                          device=dev) for _ in range(2))
        k3v = lambda i: L.cuckoo_count_valid_step(counts, tally, table, bs[i], h, salt, k)  # noqa: E731
        k3v_plain = lambda i: L.cuckoo_count_valid_step_plain(  # noqa: E731
            counts_plain, tally_plain, table, bs[i], h, salt, k)
        half = [p[0] // 2 for p in per]
        return {
            "cuckoo_hit_accumulate": (
                lambda i: (L.cuckoo_hit_accumulate(acc, table, bs[i], h, salt, k),),
                lambda i: (L.cuckoo_hit_accumulate_plain(acc_plain, table, bs[i], h, salt, k),),
                k8_bytes(bs[0], valid, hits, "cuckoo")),
            "cuckoo_count_valid_step": (
                lambda i: (k3v(i), L.valid_tally_total(tally)),
                lambda i: (k3v_plain(i), L.valid_tally_total_plain(tally_plain)),
                k3v_bytes(bs[0], valid, hits, "cuckoo"),
                lambda i: (k3v(i),),
                lambda i: (k3v_plain(i),)),
            "cuckoo_hit_stats": (
                lambda i: (L.cuckoo_hit_stats(table, bs[i], half[i], h, salt, k),),
                lambda i: (L.cuckoo_hit_stats_plain(table, bs[i], half[i], h, salt, k),),
                k9_bytes(bs[0], valid, hits, "cuckoo")),
        }

    return cases, (table, h, salt)


def check_poly_t(d: str, ctx: dict, dev) -> None:
    """Every cuckoo kernel at k = 32 against its plain version on phase 2's
    counting batches with a run of 300 T in every fourth row: those
    windows code as the empty-slot sentinel (0xFFFFFFFF in both halves)
    and are found at an empty slot, in both packages."""
    import torch

    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops.packing import canonical_windows_plain
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    ct = StrainIndex.from_fasta(os.path.join(d, "strain.fna"),
                                TorchKmerEngine(32, device=dev, layout="cuckoo")).table
    table = torch.from_numpy(ct.table).to(dev)
    h, salt, k = ct.h_bits, ct.salt, 32
    bs = []
    for b in ctx["count"]:
        b = b.clone()
        b[::4, 1000:1300] = 3
        bs.append(b)
    meta = torch.from_numpy((np.arange(ct.num_slots) % 3 == 0).astype(np.uint32) + 1).to(dev)
    bounds = torch.arange(0, ROWS * (ROW_LEN - k + 1) + 1, 997, dtype=torch.int32, device=dev)
    z = lambda dt, n: torch.zeros(n, dtype=dt, device=dev)  # noqa: E731
    n_tally = L.n_tiles(ROWS, ROW_LEN, k)
    pairs = {
        "cuckoo_lookup": lambda f, i: f(table, h, salt, *canonical_windows_plain(bs[i], k)[:2]),
        "cuckoo_count_step": lambda f, i: (f(z(torch.uint32, ct.num_slots), table, bs[i], h, salt, k),),
        "cuckoo_count_valid_step": lambda f, i: (f(z(torch.uint32, ct.num_slots),
                                                   z(torch.int64, n_tally), table, bs[i], h, salt, k),),
        "cuckoo_classify_step": lambda f, i: f(table, meta, bs[i], bounds, h, salt, k),
        "cuckoo_hit_accumulate": lambda f, i: (f(z(torch.int64, 2), table, bs[i], h, salt, k),),
        "cuckoo_hit_stats": lambda f, i: (f(table, bs[i], 77, h, salt, k),),
    }
    for name, call in pairs.items():
        kern, plain = getattr(L, name), getattr(L, name + "_plain")
        checked(f"{name} k=32 poly-T", lambda i: call(kern, i), lambda i: call(plain, i))
    sentinel = L.cuckoo_lookup_plain(table, h, salt, torch.full((1,), -1, dtype=torch.int32,
                                                                device=dev).view(torch.uint32),
                                     torch.full((1,), -1, dtype=torch.int32, device=dev).view(torch.uint32))
    print(f"poly-T at k = 32: the sentinel window found {bool(sentinel[0])} (slot {int(sentinel[1])})",
          flush=True)


DEVICE_WORK = ("hit_stats_kernel", "hit_crossing_kernel", "count_valid_step_kernel")


def device_work(fn) -> None:
    """Print the device kernels and memsets of one K9 call and one call of
    K3 with its valid count (fn makes both), as torch.profiler records
    them; fails unless they are K9's masks and crossing kernels and one
    K3 kernel, no memset. It is the smoke's first profiler session: a
    later one in the same process may record nothing, and then fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"device work of one hit_stats and one count_valid_step call: {len(names)} "
          f"{names if names else '(not traced)'}", flush=True)
    short = sorted(n.split("::")[-1].split("(")[0] for n in names)
    if short != sorted(DEVICE_WORK):
        fail(f"hit_stats and count_valid_step ran {short}, not {sorted(DEVICE_WORK)}")


def check_remaining_edges(name, table, bs, per, k, label) -> int:
    """K9 (``name`` hit_stats or cuckoo_hit_stats, on ``table`` = (rows or
    slots, h_bits, salt)) against its plain version with remaining at 0, 1,
    each batch's valid total and one past it; fails on any difference."""
    from strainer2_tpu_torch.ops import lookup as L

    kern, plain = getattr(L, name), getattr(L, name + "_plain")
    t, h, salt = table
    err = 0
    for i, b in enumerate(bs):
        total = per[i][0]
        for rem in (0, 1, total, total + 1):
            got = kern(t, b, rem, h, salt, k)
            err = max(err, max_abs_err((got,), (plain(t, b, rem, h, salt, k),)))
            if rem == total + 1 and got.tolist()[2:] != [0, -1]:
                fail(f"{name} {label}: a crossing past the batch was found")
    print(f"check {name} {label} remaining 0, 1, total, total + 1: max_abs_err {err}", flush=True)
    if err:
        fail(f"{name} {label} disagrees with its plain version at a remaining edge")
    return err


def lookup_ab() -> dict:
    """Phase 2b, path (a): the lookup A/B tool at each row width, with the
    launch counts of this run; every variant must equal K2 and the plain
    lookup exactly on every slice."""
    from strainer2_tpu_torch.ops import _build
    from strainer2_tpu_torch.tools.bench_lookup import bench

    _build.reset_launches()
    runs = {}
    for width in ROW_WIDTHS:
        log = io.StringIO()
        runs[width] = bench(["--device", DEVICE, "--row-width", str(width),
                             "--queries", str(AB_QUERIES)], out=log)
        for line in log.getvalue().splitlines():
            print(f"bench_lookup {width} lanes: {line}", flush=True)
        if not runs[width]["ok"]:
            fail(f"bench_lookup at {width} lanes: a variant disagrees or a checksum is not linear")
    launches = dict(_build.launches)
    rings = [v for v in runs[ROW_WIDTHS[0]] if str(v).startswith("ring")]
    base = runs[ROW_WIDTHS[0]]
    return {
        "launches": launches,
        "max_abs_err": max(r[v]["err_plain"] for r in runs.values() for v in rings),
        "ms": base[RING_DEFAULT]["ms"],
        "plain_ms": base["plain"]["ms"],
        "k10_max_abs_err": max(max(r["k10"]["err_plain"], r["k10"]["err_k2"]) for r in runs.values()),
        "k10_ms": base["k10"]["ms"],
        "k2_ms": base["k2"]["ms"],
    }


def check_multi_kernels(ctx: dict) -> dict:
    """Phase 2b: K6 and K7 against their plain versions at S strains per
    pass, on phase 2's key set (rows widened on the device to
    32 + 16 max(2, ceil(S/16)) lanes of seeded meta words) and both kinds
    of its 256 x 4096 detection batches."""
    import torch

    from strainer2_tpu_torch.ops import segsum as G
    from strainer2_tpu_torch.tools.bench_kernels import bound_ms, k6_bytes, k7_bytes, multi_rows

    t = ctx["index"].table
    h, salt = t.h_bits, t.salt
    out = {"multi_hit_words": {}, "strain_sums": {}}
    for n_strains in S_SWEEP:
        n_words = G.words_for_strains(n_strains)
        rows = multi_rows(ctx["rows"], n_words, seed=n_strains)
        for kind, batches in ctx["detect"].items():
            valid, _, hits = ctx["detect_stats"][kind]
            words = [G.multi_hit_words(rows, b, h, salt, K, n_words) for b, _, _ in batches]
            cases = {
                "multi_hit_words": (
                    lambda i: (G.multi_hit_words(rows, batches[i][0], h, salt, K, n_words),),
                    lambda i: (G.multi_hit_words_plain(rows, batches[i][0], h, salt, K, n_words),),
                    k6_bytes(batches[0][0], valid, hits, n_words)),
                "strain_sums": (
                    lambda i: G.boundary_strain_sums(words[i], batches[i][1], n_strains),
                    lambda i: G.boundary_strain_sums_plain(words[i], batches[i][1], n_strains),
                    k7_bytes(words[0], batches[0][1], n_strains)),
            }
            for name, (kern, plain, n_bytes) in cases.items():
                label = f"{name} {kind} S={n_strains}"
                err = checked(label, kern, plain)
                if not int((kern(0)[0] != 0).sum()):
                    fail(f"{label}: all zero")
                res = dict(timed(label, kern, plain, bound_ms(n_bytes)), max_abs_err=err)
                out[name].setdefault(n_strains, {})[kind] = res
            del words
        del rows
        torch.cuda.empty_cache()
    return out


# ---- phases 3 and 4: the CLIs -------------------------------------------------

def run_cli(module: str, argv: list[str], stdout_path: str) -> float:
    """Run one port CLI in this process (so its kernel launches are
    counted), stdout to a file; returns its wall time in seconds."""
    import importlib

    import torch

    main = importlib.import_module(f"strainer2_tpu_torch.cli.{module}").main
    t0 = time.perf_counter()
    with open(stdout_path, "w") as f, contextlib.redirect_stdout(f):
        rc = main(argv + ["--device", DEVICE])
    torch.cuda.synchronize()
    if rc:
        fail(f"{module} {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def same_bytes(path: str, expected: str, gz: bool = False) -> bool:
    opener = gzip.open if gz else open
    with opener(path, "rb") as f, open(expected, "rb") as g:
        return f.read() == g.read()


def mini_goldens(repo: str, out: str) -> None:
    mini = os.path.join(repo, "tests", "golden", "mini")
    exp = os.path.join(mini, "expected")
    cwd = os.getcwd()
    os.chdir(mini)  # list files hold paths relative to it
    try:
        o = lambda name: os.path.join(out, name)  # noqa: E731
        run_cli("kmer_scrub_count", ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                                     "-B", "data/metagenomes.txt"], o("counts.tsv"))
        run_cli("kmer_scrub_filter", ["-s", "expected/scrub_counts.gz", "-m", "0.05"],
                o("scrubbed.txt"))
        run_cli("strain_detect", ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt",
                                  "-B", "data/targets.txt", "-o", o("hits.gz")],
                o("detect_stdout.txt"))
        run_cli("strain_detect", ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt",
                                  "-B", "data/targets.txt", "-g", "data/background.txt",
                                  "-o", o("hits_bg.gz")], o("detect_bg_stdout.txt"))
        with gzip.open(o("strainA_x.kmer_hits.gz"), "wb") as f, open(os.path.join(exp, "kmer_hits.txt"), "rb") as g:
            f.write(g.read())
        run_cli("coverage_depth", ["-k", o("strainA_x.kmer_hits.gz")], o("coverage.tsv"))
    finally:
        os.chdir(cwd)
    checks = [
        ("scrub_counts.tsv", same_bytes(o("counts.tsv"), os.path.join(exp, "scrub_counts.tsv"))),
        ("scrubbed_m05.txt", same_bytes(o("scrubbed.txt"), os.path.join(exp, "scrubbed_m05.txt"))),
        ("kmer_hits.txt", same_bytes(o("hits.gz"), os.path.join(exp, "kmer_hits.txt"), gz=True)),
        ("detect_stdout.txt", same_bytes(o("detect_stdout.txt"), os.path.join(exp, "detect_stdout.txt"))),
        ("kmer_hits_bg.txt", same_bytes(o("hits_bg.gz"), os.path.join(exp, "kmer_hits_bg.txt"), gz=True)),
        ("detect_bg_stdout.txt", same_bytes(o("detect_bg_stdout.txt"), os.path.join(exp, "detect_bg_stdout.txt"))),
        ("coverage_depth.tsv", same_bytes(o("coverage.tsv"), os.path.join(exp, "coverage_depth.tsv"))),
    ]
    checks += mini_fused(mini, o)
    checks += mini_compare(mini, o)
    checks += mini_modes(mini, o)
    cuckoo_checks, cuckoo_launches = mini_cuckoo(mini, o)
    checks += cuckoo_checks
    for name, ok in checks:
        print(f"mini golden {name}: {'identical' if ok else 'DIFFERS'}", flush=True)
    if not all(ok for _, ok in checks):
        fail("mini goldens differ")
    return cuckoo_launches


# the gc_* goldens at k <= 32 as run_genome_compare arguments: (call, config)
CUCKOO_GC = {
    "gc_single.txt": (dict(b_file="data/panel1.fna.gz", print_header=True), {}),
    "gc_list_s17.txt": (dict(b_list="data/compare_list.txt"), dict(k=17)),
    "gc_rapid.txt": (dict(b_list="data/compare_list.txt"),
                     dict(max_seeds=300, threshold_for_fullmap=0.5)),
    "gc_strainmode.txt": (dict(b_list="data/compare_list.txt"),
                          dict(max_seeds=100_000, threshold_for_fullmap=0.05)),
}


def mini_cuckoo(mini: str, o) -> tuple[list, dict]:
    """The mini goldens in the cuckoo layout, through the stage APIs (no
    CLI takes a layout): run_scrub_count, strain_detect (run_detect) and
    coverage_depth on its hits, genome_compare in the gc_* cases at k <=
    32, strain-track with its tracks.  Returns the checks and the kernel
    launches of this block, counted from 0 (strain-track's is the cuckoo
    K3 with its valid count's path)."""
    import shutil

    import torch

    from strainer2_tpu_torch.ops import _build
    from strainer2_tpu_torch.pipeline.compare import CompareConfig, run_genome_compare
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect
    from strainer2_tpu_torch.pipeline.multi import run_strain_track
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    exp = lambda name: os.path.join(mini, "expected", name)  # noqa: E731
    c = lambda name: o(os.path.join("cuckoo", name))  # noqa: E731
    os.makedirs(c("track"))
    for name in ("strainA.fna.gz", "drug1.fna.gz", "scrubmeta1.fasta.gz"):
        shutil.copy(os.path.join(mini, "data", name), c("track"))
    with open(c("track/strains2.txt"), "w") as f:
        f.write("strainA.fna.gz\ndrug1.fna.gz\n")
    cwd = os.getcwd()
    _build.reset_launches()
    try:
        os.chdir(mini)
        with open(c("counts.tsv"), "w") as f:
            run_scrub_count("data/strainA.fna.gz", "data/genomes.txt", "data/metagenomes.txt",
                            out=f, cfg=ScrubCountConfig(device=DEVICE, layout="cuckoo"))
        with open(c("detect_stdout.txt"), "w") as f:
            run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt",
                       c("strainA_x.kmer_hits.gz"), batch_list="data/targets.txt", stdout=f,
                       cfg=DetectConfig(device=DEVICE, layout="cuckoo"))
        run_cli("coverage_depth", ["-k", c("strainA_x.kmer_hits.gz")], c("coverage.tsv"))
        for golden, (call, cfg) in CUCKOO_GC.items():
            with open(c(golden), "w") as f:
                run_genome_compare("data/strainA.fna.gz", out=f, **call,
                                   cfg=CompareConfig(device=DEVICE, layout="cuckoo", **cfg))
        os.chdir(c("track"))
        with open("st.txt", "w") as f:
            run_strain_track("strains2.txt", "scrubmeta1.fasta.gz", out=f, device=DEVICE,
                             layout="cuckoo")
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    launches = dict(_build.launches)
    track = "fna.gz_scrubmeta1.fasta.gz.strain_track"
    checks = [
        ("cuckoo scrub_counts.tsv", same_bytes(c("counts.tsv"), exp("scrub_counts.tsv"))),
        ("cuckoo kmer_hits.txt", same_bytes(c("strainA_x.kmer_hits.gz"), exp("kmer_hits.txt"),
                                            gz=True)),
        ("cuckoo detect_stdout.txt", same_bytes(c("detect_stdout.txt"), exp("detect_stdout.txt"))),
        ("cuckoo coverage_depth.tsv", same_bytes(c("coverage.tsv"), exp("coverage_depth.tsv"))),
        *((f"cuckoo {g}", same_bytes(c(g), exp(g))) for g in CUCKOO_GC),
        ("cuckoo strain-track stdout", same_bytes(c("track/st.txt"),
                                                  exp("modes/strain_track_stdout.txt"))),
        *((f"cuckoo strain-track {s}.{track}", same_bytes(c(f"track/{s}.{track}"),
                                                          exp(f"modes/{s}.{track}")))
          for s in ("strainA", "drug1")),
    ]
    print(f"launches during the cuckoo mini runs (phase 3): {launches}", flush=True)
    return checks, launches


# tools/make_mini_fixtures.py's genome_compare runs
GC_GOLDENS = {
    "gc_single.txt": ["-b", "data/panel1.fna.gz", "-H"],
    "gc_list_s17.txt": ["-B", "data/compare_list.txt", "-s", "17"],
    "gc_rapid.txt": ["-B", "data/compare_list.txt", "-r", "300", "-t", "0.5"],
    "gc_strainmode.txt": ["-B", "data/compare_list.txt", "-S"],
    "gc_s40.txt": ["-B", "data/compare_list.txt", "-s", "40"],
    "gc_s40_rapid.txt": ["-B", "data/compare_list.txt", "-s", "40", "-r", "200", "-t", "0.3"],
}


def mini_compare(mini: str, o) -> list:
    """The six gc_* goldens through genome_compare (K8 and K9 at k <= 32,
    the string engine at k = 40)."""
    cwd = os.getcwd()
    os.chdir(mini)
    try:
        for golden, argv in GC_GOLDENS.items():
            run_cli("genome_compare", ["-a", "data/strainA.fna.gz", *argv], o(golden))
    finally:
        os.chdir(cwd)
    return [(golden, same_bytes(o(golden), os.path.join(mini, "expected", golden)))
            for golden in GC_GOLDENS]


def mini_modes(mini: str, o) -> list:
    """The modes/ goldens through strainer2_tools pangenome, kmer-matrix and
    strain-track, on a copy of the mini data (the modes write their tracks
    beside their inputs), with the paths the goldens were made with."""
    import shutil

    exp = lambda name: os.path.join(mini, "expected", "modes", name)  # noqa: E731
    cwd = os.getcwd()
    work = o("modes")
    shutil.copytree(os.path.join(mini, "data"), os.path.join(work, "data"))
    track = o("modes_track")
    os.makedirs(track)
    for name in ("strainA.fna.gz", "drug1.fna.gz", "scrubmeta1.fasta.gz"):
        shutil.copy(os.path.join(mini, "data", name), track)
    with open(os.path.join(track, "strains2.txt"), "w") as f:
        f.write("strainA.fna.gz\ndrug1.fna.gz\n")
    checks = []
    try:
        os.chdir(work)
        w = lambda name: os.path.join(work, name)  # noqa: E731
        run_cli("strainer2_tools", ["pangenome", "-A", "data/pangenomes.txt", "-r", "data/strainA.fna.gz"],
                w("pg_ref.txt"))
        checks += [("pangenome -r stdout", same_bytes(w("pg_ref.txt"), exp("pangenome_ref_stdout.txt"))),
                   ("pangenome -r track", same_bytes(w("data/strainA.fna.gz_.pangenome"),
                                                     exp("strainA.pangenome")))]
        run_cli("strainer2_tools", ["pangenome", "-A", "data/pangenomes.txt", "-d"], w("pg_all.txt"))
        checks.append(("pangenome -d stdout", same_bytes(w("pg_all.txt"), exp("pangenome_all_stdout.txt"))))
        for name in ("panel1.fna.gz", "panel2.fna", "strainA.fna.gz"):
            checks.append((f"pangenome {name}", same_bytes(w(f"data/{name}_.pangenome"),
                                                           exp(f"{name}_.pangenome"))))
        checks.append(("pangenome dist", same_bytes(w("data/pangenomes.txt_.pangenome_dist"),
                                                    exp("pangenomes.pangenome_dist"))))
        run_cli("strainer2_tools", ["kmer-matrix", "-A", "data/pangenomes.txt"], w("matrix.tsv"))
        checks.append(("kmer-matrix", same_bytes(w("matrix.tsv"), exp("kmer_matrix.tsv"))))
        os.chdir(track)
        t = lambda name: os.path.join(track, name)  # noqa: E731
        run_cli("strainer2_tools", ["strain-track", "-A", "strains2.txt", "-b", "scrubmeta1.fasta.gz"],
                t("st.txt"))
        checks.append(("strain-track stdout", same_bytes(t("st.txt"), exp("strain_track_stdout.txt"))))
        for name in ("strainA.fna.gz_scrubmeta1.fasta.gz.strain_track",
                     "drug1.fna.gz_scrubmeta1.fasta.gz.strain_track"):
            checks.append((f"strain-track {name}", same_bytes(t(name), exp(name))))
        run_cli("strainer2_tools", ["strain-track", "-A", "strains2.txt", "-b", "scrubmeta1.fasta.gz",
                                    "-n", "-m", "60"], t("st_m.txt"))
        checks.append(("strain-track -n -m 60", same_bytes(t("st_m.txt"), exp("strain_track_m100_stdout.txt"))))
    finally:
        os.chdir(cwd)
    return checks


def same_payloads(a: str, b: str) -> bool:
    """Equal decompressed payloads of two gzip files."""
    with gzip.open(a, "rb") as f, gzip.open(b, "rb") as g:
        return f.read() == g.read()


def mini_fused(mini: str, o) -> list:
    """The fused pipeline on the mini data to the goldens, and
    pipeline-multi on strainA and drug1 against the staged CLIs run strain
    by strain; coverage files against coverage_depth on their own hits."""
    exp = lambda name: os.path.join(mini, "expected", name)  # noqa: E731
    cwd = os.getcwd()
    os.chdir(mini)
    checks = []
    try:
        run_cli("strainer2_tools", ["pipeline", "-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                                    "-B", "data/metagenomes.txt", "-T", "data/targets.txt",
                                    "-m", "0.05", "-o", o("fused")], o("fused_stdout.txt"))
        f = lambda name: o(os.path.join("fused", "strainA" + name))  # noqa: E731
        run_cli("coverage_depth", ["-k", f(".kmer_hits.gz")], o("fused_coverage.tsv"))
        checks += [
            ("pipeline counts", same_bytes(f(".scrub_kmer_counts.gz"), exp("scrub_counts.tsv"), gz=True)),
            ("pipeline scrubbed", same_bytes(f(".scrubbed_kmers.gz"), exp("scrubbed_m05.txt"), gz=True)),
            ("pipeline hits", same_bytes(f(".kmer_hits.gz"), exp("kmer_hits.txt"), gz=True)),
            ("pipeline stdout", same_bytes(o("fused_stdout.txt"), exp("detect_stdout.txt"))),
            ("pipeline coverage", same_bytes(f(".coverage_depth"), o("fused_coverage.tsv"))),
        ]
        strains = ["data/strainA.fna.gz", "data/drug1.fna.gz"]
        with open(o("strains.txt"), "w") as fh:
            fh.write("".join(r + "\n" for r in strains))
        run_cli("strainer2_tools", ["pipeline-multi", "-R", o("strains.txt"), "-A", "data/genomes.txt",
                                    "-B", "data/metagenomes.txt", "-T", "data/targets.txt",
                                    "-m", "0.05", "-o", o("fusedm")], o("fusedm_stdout.txt"))
        for r in strains:
            stem = os.path.basename(r)[: -len(".fna.gz")]
            s = lambda name: o(f"staged_{stem}{name}")  # noqa: E731
            m = lambda name: o(os.path.join("fusedm", stem + name))  # noqa: E731
            run_cli("kmer_scrub_count", ["-r", r, "-A", "data/genomes.txt", "-B", "data/metagenomes.txt"],
                    s(".counts.tsv"))
            run_cli("kmer_scrub_filter", ["-s", s(".counts.tsv"), "-m", "0.05"], s(".scrubbed.txt"))
            run_cli("strain_detect", ["-r", r, "-a", s(".scrubbed.txt"), "-B", "data/targets.txt",
                                      "-o", s(".hits.gz")], s(".detect_stdout.txt"))
            run_cli("coverage_depth", ["-k", m(".kmer_hits.gz")], s(".coverage.tsv"))
            checks += [
                (f"pipeline-multi {stem} counts", same_bytes(m(".scrub_kmer_counts.gz"), s(".counts.tsv"), gz=True)),
                (f"pipeline-multi {stem} scrubbed", same_bytes(m(".scrubbed_kmers.gz"), s(".scrubbed.txt"), gz=True)),
                (f"pipeline-multi {stem} hits", same_payloads(m(".kmer_hits.gz"), s(".hits.gz"))),
                (f"pipeline-multi {stem} coverage", same_bytes(m(".coverage_depth"), s(".coverage.tsv"))),
            ]
    finally:
        os.chdir(cwd)
    return checks


def real_size(d: str, data: dict) -> dict:
    p = lambda name: os.path.join(d, name)  # noqa: E731
    walls = {}
    walls["kmer_scrub_count"] = run_cli(
        "kmer_scrub_count", ["-r", p("strain.fna"), "-A", p("genomes.txt"), "-B", p("metagenomes.txt")],
        p("counts.tsv"))
    walls["kmer_scrub_filter"] = run_cli(
        "kmer_scrub_filter", ["-s", p("counts.tsv"), "-m", str(MIN_FRACTION)], p("informative.txt"))
    walls["strain_detect"] = run_cli(
        "strain_detect", ["-r", p("strain.fna"), "-a", p("informative.txt"), "-B", p("targets.txt"),
                          "-o", p("hits.gz")], p("detect_stdout.txt"))
    walls["coverage_depth"] = run_cli("coverage_depth", ["-k", p("hits.gz")], p("coverage.tsv"))
    rates = {
        "kmer_scrub_count": data["windows"]["panel"],
        "strain_detect": data["windows"]["targets"],
    }
    for stage, wall in walls.items():
        extra = f", {rates[stage] / wall:,.0f} windows/s ({rates[stage]} windows)" if stage in rates else ""
        print(f"stage {stage}: wall {wall:.3f} s{extra}", flush=True)
    return walls


def check_real_outputs(d: str, data: dict, genome: str, counts: str, informative: str,
                       hits: str, label: str = "real-size"):
    """Panel counts (the table at ``counts``) vs the C++ NativePanelCounter
    and the detection rows of ``hits`` vs the C++ NativeClassifier's
    prediction from the scrubbed k-mers of ``informative``, on the index
    of ``genome``; returns that index."""
    from concurrent.futures import ThreadPoolExecutor

    from strainer2_tpu_torch import native
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.index.refhash_order import reference_row_order
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    p = lambda name: os.path.join(d, name)  # noqa: E731
    index = StrainIndex.from_fasta(genome, TorchKmerEngine(K, device=DEVICE))
    order = reference_row_order(index.codes, K)
    parsed = native.parse_scrub_table_native(counts)
    if parsed is None:
        fail("native library unavailable: cannot parse the count table for the check")
    _, _, c_ref, c_pan, c_meta, _, _ = parsed
    if c_ref.shape[0] != index.num_kmers:
        fail(f"count table has {c_ref.shape[0]} rows, index {index.num_kmers} k-mers")

    counter = native.NativePanelCounter(index.codes, index.table.slot_of_key, K)

    def count(path):
        buf = np.zeros(index.table.num_slots, dtype=np.uint32)
        counter.count_file(buf, path)
        return buf

    with ThreadPoolExecutor(8) as ex:
        pan = sum(ex.map(count, data["genomes"]))
        meta = sum(ex.map(count, data["metas"]))
    ok = {
        "reference_count": np.array_equal(c_ref, index.genome_counts[order].astype(np.int64)),
        "pangenome_count": np.array_equal(c_pan, index.key_values(pan)[order].astype(np.int64)),
        "metagenome_count": np.array_equal(c_meta, index.key_values(meta)[order].astype(np.int64)),
    }
    print(f"{label} panel counts vs NativePanelCounter: {ok}; "
          f"pangenome total {int(c_pan.sum())}, metagenome total {int(c_meta.sum())}", flush=True)
    if not all(ok.values()):
        fail("panel counts differ from NativePanelCounter")

    # detection: rows per sample = informative hits of the passing reads/pairs
    kinds = np.ones(index.num_kmers, dtype=np.int32)
    with (gzip.open if informative.endswith(".gz") else open)(informative, "rb") as f:
        lines = [ln.rstrip(b"\n") for ln in f if not ln.startswith(b"#")]
    mat = np.frombuffer(b"".join(lines), dtype=np.uint8).reshape(len(lines), K)
    two = np.searchsorted(_ACGT, mat).astype(np.uint64)
    weights = np.uint64(4) ** np.arange(K - 1, -1, -1, dtype=np.uint64)
    fwd = (two * weights).sum(axis=1, dtype=np.uint64)
    rc = ((np.uint64(3) - two)[:, ::-1] * weights).sum(axis=1, dtype=np.uint64)
    order_codes = np.argsort(index.codes)
    pos = order_codes[np.searchsorted(index.codes[order_codes], np.maximum(fwd, rc))]
    kinds[pos] = 2
    classifier = native.NativeClassifier(index.codes, kinds, K)
    rows_by_sample: dict[str, int] = {}
    with gzip.open(hits, "rt") as f:
        for line in f:
            if not line.startswith("#"):
                s = line.split("\t", 1)[0]
                rows_by_sample[s] = rows_by_sample.get(s, 0) + 1
    for f1, f2, mode in ((p("target_SE.fasta"), None, 0),
                         (p("target_PE1.fasta"), p("target_PE2.fasta"), 1)):
        expect = 0
        for lens, tot, inf in classifier.open_stream(f1, f2, mode):
            tot, inf = tot.astype(np.int64), inf.astype(np.int64)
            if mode:
                t, i = tot[0::2] + tot[1::2], inf[0::2] + inf[1::2]
            else:
                t, i = tot, inf
            expect += int(i[(t >= 1) & (i >= 1)].sum())
        got = rows_by_sample.get(f1, 0)
        print(f"{label} detection {os.path.basename(f1)}: {got} hit rows, "
              f"NativeClassifier expects {expect}", flush=True)
        if got != expect or got == 0:
            fail(f"{label} detection rows for {f1}: {got} != {expect}")
    return index


# ---- phase 6: detect-multi at real size ----------------------------------------

def canonical_codes_at(seq: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Canonical uint64 codes of the k-mers of ``seq`` (base codes) at ``starts``."""
    win = seq[starts[:, None] + np.arange(K)].astype(np.uint64)
    weights = np.uint64(4) ** np.arange(K - 1, -1, -1, dtype=np.uint64)
    fwd = (win * weights).sum(axis=1, dtype=np.uint64)
    rc = ((np.uint64(3) - win)[:, ::-1] * weights).sum(axis=1, dtype=np.uint64)
    return np.maximum(fwd, rc)


def make_multi_dataset(d: str, data: dict, rng) -> dict:
    """MULTI_STRAINS strains of the phase-4 genome with seeded SNPs, each
    with a seeded INFORMATIVE_FRACTION sample of its own k-mers written as
    kmer_scrub_filter writes them (two comment lines, one k-mer a line)."""
    from strainer2_tpu_torch.ops.packing_np import decode_codes_np

    t0 = time.perf_counter()
    strains, informative = [], []
    for i in range(MULTI_STRAINS):
        g = data["genome"].copy()
        hit = np.flatnonzero(rng.random(g.size) < SNP_RATE)
        g[hit] = (g[hit] + rng.integers(1, 4, hit.size, dtype=np.uint8)) % 4
        contigs = np.array_split(g, STRAIN_CONTIGS)
        path = os.path.join(d, f"strain_{i:02d}.fna")
        write_fasta(path, contigs, f"strain_{i:02d}")
        codes = np.concatenate([
            canonical_codes_at(c, np.flatnonzero(rng.random(c.size - K + 1) < INFORMATIVE_FRACTION))
            for c in contigs
        ])
        inf_path = os.path.join(d, f"strain_{i:02d}.informative.txt")
        with open(inf_path, "w") as f:
            f.write(f"#seeded {INFORMATIVE_FRACTION} sample of strain_{i:02d}'s k-mers\n")
            f.write(f"#post scrub kmers {codes.size}\n")
            f.write("".join(s + "\n" for s in decode_codes_np(codes, K)))
        strains.append(path)
        informative.append(codes)
    with open(os.path.join(d, "strains.tsv"), "w") as f:
        f.write("".join(f"{p}\t{p[: -len('.fna')]}.informative.txt\n" for p in strains))
    print(f"multi data: {MULTI_STRAINS} strains of the {STRAIN_BP} bp genome with SNPs at rate "
          f"{SNP_RATE}, {INFORMATIVE_FRACTION:.0%} of each strain's k-mers informative "
          f"({sum(c.size for c in informative)} lines); made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"strains": strains, "informative": informative}


def detect_multi_real(d: str, data: dict, multi: dict) -> tuple[float, dict]:
    """Path (b): detect-multi over all strains on the GPU, in this process
    with the launch counts reset just before and read just after."""
    from strainer2_tpu_torch.ops import _build
    from strainer2_tpu_torch.utils import observability

    set_up = observability._totals["multi.strain_states"]
    _build.reset_launches()
    wall = run_cli("strainer2_tools", ["detect-multi", "-S", os.path.join(d, "strains.tsv"),
                                       "-B", os.path.join(d, "targets.txt"),
                                       "-o", os.path.join(d, "multi")],
                   os.path.join(d, "multi_stdout.txt"))
    launches = dict(_build.launches)
    set_up = observability._totals["multi.strain_states"] - set_up
    windows = data["windows"]["targets"]
    print(f"stage detect-multi ({MULTI_STRAINS} strains): wall {wall:.3f} s, "
          f"{windows / wall:,.0f} windows/s ({windows} windows), "
          f"{windows * MULTI_STRAINS / wall:,.0f} strain-windows/s", flush=True)
    print(f"stage detect-multi multi.strain_states: {set_up:.3f} s", flush=True)
    return wall, launches


def check_multi_outputs(d: str, multi: dict) -> None:
    """Strains MULTI_CHECKED byte-identical to single-strain strain_detect
    runs; every strain's hit rows per sample equal to what the C++
    NativeClassifier predicts over the union table with the same 2-bit
    strain meta (built here from the genomes and the informative sets)."""
    from concurrent.futures import ThreadPoolExecutor

    from strainer2_tpu_torch import native
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.multi_detect import union_sorted_many

    p = lambda name: os.path.join(d, name)  # noqa: E731
    stem = lambda i: f"strain_{i:02d}"  # noqa: E731
    for i in MULTI_CHECKED:
        run_cli("strain_detect", ["-r", multi["strains"][i], "-a", p(stem(i) + ".informative.txt"),
                                  "-B", p("targets.txt"), "-o", p(f"single_{i}.gz")],
                p(f"single_{i}_stdout.txt"))
        with gzip.open(p(f"single_{i}.gz"), "rb") as f, gzip.open(p(f"multi/{stem(i)}.kmer_hits.gz"), "rb") as g:
            single, both = f.read(), g.read()
        n_lines = single.count(b"\n")
        print(f"detect-multi strain {i}: {'identical to' if single == both else 'DIFFERS from'} "
              f"its single run ({n_lines} lines)", flush=True)
        if single != both:
            fail(f"detect-multi strain {i} differs from its single-strain run")

    engine = TorchKmerEngine(K, device=DEVICE)

    def strain_codes(path):
        return np.sort(StrainIndex.from_fasta(path, engine).codes)

    with ThreadPoolExecutor(8) as ex:
        codes = list(ex.map(strain_codes, multi["strains"]))
    union = union_sorted_many(codes)
    words = np.zeros((2, union.size), dtype=np.uint32)
    for s, (c, inf) in enumerate(zip(codes, multi["informative"])):
        w, sh = s // 16, np.uint32(2 * (s % 16))
        words[w, np.searchsorted(union, c)] |= np.uint32(1) << sh
        words[w, np.searchsorted(union, np.unique(inf))] |= np.uint32(2) << sh
    classifier = native.NativeClassifier(union, words[0].view(np.int32), K,
                                         values_hi=words[1].view(np.int32))
    rows = np.zeros((MULTI_STRAINS, 2), dtype=np.int64)
    samples = {p("target_SE.fasta"): 0, p("target_PE1.fasta"): 1}
    for s in range(MULTI_STRAINS):
        with gzip.open(p(f"multi/{stem(s)}.kmer_hits.gz"), "rt") as f:
            for line in f:
                if not line.startswith("#"):
                    rows[s, samples[line.split("\t", 1)[0]]] += 1
    expect = np.zeros_like(rows)
    for (f1, col), f2, mode in zip(samples.items(), (None, p("target_PE2.fasta")), (0, 1)):
        for _, tot, inf in classifier.open_multi_stream(f1, f2, mode, MULTI_STRAINS):
            tot, inf = tot.astype(np.int64), inf.astype(np.int64)
            if mode:
                tot, inf = tot[0::2] + tot[1::2], inf[0::2] + inf[1::2]
            expect[:, col] += np.where((tot >= 1) & (inf >= 1), inf, 0).sum(axis=0)
    print(f"detect-multi hit rows per strain (SE, PE): {rows.tolist()}", flush=True)
    print(f"NativeClassifier expects: {expect.tolist()}; union {union.size} keys", flush=True)
    if not np.array_equal(rows, expect) or not (rows > 0).all():
        fail("detect-multi hit rows differ from NativeClassifier's prediction")


# ---- phases 7 and 8: the fused pipelines at real size ---------------------------

def stage_deltas(before: dict, prefix: str = "fused.") -> dict:
    from strainer2_tpu_torch.utils import observability

    return {k: v - before.get(k, 0.0) for k, v in observability._totals.items()
            if k.startswith(prefix) and v - before.get(k, 0.0) > 0}


def fused_real(d: str) -> dict:
    """Phase 7 (a): the fused pipeline in this process (its launches are
    counted) on the phase-4 data at phase 4's -m; its wall and stage
    timers."""
    from strainer2_tpu_torch.utils import observability

    p = lambda name: os.path.join(d, name)  # noqa: E731
    before = dict(observability._totals)
    wall = run_cli("strainer2_tools", ["pipeline", "-r", p("strain.fna"), "-A", p("genomes.txt"),
                                       "-B", p("metagenomes.txt"), "-T", p("targets.txt"),
                                       "-m", str(MIN_FRACTION), "-o", p("p7a")], p("p7a_stdout.txt"))
    timers = stage_deltas(before)
    print(f"stage pipeline (phase 7 a): wall {wall:.3f} s; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(timers.items())), flush=True)
    return {"wall": wall, "timers": timers}


def fused_artifacts(out_dir: str, stem: str) -> dict:
    """Payloads of a fused run's four artifacts (gzip ones decompressed)."""
    out = {}
    for key, suffix in (("counts", ".scrub_kmer_counts.gz"), ("scrubbed", ".scrubbed_kmers.gz"),
                        ("hits", ".kmer_hits.gz"), ("coverage", ".coverage_depth")):
        path = os.path.join(out_dir, stem + suffix)
        with (gzip.open if suffix.endswith(".gz") else open)(path, "rb") as f:
            out[key] = f.read()
    return out


def check_fused_against_phase4(d: str) -> dict:
    """Phase 7 (a)'s artifacts against phase 4's staged outputs; coverage
    against coverage_depth on the fused hits file itself (coverage names
    come from the hits file's name)."""
    p = lambda name: os.path.join(d, name)  # noqa: E731
    got = fused_artifacts(p("p7a"), "strain")
    run_cli("coverage_depth", ["-k", p("p7a/strain.kmer_hits.gz")], p("p7a_coverage.tsv"))
    with open(p("counts.tsv"), "rb") as f1, open(p("informative.txt"), "rb") as f2, \
            gzip.open(p("hits.gz"), "rb") as f3, open(p("p7a_coverage.tsv"), "rb") as f4:
        want = {"counts": f1.read(), "scrubbed": f2.read(), "hits": f3.read(), "coverage": f4.read()}
    ok = {k: got[k] == want[k] for k in want}
    ok["detect stdout"] = same_bytes(p("p7a_stdout.txt"), p("detect_stdout.txt"))
    n_lines = got["hits"].count(b"\n")
    print(f"phase 7 (a) against phase 4: {ok}; {n_lines} hits lines", flush=True)
    if not all(ok.values()):
        fail("the fused pipeline differs from the staged CLIs at real size")
    return got


def _rss_kib(pid: int) -> int:
    """The largest of VmHWM (the peak, where /proc/<pid>/status gives it),
    VmRSS and statm's resident pages: KiB, 0 where /proc shows none."""
    best = 0
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(("VmHWM:", "VmRSS:")):
                    best = max(best, int(line.split()[1]))
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open(f"/proc/{pid}/statm") as f:
            best = max(best, int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024)
    except (OSError, ValueError, IndexError):
        pass
    return best


def child(argv: list[str], d: str, label: str, stop=None) -> dict:
    """Run ``python -m <argv>`` from this checkout in a child process with
    stage timers on, stdout and stderr to files under d; with ``stop``,
    SIGKILL it as soon as stop() is true (polled every 20 ms) and fail if
    it ends first.  Returns its wall, exit code, whether it was killed and
    its peak RSS as _rss_kib reads it at every poll (a child's ru_maxrss
    would start from this process's RSS at the fork)."""
    import signal

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, STRAINER2_TIMINGS="1",
               PYTHONPATH=os.pathsep.join(x for x in (repo, os.environ.get("PYTHONPATH")) if x))
    t0 = time.perf_counter()
    with open(os.path.join(d, f"{label}.stdout"), "w") as out, \
            open(os.path.join(d, f"{label}.stderr"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", *argv, "--device", DEVICE],
                                stdout=out, stderr=err, env=env)
        killed, status, hwm_kib = False, None, 0
        try:
            while True:
                hwm_kib = max(hwm_kib, _rss_kib(proc.pid))
                pid, st = os.waitpid(proc.pid, os.WNOHANG)
                if pid:
                    status = st
                    break
                if stop is not None and stop():
                    proc.send_signal(signal.SIGKILL)
                    killed = True
                    _, status = os.waitpid(proc.pid, 0)
                    break
                if time.perf_counter() - t0 > 600:
                    fail(f"{label}: no end after 600 s")
                time.sleep(0.02)
        finally:
            if status is None:  # leaving early: stop the child first
                proc.send_signal(signal.SIGKILL)
                _, status = os.waitpid(proc.pid, 0)
            proc.returncode = os.waitstatus_to_exitcode(status)
    res = {"wall": time.perf_counter() - t0, "rc": proc.returncode, "killed": killed,
           "maxrss_mib": hwm_kib / 1024}
    rss = f"{res['maxrss_mib']:.1f} MiB" if hwm_kib else "not measured (no /proc entry)"
    print(f"child {label}: wall {res['wall']:.3f} s, exit {res['rc']}, killed {killed}, "
          f"peak RSS {rss}", flush=True)
    if stop is not None and not killed:
        fail(f"{label} ended before its kill point")
    if stop is None and res["rc"] != 0:
        with open(os.path.join(d, f"{label}.stderr")) as f:
            print(f.read()[-3000:], flush=True)
        fail(f"{label} exited {res['rc']}")
    return res


def _json_or_none(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def fused_resume(d: str, want: dict) -> dict:
    """Phase 7 (b): the checkpointed fused pipeline killed in its panel
    scan, killed again in detection, then run to the end; its artifacts
    must equal (a)'s, and each run must take up the work the one before
    it finished instead of doing it again."""
    p = lambda name: os.path.join(d, name)  # noqa: E731
    ck = p("p7b_ckpt")
    scrub_manifest = os.path.join(ck, "scrub", "manifest.json")
    sample0 = os.path.join(ck, "detect", "sample_0.z")
    argv = ["strainer2_tpu_torch.cli.strainer2_tools", "pipeline", "-r", p("strain.fna"),
            "-A", p("genomes.txt"), "-B", p("metagenomes.txt"), "-T", p("targets.txt"),
            "-m", str(MIN_FRACTION), "-o", p("p7b"), "--checkpoint", ck]
    n_files = 0
    for name in ("genomes.txt", "metagenomes.txt"):
        with open(p(name)) as f:
            n_files += sum(1 for line in f if line.strip())

    def scrub_state():
        """(inode, mtime, finished files) of the scrub manifest, read from
        one open file: each record replaces it by a new file."""
        try:
            with open(scrub_manifest) as f:
                st = os.fstat(f.fileno())
                m = json.load(f)
        except (OSError, ValueError):
            return None
        return st.st_ino, st.st_mtime_ns, sum(len(v) for v in m["done"].values())

    def scrub_done():
        st = scrub_state()
        return st is not None and st[2] >= 1

    def sample0_done():
        m = _json_or_none(os.path.join(ck, "detect", "detect_manifest.json"))
        return m is not None and "0" in m["samples"]

    seen = []  # every scrub manifest run 2 leaves, first run 1's

    def watch_scrub_until_sample0():
        st = scrub_state()
        if st is not None and (not seen or seen[-1][:2] != st[:2]):
            seen.append(st)
        return sample0_done()

    runs = {"kill in scrub": child(argv, d, "p7b_run1", stop=scrub_done)}
    n1 = scrub_state()[2]
    print(f"phase 7 (b) run 1 left {n1} of {n_files} finished panel files", flush=True)
    runs["kill in detect"] = child(argv, d, "p7b_run2", stop=watch_scrub_until_sample0)
    after2 = scrub_state()
    sample0_mtime = os.stat(sample0).st_mtime_ns
    counts = [st[2] for st in seen]
    print(f"phase 7 (b) run 2: finished panel files after each record {counts}", flush=True)
    runs["to the end"] = child(argv, d, "p7b_run3")
    with open(p("p7b_run3.stderr")) as f:
        for line in f:
            if line.startswith("#   "):
                print(f"phase 7 (b) run 3 timer: {line[4:].rstrip()}", flush=True)
    resumed = {}
    for run in ("p7b_run2", "p7b_run3"):
        with open(p(f"{run}.stderr")) as f:
            resumed[f"{run} kept its checkpoint"] = "starting fresh" not in f.read()
    resumed["run 2 began from run 1's files"] = bool(seen) and counts[0] == n1
    resumed["run 2 only added files"] = all(b > a for a, b in zip(counts, counts[1:]))
    resumed["run 2 counted no more than what was left"] = len(seen) - 1 <= n_files - n1
    resumed["run 2 finished the scan"] = after2[2] == n_files
    resumed["run 3 counted no panel file"] = scrub_state() == after2
    resumed["run 3 kept sample 0"] = os.stat(sample0).st_mtime_ns == sample0_mtime
    print(f"phase 7 (b) resume checks: {resumed}", flush=True)
    if not all(resumed.values()):
        fail("a resumed fused pipeline did work its checkpoint holds again")
    got = fused_artifacts(p("p7b"), "strain")
    ok = {k: got[k] == want[k] for k in want}
    ok["stdout"] = same_bytes(p("p7b_run3.stdout"), p("p7a_stdout.txt"))
    print(f"phase 7 (b) resumed run against (a): {ok}", flush=True)
    if not all(ok.values()):
        fail("the resumed fused pipeline differs from the uninterrupted run")
    return runs


def time_record(d: str, num_slots: int) -> list:
    """What a checkpointed panel scan pays after each file: a record of the
    whole real-size count buffer (device to host copy, np.save, manifest),
    the call _count_files makes; wall ms of each of RECORD_REPS."""
    import torch

    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.progress import ScrubCheckpoint

    engine = TorchKmerEngine(K, device=DEVICE)
    counts = torch.randint(0, 1 << 20, (num_slots,), dtype=torch.int32, device=DEVICE).view(torch.uint32)
    ckpt = ScrubCheckpoint(os.path.join(d, "record_timing"))
    times = []
    for i in range(RECORD_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.record(1, f"panel{i}", engine.finalize_counts(counts))
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"checkpoint record of {num_slots} slots ({num_slots * 4 / 2**20:.0f} MiB): "
          + ", ".join(f"{t:.1f}" for t in times) + " ms", flush=True)
    return times


def staged_detect_rss(d: str) -> dict:
    """Peak RSS of strain_detect at real size, streaming and with
    --checkpoint (the staged loop holds a sample's payload in memory),
    each in a child process; both hit files equal phase 4's."""
    p = lambda name: os.path.join(d, name)  # noqa: E731
    out = {}
    for label, extra in (("streaming", []), ("checkpoint", ["--checkpoint", p("p7c_ckpt")])):
        res = child(["strainer2_tpu_torch.cli.strain_detect", "-r", p("strain.fna"),
                     "-a", p("informative.txt"), "-B", p("targets.txt"),
                     "-o", p(f"p7c_{label}.gz"), *extra], d, f"p7c_{label}")
        if not same_payloads(p(f"p7c_{label}.gz"), p("hits.gz")):
            fail(f"strain_detect ({label}) differs from phase 4's hits")
        out[label] = res
    return out


def fused_multi_real(d: str, multi: dict) -> dict:
    """Phase 8: pipeline-multi on FUSED_STRAINS strains in this process (its
    launches are counted): wall, fused.* timers, peak device memory."""
    import torch

    from strainer2_tpu_torch.pipeline import multi_detect as md
    from strainer2_tpu_torch.utils import observability

    p = lambda name: os.path.join(d, name)  # noqa: E731
    strains = [p("strain.fna")] + multi["strains"][: FUSED_STRAINS - 1]
    with open(p("p8_strains.txt"), "w") as f:
        f.write("".join(r + "\n" for r in strains))
    # device memory held when the multi-strain rows upload: the union
    # table and count buffer of the shared panel scan must be gone by then
    at_rows: list = []
    upload = md.MultiStrainDetector._device_rows

    def probed(self, meta_words):
        torch.cuda.synchronize()
        at_rows.append(torch.cuda.memory_allocated())
        return upload(self, meta_words)

    before = dict(observability._totals)
    torch.cuda.reset_peak_memory_stats()
    md.MultiStrainDetector._device_rows = probed
    try:
        wall = run_cli("strainer2_tools", ["pipeline-multi", "-R", p("p8_strains.txt"),
                                           "-A", p("genomes.txt"), "-B", p("metagenomes.txt"),
                                           "-T", p("targets.txt"), "-m", str(MIN_FRACTION),
                                           "-o", p("p8")], p("p8_stdout.txt"))
    finally:
        md.MultiStrainDetector._device_rows = upload
    peak = torch.cuda.max_memory_allocated()
    timers = stage_deltas(before)
    print(f"stage pipeline-multi (phase 8, {len(strains)} strains): wall {wall:.3f} s; "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(timers.items())), flush=True)
    print(f"phase 8 peak device memory: {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated); allocated when the multi-strain rows upload: "
          + ", ".join(f"{a / 2**30:.3f}" for a in at_rows) + " GiB", flush=True)
    return {"wall": wall, "timers": timers, "peak_bytes": peak, "strains": strains}


def check_fused_multi(d: str, data: dict, run: dict, want: dict) -> None:
    """Strain 0's artifacts equal phase 7 (a)'s; strains FUSED_CHECKED
    against the C++ counters from their own scrubbed files."""
    from strainer2_tpu_torch.pipeline.fused import _stem

    got = fused_artifacts(os.path.join(d, "p8"), "strain")
    ok = {k: got[k] == want[k] for k in want}
    print(f"phase 8 strain 0 against phase 7 (a): {ok}", flush=True)
    if not all(ok.values()):
        fail("pipeline-multi strain 0 differs from the single-strain fused run")
    for i in FUSED_CHECKED:
        if i >= len(run["strains"]):
            continue
        r = run["strains"][i]
        o = lambda suffix: os.path.join(d, "p8", _stem(r) + suffix)  # noqa: E731
        check_real_outputs(d, data, r, o(".scrub_kmer_counts.gz"), o(".scrubbed_kmers.gz"),
                           o(".kmer_hits.gz"), label=f"phase 8 strain {i}")


# ---- phase 9: genome_compare and strain-track at real size ----------------------

def compare_real(d: str, data: dict) -> dict:
    """genome_compare -a the strain against the 10 genomes and the 8 panel
    metagenomes, in each of COMPARE_RUNS, in this process (launches
    counted); every line against the C++ NativeComparer on this host."""
    from concurrent.futures import ThreadPoolExecutor

    from strainer2_tpu_torch import native
    from strainer2_tpu_torch.pipeline.compare import _c_fraction

    p = lambda name: os.path.join(d, name)  # noqa: E731
    queries = data["genomes"] + data["metas"]
    with open(p("compare_list.txt"), "w") as f:
        f.write("".join(q + "\n" for q in queries))
    windows = (N_GENOMES * (GENOME_BP - COMPARE_K + 1)
               + N_METAGENOMES * METAGENOME_READS * (READ_LEN - COMPARE_K + 1))
    t0 = time.perf_counter()
    comparer = native.NativeComparer(p("strain.fna"), COMPARE_K)
    print(f"NativeComparer: {comparer.num_kmers} {COMPARE_K}-mers of the strain, built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    walls = {}
    for run, (extra, max_seeds, threshold) in COMPARE_RUNS.items():
        out = p(f"p9_{run.replace(' ', '_')}.txt")
        walls[run] = run_cli("genome_compare", ["-a", p("strain.fna"), "-B", p("compare_list.txt"),
                                                *extra], out)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            tallies = list(ex.map(lambda q: comparer.score(q, max_seeds, threshold), queries))
        host_wall = time.perf_counter() - t0
        want = "".join(f"{p('strain.fna')}\t{q}\t{h}\t{m}\t{_c_fraction(h, m)}\n"
                       for q, (h, m) in zip(queries, tallies))
        with open(out) as f:
            got = f.read()
        evaluated = sum(h + m for h, m in tallies)
        fullmapped = sum(1 for h, m in tallies if not max_seeds or h + m > max_seeds)
        print(f"stage genome_compare {run}: wall {walls[run]:.3f} s, {evaluated:,} windows evaluated "
              f"({evaluated / walls[run]:,.0f}/s; {windows:,} windows in the queries), "
              f"{fullmapped} of {len(queries)} queries fullmapped; "
              f"NativeComparer on 8 threads {host_wall:.3f} s", flush=True)
        lines = got.splitlines()
        print(f"genome_compare {run}: {lines[0]} ... {lines[-1]}", flush=True)
        if got != want:
            fail(f"genome_compare {run}: lines differ from NativeComparer's")
        print(f"genome_compare {run}: all {len(queries)} lines equal NativeComparer's", flush=True)
    return walls


def strain_track_real(d: str, multi: dict, rng) -> float:
    """strain-track -n of the first TRACK_STRAINS strains of phase 6, in this
    process (launches counted), against a metagenome made like the phase-4
    panels whose strain reads (STRAIN_READ_FRACTION of them for each
    strain) are drawn from those strains: a phase-4 metagenome holds none
    of the k-mers unique to one of them, so every count would be 0. Each
    strain's (used, possible, counted) seeds and the valid windows are
    checked against the C++ NativePanelCounter on the k-mers that occur
    once across the strains, found here with numpy."""
    from strainer2_tpu_torch import native
    from strainer2_tpu_torch.io.fastx import read_fastx
    from strainer2_tpu_torch.ops.packing_np import canonical_codes_np, encode_ascii_np
    from strainer2_tpu_torch.tools.bench_kernels import revcomp

    p = lambda name: os.path.join(d, name)  # noqa: E731
    strains = multi["strains"][:TRACK_STRAINS]
    contigs = [[encode_ascii_np(np.frombuffer(rec.seq, dtype=np.uint8)) for rec in read_fastx(r)]
               for r in strains]
    reads = rng.integers(0, 4, size=(METAGENOME_READS, READ_LEN), dtype=np.uint8)
    per = int(METAGENOME_READS * STRAIN_READ_FRACTION)
    slots = rng.choice(METAGENOME_READS, size=per * len(strains), replace=False)
    for s, cs in enumerate(contigs):
        genome = np.concatenate(cs)
        sample = genome[rng.integers(0, genome.size - READ_LEN, per)[:, None] + np.arange(READ_LEN)]
        flip = rng.random(per) < 0.5
        sample[flip] = revcomp(sample[flip])
        reads[slots[s * per : (s + 1) * per]] = sample
    meta = p("track_meta.fasta")
    write_reads(meta, reads, 0.001, rng)
    print(f"strain-track: the first {TRACK_STRAINS} of phase 6's {MULTI_STRAINS} strains against "
          f"{METAGENOME_READS} reads, {STRAIN_READ_FRACTION:.0%} from each of them", flush=True)
    with open(p("track_strains.txt"), "w") as f:
        f.write("".join(r + "\n" for r in strains))
    wall = run_cli("strainer2_tools", ["strain-track", "-A", p("track_strains.txt"), "-b", meta, "-n"],
                   p("p9_track.txt"))
    with open(p("p9_track.txt")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if not line.startswith("#")]
    got = [(r[0], int(r[2]), int(r[3]), int(r[4]), int(r[5])) for r in rows]

    scans = [np.concatenate([c[v] for c, v in (canonical_codes_np(x, K) for x in cs)]) for cs in contigs]
    allc = np.sort(np.concatenate(scans))
    starts = np.flatnonzero(np.concatenate([[True], allc[1:] != allc[:-1]]))
    unique = allc[starts[np.diff(np.append(starts, allc.size)) == 1]]
    counter = native.NativePanelCounter(unique, np.arange(unique.size, dtype=np.int32), K)
    counts = np.zeros(unique.size, dtype=np.uint32)
    n_valid = counter.count_file(counts, meta)
    want = []
    for r, c in zip(strains, scans):
        pos = np.minimum(np.searchsorted(unique, c), unique.size - 1)
        seen = counts[pos[unique[pos] == c]].astype(np.int64)
        want.append((r, int((seen > 0).sum()), int(seen.size), int(seen.sum()), n_valid))
    print(f"stage strain-track ({TRACK_STRAINS} strains): wall {wall:.3f} s; {unique.size} unique "
          f"k-mers of {allc.size} windows; (used, possible, counted, valid windows) "
          f"{[g[1:] for g in got]}; NativePanelCounter {[w[1:] for w in want]}", flush=True)
    if got != want or not all(g[1] > 0 for g in got):
        fail("strain-track differs from NativePanelCounter on the unique k-mers")
    return wall


# ---- phase 10: the cuckoo layout at real size ---------------------------------

def real_size_cuckoo(d: str, data: dict) -> dict:
    """The phase-4 strain's cuckoo index built on the card (K1, then the
    port's native builder), every key checked to sit in one of its two
    slots and saved; then, with layout="cuckoo" through the stage APIs,
    run_scrub_count on the phase-4 panels, strain_detect on the phase-4
    targets and genome_compare fullmap and -S on the phase-9 queries, each
    byte-identical to phases 4 and 9; one more strain_detect on the saved
    npz as its --index-cache must reuse it unwritten.  Launches counted
    from 0 over the stage runs; every cuckoo kernel of the path must run
    and no bucket twin may."""
    import torch

    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.index.hashing import cuckoo_slots
    from strainer2_tpu_torch.ops import _build
    from strainer2_tpu_torch.ops.packing_np import split_code64_np
    from strainer2_tpu_torch.pipeline.compare import CompareConfig, run_genome_compare
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    p = lambda name: os.path.join(d, name)  # noqa: E731
    t0 = time.perf_counter()
    index = StrainIndex.from_fasta(p("strain.fna"), TorchKmerEngine(K, device=DEVICE, layout="cuckoo"))
    t = index.table
    build_s = time.perf_counter() - t0
    hi, lo = split_code64_np(index.codes, K)
    s0 = cuckoo_slots(hi ^ np.uint32(t.salt), lo, t.h_bits, 0).astype(np.int64)
    s1 = cuckoo_slots(hi ^ np.uint32(t.salt), lo, t.h_bits, 1).astype(np.int64) + t.num_slots // 2
    slot = t.slot_of_key.astype(np.int64)
    placed = bool(((slot == s0) | (slot == s1)).all()
                  and np.array_equal(t.table[slot], np.stack([hi, lo], axis=1)))
    print(f"phase 10 cuckoo index: {index.num_kmers} keys in 2 x 2^{t.h_bits} slots, salt {t.salt}, "
          f"built in {build_s:.3f} s (scan on the card, native builder); every key at one of its "
          f"two slots: {placed}", flush=True)
    if not placed:
        fail("a key of the cuckoo index is not at one of its two slots")
    npz = p("cuckoo_index.npz")
    index.save(npz)
    del index

    walls, cfg = {}, dict(device=DEVICE, layout="cuckoo")
    _build.reset_launches()
    t0 = time.perf_counter()
    with open(p("p10_counts.tsv"), "w") as f:
        run_scrub_count(p("strain.fna"), p("genomes.txt"), p("metagenomes.txt"), out=f,
                        cfg=ScrubCountConfig(**cfg))
    torch.cuda.synchronize()
    walls["kmer_scrub_count"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(p("p10_detect_stdout.txt"), "w") as f:
        run_detect(p("strain.fna"), p("informative.txt"), p("p10_hits.gz"),
                   batch_list=p("targets.txt"), stdout=f, cfg=DetectConfig(**cfg))
    torch.cuda.synchronize()
    walls["strain_detect"] = time.perf_counter() - t0
    evaluated = {}
    for run in ("fullmap", "strain mode"):
        _, max_seeds, threshold = COMPARE_RUNS[run]
        out = p(f"p10_{run.replace(' ', '_')}.txt")
        t0 = time.perf_counter()
        with open(out, "w") as f:
            run_genome_compare(p("strain.fna"), b_list=p("compare_list.txt"), out=f,
                               cfg=CompareConfig(max_seeds=max_seeds, threshold_for_fullmap=threshold,
                                                 **cfg))
        torch.cuda.synchronize()
        walls[f"genome_compare {run}"] = time.perf_counter() - t0
        with open(out) as f:
            evaluated[run] = sum(int(x[2]) + int(x[3]) for x in (ln.split("\t") for ln in f))
    launches = dict(_build.launches)

    with open(npz, "rb") as f:
        npz_bytes = f.read()
    npz_mtime = os.stat(npz).st_mtime_ns
    with open(p("p10_cache_stdout.txt"), "w") as f:
        run_detect(p("strain.fna"), p("informative.txt"), p("p10_cache_hits.gz"),
                   batch_list=p("targets.txt"), stdout=f, index_cache=npz, cfg=DetectConfig(**cfg))
    with open(npz, "rb") as f:
        cache_kept = f.read() == npz_bytes and os.stat(npz).st_mtime_ns == npz_mtime

    rates = {"kmer_scrub_count": data["windows"]["panel"], "strain_detect": data["windows"]["targets"],
             "genome_compare fullmap": evaluated["fullmap"],
             "genome_compare strain mode": evaluated["strain mode"]}
    for stage, wall in walls.items():
        print(f"stage {stage} (cuckoo, phase 10): wall {wall:.3f} s, {rates[stage] / wall:,.0f} "
              f"windows/s ({rates[stage]} windows)", flush=True)
    ok = {
        "counts": same_bytes(p("p10_counts.tsv"), p("counts.tsv")),
        "hits": same_payloads(p("p10_hits.gz"), p("hits.gz")),
        "detect stdout": same_bytes(p("p10_detect_stdout.txt"), p("detect_stdout.txt")),
        "genome_compare fullmap": same_bytes(p("p10_fullmap.txt"), p("p9_fullmap.txt")),
        "genome_compare -S": same_bytes(p("p10_strain_mode.txt"), p("p9_strain_mode.txt")),
        "index-cache hits": same_payloads(p("p10_cache_hits.gz"), p("hits.gz")),
        "index cache reused unwritten": cache_kept,
    }
    print(f"phase 10 (cuckoo) against phases 4 and 9: {ok}", flush=True)
    if not all(ok.values()):
        fail("the cuckoo layout's outputs differ from the bucket layout's at real size")
    print(f"launches during phase 10 (cuckoo scrub, detect, genome_compare): {launches}", flush=True)
    ran = ("canonical_windows", "cuckoo_count_step", "cuckoo_classify_step", "cuckoo_hit_accumulate",
           "cuckoo_hit_stats")
    twins = ("count_step", "classify_step", "hit_accumulate", "hit_stats")
    if not all(launches[name] > 0 for name in ran) or any(launches[name] for name in twins):
        fail(f"phase 10 did not run {ran} alone of the probing kernels")
    return launches


def profiled(out_dir: str, label: str, fn):
    """Run fn under torch.profiler: print device busy time against wall
    time, and write key_averages() sorted by device time to out_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0  # before the profiler's own teardown
    # device busy = the device-side records (kernels and copies), one stream;
    # the host ops that issued them carry the same time again
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    busy_us = sum(sum(v) for v in by_name.values())
    with open(os.path.join(out_dir, f"{label}_key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    print(f"profile {label}: device busy {busy_us / 1e6:.3f} s of {wall:.3f} s wall "
          f"(idle share {1 - busy_us / 1e6 / wall:.4f})", flush=True)
    for key, times in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        times = sorted(times)
        print(f"profile {label}: {sum(times) / 1e3:10.3f} ms  {len(times):6d}x  median "
              f"{times[len(times) // 2]:.1f} us, longest {', '.join(f'{t:.1f}' for t in times[-3:][::-1])} us  "
              f"{key[:90]}", flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep", default=None, help="directory to keep the generated data and outputs in")
    ap.add_argument("--profile", default=None,
                    help="trace phases 4, 6, 7, 8, 9 and 10 with torch.profiler; prints the device's busy "
                         "share and writes the per-kernel tables into this directory")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU",
              flush=True)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from strainer2_tpu_torch import native
        from strainer2_tpu_torch.ops import _build
    except ImportError as e:
        print(f"FAIL: cannot import the port next to this script ({e})", flush=True)
        return 1

    # ---- phase 1: set-up
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    print(f"native_host: {str(native.available()).lower()}", flush=True)
    _build.kernels()
    print(f"kernel build: {_build.build_seconds:.2f} s ({_build.built_how})", flush=True)

    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"== phase {name} at {time.perf_counter() - t_start:.1f} s", flush=True)

    with contextlib.ExitStack() as stack:
        d = args.keep or stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_"))
        os.makedirs(d, exist_ok=True)
        data = make_dataset(d, rng)

        # ---- phase 2: kernels vs plain versions
        phase("2")
        results, ctx = check_kernels(d, data, rng, torch.device(DEVICE), args.seed)
        cuckoo_k = check_cuckoo_kernels(ctx, torch.device(DEVICE))
        compare_k = check_compare_kernels(d, ctx, torch.device(DEVICE))

        # ---- phase 2b: the lookup A/B tool (path (a)), K6/K7 at S strains
        phase("2b")
        ab = lookup_ab()
        multi_k = check_multi_kernels(ctx)
        del ctx
        torch.cuda.empty_cache()

        # ---- phase 3: mini goldens through the CLIs on the GPU
        phase("3")
        mini_out = os.path.join(d, "mini")
        os.makedirs(mini_out, exist_ok=True)
        mini_cuckoo_launches = mini_goldens(repo, mini_out)

        # ---- phase 4: real size through the CLIs; launches counted here
        phase("4")
        _build.reset_launches()
        if args.profile:
            walls = profiled(args.profile, "phase4", lambda: real_size(d, data))
        else:
            walls = real_size(d, data)
        launches = dict(_build.launches)
        p4 = lambda name: os.path.join(d, name)  # noqa: E731
        index = check_real_outputs(d, data, p4("strain.fna"), p4("counts.tsv"),
                                   p4("informative.txt"), p4("hits.gz"))
        num_slots = index.table.num_slots
        del index

        # ---- phase 7: the fused single-strain pipeline at real size
        phase("7")
        _build.reset_launches()
        if args.profile:
            fused = profiled(args.profile, "phase7", lambda: fused_real(d))
        else:
            fused = fused_real(d)
        fused_launches = dict(_build.launches)
        want = check_fused_against_phase4(d)
        fused_resume(d, want)
        time_record(d, num_slots)
        staged_detect_rss(d)

        # ---- phase 6: detect-multi at real size (path (b)); launches counted
        phase("6")
        multi = make_multi_dataset(d, data, rng)
        if args.profile:
            _, multi_launches = profiled(args.profile, "phase6",
                                         lambda: detect_multi_real(d, data, multi))
        else:
            _, multi_launches = detect_multi_real(d, data, multi)
        check_multi_outputs(d, multi)

        # ---- phase 8: the fused multi-strain pipeline at real size
        phase("8")
        _build.reset_launches()
        if args.profile:
            fused_multi = profiled(args.profile, "phase8", lambda: fused_multi_real(d, multi))
        else:
            fused_multi = fused_multi_real(d, multi)
        fused_multi_launches = dict(_build.launches)
        check_fused_multi(d, data, fused_multi, want)
        print(f"phase 7 wall {fused['wall']:.3f} s against phase 4's four CLIs "
              f"{sum(walls.values()):.3f} s; phase 8 wall {fused_multi['wall']:.3f} s", flush=True)

        # ---- phase 9: genome_compare and strain-track at real size; launches counted
        phase("9")
        _build.reset_launches()
        if args.profile:
            profiled(args.profile, "phase9", lambda: (compare_real(d, data),
                                                      strain_track_real(d, multi, rng)))
        else:
            compare_real(d, data)
            strain_track_real(d, multi, rng)
        compare_launches = dict(_build.launches)

        # ---- phase 10: the cuckoo layout at real size; launches counted
        phase("10")
        if args.profile:
            cuckoo_launches = profiled(args.profile, "phase10", lambda: real_size_cuckoo(d, data))
        else:
            cuckoo_launches = real_size_cuckoo(d, data)
            print("phase 10 idle share: not measured (run with --profile)", flush=True)

    # ---- phase 5
    phase("5")
    paths = {
        "strain scrub/filter/detect/coverage (phase 4)": launches,
        "bench_lookup (phase 2b)": ab["launches"],
        "detect-multi (phase 6)": multi_launches,
        "genome_compare and strain-track (phase 9)": compare_launches,
        "cuckoo stage runs (phase 10)": cuckoo_launches,
    }
    for path, counts in paths.items():
        print(f"launches during {path}: {counts}", flush=True)
    for path, counts, need in (
            ("pipeline (phase 7)", fused_launches, ("canonical_windows", "count_step", "classify_step")),
            ("pipeline-multi (phase 8)", fused_multi_launches,
             ("canonical_windows", "count_step", "multi_hit_words", "strain_sums"))):
        print(f"launches during {path}: {counts}", flush=True)
        if not all(counts[name] > 0 for name in need):
            fail(f"a kernel of {path} was not launched: {need}")
    launched_by = dict.fromkeys(REPLACES, "strain scrub/filter/detect/coverage (phase 4)")
    for name, path, counts in (("bucket_lookup", "bench_lookup (phase 2b)", ab["launches"]),
                               ("bucket_lookup_ring", "bench_lookup (phase 2b)", ab["launches"]),
                               ("multi_hit_words", "detect-multi (phase 6)", multi_launches),
                               ("strain_sums", "detect-multi (phase 6)", multi_launches),
                               ("hit_accumulate", "genome_compare (phase 9)", compare_launches),
                               ("hit_stats", "genome_compare (phase 9)", compare_launches),
                               ("count_valid_step", "strain-track (phase 9)", compare_launches),
                               ("valid_tally_total", "strain-track (phase 9)", compare_launches),
                               ("cuckoo_lookup", "bench_lookup (phase 2b)", ab["launches"]),
                               ("cuckoo_count_step", "scrub count, cuckoo (phase 10)", cuckoo_launches),
                               ("cuckoo_classify_step", "strain_detect, cuckoo (phase 10)",
                                cuckoo_launches),
                               ("cuckoo_hit_accumulate", "genome_compare fullmap, cuckoo (phase 10)",
                                cuckoo_launches),
                               ("cuckoo_hit_stats", "genome_compare -S, cuckoo (phase 10)",
                                cuckoo_launches),
                               ("cuckoo_count_valid_step", "strain-track, cuckoo (phase 3)",
                                mini_cuckoo_launches)):
        launches[name] = counts[name]
        launched_by[name] = path
    if not all(launches[name] > 0 for name in REPLACES):
        fail("a kernel of the path was not launched by its path")
    ring = results["bucket_lookup_ring"]
    ring.update(max_abs_err=max(ring["max_abs_err"], ab["max_abs_err"]),
                ab_ms_per_4m=ab["ms"], ab_plain_ms_per_4m=ab["plain_ms"])
    results.update(cuckoo_k)
    k10 = results["cuckoo_lookup"]
    k10.update(max_abs_err=max(k10["max_abs_err"], ab["k10_max_abs_err"]), ab_ms_per_4m=ab["k10_ms"],
               ab_k2_ms_per_4m=ab["k2_ms"])
    for name, headline in (("hit_accumulate", f"targets k={COMPARE_K}"),
                           ("hit_stats", f"targets k={COMPARE_K}"),
                           ("count_valid_step", f"targets k={K}"),
                           ("valid_tally_total", f"targets k={K}"),
                           ("cuckoo_hit_accumulate", f"targets k={COMPARE_K}"),
                           ("cuckoo_hit_stats", f"targets k={COMPARE_K}"),
                           ("cuckoo_count_valid_step", f"targets k={K}")):
        by = compare_k[name]
        results[name] = dict(by[headline], max_abs_err=max(r["max_abs_err"] for r in by.values()),
                             **{label: r for label, r in by.items() if label != headline})
    for name in ("multi_hit_words", "strain_sums"):
        by_kind = multi_k[name][MULTI_STRAINS]
        results[name] = dict(by_kind["phase2"], targets=by_kind["targets"], max_abs_err=max(
            r["max_abs_err"] for per_s in multi_k[name].values() for r in per_s.values()))
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "launched_by": launched_by[name], **results[name]}
        for name in REPLACES
    ]
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "strainer2_tpu"))
    if jax_side:
        fail(f"jax or the JAX package was imported: {jax_side[:5]}")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
