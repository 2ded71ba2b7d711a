#!/usr/bin/env python3
"""ThreadSanitizer stress of the port's host plane.

Run through strainer2_tpu_torch/tools/tsan_stress.sh, which builds the
port's C++ host library with -fsanitize=thread, points the port at it
(STRAINER2_TORCH_HOST_LIB) and preloads libtsan.  Every concurrent shape of
the port's host plane runs on small data made from a seed, on the CPU, and
each is held to the same work done one thread at a time:

1. the sample pool of strain_detect (pipeline/detect.py _run_sample_pool):
   per-sample native classify streams and read extractors over one shared
   classify table, the staged form with a checkpoint too;
2. the multi-strain sample pool (pipeline/multi_detect.py): multi-strain
   classify streams over one shared union table;
3. the native panel-count pool (pipeline/scrub_count.py
   _count_files_parallel): fused counts into per-thread buffers over one
   shared count table;
4. the device feeder on the CPU (pipeline/scrub_count.py
   _count_files_device_parallel): native reader/packer streams on worker
   threads, their batches counted under a lock;
5. the compare pool (pipeline/compare.py run_genome_compare): concurrent
   NativeComparer.score over one shared key set;
6. the fused runners' pools (pipeline/fused.py): the row-order thread, the
   counts writers, the strain-parallel index builds and the sample pools
   of run_pipeline and run_multi_pipeline;
7. the multi-thread table build and the prefetch thread of a pack stream
   (index/bucket.py through the library, utils/prefetch.py).

torch runs one intra-op thread: its own threads are not under test.

    strainer2_tpu_torch/tools/tsan_stress.sh [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import os
import sys
import tempfile

import numpy as np

K = 31
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_fasta(path: str, seqs: list[np.ndarray], gz: bool = False) -> None:
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">r%d\n" % i + s.tobytes() + b"\n")


def _reads(genome: np.ndarray, rng, n: int, length: int = 150) -> list[np.ndarray]:
    starts = rng.integers(0, genome.size - length, n)
    out = []
    for s in starts:
        r = genome[s : s + length].copy()
        flip = rng.random(length) < 0.01
        r[flip] = ACGT[rng.integers(0, 4, int(flip.sum()))]
        out.append(r)
    return out


def make_data(d: str, rng) -> dict:
    """A 60 kbp strain and two SNP copies, four panel genomes, three panel
    metagenomes, and six target samples (SE, PE, PEI) with reads of the
    strain among random ones."""
    p = lambda name: os.path.join(d, name)  # noqa: E731
    strain = ACGT[rng.integers(0, 4, 60_000)]
    copies = []
    for i in range(2):
        c = strain.copy()
        at = rng.random(c.size) < 0.003
        c[at] = ACGT[rng.integers(0, 4, int(at.sum()))]
        copies.append(c)
    genomes = [strain] + copies
    for i, g in enumerate(genomes):
        _write_fasta(p(f"strain{i}.fna"), [g])
    panels = []
    for i in range(4):
        path = p(f"genome{i}.fna.gz")
        _write_fasta(path, [ACGT[rng.integers(0, 4, 40_000)], strain[i * 9000: i * 9000 + 8000]],
                     gz=True)
        panels.append(path)
    metas = []
    for i in range(3):
        path = p(f"meta{i}.fa")
        _write_fasta(path, _reads(strain, rng, 300) + [ACGT[rng.integers(0, 4, 150)]
                                                       for _ in range(300)])
        metas.append(path)
    targets = []
    for i in range(6):
        kind = ("SE", "PE", "PEI")[i % 3]
        reads = _reads(strain, rng, 200) + [ACGT[rng.integers(0, 4, 150)] for _ in range(200)]
        if kind == "PE":
            a, b = p(f"t{i}_1.fa"), p(f"t{i}_2.fa")
            _write_fasta(a, reads[0::2])
            _write_fasta(b, reads[1::2])
            targets.append(f"PE\t{a}\t{b}")
        else:
            path = p(f"t{i}.fa")
            _write_fasta(path, reads)
            targets.append(f"{kind}\t{path}")
    lists = {"A": panels, "B": metas, "T": targets, "R": [p(f"strain{i}.fna") for i in range(3)]}
    for name, rows in lists.items():
        with open(p(f"{name}.txt"), "w") as f:
            f.write("".join(r + "\n" for r in rows))
    return {"d": d, "strains": lists["R"], "panels": panels, "metas": metas}


def _informative(d: str, r: str, every: int) -> str:
    """Every ``every``th distinct k-mer of ``r`` as its scrubbed file."""
    from strainer2_tpu_torch.native import scan_file_codes_native
    from strainer2_tpu_torch.ops.packing_np import decode_codes_np

    path = os.path.join(d, os.path.basename(r) + f".inf{every}.txt")
    codes = np.unique(scan_file_codes_native(r, K))[::every]
    with open(path, "w") as f:
        f.write("".join(s + "\n" for s in decode_codes_np(codes, K)))
    return path


@contextlib.contextmanager
def env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _gz(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def stress_sample_pool(data: dict) -> None:
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

    d = data["d"]
    r = data["strains"][0]
    inf = _informative(d, r, 7)
    outs = {}
    for label, threads, ckpt in (("seq", 1, None), ("pool", 4, None),
                                 ("staged pool", 4, os.path.join(d, "dck"))):
        hits = os.path.join(d, f"hits_{threads}_{ckpt is not None}.gz")
        out = io.StringIO()
        with env(STRAINER2_DETECT_THREADS=threads):
            run_detect(r, inf, hits, batch_list=os.path.join(d, "T.txt"),
                       background_list=os.path.join(d, "B.txt"), stdout=out,
                       cfg=DetectConfig(device="cpu"), checkpoint_dir=ckpt)
        outs[label] = (_gz(hits), out.getvalue())
    assert outs["pool"] == outs["seq"] == outs["staged pool"], "sample pool differs"
    assert outs["seq"][0].count(b"\n") > 24
    print("sample pool (strain_detect, streamed and staged): ok", flush=True)


def stress_multi_pool(data: dict) -> None:
    from strainer2_tpu_torch.pipeline.detect import DetectConfig
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    d = data["d"]
    strains = [(r, _informative(d, r, 5 + i)) for i, r in enumerate(data["strains"])]
    got = {}
    for threads in (1, 4):
        det = MultiStrainDetector(strains, cfg=DetectConfig(device="cpu"), stdout=io.StringIO(),
                                  background_list=os.path.join(d, "B.txt"))
        assert det._native_multi_classifier() is not None
        outs = [os.path.join(d, f"multi{threads}_{i}.gz") for i in range(len(strains))]
        with env(STRAINER2_DETECT_THREADS=threads):
            det.quantify_all(outs, os.path.join(d, "T.txt"))
        got[threads] = [_gz(o) for o in outs]
    assert got[1] == got[4], "multi-strain pool differs"
    print("multi-strain sample pool (detect-multi): ok", flush=True)


def stress_count_pool(data: dict) -> None:
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.scrub_count import count_files_native_pooled

    index = StrainIndex.from_fasta(data["strains"][0], TorchKmerEngine(K, device="cpu"))
    nc = index.native_counter()
    paths = data["panels"] + data["metas"]
    got = {}
    for threads in (1, 4):
        with env(STRAINER2_COUNT_THREADS=threads):
            got[threads] = count_files_native_pooled(nc, paths, index.table.num_slots)
    assert np.array_equal(got[1], got[4]) and got[1].sum() > 0, "count pool differs"
    print("native panel-count pool (per-thread buffers): ok", flush=True)


def stress_device_feeder(data: dict) -> None:
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.scrub_count import (
        ScrubCountConfig,
        _count_files_device_parallel,
        count_panel_file,
    )

    cfg = ScrubCountConfig(device="cpu", rows=8, row_len=1024)
    eng = TorchKmerEngine(K, device="cpu")
    paths = data["panels"] + data["metas"]
    with env(STRAINER2_NATIVE_COUNT=0):
        index = StrainIndex.from_fasta(data["strains"][0], eng, cfg.rows, cfg.row_len)
        fed = _count_files_device_parallel(eng, index, eng.init_counts(index), paths, 4, cfg)
        seq = eng.init_counts(index)
        for path in paths:
            seq = count_panel_file(eng, index, seq, path, cfg.rows, cfg.row_len)
    assert np.array_equal(eng.finalize_counts(fed), eng.finalize_counts(seq)), "feeder differs"
    print("device feeder on the CPU (packer threads, counts under a lock): ok", flush=True)


def stress_compare_pool(data: dict) -> None:
    from strainer2_tpu_torch.pipeline.compare import CompareConfig, run_genome_compare

    d = data["d"]
    lst = os.path.join(d, "compare.txt")
    with open(lst, "w") as f:
        f.write("".join(p + "\n" for p in data["panels"] + data["metas"] + data["strains"]))
    got = {}
    for threads in (1, 4):
        out = io.StringIO()
        with env(STRAINER2_COMPARE_THREADS=threads):
            run_genome_compare(data["strains"][0], b_list=lst, cfg=CompareConfig(device="cpu"),
                               out=out)
        got[threads] = out.getvalue()
    assert got[1] == got[4] and got[1].count("\n") == 10, "compare pool differs"
    print("compare pool (NativeComparer.score): ok", flush=True)


def stress_fused(data: dict) -> None:
    from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_multi_pipeline, run_pipeline

    d = data["d"]
    lists = [os.path.join(d, f"{n}.txt") for n in ("A", "B", "T")]
    cfg = FusedConfig(device="cpu", min_fraction=0.05)
    got = {}
    for threads in (1, 4):
        with env(STRAINER2_DETECT_THREADS=threads, STRAINER2_COUNT_THREADS=threads,
                 STRAINER2_STRAIN_THREADS=threads):
            one = run_pipeline(data["strains"][0], *lists, os.path.join(d, f"fused{threads}"),
                               fused_cfg=cfg, stdout=io.StringIO(), err=io.StringIO(),
                               progress=io.StringIO())
            many = run_multi_pipeline(data["strains"], *lists, os.path.join(d, f"fm{threads}"),
                                      fused_cfg=cfg, stdout=io.StringIO(), err=io.StringIO(),
                                      progress=io.StringIO())
        got[threads] = [_gz(one["hits"])] + [_gz(paths["hits"]) for paths in many]
    assert got[1] == got[4] and got[1][0] == got[1][1], "fused pools differ"
    print("fused pools (pipeline, pipeline-multi): ok", flush=True)


def stress_build_and_prefetch(data: dict, rng) -> None:
    from strainer2_tpu_torch.native import NativePackStream, build_bucket_native
    from strainer2_tpu_torch.utils.prefetch import prefetch

    codes = np.unique(rng.integers(0, 1 << 62, size=300_000, dtype=np.uint64))
    h_bits = max(4, int(np.ceil(np.log2(codes.size / 3.3))))
    out = build_bucket_native(codes, K, h_bits, 0)
    assert out is not None and out != "retry"
    n = sum(b.n_reads for b in prefetch(iter(NativePackStream(
        data["metas"], K, 16, 1024, with_read_ids=True)), depth=2))
    assert n == 3 * 600, n
    print("multi-thread bucket build, prefetch-thread pack stream: ok", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from strainer2_tpu_torch import native

    torch.set_num_threads(1)
    if not native.available():
        print(f"FAIL: host library unavailable: {native.build_error}", flush=True)
        return 1
    print(f"host library: {os.environ.get('STRAINER2_TORCH_HOST_LIB') or native.library_path()}",
          flush=True)
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="tsan_stress_") as d, \
            env(STRAINER2_NATIVE_COUNT=None):
        data = make_data(d, rng)
        stress_sample_pool(data)
        stress_multi_pool(data)
        stress_count_pool(data)
        stress_device_feeder(data)
        stress_compare_pool(data)
        stress_fused(data)
        stress_build_and_prefetch(data, rng)
    print("ALL STRESSES PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
