"""The port's CLIs on the JAX package's cuckoo artifacts, and the cuckoo
kernels' filtered probe, on the CPU.

Off the TPU the JAX CLIs build cuckoo tables (``default_layout``), so the
index caches and scrub checkpoints they write there are cuckoo.  The
port's CLIs take the layout of what is on disk: a cache in its npz's own
layout, a checkpoint in the layout whose table for the strain has as many
slots as its stored counts.  Here the JAX CLIs write each artifact, and
the port's CLIs (``--device cpu``) reuse the cache unwritten and resume
the checkpoints (``kmer_scrub_count``, ``pipeline``, ``scrub-multi``),
each output equal to the JAX CLI's and the goldens.  A size that both
layouts' tables can have reads as bucket.

The cuckoo kernels read a table slot only where a byte of the table's
fingerprint array equals the query's fingerprint.  Its plain version and
a torch emulation of that probe are held to ``cuckoo_lookup_plain`` and
the JAX ``cuckoo_lookup`` (found, slot) at k = 31 and 32 (poly-A and
poly-T windows, the empty-slot sentinel, included) and on queries chosen
so that their fingerprints collide with their slots'.  Every comparison
is exact."""

import contextlib
import gzip
import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strainer2_tpu.index.cuckoo as j_cuckoo
from strainer2_tpu.cli.kmer_scrub_count import main as jax_scrub_main
from strainer2_tpu.cli.strain_detect import main as jax_detect_main
from strainer2_tpu.cli.strainer2_tools import main as jax_tools_main
from strainer2_tpu.index.build import StrainIndex as JaxIndex
from strainer2_tpu.ops.lookup import cuckoo_lookup as jax_cuckoo_lookup
from strainer2_tpu.pipeline.engine import KmerEngine
from strainer2_tpu_torch.cli.kmer_scrub_count import main as scrub_main
from strainer2_tpu_torch.cli.strain_detect import main as detect_main
from strainer2_tpu_torch.cli.strainer2_tools import main as tools_main
from strainer2_tpu_torch.index import cuckoo as t_cuckoo
from strainer2_tpu_torch.index.build import StrainIndex, layout_of_counts, table_slots
from strainer2_tpu_torch.index.hashing import cuckoo_slots
from strainer2_tpu_torch.ops import lookup as L
from strainer2_tpu_torch.ops.packing_np import canonical_codes_np, split_code64_np
from strainer2_tpu_torch.pipeline import scrub_count as sc
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
SMALL = ["--rows", "8", "--row-len", "1024"]  # both packages' hidden batch-geometry flags
STRAIN = "data/strainA.fna.gz"
SCRUB = ["-r", STRAIN, "-A", "data/genomes.txt", "-B", "data/metagenomes.txt"]
FIRST_FILE = ["-r", STRAIN, "-A", "first.txt", "-B", "none.txt"]  # the -A panel's first file
DETECT = ["-r", STRAIN, "-a", "expected/scrubbed_m05.txt", "-B", "data/targets.txt"]


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


def _read(path, gz: bool = False) -> bytes:
    with (gzip.open if gz else open)(path, "rb") as f:
        return f.read()


@pytest.fixture
def data(tmp_path, monkeypatch):
    """A copy of the mini data (the checkpointed runs write beside it),
    with list files of the -A panel's first file and of nothing."""
    shutil.copytree(os.path.join(MINI, "data"), tmp_path / "data")
    shutil.copytree(os.path.join(MINI, "expected"), tmp_path / "expected")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "first.txt").write_text("data/panel1.fna.gz\n")
    (tmp_path / "none.txt").write_text("")
    return tmp_path


def _cli(main, argv, stdout_path) -> str:
    """Run a CLI's main in this process, its stdout into a file; returns
    its stderr and fails on a non-zero exit."""
    err = io.StringIO()
    with open(stdout_path, "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc in (0, None), err.getvalue()
    return err.getvalue()


@pytest.fixture
def counted(monkeypatch):
    """The (path, layout) of every panel file the port counts: the scrub
    panels and detection's background panel."""
    from strainer2_tpu_torch.pipeline import detect

    seen = []
    real = sc.count_panel_file

    def recording(engine, index, counts, path, *a):
        assert engine.layout == index.layout
        seen.append((path, index.layout))
        return real(engine, index, counts, path, *a)

    monkeypatch.setattr(sc, "count_panel_file", recording)
    monkeypatch.setattr(detect, "count_panel_file", recording)
    return seen


# ---- Part A: the layout of what is on disk -------------------------------------

def test_strain_detect_cli_reuses_jax_cli_index_cache(data, monkeypatch):
    """strain_detect --index-cache: the JAX CLI writes a cuckoo npz; the
    port's CLI reuses it (no genome scan, the file's bytes and mtime
    unchanged) and writes the JAX CLI's and the golden hits and stdout."""
    from strainer2_tpu_torch.pipeline import detect

    cache = str(data / "index.npz")
    _cli(jax_detect_main, DETECT + ["-o", "jax.gz", "--index-cache", cache] + SMALL, "jax.out")
    assert JaxIndex.load(cache).layout == StrainIndex.load(cache).layout == "cuckoo"
    before, mtime = _read(cache), os.stat(cache).st_mtime_ns

    def no_scan(*a, **kw):
        raise AssertionError("the cache was not reused")

    monkeypatch.setattr(detect.StrainIndex, "from_fasta", no_scan)
    _cli(detect_main, DETECT + ["-o", "ours.gz", "--index-cache", cache, "--device", "cpu"]
         + SMALL, "ours.out")
    assert _read(cache) == before and os.stat(cache).st_mtime_ns == mtime
    assert _read("ours.gz", gz=True) == _read("jax.gz", gz=True) == expected("kmer_hits.txt")
    assert _read("ours.out") == _read("jax.out") == expected("detect_stdout.txt")


def test_kmer_scrub_count_cli_resumes_jax_cli_checkpoint(data, counted):
    """kmer_scrub_count --checkpoint: the JAX CLI counts the -A panel's
    first file into a cuckoo checkpoint; the port's CLI, given the whole
    panels, resumes it in the cuckoo layout, counting only the other files,
    to the JAX CLI's and the golden table."""
    _cli(jax_scrub_main, FIRST_FILE + ["--checkpoint", "ck"] + SMALL, "first.out")
    stored = np.load("ck/counts_1.npy")
    assert stored.shape == (table_slots(1287, "cuckoo"),) and stored.any()
    _cli(scrub_main, SCRUB + ["--checkpoint", "ck", "--device", "cpu"] + SMALL, "ours.out")
    _cli(jax_scrub_main, SCRUB + SMALL, "jax.out")
    assert counted == [("data/panel2.fna", "cuckoo"), ("data/scrubmeta1.fasta.gz", "cuckoo")]
    assert _read("ours.out") == _read("jax.out") == expected("scrub_counts.tsv")


def test_pipeline_cli_resumes_jax_cli_checkpoint(data, counted):
    """pipeline --checkpoint: the JAX CLI's run leaves a cuckoo scrub
    checkpoint of the -A panel's first file (its detect checkpoint removed,
    as a run killed in the panel scan leaves none); the port's pipeline
    resumes it in the cuckoo layout, scan and detection, to every artifact
    of the JAX CLI's uninterrupted run and the golden hits."""
    rest = ["-T", "data/targets.txt", "-m", "0.05", "-g", "data/background.txt"]
    _cli(jax_tools_main, ["pipeline"] + FIRST_FILE + rest + ["-o", "first", "--checkpoint", "ck"],
         "first.out")
    shutil.rmtree("ck/detect")
    assert np.load("ck/scrub/counts_1.npy").shape == (table_slots(1287, "cuckoo"),)
    _cli(tools_main, ["pipeline"] + SCRUB + rest + ["-o", "ours", "--checkpoint", "ck",
                                                    "--device", "cpu"], "ours.out")
    _cli(jax_tools_main, ["pipeline"] + SCRUB + rest + ["-o", "jax"], "jax.out")
    # the panels' files not recorded, then detection's background panel
    assert counted == [("data/panel2.fna", "cuckoo"), ("data/scrubmeta1.fasta.gz", "cuckoo"),
                       ("data/background1.fasta.gz", "cuckoo")]
    for name in sorted(os.listdir("jax")):
        gz = name.endswith(".gz")
        assert _read(f"ours/{name}", gz) == _read(f"jax/{name}", gz), name
    assert _read("ours/strainA.kmer_hits.gz", gz=True) == expected("kmer_hits_bg.txt")
    assert _read("ours.out") == _read("jax.out")


def test_scrub_multi_cli_resumes_jax_cli_checkpoint(data, counted):
    """scrub-multi --checkpoint: the union counts of two strains, the -A
    panel's first file counted by the JAX CLI in the cuckoo layout, resume
    in the port to the JAX CLI's uninterrupted tables."""
    (data / "r.txt").write_text("data/strainA.fna.gz\ndata/drug1.fna.gz\n")
    multi = ["scrub-multi", "-R", "r.txt"]
    _cli(jax_tools_main, multi + ["-A", "first.txt", "-B", "none.txt", "-o", "first",
                                  "--checkpoint", "ck"], "first.out")
    _cli(tools_main, multi + SCRUB[2:] + ["-o", "ours", "--checkpoint", "ck", "--device", "cpu"],
         "ours.out")
    _cli(jax_tools_main, multi + SCRUB[2:] + ["-o", "jax"], "jax.out")
    assert counted == [("data/panel2.fna", "cuckoo"), ("data/scrubmeta1.fasta.gz", "cuckoo")]
    assert sorted(os.listdir("ours")) == sorted(os.listdir("jax"))
    for name in os.listdir("jax"):
        assert _read(f"ours/{name}", name.endswith(".gz")) == _read(f"jax/{name}",
                                                                    name.endswith(".gz"))


def test_table_sizes_of_the_two_layouts():
    """``table_slots`` is each builder's size at its default h_bits, and the
    two default sizes never meet: the bucket table has 2, 4 or 8 times the
    cuckoo table's slots, whatever the key count."""
    rng = np.random.default_rng(11)
    for n in (1, 13, 14, 52, 53, 54, 1287, 5000, 40_000):
        codes = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))
        while codes.size < n:
            codes = np.unique(np.concatenate([codes, rng.integers(0, 1 << 62, n, dtype=np.uint64)]))
        codes = codes[:n]
        for layout in ("bucket", "cuckoo"):
            ix = StrainIndex(k=31, codes=codes, genome_counts=np.ones(n, np.uint32),
                             layout_=layout)
            assert ix.table.num_slots == table_slots(n, layout), (n, layout)
    for n in list(range(1, 20_000)) + [int(x) for x in np.logspace(4.3, 9.5, 4000)]:
        ratio = table_slots(n, "bucket") / table_slots(n, "cuckoo")
        assert ratio in (2, 4, 8), n
        assert layout_of_counts(n, table_slots(n, "bucket")) == "bucket"
        assert layout_of_counts(n, table_slots(n, "cuckoo")) == "cuckoo"
    assert layout_of_counts(1287, 2 * table_slots(1287, "bucket")) is None


def test_checkpoint_size_tie_reads_as_bucket(data, counted):
    """The one way both layouts' tables have one size: a cuckoo table that
    its builder grew (its tries failed) to the bucket table's size.  Such
    counts cannot say their layout, and read as bucket: a bucket
    checkpoint of that size from the JAX package resumes in the port's
    bucket layout to the golden table."""
    from strainer2_tpu.pipeline import scrub_count as jsc

    n = 1287  # the mini strain's k-mers
    grown = j_cuckoo.build_cuckoo(JaxIndex.from_fasta(STRAIN, KmerEngine(31)).codes, 31,
                                  h_bits=12)
    assert grown.num_slots == table_slots(n, "bucket") == 2 * table_slots(n, "cuckoo")
    assert layout_of_counts(n, grown.num_slots) == "bucket"
    index = JaxIndex.from_fasta(STRAIN, KmerEngine(31, layout="bucket"))
    jsc.run_scrub_count(STRAIN, "first.txt", "none.txt", out=io.StringIO(), index=index,
                        checkpoint_dir="ck")
    assert np.load("ck/counts_1.npy").shape == (grown.num_slots,)
    _cli(scrub_main, SCRUB + ["--checkpoint", "ck", "--device", "cpu"] + SMALL, "ours.out")
    assert counted == [("data/panel2.fna", "bucket"), ("data/scrubmeta1.fasta.gz", "bucket")]
    assert _read("ours.out") == expected("scrub_counts.tsv")


# ---- Part B: the fingerprint filter --------------------------------------------

def _fingerprint_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """The kernels' fingerprint in numpy uint32 arithmetic."""
    with np.errstate(over="ignore"):
        x = (hi * np.uint32(0x2C1B3C6D)) ^ (lo * np.uint32(0x297A2D39)) ^ np.uint32(0x61C88647)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return (x >> np.uint32(24)).astype(np.uint8)


def _table_and_queries(k: int, seed: int):
    """A cuckoo table of a random genome's k-mers, its keys, and queries:
    present keys, random codes, poly-A (0) and poly-T (all ones: at k = 32
    the empty sentinel), as (table, keys, qhi, qlo)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 40_000, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, k)
    keys = np.unique(codes[valid])
    t = t_cuckoo.build_cuckoo(keys, k)
    top = (1 << (2 * k)) - 1
    q = np.concatenate([keys[rng.integers(0, keys.size, 4000)],
                        rng.integers(0, top, 20_000, dtype=np.uint64),
                        np.array([0, top], dtype=np.uint64)])
    return t, keys, *split_code64_np(q, k)


def _three_ways(t, qhi, qlo, fp):
    """(found, slot) of the filtered emulation, the plain lookup and the JAX
    cuckoo_lookup, and the emulation's table reads."""
    table = torch.from_numpy(t.table)
    qh, ql = torch.from_numpy(qhi), torch.from_numpy(qlo)
    f_found, f_slot, reads = L.cuckoo_lookup_filtered_plain(table, fp, t.h_bits, t.salt, qh, ql)
    p_found, p_slot = L.cuckoo_lookup_plain(table, t.h_bits, t.salt, qh, ql)
    j_found, j_slot = jax_cuckoo_lookup(jnp.asarray(t.table), t.h_bits, t.salt, jnp.asarray(qhi),
                                        jnp.asarray(qlo))
    np.testing.assert_array_equal(f_found.numpy(), p_found.numpy())
    np.testing.assert_array_equal(f_slot.numpy(), p_slot.numpy())
    np.testing.assert_array_equal(f_found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(f_slot.numpy(), np.asarray(j_slot))
    return f_found.numpy(), f_slot.numpy(), reads


def test_cuckoo_fingerprints_plain_matches_numpy():
    """cuckoo_fingerprints_plain is the kernels' hash, byte for byte, on a
    built table (empty slots: the sentinel's byte) and on random words."""
    t, _, _, _ = _table_and_queries(31, 1)
    words = np.random.default_rng(2).integers(0, 2**32, (5000, 2), dtype=np.uint64)
    for table in (t.table, words.astype(np.uint32)):
        fp = L.cuckoo_fingerprints(torch.from_numpy(table))  # the CPU runs the plain version
        assert fp.dtype == torch.uint8 and fp.shape == (table.shape[0],)
        np.testing.assert_array_equal(fp.numpy(), _fingerprint_np(table[:, 0], table[:, 1]))
    empty = t.table[:, 0] == 0xFFFFFFFF
    assert len(set(_fingerprint_np(t.table[empty, 0], t.table[empty, 1]))) == 1


@pytest.mark.parametrize("k", [31, 32])
def test_filtered_probe_matches_plain_and_jax(k):
    """The filtered probe equals the plain and the JAX lookup on present,
    absent, poly-A and poly-T queries; it reads the table at the slots
    whose fingerprint matched, a hit's and about one in 256 probed slots
    besides; at k = 32 the poly-T window is found at an empty slot."""
    t, _, qhi, qlo = _table_and_queries(k, 10 + k)
    fp = L.cuckoo_fingerprints_plain(torch.from_numpy(t.table))
    found, slot, reads = _three_ways(t, qhi, qlo, fp)
    assert found[:4000].all()
    false_reads = reads - int(found.sum())
    assert 0 < false_reads / (2 * qhi.size) < 3 / 256
    at_empty = bool((t.table[slot[-1]] == 0xFFFFFFFF).all())
    assert bool(found[-1]) == (k == 32 and at_empty)


@pytest.mark.parametrize("k", [31, 32])
def test_filtered_probe_on_forced_fingerprint_collisions(k):
    """Queries chosen so that their fingerprint equals a slot's: absent keys
    that match at s0, at s1 or at both (every one a table read that must
    miss), and a hand-built table with keys in both of their slots and
    keys in slot s1 alone: found and slot equal the plain and the JAX
    lookup's, and each forced match is one read."""
    t, keys, _, _ = _table_and_queries(k, 20 + k)
    rng = np.random.default_rng(30 + k)
    table = t.table.copy()
    h = table.shape[0] // 2

    def slots(qhi, qlo):
        sh = qhi ^ np.uint32(t.salt) if t.salt else qhi
        return (cuckoo_slots(sh, qlo, t.h_bits, 0).astype(np.int64),
                cuckoo_slots(sh, qlo, t.h_bits, 1).astype(np.int64) + h)

    # keys of the table written into their other, empty slot too, and keys
    # moved from slot s0 to slot s1
    hi, lo = table[t.slot_of_key, 0], table[t.slot_of_key, 1]
    s0, s1 = slots(hi, lo)
    free1 = np.flatnonzero((t.slot_of_key == s0) & (table[s1, 0] == 0xFFFFFFFF))
    free1 = np.sort(free1[np.unique(s1[free1], return_index=True)[1]])  # one key a free slot
    both, moved = free1[:200], free1[200:400]
    table[s1[both]] = table[s0[both]]
    table[s1[moved]] = table[s0[moved]]
    table[s0[moved]] = 0xFFFFFFFF
    fp = L.cuckoo_fingerprints_plain(torch.from_numpy(table)).numpy()
    # absent codes whose fingerprint collides with one or both of their slots'
    cand = rng.integers(0, (1 << (2 * k)) - 1, 600_000, dtype=np.uint64)
    cand = cand[~np.isin(cand, keys)]
    chi, clo = split_code64_np(cand, k)
    c0, c1 = slots(chi, clo)
    f = _fingerprint_np(chi, clo)
    m0, m1 = fp[c0] == f, fp[c1] == f
    assert (m0 & m1).any() and (m0 & ~m1).any() and (m1 & ~m0).any()
    pick = np.flatnonzero(m0 | m1)
    qhi = np.concatenate([chi[pick], hi[both], hi[moved]])
    qlo = np.concatenate([clo[pick], lo[both], lo[moved]])
    q0, q1 = slots(qhi, qlo)
    fq = _fingerprint_np(qhi, qlo)
    tb = t_cuckoo.CuckooTable(table, t.slot_of_key, t.h_bits, t.salt)
    found, slot, reads = _three_ways(tb, qhi, qlo, torch.from_numpy(fp))
    assert reads == int((fp[q0] == fq).sum() + (fp[q1] == fq).sum())
    n = pick.size
    assert not found[:n].any() and found[n:].all()
    assert (slot[n : n + both.size] == s0[both]).all() and (slot[n + both.size :] == s1[moved]).all()


def test_engine_keeps_fingerprints_beside_the_table(monkeypatch):
    """TorchKmerEngine makes a cuckoo table's fingerprints once, when
    table_for uploads it, and the count step reads them there; a bucket
    engine makes none."""
    made = []
    real = L.cuckoo_fingerprints

    def recording(table):
        made.append(table)
        return real(table)

    from strainer2_tpu_torch.pipeline import engine as E

    monkeypatch.setattr(E, "cuckoo_fingerprints", recording)
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 20_000, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, 31)
    tables = {}
    for layout in ("cuckoo", "bucket"):
        index = StrainIndex.from_scan_codes(codes[valid], 31, layout=layout)
        eng = TorchKmerEngine(31, device="cpu", layout=layout)
        tables[layout] = eng.table_for(index)
        assert eng.table_for(index) is tables[layout]
        bases = np.stack([genome[:1024], rng.integers(0, 4, 1024, dtype=np.uint8)])
        counts = eng.count_batch(eng.init_counts(index), tables[layout], index.table.h_bits,
                                 index.table.salt, bases)
        assert int(counts.view(torch.int32).sum()) == 1024 - 31 + 1
    assert len(made) == 1 and made[0] is tables["cuckoo"]


def test_bench_counts_the_filtered_probe():
    """tools/bench_kernels.py's copy of the fingerprint is the kernels', and
    its FilterStats count the table reads of the emulated probe: the bytes
    of the filtered bound."""
    from strainer2_tpu_torch.tools import bench_kernels as B

    t, _, qhi, qlo = _table_and_queries(31, 5)
    table = torch.from_numpy(t.table)
    words = table.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(B.fingerprints(words[:, 0], words[:, 1]),
                       L.cuckoo_fingerprint_plain(words[:, 0], words[:, 1]))
    qh, ql = torch.from_numpy(qhi), torch.from_numpy(qlo)
    found, _, reads = L.cuckoo_lookup_filtered_plain(table, L.cuckoo_fingerprints_plain(table),
                                                     t.h_bits, t.salt, qh, ql)
    st = B.filter_stats(table, t.h_bits, t.salt, qh, ql)
    assert (st.probes, st.hits, st.matched, st.slots) == (qh.numel(), int(found.sum()), reads,
                                                         t.num_slots)
    assert B.fp_bytes(st) == min(t.num_slots, 64 * qh.numel()) + 32 * reads
    assert 0 < st.false_match < 3 / 256
