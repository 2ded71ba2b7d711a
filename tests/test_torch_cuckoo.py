"""The port's cuckoo layout on the CPU against the JAX package's: the host
builders (native and Python, a forced retry with a non-zero salt; the
native entry point itself is pinned in tests/test_torch_host.py), the
plain two-probe lookup against jnp ``cuckoo_lookup``, the five cuckoo
programs through ``TorchKmerEngine(layout="cuckoo")`` against
``KmerEngine(k, layout="cuckoo")``, a hand-built table holding a key in
both of its slots, the index npz across packages, a JAX scrub checkpoint
(cuckoo geometry) refused by a bucket run and resumed by a cuckoo one,
strain_detect on a JAX-written cuckoo ``--index-cache``, genome_compare
and strain-track in the cuckoo layout against the mini goldens, and the
multi-strain engine's refusal of a cuckoo engine.  Batches are 8 x 1024;
every value is an integer, so every comparison is exact.

At k = 32 a poly-A or poly-T window codes as the empty-slot sentinel
(0xFFFFFFFF in both halves), so both packages find it at an empty slot:
the batches hold such a run and the port must give the JAX answer."""

import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strainer2_tpu.index.cuckoo as j_cuckoo
import strainer2_tpu.native as j_native
import strainer2_tpu_torch.index.cuckoo as t_cuckoo
import strainer2_tpu_torch.native as t_native
from strainer2_tpu.index.build import StrainIndex as JaxIndex
from strainer2_tpu.ops.lookup import cuckoo_lookup as jax_cuckoo_lookup
from strainer2_tpu.pipeline.engine import KmerEngine
from strainer2_tpu_torch.index.build import StrainIndex
from strainer2_tpu_torch.index.hashing import cuckoo_slots
from strainer2_tpu_torch.io.batches import max_reads_capacity
from strainer2_tpu_torch.ops import lookup as L
from strainer2_tpu_torch.ops.packing_np import canonical_codes_np, split_code64_np
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
from tests.test_torch_kernels import SELECT_CASES, select_case
from tests.test_torch_lookup import check_selection, jax_emission

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
SCRUB_ARGS = ("data/strainA.fna.gz", "data/genomes.txt", "data/metagenomes.txt")
ROWS, ROW_LEN = 8, 1024


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


@pytest.fixture
def mini(monkeypatch):
    monkeypatch.chdir(MINI)


def _genome_keys(rng, k, n_bases=30_000):
    genome = rng.integers(0, 4, n_bases, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, k)
    return genome, np.unique(codes[valid])


def _poly_t_batch(rng, genome, k):
    """8 x 1024 rows: every other one from the genome, 2% N, the second
    row a run of 100 T: at k = 32 the sentinel window."""
    bases = rng.integers(0, 4, (ROWS, ROW_LEN), dtype=np.uint8)
    for r in range(0, ROWS, 2):
        s = int(rng.integers(0, genome.size - ROW_LEN))
        bases[r] = genome[s : s + ROW_LEN]
    bases[rng.random(bases.shape) < 0.02] = 4
    bases[1, 300:400] = 3
    bases[-1] = 4
    return bases


# ---- the host builders ---------------------------------------------------------

@pytest.mark.parametrize("retry", [False, True], ids=["fits", "retried"])
@pytest.mark.parametrize("builder", ["native", "python"])
def test_build_cuckoo_matches_jax(builder, retry, monkeypatch):
    """Table, slot_of_key, h_bits and salt equal the JAX build's; a tiny
    h_bits forces failed tries, a grown table and a non-zero salt."""
    rng = np.random.default_rng(3)
    codes = np.unique(rng.integers(0, 1 << 62, 1000 if retry else 5000, dtype=np.uint64))
    if builder == "python":
        monkeypatch.setattr(t_native, "build_cuckoo_native", lambda *a: None)
        monkeypatch.setattr(j_native, "build_cuckoo_native", lambda *a: None)
    h_bits = 9 if retry else None
    ours = t_cuckoo.build_cuckoo(codes, 31, h_bits=h_bits)
    theirs = j_cuckoo.build_cuckoo(codes, 31, h_bits=h_bits)
    np.testing.assert_array_equal(ours.table, theirs.table)
    np.testing.assert_array_equal(ours.slot_of_key, theirs.slot_of_key)
    assert (ours.h_bits, ours.salt) == (theirs.h_bits, theirs.salt)
    assert (ours.salt != 0) == retry and ours.num_slots == 2 << ours.h_bits
    hi, lo = split_code64_np(codes, 31)
    np.testing.assert_array_equal(ours.table[ours.slot_of_key], np.stack([hi, lo], axis=1))


# ---- the two-probe lookup --------------------------------------------------------

@pytest.mark.parametrize("k", [20, 31, 32])
def test_cuckoo_lookup_plain_matches_jax(k):
    """Present, absent and (k = 32) poly-A / poly-T queries, in a table
    built with a non-zero salt: found and slot equal jnp cuckoo_lookup's
    everywhere (slot s1 where not found)."""
    rng = np.random.default_rng(k)
    _, keys = _genome_keys(rng, k)
    t = t_cuckoo.build_cuckoo(keys, k, h_bits=13)
    assert t.salt != 0
    top = (1 << (2 * k)) - 1
    q = np.concatenate([keys[rng.integers(0, keys.size, 3000)],
                        rng.integers(0, top, 3000, dtype=np.uint64),
                        np.array([0, top], dtype=np.uint64)])  # poly-A, poly-T
    qhi, qlo = split_code64_np(q, k)
    found, slot = L.cuckoo_lookup_plain(torch.from_numpy(t.table), t.h_bits, t.salt,
                                        torch.from_numpy(qhi), torch.from_numpy(qlo))
    j_found, j_slot = jax_cuckoo_lookup(jnp.asarray(t.table), t.h_bits, t.salt,
                                        jnp.asarray(qhi), jnp.asarray(qlo))
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    assert found[:3000].all() and 0 < int(found.sum()) < q.size
    # the sentinel is found where one of its slots is empty, at k = 32 only
    at_empty = bool((t.table[int(slot[-1])] == 0xFFFFFFFF).all())
    assert bool(found[-1]) == (k == 32 and at_empty)


# ---- the five programs through the engine ---------------------------------------

@pytest.fixture(params=[20, 31, 32], ids=lambda k: f"k{k}")
def programs(request):
    """A cuckoo table of a random genome (salted: built at a small h_bits),
    a batch with a poly-T run, read boundaries and a class array, and both
    packages' cuckoo engines."""
    k = request.param
    rng = np.random.default_rng(100 + k)
    genome, keys = _genome_keys(rng, k)
    t = t_cuckoo.build_cuckoo(keys, k, h_bits=13)
    bases = _poly_t_batch(rng, genome, k)
    max_reads = max_reads_capacity(k, ROWS, ROW_LEN)
    q = ROWS * (ROW_LEN - k + 1)
    bounds = np.sort(rng.integers(0, q, max_reads + 1)).astype(np.int32)
    bounds[-1] = q
    meta = np.zeros(t.num_slots, dtype=np.uint32)
    meta[t.slot_of_key] = rng.integers(1, 3, t.slot_of_key.size)
    eng = TorchKmerEngine(k, max_reads, device="cpu", layout="cuckoo")
    j_eng = KmerEngine(k, max_reads, layout="cuckoo")
    j_table = (jnp.asarray(np.ascontiguousarray(t.table[:, 0])),
               jnp.asarray(np.ascontiguousarray(t.table[:, 1])))
    return dict(k=k, t=t, bases=bases, bounds=bounds, meta=meta, eng=eng, j_eng=j_eng,
                j_table=j_table, table=torch.from_numpy(t.table))


def test_cuckoo_count_programs_match_jax(programs):
    """count_batch and count_batch_with_valid (two batches into one
    count buffer and one tally) against the JAX engine's."""
    p = programs
    t, eng, j_eng = p["t"], p["eng"], p["j_eng"]
    b2 = np.roll(p["bases"], 1, axis=0)
    counts = eng.init_counts(StrainIndex(p["k"], np.zeros(1, np.uint64), np.zeros(1, np.uint32),
                                         table_=t))
    assert counts.shape == (2 << t.h_bits,)
    j_counts = jnp.zeros(t.num_slots, dtype=jnp.uint32)
    for b in (p["bases"], b2):
        counts = eng.count_batch(counts, p["table"], t.h_bits, t.salt, b)
        j_counts = j_eng.count_batch(j_counts, p["j_table"], t.h_bits, t.salt, b)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert int(counts.view(torch.int32).sum()) > 0

    counts = torch.zeros(t.num_slots, dtype=torch.uint32)
    tally = eng.init_valid_tally(ROWS, ROW_LEN)
    j_counts, j_valid = jnp.zeros(t.num_slots, dtype=jnp.uint32), 0
    for b in (p["bases"], b2):
        counts = eng.count_batch_with_valid(counts, tally, p["table"], t.h_bits, t.salt, b)
        j_counts, v = j_eng.count_batch_with_valid(j_counts, p["j_table"], t.h_bits, t.salt, b)
        j_valid += int(v)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert eng.valid_total(tally) == j_valid > 0


def test_cuckoo_classify_program_matches_jax(programs):
    """classify_batch with the slot-indexed class array: per-read sums."""
    p = programs
    t = p["t"]
    tot, inf = p["eng"].classify_batch(p["table"], t.h_bits, t.salt, p["bases"], p["bounds"],
                                       meta=torch.from_numpy(p["meta"]))
    j_tot, j_inf = p["j_eng"].classify_batch(p["j_table"], jnp.asarray(p["meta"]), t.h_bits,
                                             t.salt, p["bases"], p["bounds"])
    np.testing.assert_array_equal(tot.numpy(), np.asarray(j_tot))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(j_inf))
    assert int(inf.sum()) > 0
    with pytest.raises(ValueError, match="meta"):
        p["eng"].classify_batch(p["table"], t.h_bits, t.salt, p["bases"], p["bounds"])


def test_cuckoo_hit_programs_match_jax(programs):
    """hit_accumulate (int64 lanes against the JAX int32 ones) and
    hit_stats at remaining 0, 1, the batch's valid total and one past."""
    p = programs
    t, eng, j_eng = p["t"], p["eng"], p["j_eng"]
    acc = eng.hit_accumulate(eng.init_accumulator(), p["table"], t.h_bits, t.salt, p["bases"])
    j_acc = j_eng.hit_accumulate(jnp.zeros(2, dtype=jnp.int32), p["j_table"], t.h_bits, t.salt,
                                 p["bases"])
    assert acc.tolist() == [int(x) for x in j_acc] and 0 < acc[0] < acc[1]
    total = int(acc[1])
    for rem in (0, 1, total, total + 1):
        got = eng.hit_stats(p["table"], t.h_bits, t.salt, p["bases"], rem).tolist()
        want = j_eng.hit_stats(p["j_table"], t.h_bits, t.salt, p["bases"], jnp.int32(rem))
        assert got == [int(x) for x in want], rem


def test_cuckoo_key_in_both_slots_matches_jax(programs):
    """A built table where a share of the keys held in slot s0 is also
    written into its empty slot s1, with the other class there: found,
    slot (s0) and the per-read sums (the class read is meta[s0], one word,
    never the bucket lookups' sum) equal the JAX package's."""
    p = programs
    t, k = p["t"], p["k"]
    table, meta = t.table.copy(), p["meta"].copy()
    hi, lo = table[t.slot_of_key, 0], table[t.slot_of_key, 1]
    sh = hi ^ np.uint32(t.salt)
    s0 = cuckoo_slots(sh, lo, t.h_bits, 0).astype(np.int64)
    s1 = cuckoo_slots(sh, lo, t.h_bits, 1).astype(np.int64) + table.shape[0] // 2
    rng = np.random.default_rng(k)
    pick = np.flatnonzero((t.slot_of_key == s0) & (table[s1, 0] == 0xFFFFFFFF)
                          & (rng.random(s0.size) < 0.5))
    table[s1[pick]] = table[s0[pick]]
    meta[s1[pick]] = 3 - meta[s0[pick]]
    assert pick.size > 100
    found, slot = L.cuckoo_lookup_plain(torch.from_numpy(table), t.h_bits, t.salt,
                                        torch.from_numpy(hi), torch.from_numpy(lo))
    j_found, j_slot = jax_cuckoo_lookup(jnp.asarray(table), t.h_bits, t.salt, jnp.asarray(hi),
                                        jnp.asarray(lo))
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    assert found.all() and (slot.numpy()[pick] == s0[pick]).all()
    j_table = (jnp.asarray(np.ascontiguousarray(table[:, 0])),
               jnp.asarray(np.ascontiguousarray(table[:, 1])))
    tot, inf = p["eng"].classify_batch(torch.from_numpy(table), t.h_bits, t.salt, p["bases"],
                                       p["bounds"], meta=torch.from_numpy(meta))
    j_tot, j_inf = p["j_eng"].classify_batch(j_table, jnp.asarray(meta), t.h_bits, t.salt,
                                             p["bases"], p["bounds"])
    np.testing.assert_array_equal(tot.numpy(), np.asarray(j_tot))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(j_inf))


def test_multi_strain_engine_refuses_cuckoo():
    """The multi-strain classify (K6, K7) runs on bucket rows only, as the
    JAX multi-strain detector forces it."""
    eng = TorchKmerEngine(31, 100, device="cpu", layout="cuckoo")
    bases = np.zeros((2, 64), dtype=np.uint8)
    rows = torch.zeros((16, 64), dtype=torch.uint32)
    with pytest.raises(ValueError, match="bucket"):
        eng.hit_words_batch(rows, 4, 0, bases, 16)
    with pytest.raises(ValueError, match="bucket"):
        eng.classify_multi_batch(rows, 4, 0, bases, np.zeros(101, np.int32), 16)
    with pytest.raises(ValueError, match="layout"):
        TorchKmerEngine(31, device="cpu", layout="sharded")


# ---- the index across packages ---------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cuckoo_index_npz_across_packages(mini, tmp_path, direction):
    """A cuckoo index saved by one package loads in the other as a cuckoo
    index with the same keys, table and slots; a file with no layout
    entry is read as cuckoo by both."""
    path = str(tmp_path / "ix.npz")
    ours = StrainIndex.from_fasta("data/strainA.fna.gz", TorchKmerEngine(31, device="cpu",
                                                                       layout="cuckoo"))
    theirs = JaxIndex.from_fasta("data/strainA.fna.gz", KmerEngine(31, layout="cuckoo"))
    (theirs if direction == "jax_to_torch" else ours).save(path)
    back = (StrainIndex if direction == "jax_to_torch" else JaxIndex).load(path)
    assert back.layout == "cuckoo" and type(back.table).__name__ == "CuckooTable"
    for a in (ours, theirs):
        np.testing.assert_array_equal(back.codes, a.codes)
        np.testing.assert_array_equal(back.table.table, a.table.table)
        np.testing.assert_array_equal(back.table.slot_of_key, a.table.slot_of_key)
        assert (back.table.h_bits, back.table.salt) == (a.table.h_bits, a.table.salt)
    z = dict(np.load(path))
    del z["layout"]
    np.savez(str(tmp_path / "old.npz"), **z)
    assert StrainIndex.load(str(tmp_path / "old.npz")).layout == "cuckoo"


# ---- the scrub checkpoint's geometry ----------------------------------------------

def _jax_cuckoo_checkpoint(ck: str, first_file_only: bool = False,
                           h_bits: int | None = None) -> None:
    """A scrub checkpoint the JAX package writes off the TPU, where its
    default layout is cuckoo (here asked for by name): the whole run, or
    (first_file_only) the -A panel's first file, as a run killed after it
    would leave; with h_bits, over a table of 2 x 2**h_bits slots, as its
    builder grows one whose tries failed."""
    from strainer2_tpu.pipeline import scrub_count as jsc

    index = JaxIndex.from_fasta(SCRUB_ARGS[0], KmerEngine(31, layout="cuckoo"))
    if h_bits is not None:
        index.table_ = j_cuckoo.build_cuckoo(index.codes, 31, h_bits=h_bits)
    if not first_file_only:
        jsc.run_scrub_count(*SCRUB_ARGS, out=io.StringIO(), index=index, checkpoint_dir=ck)
        return
    with open("first.txt", "w") as f:
        f.write("data/panel1.fna.gz\n")
    open("none.txt", "w").close()
    jsc.run_scrub_count(SCRUB_ARGS[0], "first.txt", "none.txt", out=io.StringIO(), index=index,
                        checkpoint_dir=ck)


def test_scrub_checkpoint_of_another_geometry_is_refused(mini, tmp_path):
    """A run handed counts that fit neither of the strain's table sizes
    (bucket 8,192 cells, cuckoo 4,096 slots; here a cuckoo table of 16,384
    slots, as the JAX builder grows one) raises before it reads a panel
    file, naming both sizes (unchecked, such counts raised IndexError after
    the files were read).  A cuckoo checkpoint of the default size resumes:
    tests/test_torch_cuckoo_fp.py."""
    from strainer2_tpu_torch.pipeline import scrub_count as sc

    ck = str(tmp_path / "ck")
    _jax_cuckoo_checkpoint(ck, h_bits=13)
    with pytest.raises(ValueError, match=r"(?s)cells.*another table layout or size"):
        sc.run_scrub_count(*SCRUB_ARGS, out=io.StringIO(), checkpoint_dir=ck,
                           cfg=sc.ScrubCountConfig(device="cpu", rows=ROWS, row_len=ROW_LEN))


def test_jax_cuckoo_scrub_checkpoint_resumes_in_cuckoo(tmp_path, monkeypatch):
    """The JAX package's cuckoo checkpoint, left after the first panel
    file, resumes in the port's cuckoo layout to the golden table,
    counting only the files it does not hold."""
    from strainer2_tpu_torch.pipeline import scrub_count as sc

    shutil.copytree(os.path.join(MINI, "data"), tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck")
    _jax_cuckoo_checkpoint(ck, first_file_only=True)
    counted = []
    real = sc.count_panel_file

    def recording(engine, index, counts, path, *a):
        counted.append(path)
        return real(engine, index, counts, path, *a)

    monkeypatch.setattr(sc, "count_panel_file", recording)
    out = io.StringIO()
    index = sc.run_scrub_count(*SCRUB_ARGS, out=out, checkpoint_dir=ck,
                               cfg=sc.ScrubCountConfig(device="cpu", rows=ROWS, row_len=ROW_LEN,
                                                       layout="cuckoo"))
    assert index.layout == "cuckoo"
    assert counted == ["data/panel2.fna", "data/scrubmeta1.fasta.gz"]
    assert out.getvalue().encode() == expected("scrub_counts.tsv")


# ---- stages in the cuckoo layout against the goldens --------------------------------

def test_detect_reuses_jax_cuckoo_index_cache(mini, tmp_path):
    """strain_detect in the cuckoo layout on an --index-cache the JAX
    package wrote: the golden hits, and the cache file untouched."""
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

    cache = str(tmp_path / "index.npz")
    JaxIndex.from_fasta("data/strainA.fna.gz", KmerEngine(31, layout="cuckoo")).save(cache)
    with open(cache, "rb") as f:
        before = f.read()
    mtime = os.stat(cache).st_mtime_ns
    hits, out = str(tmp_path / "hits.txt"), io.StringIO()
    det = run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", hits,
                     batch_list="data/targets.txt", stdout=out, index_cache=cache,
                     cfg=DetectConfig(device="cpu", rows=ROWS, row_len=ROW_LEN, layout="cuckoo"),
                     gzip_output=False)
    with open(hits, "rb") as f:
        assert f.read() == expected("kmer_hits.txt")
    assert out.getvalue().encode() == expected("detect_stdout.txt")
    assert det.index.layout == det.engine.layout == "cuckoo"
    with open(cache, "rb") as f:
        assert f.read() == before
    assert os.stat(cache).st_mtime_ns == mtime


# genome_compare's k <= 32 goldens (tools/make_mini_fixtures.py's argv)
COMPARE_GOLDENS = [
    (dict(b_file="data/panel1.fna.gz", print_header=True), {}, "gc_single.txt"),
    (dict(b_list="data/compare_list.txt"), dict(k=17), "gc_list_s17.txt"),
    (dict(b_list="data/compare_list.txt"), dict(max_seeds=300, threshold_for_fullmap=0.5),
     "gc_rapid.txt"),
    (dict(b_list="data/compare_list.txt"), dict(max_seeds=100_000, threshold_for_fullmap=0.05),
     "gc_strainmode.txt"),
]


@pytest.mark.parametrize("args,cfg_kw,golden", COMPARE_GOLDENS,
                         ids=[g for _, _, g in COMPARE_GOLDENS])
def test_genome_compare_cuckoo_goldens(mini, monkeypatch, args, cfg_kw, golden):
    """Fullmap batches on the cuckoo K8 form, rapid-mode and strain-mode
    batches on the cuckoo K9 form (the engine route)."""
    from strainer2_tpu_torch.pipeline.compare import CompareConfig, GenomeComparer, run_genome_compare

    monkeypatch.setenv("STRAINER2_NATIVE_COMPARE", "0")
    cfg = CompareConfig(rows=ROWS, row_len=ROW_LEN, device="cpu", layout="cuckoo", **cfg_kw)
    out = io.StringIO()
    run_genome_compare("data/strainA.fna.gz", cfg=cfg, out=out, **args)
    assert out.getvalue().encode() == expected(golden)
    assert GenomeComparer("data/strainA.fna.gz", cfg).index.layout == "cuckoo"


def test_strain_track_cuckoo_golden(tmp_path, monkeypatch):
    """strain-track -n in the cuckoo layout (K3 with its valid count)."""
    from strainer2_tpu_torch.pipeline.multi import run_strain_track

    for name in ("strainA.fna.gz", "drug1.fna.gz", "scrubmeta1.fasta.gz"):
        shutil.copy(os.path.join(MINI, "data", name), tmp_path / name)
    with open(tmp_path / "strains2.txt", "w") as f:
        f.write("strainA.fna.gz\ndrug1.fna.gz\n")
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    run_strain_track("strains2.txt", "scrubmeta1.fasta.gz", print_track=False, max_reads=60,
                     out=out, device="cpu", rows=ROWS, row_len=ROW_LEN, layout="cuckoo")
    with open(os.path.join(MINI, "expected", "modes", "strain_track_m100_stdout.txt"), "rb") as f:
        assert out.getvalue().encode() == f.read()


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_cuckoo_classify_select_step_matches_jax_emission(case):
    """K4 then K4e's plain version in the cuckoo layout (cuckoo K4's
    lookups, the slot-indexed classes) against the JAX package's emission
    of the same batch from its _classify_step sums, on the cases of
    tests/test_torch_lookup.py's bucket twin."""
    from strainer2_tpu.io.batches import pack_stream
    from strainer2_tpu.pipeline.engine import _classify_step

    k = 31
    rng = np.random.default_rng(7)
    genome, keys = _genome_keys(rng, k)
    t = t_cuckoo.build_cuckoo(keys, k)
    meta = np.zeros(t.num_slots, dtype=np.uint32)
    if case != "gate_with_zero_rows":
        meta[t.slot_of_key] = np.where(rng.random(keys.size) < 0.3, 2, 1)
    else:
        meta[t.slot_of_key] = 1
    j_hi, j_lo = (jnp.asarray(np.ascontiguousarray(t.table[:, c])) for c in (0, 1))

    def classify(bases, bounds):
        return tuple(np.asarray(x) for x in _classify_step(
            j_hi, j_lo, jnp.asarray(meta), bases, jnp.asarray(bounds), h_bits=t.h_bits,
            salt=t.salt, k=k, max_reads=bounds.size - 1))

    batch, bounds, paired, min_t, min_i = select_case(case, genome, pack_stream, classify)
    tot, inf = classify(batch.bases, bounds)
    got = L.cuckoo_classify_select_step(
        torch.from_numpy(t.table), torch.from_numpy(meta), torch.from_numpy(batch.bases),
        torch.from_numpy(bounds), t.h_bits, t.salt, k, n_reads=batch.n_reads, paired=paired,
        min_t=min_t, min_i=min_i)
    want = jax_emission(batch, tot, inf, paired, min_t, min_i, keys, meta[t.slot_of_key])
    check_selection(got, want, case, batch, paired, min_t, min_i)

