"""The port's host copies vs their JAX-package originals, on the same
inputs: constants, stage timers, prefetch, readers, packer, bucket tables,
row-order replay, index and its npz, filter and coverage, the native
cuckoo builder.  Also the port's
own C++ host library: built under build/strainer2_tpu_torch/, equal to the
JAX package's library batch for batch, and (unlike it) splitting a
sequence longer than one buffer as the Python packer does."""

import gzip
import io
import os

import numpy as np
import pytest
import torch

import strainer2_tpu.constants as j_constants
import strainer2_tpu.index.bucket as j_bucket
import strainer2_tpu.native as j_native
import strainer2_tpu.index.refhash_order as j_refhash
import strainer2_tpu.io.batches as j_batches
import strainer2_tpu.io.fastx as j_fastx
import strainer2_tpu.ops.packing_np as j_packing_np
import strainer2_tpu.pipeline.coverage as j_coverage
import strainer2_tpu.pipeline.filter as j_filter
import strainer2_tpu.utils.observability as j_observability
import strainer2_tpu.utils.prefetch as j_prefetch
import strainer2_tpu_torch.constants as t_constants
import strainer2_tpu_torch.index.bucket as t_bucket
import strainer2_tpu_torch.native as t_native
import strainer2_tpu_torch.index.refhash_order as t_refhash
import strainer2_tpu_torch.io.batches as t_batches
import strainer2_tpu_torch.io.fastx as t_fastx
import strainer2_tpu_torch.ops.packing_np as t_packing_np
import strainer2_tpu_torch.pipeline.coverage as t_coverage
import strainer2_tpu_torch.pipeline.filter as t_filter
import strainer2_tpu_torch.utils.observability as t_observability
import strainer2_tpu_torch.utils.prefetch as t_prefetch

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
DATA = os.path.join(MINI, "data")
K = 31
FASTX_FILES = sorted(f for f in os.listdir(DATA) if not f.endswith(".txt"))


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.bases, y.bases)
        assert x.n_reads == y.n_reads
        np.testing.assert_array_equal(x.read_lengths, y.read_lengths)
        for f in ("read_id", "window_starts"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None)
            if u is not None:
                np.testing.assert_array_equal(u, v)


def test_packing_np_twin_matches():
    rng = np.random.default_rng(0)
    ascii_bytes = rng.choice(np.frombuffer(b"ACGTNacgtX", np.uint8), size=5000)
    codes = j_packing_np.encode_ascii_np(ascii_bytes)
    np.testing.assert_array_equal(t_packing_np.encode_ascii_np(ascii_bytes), codes)
    for k in (15, 31):
        cc, ok = j_packing_np.canonical_codes_np(codes, k)
        tc, tok = t_packing_np.canonical_codes_np(codes, k)
        np.testing.assert_array_equal(tc, cc)
        np.testing.assert_array_equal(tok, ok)
        hi, lo = j_packing_np.split_code64_np(cc, k)
        for a, b in zip(t_packing_np.split_code64_np(cc, k), (hi, lo)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t_packing_np.merge_code64_np(hi, lo, k), cc)
        assert t_packing_np.decode_codes_np(cc[:50], k) == j_packing_np.decode_codes_np(cc[:50], k)


@pytest.mark.parametrize("name", FASTX_FILES)
def test_fastx_twin_matches(name):
    path = os.path.join(DATA, name)
    assert list(t_fastx.read_fastx(path)) == list(j_fastx.read_fastx(path))


@pytest.mark.parametrize("with_ids,group", [(False, 1), (True, 1), (True, 2)])
def test_pack_stream_twin_matches(with_ids, group):
    seqs = [r.seq for r in j_fastx.read_fastx(os.path.join(DATA, "target_PEI.fasta"))]
    kw = dict(rows=8, row_len=512, with_read_ids=with_ids, group_size=group)
    _same_batches(t_batches.pack_stream(iter(seqs), K, **kw),
                  j_batches.pack_stream(iter(seqs), K, **kw))
    assert t_batches.max_reads_capacity(K) == j_batches.max_reads_capacity(K) == 32768
    if with_ids:
        tb = next(t_batches.pack_stream(iter(seqs), K, **kw))
        jb = next(j_batches.pack_stream(iter(seqs), K, **kw))
        for rid in (0, 3, tb.n_reads - 1):
            np.testing.assert_array_equal(t_batches.read_codes_from_batch(tb, rid, K),
                                          j_batches.read_codes_from_batch(jb, rid, K))


@pytest.mark.parametrize("mode,files", [(0, ["target_SE.fastq"]),
                                        (1, ["target_PE1.fasta.gz", "target_PE2.fasta.gz"])])
def test_native_pack_stream_twin_matches(mode, files):
    from strainer2_tpu import native as j_native
    from strainer2_tpu_torch import native as t_native

    if not t_native.available():
        pytest.skip("C++ host library unavailable")
    paths = [os.path.join(DATA, f) for f in files]
    kw = dict(mode=mode, with_read_ids=True, group_size=1 + mode, max_reads=512)
    batches = list(t_native.NativePackStream(paths, K, 8, 512, **kw))
    assert all(type(b) is t_batches.PackedBatch for b in batches)
    _same_batches(batches, j_native.NativePackStream(paths, K, 8, 512, **kw))


def test_native_pack_stream_splits_long_sequences(tmp_path):
    """Sequences longer than one buffer: the port's native stream equals
    the Python packer batch for batch (bases, read count and lengths; a
    continuation counts as a read of length 0), with no error, on small
    contigs at 4 x 512 and on a 1.5 Mbp contig at 256 x 4096."""
    from strainer2_tpu_torch import native as t_native

    if not t_native.available():
        pytest.skip("C++ host library unavailable")
    rng = np.random.default_rng(1)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for name, lengths, rows, row_len in (("contigs.fna", (9000, 50, 4000, 20, 3000), 4, 512),
                                         ("long.fna", (1_500_000, 300), 256, 4096)):
        fa = tmp_path / name
        with open(fa, "wb") as f:
            for i, n in enumerate(lengths):
                f.write(b">c%d\n" % i + acgt[rng.integers(0, 4, size=n)].tobytes() + b"\n")
        native_batches = list(t_native.NativePackStream([str(fa)], K, rows, row_len))
        seqs = (r.seq for r in t_fastx.read_fastx(str(fa)))
        python_batches = list(t_batches.pack_stream(seqs, K, rows, row_len))
        assert len(native_batches) >= 2
        _same_batches(native_batches, python_batches)


@pytest.mark.parametrize("name", [f for f in FASTX_FILES if "fna" in f or "fasta" in f])
def test_native_counting_stream_matches_jax_library(name):
    """Counting streams (no read ids) of the port's library and the JAX
    package's library give the same batches on the mini data."""
    from strainer2_tpu import native as j_native
    from strainer2_tpu_torch import native as t_native

    if not (t_native.available() and j_native.available()):
        pytest.skip("C++ host library unavailable")
    path = os.path.join(DATA, name)
    _same_batches(t_native.NativePackStream([path], K, 4, 256),
                  j_native.NativePackStream([path], K, 4, 256))


def test_native_library_builds_under_build_dir():
    """The port builds its own library into build/strainer2_tpu_torch/,
    named by the source's hash, and writes nothing under strainer2_tpu/."""
    from strainer2_tpu_torch import native as t_native

    if not t_native.available():
        pytest.skip(f"C++ host library unavailable: {t_native.build_error}")
    path = t_native.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(path) == os.path.join(repo, "build", "strainer2_tpu_torch")
    assert os.path.exists(path)
    assert "strainer2_tpu" + os.sep not in os.path.relpath(path, repo)


def test_constants_copy_matches():
    names = [n for n in dir(t_constants) if n.isupper()]
    assert len(names) == 13
    for n in names:
        assert getattr(t_constants, n) == getattr(j_constants, n), n


def test_stage_copy_matches(monkeypatch):
    """stage() adds wall time and items under a name, as the original does."""
    for mod in (t_observability, j_observability):
        monkeypatch.setattr(mod, "_totals", type(mod._totals)(float))
        monkeypatch.setattr(mod, "_items", type(mod._items)(int))
        for items in (3, 4):
            with mod.stage("x.step", items=items):
                pass
        with pytest.raises(KeyError):
            with mod.stage("x.fail"):
                raise KeyError("inside")
        assert mod._items["x.step"] == 7 and mod._items["x.fail"] == 0
        assert sorted(mod._totals) == ["x.fail", "x.step"]
        assert mod.timings_enabled() == bool(os.environ.get("STRAINER2_TIMINGS"))


def test_prefetch_copy_matches():
    def stream(fail):
        yield from range(5)
        if fail:
            raise ValueError("producer")

    for mod in (t_prefetch, j_prefetch):
        assert list(mod.prefetch(stream(False), depth=2)) == list(range(5))
        got = []
        with pytest.raises(ValueError, match="producer"):
            for x in mod.prefetch(stream(True)):
                got.append(x)
        assert got == list(range(5))


def test_bucket_twin_matches():
    codes = np.unique(np.random.default_rng(2).integers(0, 1 << 62, size=20000, dtype=np.uint64))
    jt, tt = j_bucket.build_bucket_table(codes, K), t_bucket.build_bucket_table(codes, K)
    np.testing.assert_array_equal(tt.table, jt.table)
    np.testing.assert_array_equal(tt.slot_of_key, jt.slot_of_key)
    assert (tt.h_bits, tt.salt, tt.num_slots) == (jt.h_bits, jt.salt, jt.num_slots)
    meta = np.arange(jt.num_slots, dtype=np.uint32)
    np.testing.assert_array_equal(tt.with_meta(meta), jt.with_meta(meta))


@pytest.mark.parametrize("k,h_bits,salt", [(31, 16, 0x9E3779B9), (20, 15, 0), (32, 16, 7)])
def test_native_cuckoo_builder_twin_matches(k, h_bits, salt):
    """build_cuckoo_native: the table and key slots of the JAX library's,
    and "retry" where both libraries' eviction chains run past the limit."""
    rng = np.random.default_rng(k)
    codes = np.unique(rng.integers(0, (1 << (2 * k)) - 1, 20_000, dtype=np.uint64))
    ours = t_native.build_cuckoo_native(codes, k, h_bits, salt)
    theirs = j_native.build_cuckoo_native(codes, k, h_bits, salt)
    assert ours not in (None, "retry")
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert t_native.build_cuckoo_native(codes, k, 13, salt) == "retry"
    assert j_native.build_cuckoo_native(codes, k, 13, salt) == "retry"


def test_refhash_order_twin_matches():
    codes = np.unique(np.random.default_rng(3).integers(0, 1 << 62, size=3000, dtype=np.uint64))
    np.testing.assert_array_equal(t_refhash.djb2_codes(codes, K), j_refhash.djb2_codes(codes, K))
    np.testing.assert_array_equal(t_refhash.reference_row_order(codes, K, 64),
                                  j_refhash.reference_row_order(codes, K, 64))


@pytest.fixture(scope="module")
def jax_index():
    from strainer2_tpu.index.build import StrainIndex as JaxIndex
    from strainer2_tpu.pipeline.engine import KmerEngine

    eng = KmerEngine(K, layout="bucket")
    idx = JaxIndex.from_fasta(os.path.join(DATA, "strainA.fna.gz"), eng)
    idx.table
    return eng, idx


def test_strain_index_matches_jax(jax_index):
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    _, j_idx = jax_index
    idx = StrainIndex.from_fasta(os.path.join(DATA, "strainA.fna.gz"), TorchKmerEngine(K, device="cpu"))
    np.testing.assert_array_equal(idx.codes, j_idx.codes)
    np.testing.assert_array_equal(idx.genome_counts, j_idx.genome_counts)
    np.testing.assert_array_equal(idx.table.table, j_idx.table.table)
    np.testing.assert_array_equal(idx.table.slot_of_key, j_idx.table.slot_of_key)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_index_npz_carries_across(jax_index, tmp_path, direction):
    """StrainIndex.save of either package loads in the other; the port
    engine on the loaded index counts and classifies like the JAX engine."""
    from strainer2_tpu.index.build import StrainIndex as JaxIndex
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    j_eng, j_idx = jax_index
    path = str(tmp_path / "index.npz")
    if direction == "jax_to_torch":
        j_idx.save(path)
        idx = StrainIndex.load(path)
        other = j_idx
    else:
        StrainIndex.load(_saved(j_idx, tmp_path)).save(path)
        idx, other = JaxIndex.load(path), j_idx
    for f in ("codes", "genome_counts"):
        np.testing.assert_array_equal(getattr(idx, f), getattr(other, f))
    np.testing.assert_array_equal(idx.table.table, other.table.table)
    assert (idx.table.h_bits, idx.table.salt, idx.layout) == (other.table.h_bits, other.table.salt, "bucket")

    seqs = [r.seq for r in j_fastx.read_fastx(os.path.join(DATA, "target_SE.fastq"))]
    batch = next(j_batches.pack_stream(iter(seqs), K, 8, 512, with_read_ids=True))
    t = idx.table
    eng = TorchKmerEngine(K, device="cpu")
    counts = eng.count_batch(eng.init_counts(idx), eng.table_for(idx), t.h_bits, t.salt, batch.bases)
    j_counts = j_eng.count_batch(j_eng.init_counts(j_idx), j_idx.device_table(), t.h_bits, t.salt, batch.bases)
    np.testing.assert_array_equal(eng.finalize_counts(counts), np.asarray(j_counts))
    assert eng.finalize_counts(counts).sum() > 0
    resumed = eng.counts_from_numpy(idx, np.asarray(j_counts))
    eng.count_batch(resumed, eng.table_for(idx), t.h_bits, t.salt, batch.bases)
    np.testing.assert_array_equal(eng.finalize_counts(resumed), 2 * np.asarray(j_counts))

    kinds = np.where(np.arange(idx.num_kmers) % 3 == 0, 2, 1).astype(np.uint32)
    rows = t.with_meta(idx.slot_values(kinds))
    max_reads = j_batches.max_reads_capacity(K, 8, 512)
    bounds = np.full(max_reads + 1, 8 * (512 - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    import jax.numpy as jnp
    from strainer2_tpu.pipeline.engine import KmerEngine

    j_cls = KmerEngine(K, max_reads, layout="bucket")
    ref = j_cls.classify_batch(jnp.asarray(rows), None, t.h_bits, t.salt, batch.bases, bounds)
    got = eng.classify_batch(torch.from_numpy(rows), t.h_bits, t.salt, batch.bases, bounds)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _saved(j_idx, tmp_path):
    p = str(tmp_path / "jax.npz")
    j_idx.save(p)
    return p


@pytest.mark.parametrize(
    "src,kwargs",
    [
        ("scrub_counts.gz", dict(min_fraction=0.05)),
        ("scrub_counts_drug.gz", dict(min_fraction=0.05)),
        ("scrub_counts.gz", dict(min_fraction=0.05, independent=True)),
    ],
)
def test_filter_twin_matches(src, kwargs):
    path = os.path.join(MINI, "expected", src)
    outs = []
    for mod in (t_filter, j_filter):
        out, err = io.StringIO(), io.StringIO()
        mod.run_filter(mod.parse_scrub_tables([path]), out=out, err=err, **kwargs)
        outs.append((out.getvalue(), err.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0]


@pytest.mark.parametrize("kwargs", [dict(), dict(min_kmer_hits=5),
                                    dict(background_metagenomes_file=os.path.join(DATA, "background.txt"))])
def test_coverage_twin_matches(tmp_path, kwargs):
    hits = str(tmp_path / "strainA_x.kmer_hits.gz")
    with open(os.path.join(MINI, "expected", "kmer_hits.txt"), "rb") as f, gzip.open(hits, "wb") as g:
        g.write(f.read())
    outs = []
    for mod in (t_coverage, j_coverage):
        out = io.StringIO()
        mod.run_coverage_depth(hits, out=out, **kwargs)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] != ""


@pytest.mark.parametrize("k", [20, 40])
def test_native_comparer_twin_matches(k):
    """The port's NativeComparer against the JAX package's and against the
    pure-Python _HostSetComparer, fullmap and in rapid mode on every query
    of the compare list."""
    from strainer2_tpu.native import NativeComparer as JaxComparer
    from strainer2_tpu.pipeline.compare import _HostSetComparer
    from strainer2_tpu_torch.native import NativeComparer

    a = os.path.join(DATA, "strainA.fna.gz")
    ours, theirs, python = NativeComparer(a, k), JaxComparer(a, k), _HostSetComparer(a, k)
    assert ours.num_kmers == theirs.num_kmers == len(python.kmers) > 0
    for name in ("panel1.fna.gz", "panel2.fna", "strainA.fna.gz", "target_SE.fastq"):
        q = os.path.join(DATA, name)
        for max_seeds, threshold in ((0, 0.1), (200, 0.3), (300, 0.9)):
            got = ours.score(q, max_seeds, threshold)
            assert got == theirs.score(q, max_seeds, threshold) == python.score(q, max_seeds, threshold)
    with pytest.raises(OSError):
        ours.score("/nonexistent_q.fa", 0, 0.1)
    with pytest.raises(OSError):
        NativeComparer("/nonexistent_a.fa", k)


def _c_functions(path: str, names) -> dict:
    """The source text of each named C function of a host library file,
    from its signature to the closing brace at column 0."""
    with open(path) as f:
        src = f.read()
    out = {}
    for name in names:
        start = src.index(f" {name}(")
        start = src.rindex("\n", 0, start) + 1
        out[name] = src[start : src.index("\n}\n", start) + 3]
    return out


def test_read_extractor_and_scanner_sources_are_copies():
    """The read extractor (s2_open_extract, s2_extract_ok, s2_extract_read,
    s2_close_extract, and ExtractStream) and the rolling scanner the
    --device cpu routes call are the JAX library's source, character for
    character."""
    names = ("s2_open_extract", "s2_extract_ok", "s2_extract_read", "s2_close_extract",
             "s2_open_scan", "s2_scan_ok", "s2_scan_next", "s2_close_scan")
    jax_src = os.path.join(os.path.dirname(j_native.__file__), "strainer2_host.cc")
    port_src = t_native._SRC
    assert _c_functions(port_src, names) == _c_functions(jax_src, names)
    struct = "struct ExtractStream {"
    for path in (port_src, jax_src):
        with open(path) as f:
            src = f.read()
        assert src.count(struct) == 1
    with open(port_src) as f, open(jax_src) as g:
        a, b = f.read(), g.read()
    grab = lambda s: s[s.index(struct): s.index("};", s.index(struct))]  # noqa: E731
    assert grab(a) == grab(b)


@pytest.mark.parametrize("name", FASTX_FILES)
def test_native_scan_twin_matches(name):
    """scan_file_codes_native of the port's library and the JAX library's,
    and the port's scan_file_codes on the CPU, which takes it."""
    from strainer2_tpu_torch.index.build import scan_file_codes
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    path = os.path.join(DATA, name)
    want = j_native.scan_file_codes_native(path, K)
    np.testing.assert_array_equal(t_native.scan_file_codes_native(path, K), want)
    np.testing.assert_array_equal(scan_file_codes(path, TorchKmerEngine(K, device="cpu")), want)
