"""The port's (data, index) mesh (strainer2_tpu_torch/parallel/sharding.py)
on the CPU, against JAX's ShardedKmerEngine on the 8 virtual CPU devices of
tests/conftest.py: twins of tests/test_parallel.py over the same mesh
shapes and seeded inputs, in both layouts and for 3, 20 and 100 strains;
the windowed plain versions against slices of the one-device plain
versions; the cuckoo key held in both of its slots; zero partials from a
data shard whose windows lie past every read; make_mesh's device
resolution and errors.  Every comparison is exact (integers)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

K = 31
ROWS, ROW_LEN = 8, 512
N_WINDOWS = ROWS * (ROW_LEN - K + 1)


@pytest.fixture(scope="module")
def setup():
    """The seeded genome, reads and batches of tests/test_parallel.py, a
    JAX cuckoo index of the genome and a bucket table of its keys."""
    from strainer2_tpu.index import StrainIndex
    from strainer2_tpu.index.bucket import build_bucket_table
    from strainer2_tpu.io import max_reads_capacity, pack_stream
    from strainer2_tpu.pipeline import KmerEngine
    from tests.oracle import random_dna

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    rng = np.random.default_rng(42)
    genome = random_dna(rng, 4000)
    engine = KmerEngine(K, max_reads=max_reads_capacity(K, ROWS, ROW_LEN), layout="cuckoo")
    scan = [engine.extract_codes(b.bases)
            for b in pack_stream([genome.encode()], K, rows=ROWS, row_len=ROW_LEN)]
    index = StrainIndex.from_scan_codes(np.concatenate(scan), k=K, layout="cuckoo")
    reads = [random_dna(rng, rng.integers(40, 150), n_prob=0.02) for _ in range(100)]
    for i in range(0, 100, 2):
        start = int(rng.integers(0, 3800))
        reads[i] = genome[start : start + 100]
    batches = list(pack_stream([r.encode() for r in reads], K, rows=ROWS, row_len=ROW_LEN,
                               with_read_ids=True))
    return engine, index, build_bucket_table(index.codes, K), batches


def _boundaries(b, max_reads):
    out = np.full(max_reads + 1, N_WINDOWS, dtype=np.int32)
    out[: b.n_reads] = b.window_starts
    return out


def _jax_sharded(shape, t, max_reads=None, layout="cuckoo"):
    from strainer2_tpu.parallel.sharding import ShardedKmerEngine, make_mesh

    mesh = make_mesh(*shape)
    return mesh, ShardedKmerEngine(K, mesh, t.h_bits, t.salt, t.num_slots, max_reads=max_reads,
                                   layout=layout)


def _jax_planes(mesh, table):
    spec = NamedSharding(mesh, P("index"))
    return tuple(jax.device_put(jnp.asarray(np.ascontiguousarray(table[:, j])), spec)
                 for j in (0, 1))


def _ours(shape, t, layout="cuckoo"):
    from strainer2_tpu_torch.parallel.sharding import ShardedKmerEngine, make_mesh

    return ShardedKmerEngine(K, make_mesh(*shape, devices="cpu"), t.h_bits, t.salt, t.num_slots,
                             layout=layout)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_counting_matches_jax(setup, mesh_shape):
    _, index, _, batches = setup
    t = index.table
    mesh, jx = _jax_sharded(mesh_shape, t)
    jc = jx.init_counts()
    planes = _jax_planes(mesh, t.table)
    ours = _ours(mesh_shape, t)
    table = ours.put_table(t.table)
    oc = ours.init_counts()
    for b in batches:
        jc = jx.count_batch(jc, planes, b.bases)
        oc = ours.count_batch(oc, table, b.bases)
    expect = jx.merge_counts(jc)
    got = ours.merge_counts(oc)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, expect)
    assert int(index.key_values(got).sum()) > 0


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (1, 8)])
def test_sharded_cuckoo_classify_matches_jax(setup, mesh_shape):
    """JAX's cuckoo program sums over read ids, the port's over boundaries:
    the per-read sums are compared, not the shapes."""
    engine, index, _, batches = setup
    t = index.table
    kinds = np.full(index.num_kmers, 1, np.uint32)
    kinds[::3] = 2
    meta = index.slot_values(kinds)
    max_reads = engine.max_reads
    mesh, jx = _jax_sharded(mesh_shape, t, max_reads)
    planes = _jax_planes(mesh, t.table)
    meta_sh = jax.device_put(jnp.asarray(meta), NamedSharding(mesh, P("index")))
    ours = _ours(mesh_shape, t)
    table = ours.put_table(t.table, meta)
    total = 0
    for b in batches:
        jt, ji = jx.classify_batch(planes, meta_sh, b.bases, b.read_id)
        ot, oi = ours.classify_batch(table, b.bases, _boundaries(b, max_reads))
        assert ot.shape == (mesh_shape[0], max_reads)
        np.testing.assert_array_equal(ot.sum(0), np.asarray(jt).sum(0)[:max_reads])
        np.testing.assert_array_equal(oi.sum(0), np.asarray(ji).sum(0)[:max_reads])
        total += int(oi.sum())
    assert total > 0


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (1, 8)])
def test_sharded_bucket_layout_matches_jax(setup, mesh_shape):
    """Counting and classification on bucket rows, the data shards'
    partials equal to JAX's shard by shard."""
    engine, index, tb, batches = setup
    max_reads = engine.max_reads
    mesh, jx = _jax_sharded(mesh_shape, tb, max_reads, "bucket")
    spec = NamedSharding(mesh, P("index", None))
    ours = _ours(mesh_shape, tb, "bucket")
    jc, oc = jx.init_counts(), ours.init_counts()
    rows_j = jax.device_put(jnp.asarray(tb.table), spec)
    rows_o = ours.put_table(tb.table)
    for b in batches:
        jc = jx.count_batch(jc, rows_j, b.bases)
        oc = ours.count_batch(oc, rows_o, b.bases)
    np.testing.assert_array_equal(ours.merge_counts(oc), jx.merge_counts(jc))

    kinds = np.full(index.num_kmers, 1, np.uint32)
    kinds[::3] = 2
    meta_slots = np.zeros(tb.num_slots, np.uint32)
    meta_slots[tb.slot_of_key] = kinds
    rows_meta = tb.with_meta(meta_slots)
    rows_j = jax.device_put(jnp.asarray(rows_meta), spec)
    rows_o = ours.put_table(rows_meta)
    for b in batches:
        bounds = _boundaries(b, max_reads)
        jt, ji = jx.classify_batch(rows_j, None, b.bases, jnp.asarray(bounds))
        ot, oi = ours.classify_batch(rows_o, b.bases, bounds)
        np.testing.assert_array_equal(ot, np.asarray(jt))
        np.testing.assert_array_equal(oi, np.asarray(ji))


def _multi_rows(codes, n_strains, rng):
    """A bucket table of ``codes`` with ``n_strains`` strains' seeded
    present / informative bits, as tests/test_parallel.py and
    __graft_entry__.py make them: (table, rows with the meta words)."""
    from strainer2_tpu.index.bucket import build_bucket_table

    n_words = -(-n_strains // 16)
    tb = build_bucket_table(codes, K, row_width=32 + 16 * max(2, n_words))
    words = []
    for j in range(n_words):
        w = np.zeros(codes.size, dtype=np.uint32)
        for s in range(16 * j, min(16 * (j + 1), n_strains)):
            present = rng.random(codes.size) < 0.6
            informative = present & (rng.random(codes.size) < 0.4)
            w |= present.astype(np.uint32) << np.uint32(2 * (s - 16 * j))
            w |= informative.astype(np.uint32) << np.uint32(2 * (s - 16 * j) + 1)
        slot_w = np.zeros(tb.num_slots, np.uint32)
        slot_w[tb.slot_of_key] = w
        words.append(slot_w)
    return tb, tb.with_meta_words(words)


@pytest.mark.parametrize("n_strains", [3, 20, 100])
@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (1, 8)])
def test_sharded_multi_strain_classify_matches_jax(setup, mesh_shape, n_strains):
    """K6s, R and K7 per data shard against JAX's _classify_multi_body_bucket
    at 1, 2 and 7 meta words, partials equal shard by shard; the port's
    with_words words summed over the data shards are the one-device K6's."""
    from strainer2_tpu_torch.ops.segsum import multi_hit_words_plain

    engine, index, _, batches = setup
    max_reads = engine.max_reads
    tb, rows = _multi_rows(index.codes, n_strains, np.random.default_rng(n_strains))
    mesh, jx = _jax_sharded(mesh_shape, tb, max_reads, "bucket")
    rows_j = jax.device_put(jnp.asarray(rows), NamedSharding(mesh, P("index", None)))
    ours = _ours(mesh_shape, tb, "bucket")
    rows_o = ours.put_table(rows)
    total = 0
    for b in batches[:2]:
        bounds = _boundaries(b, max_reads)
        jt, ji = jx.classify_multi_batch(rows_j, b.bases, bounds, n_strains)
        ot, oi, words = ours.classify_multi_batch(rows_o, b.bases, bounds, n_strains,
                                                  with_words=True)
        np.testing.assert_array_equal(ot, np.asarray(jt))
        np.testing.assert_array_equal(oi, np.asarray(ji))
        one = multi_hit_words_plain(torch.from_numpy(rows), torch.from_numpy(b.bases), tb.h_bits,
                                    tb.salt, K, -(-n_strains // 16))
        assert torch.equal(torch.cat(words).view(torch.int32), one.view(torch.int32))
        total += int(ot[..., n_strains - 1].sum())
    assert total > 0


@pytest.mark.parametrize("layout", ["bucket", "cuckoo"])
@pytest.mark.parametrize("n_index", [2, 4])
def test_windowed_plain_versions_are_slices_of_one_device(setup, layout, n_index):
    """Each shard's plain count is its slice of the one-device plain count;
    R of the shards' K4 scratch is the one-device scratch, and K4's sums of
    it the one-device classify; R of K6s's words is K6's."""
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.ops import segsum as G
    from strainer2_tpu_torch.parallel.sharding import shard_table

    _, index, tb, batches = setup
    t = tb if layout == "bucket" else index.table
    kinds = np.where(np.arange(index.num_kmers) % 3 == 0, 2, 1).astype(np.uint32)
    meta = np.zeros(t.num_slots, np.uint32)
    meta[t.slot_of_key] = kinds
    table = torch.from_numpy(tb.with_meta(meta) if layout == "bucket" else t.table)
    meta_t = torch.from_numpy(meta)
    shards = shard_table(table, layout, n_index, None if layout == "bucket" else meta_t)
    h, salt = t.h_bits, t.salt
    per = t.num_slots // n_index
    for b in batches[:3]:
        bases = torch.from_numpy(b.bases)
        bounds = torch.from_numpy(_boundaries(b, 200))
        if layout == "bucket":
            one = L.count_step_plain(torch.zeros(t.num_slots, dtype=torch.uint32), table, bases,
                                     h, salt, K)
            lookups = L.valid_hits_plain(table, bases, h, salt, K)
        else:
            one = L.cuckoo_count_step_plain(torch.zeros(t.num_slots, dtype=torch.uint32), table,
                                            bases, h, salt, K)
            lookups = L.cuckoo_valid_hits_plain(table, bases, h, salt, K, meta_t)
        one_masks, one_counts = L._tile_masks(lookups, bases, K)
        parts = []
        for i, sh in enumerate(shards):
            c = torch.zeros(per, dtype=torch.uint32)
            if layout == "bucket":
                L.shard_count_step(c, sh.table, sh.lo, bases, h, salt, K)
                parts.append(L.shard_classify_masks(sh.table, sh.lo, bases, h, salt, K)[0])
            else:
                L.shard_cuckoo_count_step(c, sh.table, sh.lo, bases, h, salt, K)
                parts.append(L.shard_cuckoo_classify_masks(sh.table, sh.meta, sh.lo, bases, h,
                                                           salt, K)[0])
            assert torch.equal(c.view(torch.int32), one[i * per : (i + 1) * per].view(torch.int32))
        masks, counts = L.shard_reduce(torch.stack([p.view(torch.int32) for p in parts])
                                       .view(torch.uint32), masks=True)
        assert torch.equal(masks.view(torch.int32), one_masks.view(torch.int32))
        assert torch.equal(counts.view(torch.int32), one_counts.view(torch.int32))
        tot, inf = L.classify_sums(masks, counts, tuple(bases.shape), K, bounds)
        classify = L.classify_step_plain if layout == "bucket" else None
        ref = (classify(table, bases, bounds, h, salt, K) if classify else
               L.cuckoo_classify_step_plain(table, meta_t, bases, bounds, h, salt, K))
        assert torch.equal(tot, ref[0]) and torch.equal(inf, ref[1])
        if layout == "bucket":
            words = [G.shard_multi_hit_words(sh.table, sh.lo, bases, h, salt, K, 1)
                     for sh in shards]
            summed = L.shard_reduce(torch.stack([w.reshape(-1).view(torch.int32) for w in words])
                                    .view(torch.uint32), masks=False)
            one_w = G.multi_hit_words_plain(table, bases, h, salt, K, 1)
            assert torch.equal(summed.view(torch.int32), one_w.reshape(-1).view(torch.int32))


def test_shard_reduce_plain_words_wrap_and_masks_recount():
    """R's plain version: words add in uint32 (wrapping), masks OR and the
    count word is recounted from the OR, not summed (a bit set on two
    shards counts once)."""
    from strainer2_tpu_torch.ops.lookup import shard_reduce

    words = torch.tensor([[-1, 7], [2, -16]], dtype=torch.int32)  # 0xFFFFFFFF, 0xFFFFFFF0
    out = shard_reduce(words.view(torch.uint32), masks=False)
    assert out.view(torch.int32).tolist() == [1, -9]
    masks = torch.zeros((2, 16), dtype=torch.int32)
    masks[0, 0] = 0b1011  # hits of windows 0, 1, 3
    masks[1, 0] = 0b0011  # window 0 and 1 again, on the other shard
    masks[1, 8] = 0b1     # window 0 informative
    m, c = shard_reduce(masks.view(torch.uint32), masks=True)
    assert m.view(torch.int32)[:9].tolist() == [0b1011] + [0] * 7 + [1]
    assert c.view(torch.int32).tolist() == [3 << 16 | 1]


def _offset_parts(n_parts: int, n: int, seed: int, offset: int = 1) -> list:
    """n_parts seeded uint32 parts of n words, all ones in the first 16,
    each a view ``offset`` words into a buffer of its own."""
    gen = torch.Generator().manual_seed(seed)
    parts = []
    for _ in range(n_parts):
        buf = torch.randint(-2**31, 2**31, (n + offset,), dtype=torch.int32, generator=gen)
        buf[offset : offset + 16] = -1
        parts.append(buf[offset:].view(torch.uint32))
    return parts


@pytest.mark.parametrize("n_parts", [2, 4, 9])
@pytest.mark.parametrize("masks", [False, True], ids=["words", "masks"])
def test_shard_reduce_on_a_list_of_parts_equals_on_their_stack(masks, n_parts):
    """R and its plain version take the parts as a list (views at a word
    offset included) or as their (I, n) stack, and give the same arrays,
    in both forms; more parts than one pass of the kernel takes."""
    from strainer2_tpu_torch.ops.lookup import shard_reduce, shard_reduce_plain

    parts = _offset_parts(n_parts, 16 * 37, n_parts)
    stacked = torch.stack([p.view(torch.int32) for p in parts]).view(torch.uint32)
    outs = [fn(x, masks=masks) for fn in (shard_reduce, shard_reduce_plain)
            for x in (parts, stacked, [p.clone() for p in parts])]
    for out in outs[1:]:
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(outs[0] if masks else (outs[0],), out if masks else (out,)))
    p64 = stacked.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    want = functools.reduce(torch.bitwise_or, p64.unbind(0)) if masks else p64.sum(0) & 0xFFFFFFFF
    got = (outs[0][0] if masks else outs[0]).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="2 or more"):
        shard_reduce(parts[:1], masks=masks)
    with pytest.raises(ValueError, match="one length"):
        shard_reduce([parts[0], parts[1][:-16]], masks=masks)


@pytest.mark.parametrize("masks", [False, True], ids=["words", "masks"])
def test_reduced_reads_parts_at_a_word_offset(setup, masks):
    """ShardedKmerEngine._reduced over I = 4 shards' outputs that are views
    4 bytes into their buffers (K4s's (masks, counts), or K6s's (Q, N)
    words) gives R of their contiguous copies."""
    from strainer2_tpu_torch.ops.lookup import shard_reduce_plain

    _, index, _, _ = setup
    ours = _ours((1, 4), index.table)
    n = 16 * 24
    parts = _offset_parts(4, n, 7)
    if masks:
        outs = [(p, torch.zeros(n // 16, dtype=torch.uint32)) for p in parts]
    else:
        outs = [p.view(n // 4, 4) for p in parts]
    assert all(p.data_ptr() % 16 for p in parts)
    got = ours._reduced(outs, 0, masks=masks)
    want = shard_reduce_plain([p.clone() for p in parts], masks=masks)
    for a, b in zip(got if masks else (got,), want if masks else (want,)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n_index", [1, 2, 4])
def test_cuckoo_key_in_both_slots_counts_as_jax(n_index):
    """A hand-made cuckoo table holding keys in both of their slots: the
    window probe counts where JAX's _local_lookup does (s1 where one shard
    holds both slots, each shard's own slot where two do).  Neither
    package's builder places a key twice; this pins the corner."""
    from strainer2_tpu.index.hashing import cuckoo_slots
    from strainer2_tpu.ops.packing import canonical_codes_np
    from strainer2_tpu.parallel.sharding import ShardedKmerEngine, make_mesh
    from strainer2_tpu_torch.ops.packing_np import split_code64_np

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, size=600, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, K)
    codes = np.unique(codes[valid])[:40]
    h_bits = 7
    H = 1 << h_bits
    hi, lo = split_code64_np(codes, K)
    s0 = np.asarray(cuckoo_slots(jnp.asarray(hi), jnp.asarray(lo), h_bits, 0))
    s1 = np.asarray(cuckoo_slots(jnp.asarray(hi), jnp.asarray(lo), h_bits, 1)) + H
    table = np.full((2 * H, 2), 0xFFFFFFFF, dtype=np.uint32)
    for j in range(codes.size):  # every key at both slots where both are free
        if table[s0[j], 0] == 0xFFFFFFFF and table[s1[j], 0] == 0xFFFFFFFF:
            table[s0[j]] = (hi[j], lo[j])
            table[s1[j]] = (hi[j], lo[j])
    twice = [j for j in range(codes.size) if (table[s0[j]] == (hi[j], lo[j])).all()
             and (table[s1[j]] == (hi[j], lo[j])).all()]
    assert len(twice) > 10
    bases = np.tile(genome[None, :], (2, 1))
    mesh = make_mesh(1, n_index, devices=jax.devices()[:n_index])
    jx = ShardedKmerEngine(K, mesh, h_bits, 0, 2 * H)
    jc = jx.count_batch(jx.init_counts(), _jax_planes(mesh, table), bases)

    class _T:
        pass

    t = _T()
    t.h_bits, t.salt, t.num_slots = h_bits, 0, 2 * H
    ours = _ours((1, n_index), t)
    oc = ours.count_batch(ours.init_counts(), ours.put_table(table), bases)
    expect = jx.merge_counts(jc)
    np.testing.assert_array_equal(ours.merge_counts(oc), expect)
    assert int(expect[s1[twice]].sum()) > 0


def test_data_shard_past_every_read_gives_zero_partials(setup):
    """Rows tiled over the data axis (__graft_entry__.py's dry run): the
    data shards past the first see windows beyond every boundary, and
    their partials are zero, in classification and multi-strain."""
    engine, index, tb, batches = setup
    max_reads = engine.max_reads
    kinds = np.full(index.num_kmers, 2, np.uint32)
    meta_slots = np.zeros(tb.num_slots, np.uint32)
    meta_slots[tb.slot_of_key] = kinds
    ours = _ours((4, 2), tb, "bucket")
    rows = ours.put_table(tb.with_meta(meta_slots))
    _, rows3 = _multi_rows(index.codes, 3, np.random.default_rng(1))
    multi = ours.put_table(rows3)
    for b in batches[:2]:
        tiled = np.tile(b.bases, (4, 1))
        bounds = _boundaries(b, max_reads)
        tot, inf = ours.classify_batch(rows, tiled, bounds)
        assert int(tot[0].sum()) > 0 and not tot[1:].any() and not inf[1:].any()
        mt, mi = ours.classify_multi_batch(multi, tiled, bounds, 3)
        assert int(mt[0].sum()) > 0 and not mt[1:].any() and not mi[1:].any()


def test_make_mesh_resolution_and_errors(monkeypatch):
    from strainer2_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(2, 4, devices="cpu")
    assert mesh.shape == {"data": 2, "index": 4}
    assert set(mesh.devices) == {torch.device("cpu")}
    given = ["cpu"] * 6
    assert make_mesh(3, 2, devices=given).device(2, 1) == torch.device("cpu")
    with pytest.raises(ValueError, match=r"mesh 2x2 != 3 devices"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        make_mesh(0, 2, devices="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(1, 1)
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(2, 2, devices="cuda:0")
    # a bare cuda is every visible card, as JAX's jax.devices(): D x I must
    # be their number, never fewer cards, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"^mesh 2x2 != 1 devices$"):
        make_mesh(2, 2, devices="cuda")
    with pytest.raises(ValueError, match=r"^mesh 1x2 != 1 devices$"):
        make_mesh(1, 2)
    assert make_mesh(1, 1, devices="cuda").devices == [torch.device("cuda", 0)]
    assert make_mesh(2, 2, devices="cuda:0").devices == [torch.device("cuda", 0)] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_mesh(2, 2).devices == [torch.device("cuda", j) for j in range(4)]
    with pytest.raises(ValueError, match="not one of the 4 visible cards"):
        make_mesh(1, 1, devices="cuda:4")


def test_table_that_does_not_divide_raises_as_jax(setup):
    from strainer2_tpu.parallel.sharding import ShardedKmerEngine as JaxEngine
    from strainer2_tpu.parallel.sharding import make_mesh as jax_mesh
    from strainer2_tpu_torch.parallel.sharding import ShardedKmerEngine, make_mesh, shard_table

    _, index, tb, _ = setup
    t = index.table
    with pytest.raises(ValueError) as theirs:
        JaxEngine(K, jax_mesh(1, 3, devices=jax.devices()[:3]), t.h_bits, t.salt,
                  t.num_slots + 1)
    with pytest.raises(ValueError) as ours:
        ShardedKmerEngine(K, make_mesh(1, 3, devices="cpu"), t.h_bits, t.salt, t.num_slots + 1)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="num_slots must divide evenly"):
        shard_table(np.zeros((t.num_slots + 1, 2), np.uint32), "cuckoo", 2)
    with pytest.raises(ValueError, match="num_slots must divide evenly"):
        shard_table(t.table, "cuckoo", 3)
    with pytest.raises(ValueError, match="whole buckets"):
        shard_table(tb.table[:3], "bucket", 2)  # 48 slots, 3 buckets
    shards = shard_table(tb.table, "bucket", 4)
    assert [s.lo for s in shards] == [j * tb.table.shape[0] // 4 for j in range(4)]
    assert all(s.table.shape[0] == tb.table.shape[0] // 4 for s in shards)


def test_cuckoo_builders_place_each_key_once(setup):
    """Neither package's cuckoo builder holds a key in two slots: the
    tables of the fixture's keys have exactly one occupied slot a key, so
    a built table never reaches the both-slots corner above."""
    from strainer2_tpu_torch.index.cuckoo import build_cuckoo

    _, index, _, _ = setup
    for table in (index.table.table, build_cuckoo(index.codes, K).table):
        occupied = table[(table != 0xFFFFFFFF).any(axis=1)]
        assert occupied.shape[0] == index.num_kmers
        assert np.unique(occupied, axis=0).shape[0] == index.num_kmers


@functools.lru_cache(maxsize=None)
def _jax_planes_fn(layout, h_bits, salt, per, n_index):
    """The jitted shard_map of _jax_shard_planes, one compile a layout and
    mesh."""
    from strainer2_tpu.ops.packing import canonical_windows
    from strainer2_tpu.parallel.sharding import (ShardedKmerEngine, _local_lookup, make_mesh,
                                                 shard_map)

    mesh = make_mesh(1, n_index, devices=jax.devices()[:n_index])

    def planes(hit, inf):
        return jnp.stack([hit, inf]).astype(jnp.int32)[None]

    if layout == "bucket":
        def body(rows_loc, b):
            win = canonical_windows(b, K)
            hit, _, m = ShardedKmerEngine._bucket_local_lookup(
                rows_loc, win.hi.reshape(-1), win.lo.reshape(-1), h_bits, salt, per)
            hit = (hit & win.valid.reshape(-1)).reshape(win.valid.shape)
            return planes(hit, hit & (m.reshape(hit.shape) == 2))

        specs = (P("index", None), P())
    else:
        def body(t_hi, t_lo, meta_loc, b):
            win = canonical_windows(b, K)
            hit, slot = _local_lookup(t_hi, t_lo, win.hi, win.lo, h_bits, salt, per)
            hit = hit & win.valid
            cls = jnp.where(hit, meta_loc[jnp.where(hit, slot, 0).reshape(-1)].reshape(hit.shape), 0)
            return planes(hit, cls == 2)

        specs = (P("index"), P("index"), P("index"), P())
    return jax.jit(shard_map(body, mesh=mesh, in_specs=specs, out_specs=P("index")))


def _jax_shard_planes(layout, table, meta, bases, h_bits, salt, n_index):
    """Per index shard, the hit and informative planes that JAX's
    _classify_body (cuckoo: _local_lookup, class == 2) and
    _classify_body_bucket (_bucket_local_lookup, meta == 2) sum over
    "index": an (n_index, 2, rows, windows) int array, computed by those
    lookups inside a shard_map over a (1, n_index) mesh."""
    per = table.shape[0] // n_index
    fn = _jax_planes_fn(layout, h_bits, salt, per, n_index)
    if layout == "bucket":
        return np.asarray(fn(jnp.asarray(table), jnp.asarray(bases)))
    return np.asarray(fn(*(jnp.asarray(np.ascontiguousarray(table[:, j])) for j in (0, 1)),
                         jnp.asarray(meta), jnp.asarray(bases)))


def _mask_planes(masks, n_rows, length):
    """K4's scratch mask words as (2, rows, windows) hit and informative
    bits."""
    w = length - K + 1
    tpr = -(-w // 256)
    words = masks.view(torch.int32).numpy().view(np.uint32).reshape(n_rows, tpr, 2, 8)
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.transpose(2, 0, 1, 3, 4).reshape(2, n_rows, tpr * 256)[:, :, :w].astype(np.int32)


@pytest.mark.parametrize("batch", ["no_key", "genome"])
@pytest.mark.parametrize("n_index", [2, 4])
@pytest.mark.parametrize("layout", ["bucket", "cuckoo"])
def test_plain_shard_masks_are_jax_psum_planes(setup, layout, n_index, batch):
    """Each index shard's plain K4s masks against the planes that JAX's
    _classify_body_bucket and _classify_body psum over "index", shard by
    shard, and their OR against the psum.  On a batch of random reads the
    table holds none of the batch's keys: every shard window's masks and
    count words are zero, as JAX's planes are; on the genome's reads the
    planes are not."""
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.parallel.sharding import shard_table
    from tests.oracle import random_dna

    _, index, tb, batches = setup
    t = tb if layout == "bucket" else index.table
    kinds = np.where(np.arange(index.num_kmers) % 3 == 0, 2, 1).astype(np.uint32)
    meta = np.zeros(t.num_slots, np.uint32)
    meta[t.slot_of_key] = kinds
    table = tb.with_meta(meta) if layout == "bucket" else t.table
    if batch == "genome":
        bases = batches[0].bases
    else:
        from strainer2_tpu_torch.io.batches import pack_stream

        rng = np.random.default_rng(11)
        reads = [random_dna(rng, int(rng.integers(40, 150)), n_prob=0.02).encode()
                 for _ in range(100)]
        bases = next(pack_stream(iter(reads), K, ROWS, ROW_LEN)).bases
    want = _jax_shard_planes(layout, table, meta, bases, t.h_bits, t.salt, n_index)
    shards = shard_table(torch.from_numpy(table), layout, n_index,
                         None if layout == "bucket" else torch.from_numpy(meta))
    b = torch.from_numpy(bases)
    got = []
    for sh in shards:
        if layout == "bucket":
            masks, counts = L.shard_classify_masks_plain(sh.table, sh.lo, b, t.h_bits, t.salt, K)
        else:
            masks, counts = L.shard_cuckoo_classify_masks_plain(sh.table, sh.meta, sh.lo, b,
                                                                t.h_bits, t.salt, K)
        got.append(_mask_planes(masks, *bases.shape))
        n = counts.view(torch.int32).numpy().astype(np.int64)
        assert (n >> 16).sum() == got[-1][0].sum() and (n & 0xFFFF).sum() == got[-1][1].sum()
        if batch == "no_key":
            assert not masks.view(torch.int32).any() and not counts.view(torch.int32).any()
    np.testing.assert_array_equal(np.stack(got), want)
    np.testing.assert_array_equal(np.stack(got).max(0), np.minimum(want.sum(0), 1))
    assert (int(want.sum()) > 0) == (batch == "genome")


@functools.lru_cache(maxsize=None)
def _count_tables(k):
    """The fixture's genome (the same seeded draw) at k: its JAX bucket
    table and JAX cuckoo table."""
    from strainer2_tpu.index.bucket import build_bucket_table
    from strainer2_tpu.index.cuckoo import build_cuckoo
    from strainer2_tpu.ops.packing_np import canonical_codes_np, encode_ascii_np
    from tests.oracle import random_dna

    genome = random_dna(np.random.default_rng(42), 4000)
    codes, valid = canonical_codes_np(encode_ascii_np(np.frombuffer(genome.encode(), np.uint8)), k)
    keys = np.unique(codes[valid])
    return build_bucket_table(keys, k), build_cuckoo(keys, k)


@functools.lru_cache(maxsize=None)
def _jax_count_fn(layout, k, h_bits, salt, per, n_index):
    """JAX's _count_body_bucket (per: buckets a shard) or _count_body (per:
    slots a shard) in a jitted shard_map over a (1, n_index) mesh: each
    shard adds into its block of the (1, num_slots) counts."""
    from strainer2_tpu.parallel.sharding import ShardedKmerEngine, make_mesh, shard_map

    mesh = make_mesh(1, n_index, devices=jax.devices()[:n_index])
    if layout == "bucket":
        body = functools.partial(ShardedKmerEngine._count_body_bucket, k=k, h_bits=h_bits,
                                 salt=salt, shard_buckets=per)
        specs = (P(None, "index"), P("index", None), P())
    else:
        body = functools.partial(ShardedKmerEngine._count_body, k=k, h_bits=h_bits, salt=salt,
                                 shard_rows=per)
        specs = (P(None, "index"), P("index"), P("index"), P())
    return jax.jit(shard_map(body, mesh=mesh, in_specs=specs, out_specs=P(None, "index")))


@pytest.mark.parametrize("batch", ["no_key", "genome"])
@pytest.mark.parametrize("k", [20, 31, 32])
@pytest.mark.parametrize("n_index", [2, 4])
@pytest.mark.parametrize("layout", ["bucket", "cuckoo"])
def test_plain_shard_counts_are_jax_count_body(setup, layout, n_index, k, batch):
    """Each index shard's K3s counts through the port's entry point (its
    plain version on CPU tensors) against the counts_loc that JAX's
    _count_body_bucket and _count_body give that shard inside a shard_map,
    from the same start: on the genome's reads from counts of which every
    seventh cell is 0xFFFFFFFF (hits there wrap), on random reads from
    zero, where the table holds none of the batch's keys and every shard's
    counts stay zero."""
    from strainer2_tpu_torch.ops import lookup as L
    from strainer2_tpu_torch.parallel.sharding import shard_table
    from tests.oracle import random_dna

    _, _, _, batches = setup
    t = _count_tables(k)[0 if layout == "bucket" else 1]
    if batch == "genome":
        bases = batches[0].bases
    else:
        from strainer2_tpu_torch.io.batches import pack_stream

        rng = np.random.default_rng(11)
        reads = [random_dna(rng, int(rng.integers(40, 150)), n_prob=0.02).encode()
                 for _ in range(100)]
        bases = next(pack_stream(iter(reads), K, ROWS, ROW_LEN)).bases
    start = np.zeros(t.num_slots, np.uint32)
    if batch == "genome":
        start[::7] = 0xFFFFFFFF
    per = t.table.shape[0] // n_index  # buckets (bucket) or slots (cuckoo) a shard
    fn = _jax_count_fn(layout, k, t.h_bits, t.salt, per, n_index)
    if layout == "bucket":
        want = fn(jnp.asarray(start[None]), jnp.asarray(t.table), jnp.asarray(bases))
    else:
        want = fn(jnp.asarray(start[None]),
                  *(jnp.asarray(np.ascontiguousarray(t.table[:, j])) for j in (0, 1)),
                  jnp.asarray(bases))
    want = np.asarray(want)[0]
    b = torch.from_numpy(bases)
    cells = t.num_slots // n_index
    got = []
    for i, sh in enumerate(shard_table(torch.from_numpy(t.table), layout, n_index)):
        c = torch.from_numpy(start[i * cells : (i + 1) * cells].copy())
        if layout == "bucket":
            L.shard_count_step(c, sh.table, sh.lo, b, t.h_bits, t.salt, k)
        else:
            L.shard_cuckoo_count_step(c, sh.table, sh.lo, b, t.h_bits, t.salt, k)
        got.append(c.view(torch.int32).numpy().view(np.uint32))
        np.testing.assert_array_equal(got[-1], want[i * cells : (i + 1) * cells])
    changed = np.concatenate(got) != start
    if batch == "no_key":
        assert not want.any()
    else:
        assert (changed & (start == 0xFFFFFFFF)).any() and (changed & (start == 0)).any()


@functools.lru_cache(maxsize=None)
def _jax_words_fn(h_bits, salt, per, n_index, n_strains):
    """The operand that JAX's _classify_multi_body_bucket psums over
    "index" (strainer2_tpu/parallel/sharding.py:278-291), its words stacked
    as (windows, n_words) columns, in a jitted shard_map over a
    (1, n_index) mesh: shard i's operand is columns [i n_words, (i + 1)
    n_words) of the (windows, n_index n_words) result."""
    from strainer2_tpu.ops.packing import canonical_windows
    from strainer2_tpu.parallel.sharding import ShardedKmerEngine, make_mesh, shard_map

    mesh = make_mesh(1, n_index, devices=jax.devices()[:n_index])

    def body(rows_loc, b):
        win = canonical_windows(b, K)
        qhi, qlo, valid = win.hi.reshape(-1), win.lo.reshape(-1), win.valid.reshape(-1)
        if n_strains > 16:
            hit, words = ShardedKmerEngine._bucket_local_lookup_words(
                rows_loc, qhi, qlo, h_bits, salt, per, -(-n_strains // 16))
            masked = [jnp.where(hit & valid, w, 0) for w in words]
        else:
            hit, _, meta = ShardedKmerEngine._bucket_local_lookup(rows_loc, qhi, qlo, h_bits,
                                                                  salt, per)
            masked = [jnp.where(hit & valid, meta, 0)]
        return jnp.stack(masked, axis=1)

    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P("index", None), P()),
                             out_specs=P(None, "index")))


@pytest.mark.parametrize("batch", ["no_key", "genome"])
@pytest.mark.parametrize("n_index", [2, 4])
@pytest.mark.parametrize("n_strains", [3, 20, 100])
def test_plain_shard_words_are_jax_psum_operand(setup, n_strains, n_index, batch):
    """Each index shard's K6s words through the port's entry point (its
    plain version on CPU tensors) against the masked meta words that JAX's
    _classify_multi_body_bucket gives that shard inside a shard_map before
    its psum over "index" (1, 2 and 7 words a window), shard by shard, and
    their sum against the one-device plain K6.  On a batch of random reads
    the table holds none of the batch's keys: every shard's words are
    zero, as JAX's are; on the genome's reads they are not."""
    from strainer2_tpu_torch.ops.segsum import multi_hit_words_plain, shard_multi_hit_words
    from strainer2_tpu_torch.parallel.sharding import shard_table
    from tests.oracle import random_dna

    _, index, _, batches = setup
    tb, rows = _multi_rows(index.codes, n_strains, np.random.default_rng(n_strains))
    if batch == "genome":
        bases = batches[0].bases
    else:
        from strainer2_tpu_torch.io.batches import pack_stream

        rng = np.random.default_rng(11)
        reads = [random_dna(rng, int(rng.integers(40, 150)), n_prob=0.02).encode()
                 for _ in range(100)]
        bases = next(pack_stream(iter(reads), K, ROWS, ROW_LEN)).bases
    n_words = -(-n_strains // 16)
    per = tb.table.shape[0] // n_index  # buckets a shard
    want = np.asarray(_jax_words_fn(tb.h_bits, tb.salt, per, n_index, n_strains)(
        jnp.asarray(rows), jnp.asarray(bases)))
    assert want.shape == (N_WINDOWS, n_index * n_words)
    b = torch.from_numpy(bases)
    got = []
    for i, sh in enumerate(shard_table(torch.from_numpy(rows), "bucket", n_index)):
        w = shard_multi_hit_words(sh.table, sh.lo, b, tb.h_bits, tb.salt, K, n_words)
        got.append(w.view(torch.int32).numpy().view(np.uint32))
        np.testing.assert_array_equal(got[-1], want[:, i * n_words : (i + 1) * n_words])
    one = multi_hit_words_plain(torch.from_numpy(rows), b, tb.h_bits, tb.salt, K, n_words)
    np.testing.assert_array_equal(np.sum(got, axis=0, dtype=np.uint32),
                                  one.view(torch.int32).numpy().view(np.uint32))
    assert (np.count_nonzero(want) > 0) == (batch == "genome")
    if batch == "genome":
        assert sum(np.count_nonzero(g) > 0 for g in got) >= 2  # words in more than one shard
