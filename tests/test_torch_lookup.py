"""Plain torch lookup, count and classify steps (the CPU side of kernels
K2-K4) vs the JAX package: jnp bucket_lookup and the Pallas gridmap kernel
(interpret mode), engine._count_step_bucket, _classify_step_bucket and (the
cuckoo K4) _classify_step, and the detection pass gate.  All values are
integers: compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strainer2_tpu.index.bucket import build_bucket_table
from strainer2_tpu.index.cuckoo import build_cuckoo
from strainer2_tpu.io.batches import pack_stream, read_codes_from_batch
from strainer2_tpu.ops.lookup import bucket_lookup as jnp_bucket_lookup
from strainer2_tpu.ops.lookup import bucket_lookup_words as jnp_bucket_lookup_words
from strainer2_tpu.ops.packing_np import canonical_codes_np, split_code64_np
from strainer2_tpu.ops.pallas_lookup import bucket_lookup_pallas_gridmap
from strainer2_tpu.pipeline.detect import _passing_any_1d
from strainer2_tpu.pipeline.engine import _classify_step, _classify_step_bucket, _count_step_bucket
from strainer2_tpu_torch.ops.lookup import (
    bucket_lookup, bucket_lookup_words_plain, classify_select_step, classify_step, count_step,
    cuckoo_classify_step, passing_any,
)
from tests.oracle import random_dna, seq_to_base_codes
from tests.test_torch_kernels import (
    EDGE_K, HAND_ROW_WIDTHS, HAND_SALT, SELECT_CASES, duplicate_keys, edge_bounds, edge_rows,
    hand_built_rows, select_case, twice_queries,
)

K = 31


@pytest.fixture(scope="module")
def strain():
    """A strain sequence, its bucket table (JAX builder) and meta rows with
    a class of 1 or 2 per key."""
    rng = np.random.default_rng(5)
    genome = seq_to_base_codes(random_dna(rng, 6000))
    codes, valid = canonical_codes_np(genome, K)
    codes = np.unique(codes[valid])
    table = build_bucket_table(codes, K)
    kinds = np.zeros(table.num_slots, dtype=np.uint32)
    kinds[table.slot_of_key] = np.where(rng.random(codes.size) < 0.3, 2, 1)
    return genome, codes, table, table.with_meta(kinds)


def _reads(rng, genome, n, n_prob=0.02):
    """Reads of 20-300 bases, half cut from the strain, some with Ns."""
    out = []
    for _ in range(n):
        length = int(rng.integers(20, 300))
        if rng.random() < 0.5:
            s = int(rng.integers(0, genome.size - length))
            r = genome[s : s + length].copy()
        else:
            r = rng.integers(0, 4, size=length, dtype=np.uint8)
        r[rng.random(length) < n_prob] = 4
        out.append(r)
    return out


def test_plain_bucket_lookup_matches_jnp_and_pallas(strain):
    _, codes, table, rows = strain
    rng = np.random.default_rng(3)
    n = 2048
    q = np.where(
        rng.random(n) < 0.5,
        codes[rng.integers(0, codes.size, size=n)],
        rng.integers(0, 1 << 62, size=n, dtype=np.uint64),
    )
    qhi, qlo = split_code64_np(q, K)
    found, slot, meta = (
        x.numpy()
        for x in bucket_lookup(torch.from_numpy(rows), table.h_bits, table.salt,
                               torch.from_numpy(qhi), torch.from_numpy(qlo))
    )
    r_found, r_slot, r_meta = (
        np.asarray(x)
        for x in jnp_bucket_lookup(jnp.asarray(rows), table.h_bits, table.salt,
                                   jnp.asarray(qhi), jnp.asarray(qlo))
    )
    # the plain version equals jnp everywhere, misses included
    np.testing.assert_array_equal(found, r_found)
    np.testing.assert_array_equal(slot, r_slot)
    np.testing.assert_array_equal(meta, r_meta)
    assert 0 < found.sum() < n

    p_found, p_slot, p_meta = (
        np.asarray(x)
        for x in bucket_lookup_pallas_gridmap(jnp.asarray(rows), table.h_bits, table.salt,
                                              jnp.asarray(qhi), jnp.asarray(qlo), group=8)
    )
    np.testing.assert_array_equal(p_found.astype(bool), found)
    np.testing.assert_array_equal(p_slot[found], slot[found])
    np.testing.assert_array_equal(p_meta[found], meta[found])


def _hand_lookups(row_width):
    """The hand-built rows and queries, the plain lookup of them, and
    hand_built_rows' answer."""
    rows, qhi, qlo, expect = hand_built_rows(np.random.default_rng(row_width), row_width)
    h_bits = int(np.log2(rows.shape[0]))
    got = [x.numpy() for x in bucket_lookup(torch.from_numpy(rows), h_bits, HAND_SALT,
                                             torch.from_numpy(qhi), torch.from_numpy(qlo))]
    return rows, h_bits, qhi, qlo, got, expect


@pytest.mark.parametrize("row_width", HAND_ROW_WIDTHS)
def test_plain_bucket_lookup_hand_built_rows_match_jnp(row_width):
    """The key_hi-first contract on hand-built rows (a key_hi-only cell
    before the matching one, a key twice, key_hi-only and key_lo-only
    misses) at 48-, 64- and 288-lane rows: the plain lookup gives the built
    answers, and the jnp bucket_lookup the same everywhere, the meta of a
    key held twice included (the sum of both cells' words)."""
    rows, h_bits, qhi, qlo, got, expect = _hand_lookups(row_width)
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g, e)
    ref = jnp_bucket_lookup(jnp.asarray(rows), h_bits, HAND_SALT, jnp.asarray(qhi), jnp.asarray(qlo))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    found, slot, meta = got
    twice = twice_queries(found.size)
    assert twice.any() and found[twice].all() and 0 < found.sum() < found.size
    first = rows[slot[twice] // 16, 32 + slot[twice] % 16]
    assert (meta[twice] != first).all()  # the sum, not the first cell's word


@pytest.mark.parametrize("row_width", [64, 288])
def test_plain_bucket_lookup_words_hand_built_rows_match_jnp(row_width):
    """Every meta word of the hand-built rows (2 and 16 blocks) through the
    plain multi-word lookup and the jnp bucket_lookup_words: each word of a
    key held twice is the sum of both cells' words."""
    rows, h_bits, qhi, qlo, _, expect = _hand_lookups(row_width)
    n_words = (row_width - 32) // 16
    found, slot, words = bucket_lookup_words_plain(torch.from_numpy(rows), h_bits, HAND_SALT,
                                                   torch.from_numpy(qhi), torch.from_numpy(qlo),
                                                   n_words)
    r_found, r_slot, r_words = jnp_bucket_lookup_words(jnp.asarray(rows), h_bits, HAND_SALT,
                                                       jnp.asarray(qhi), jnp.asarray(qlo), n_words)
    np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(r_slot))
    for w, r in zip(words, r_words, strict=True):
        np.testing.assert_array_equal(w.numpy(), np.asarray(r))
    np.testing.assert_array_equal(words[0].numpy(), expect[2])


def test_plain_bucket_lookup_hand_built_rows_match_pallas():
    """The same 64-lane rows through the Pallas gridmap kernel (interpret
    mode): found and meta as the plain lookup gives them (the kernel sums
    the equal cells' words too), slot where found (the kernel answers
    bucket * 16 + 16 on a miss)."""
    rows, h_bits, qhi, qlo, got, _ = _hand_lookups(64)
    p_found, p_slot, p_meta = (
        np.asarray(x)
        for x in bucket_lookup_pallas_gridmap(jnp.asarray(rows), h_bits, HAND_SALT,
                                              jnp.asarray(qhi), jnp.asarray(qlo), group=8)
    )
    found, slot, meta = got
    np.testing.assert_array_equal(p_found.astype(bool), found)
    np.testing.assert_array_equal(p_meta, meta)
    np.testing.assert_array_equal(p_slot[found], slot[found])
    np.testing.assert_array_equal(p_slot[~found], slot[~found] + 16)


@pytest.mark.parametrize("rows,row_len", [(8, 256), (16, 512)])
def test_plain_count_step_matches_engine(strain, rows, row_len):
    genome, _, table, _ = strain
    rng = np.random.default_rng(rows)
    batch = next(pack_stream(iter(_reads(rng, genome, 60)), K, rows, row_len))
    counts = np.zeros(table.num_slots, dtype=np.uint32)
    counts[table.slot_of_key[::7]] = 0xFFFFFFFF  # these wrap to 0 on a hit
    ref = np.asarray(
        _count_step_bucket(jnp.asarray(counts), jnp.asarray(table.table), batch.bases,
                           k=K, h_bits=table.h_bits, salt=table.salt)
    )
    got = count_step(torch.from_numpy(counts.copy()), torch.from_numpy(table.table),
                     torch.from_numpy(batch.bases), table.h_bits, table.salt, K).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != counts).any()


@pytest.mark.parametrize("row_len", [40, 1000])
@pytest.mark.parametrize("k", EDGE_K)
def test_plain_count_step_edges_match_engine(strain, k, row_len):
    """The edge batches of K3's card test (every k the port takes, rows
    shorter than a tile, N at row and tile edges, an all-N row, counts
    that wrap) through the plain version and the JAX engine."""
    genome = strain[0]
    rng = np.random.default_rng(k * row_len)
    codes, valid = canonical_codes_np(genome, k)
    table = build_bucket_table(np.unique(codes[valid]), k)
    bases = edge_rows(rng, genome, row_len)
    counts = np.zeros(table.num_slots, dtype=np.uint32)
    counts[table.slot_of_key[::3]] = 0xFFFFFFFF
    ref = np.asarray(
        _count_step_bucket(jnp.asarray(counts), jnp.asarray(table.table), bases,
                           k=k, h_bits=table.h_bits, salt=table.salt)
    )
    got = count_step(torch.from_numpy(counts.copy()), torch.from_numpy(table.table),
                     torch.from_numpy(bases), table.h_bits, table.salt, k).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != counts).any()


@pytest.mark.parametrize("group_size", [1, 2])
def test_plain_classify_step_matches_engine(strain, group_size):
    from strainer2_tpu.io.batches import max_reads_capacity

    genome, _, table, rows = strain
    rng = np.random.default_rng(10 + group_size)
    rows_n, row_len = 8, 256
    batch = next(pack_stream(iter(_reads(rng, genome, 40)), K, rows_n, row_len,
                             with_read_ids=True, group_size=group_size))
    max_reads = max_reads_capacity(K, rows_n, row_len)
    bounds = np.full(max_reads + 1, rows_n * (row_len - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    r_tot, r_inf = (
        np.asarray(x)
        for x in _classify_step_bucket(jnp.asarray(rows), batch.bases, jnp.asarray(bounds),
                                       k=K, h_bits=table.h_bits, salt=table.salt,
                                       max_reads=max_reads)
    )
    tot, inf = classify_step(torch.from_numpy(rows), torch.from_numpy(batch.bases),
                             torch.from_numpy(bounds), table.h_bits, table.salt, K)
    np.testing.assert_array_equal(tot.numpy(), r_tot)
    np.testing.assert_array_equal(inf.numpy(), r_inf)
    assert tot.dtype == inf.dtype == torch.int32
    assert r_tot.sum() > 0 and r_inf.sum() > 0


def test_plain_classify_step_duplicate_keys_match_engine(strain):
    """The plain K4 on rows where a third of the keys are held twice
    (``duplicate_keys``: a class of 1 sums to informative, one of 2 to
    not) against _classify_step_bucket, which compares bucket_lookup's meta
    sum with INFORMATIVE_KMER; the first equal cell alone would differ."""
    from strainer2_tpu.io.batches import max_reads_capacity

    genome, _, table, rows = strain
    rng = np.random.default_rng(31)
    dup = duplicate_keys(rows, rng)
    rows_n, row_len = 8, 256
    batch = next(pack_stream(iter(_reads(rng, genome, 40)), K, rows_n, row_len, with_read_ids=True))
    max_reads = max_reads_capacity(K, rows_n, row_len)
    bounds = np.full(max_reads + 1, rows_n * (row_len - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    outs = {}
    for name, r in (("dup", dup), ("once", rows)):
        ref = _classify_step_bucket(jnp.asarray(r), batch.bases, jnp.asarray(bounds), k=K,
                                    h_bits=table.h_bits, salt=table.salt, max_reads=max_reads)
        got = classify_step(torch.from_numpy(r), torch.from_numpy(batch.bases),
                            torch.from_numpy(bounds), table.h_bits, table.salt, K)
        for g, x in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        outs[name] = got
    np.testing.assert_array_equal(outs["dup"][0].numpy(), outs["once"][0].numpy())
    assert not np.array_equal(outs["dup"][1].numpy(), outs["once"][1].numpy())


@pytest.mark.parametrize("paired", [False, True])
def test_passing_any_matches_jax(paired):
    rng = np.random.default_rng(int(paired))
    tot = rng.integers(0, 3, size=64).astype(np.int32)
    inf = rng.integers(0, 2, size=64).astype(np.int32)
    ref = np.asarray(_passing_any_1d(jnp.asarray(tot), jnp.asarray(inf), paired=paired,
                                     min_t=2, min_i=1))
    got = passing_any(torch.from_numpy(tot), torch.from_numpy(inf), paired=paired, min_t=2, min_i=1)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kernel_wrappers_reject_mixed_devices(strain):
    _, _, table, _ = strain
    bases = torch.zeros((2, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):
        count_step(torch.zeros(table.num_slots, dtype=torch.uint32),
                   torch.from_numpy(table.table), bases.to("meta"), table.h_bits, table.salt, K)


def test_plain_classify_step_edge_spans_match_engine(strain):
    """The plain K4 against _classify_step_bucket on reads crossing rows and
    256-window tiles of an (8, 512) batch, then the edge spans of
    ``edge_bounds``: a whole row, the whole batch, empty and
    reversed spans, bounds below 0 and above the window count."""
    genome, _, table, rows = strain
    rng = np.random.default_rng(21)
    n_rows, row_len = 8, 512
    width = row_len - K + 1
    q = n_rows * width
    reads = [genome[s : s + n].copy() for s, n in zip(rng.integers(0, genome.size - 400, 12),
                                                       rng.integers(200, 400, 12))]
    batch = next(pack_stream(iter(reads), K, n_rows, row_len, with_read_ids=True))
    starts = np.asarray(batch.window_starts)
    ends = starts[1:] - 1  # last window of each read but the last
    assert (starts[:-1] // width != ends // width).any()  # a read crosses rows
    assert ((starts[:-1] % width) // 256 != (ends % width) // 256).any()  # and tiles
    bounds = np.concatenate([batch.window_starts, edge_bounds(q, width)]).astype(np.int32)
    r_tot, r_inf = (
        np.asarray(x)
        for x in _classify_step_bucket(jnp.asarray(rows), batch.bases, jnp.asarray(bounds),
                                       k=K, h_bits=table.h_bits, salt=table.salt,
                                       max_reads=bounds.size - 1)
    )
    tot, inf = classify_step(torch.from_numpy(rows), torch.from_numpy(batch.bases),
                             torch.from_numpy(bounds), table.h_bits, table.salt, K)
    np.testing.assert_array_equal(tot.numpy(), r_tot)
    np.testing.assert_array_equal(inf.numpy(), r_inf)
    assert (r_tot < 0).any() and r_tot.max() > 100 and r_inf.sum() > 0


@pytest.mark.parametrize("layout", ["bucket", "cuckoo"])
def test_plain_classify_step_two_scan_passes_match_engine(strain, layout):
    """The plain K4 in either layout against _classify_step_bucket or
    _classify_step on a filled batch of more than 4,096 256-window tiles
    (2,100 rows of 287 bases, two tiles a row: the kernel's sums launch
    scans the tile counts in two passes there), then the edge spans of
    ``edge_bounds``."""
    genome, codes, table, rows = strain
    rng = np.random.default_rng(43)
    n_rows, row_len = 2100, 287
    width = row_len - K + 1
    batch = next(pack_stream(iter(_reads(rng, genome, 4000)), K, n_rows, row_len,
                             with_read_ids=True))
    assert n_rows * -(-width // 256) > 4096
    assert int(batch.window_starts[-1]) >= 2048 * width  # reads in the second pass's tiles
    bounds = np.concatenate([batch.window_starts, edge_bounds(n_rows * width, width)])
    bounds = bounds.astype(np.int32)
    kw = dict(k=K, max_reads=bounds.size - 1)
    bases, bounds_t = torch.from_numpy(batch.bases), torch.from_numpy(bounds)
    if layout == "bucket":
        ref = _classify_step_bucket(jnp.asarray(rows), batch.bases, jnp.asarray(bounds),
                                    h_bits=table.h_bits, salt=table.salt, **kw)
        got = classify_step(torch.from_numpy(rows), bases, bounds_t, table.h_bits, table.salt, K)
    else:
        ct = build_cuckoo(codes, K)
        meta = np.zeros(ct.num_slots, dtype=np.uint32)
        meta[ct.slot_of_key] = np.where(rng.random(codes.size) < 0.3, 2, 1)
        ref = _classify_step(jnp.asarray(np.ascontiguousarray(ct.table[:, 0])),
                             jnp.asarray(np.ascontiguousarray(ct.table[:, 1])), jnp.asarray(meta),
                             batch.bases, jnp.asarray(bounds), h_bits=ct.h_bits, salt=ct.salt,
                             **kw)
        got = cuckoo_classify_step(torch.from_numpy(ct.table), torch.from_numpy(meta), bases,
                                   bounds_t, ct.h_bits, ct.salt, K)
    for g, x in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    r_tot, r_inf = (np.asarray(x) for x in ref)
    assert (r_tot < 0).any() and r_tot.max() > 1000 and r_inf.sum() > 0


def jax_emission(batch, tot, inf, paired: bool, min_t: int, min_i: int, keys, key_kinds,
                 k: int = K):
    """What the JAX package's host emission writes for one batch, as K4e's
    selection: its pass rule (``_passing_any_1d``) over the first n reads,
    or their n // 2 pairs, then each passing read rebuilt from the batch
    (``read_codes_from_batch``), its windows' canonical codes
    (``canonical_codes_np``) and those of a key of class 2 kept.  Returns
    the passing units' sums (r1, t1, i1, t2, i2), the rows' codes and their
    reads' ordinals, as numpy."""
    per = 2 if paired else 1
    m = batch.n_reads // per * per
    ok = np.asarray(_passing_any_1d(jnp.asarray(tot[:m]), jnp.asarray(inf[:m]), paired=paired,
                                    min_t=min_t, min_i=min_i))
    order = np.argsort(keys)
    sorted_keys, sorted_kinds = keys[order], key_kinds[order]
    sums, codes, ords = [], [], []
    for u in np.flatnonzero(ok):
        r1 = int(u) * per
        sums.append([r1, tot[r1], inf[r1], tot[r1 + 1] if paired else 0,
                     inf[r1 + 1] if paired else 0])
        for r in range(r1, r1 + per):
            cc, valid = canonical_codes_np(read_codes_from_batch(batch, r, k), k)
            pos = np.clip(np.searchsorted(sorted_keys, cc), 0, sorted_keys.size - 1)
            hit = valid & (sorted_keys[pos] == cc) & (sorted_kinds[pos] == 2)
            codes.append(cc[hit])
            ords.append(np.full(int(hit.sum()), r))
    return (np.asarray(sums, dtype=np.int64).reshape(-1, 5),
            np.concatenate(codes or [np.empty(0, np.uint64)]),
            np.concatenate(ords or [np.empty(0, np.int64)]))


def check_selection(got, want, case: str, batch, paired: bool, min_t: int, min_i: int) -> None:
    """A Selection against ``jax_emission``'s rows, and what each of
    SELECT_CASES is there to show."""
    sums, codes, ords = want
    assert got.counts.tolist() == [len(sums), codes.size]
    np.testing.assert_array_equal(got.sums.numpy(), sums)
    np.testing.assert_array_equal(got.codes.numpy().view(np.uint64), codes)
    np.testing.assert_array_equal(got.ords.numpy(), ords)
    n = batch.n_reads
    assert len(sums) > 0
    assert (codes.size == 0) == (case == "gate_with_zero_rows")
    unit_inf = sums[:, 2] + sums[:, 4]
    if case == "pass_without_informative":
        assert (unit_inf == 0).any() and (unit_inf > 0).any()
    if case == "pei_odd_last_read":
        assert n % 2 and (sums[:, 0] < n - 1).all()
    if case == "reads_split_across_rows":
        width = batch.bases.shape[1] - K + 1
        starts = np.append(np.asarray(batch.window_starts), batch.bases.shape[0] * width)
        crosses = starts[1:][ords] // width > starts[ords] // width
        assert crosses.any()
    if case == "reads_with_n":
        passing_reads = set(ords.tolist())
        assert any((batch.bases.reshape(-1)[batch.read_id.reshape(-1) == r] == 4).any()
                   for r in passing_reads)
    if case == "thresholds_at_a_unit":
        at = (sums[:, 1] + sums[:, 3] == min_t) & (unit_inf == min_i)
        assert at.any() and len(sums) < n // 2
    if case == "thresholds_zero":
        assert len(sums) == (n // 2 if paired else n)


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_plain_classify_select_step_matches_jax_emission(strain, case):
    """K4 then K4e's plain version (the CPU side of the kernels, on the
    bucket rows) against the JAX package's emission of the same batch from
    its _classify_step_bucket sums: SE, PE and a PEI batch with an odd last
    read, reads split across rows, reads with N, a passing pair with no
    informative window, a gate passed with zero rows (no informative key),
    thresholds at a unit's own sums and at zero."""
    genome, codes, table, rows = strain
    if case == "gate_with_zero_rows":
        rows = table.with_meta(np.ones(table.num_slots, dtype=np.uint32))
    key_kinds = rows[:, 32:48].reshape(-1)[table.slot_of_key]

    def classify(bases, bounds):
        return tuple(np.asarray(x) for x in _classify_step_bucket(
            jnp.asarray(rows), bases, jnp.asarray(bounds), k=K, h_bits=table.h_bits,
            salt=table.salt, max_reads=bounds.size - 1))

    batch, bounds, paired, min_t, min_i = select_case(case, genome, pack_stream, classify)
    tot, inf = classify(batch.bases, bounds)
    got = classify_select_step(torch.from_numpy(rows), torch.from_numpy(batch.bases),
                               torch.from_numpy(bounds), table.h_bits, table.salt, K,
                               n_reads=batch.n_reads, paired=paired, min_t=min_t, min_i=min_i)
    want = jax_emission(batch, tot, inf, paired, min_t, min_i, codes, key_kinds)
    check_selection(got, want, case, batch, paired, min_t, min_i)

