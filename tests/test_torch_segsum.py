"""The CPU side of the multi-strain kernels against the JAX package:
bucket_lookup_words_plain vs ops.lookup.bucket_lookup_words; K6's plain
version (multi_hit_words) vs canonical_windows + bucket_lookup_words + the
hit mask; K7's plain version (boundary_strain_sums) vs ops.segsum; and the
engine's classify_multi_batch vs multi_detect._classify_multi.  All values
are integers: compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strainer2_tpu.index.bucket import build_bucket_table
from strainer2_tpu.io.batches import max_reads_capacity, pack_stream
from strainer2_tpu.ops.lookup import bucket_lookup, bucket_lookup_words
from strainer2_tpu.ops.packing import canonical_windows
from strainer2_tpu.ops.packing_np import canonical_codes_np, split_code64_np
from strainer2_tpu.ops.segsum import boundary_strain_sums as jax_strain_sums
from strainer2_tpu.pipeline.multi_detect import _classify_multi
from strainer2_tpu_torch.ops.lookup import bucket_lookup_words_plain
from strainer2_tpu_torch.ops.segsum import boundary_strain_sums, multi_hit_words, words_for_strains
from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
from tests.oracle import random_dna, seq_to_base_codes
from tests.test_torch_kernels import duplicate_keys, edge_bounds, edge_rows

K = 31


@pytest.fixture(scope="module")
def strain():
    """A strain sequence and its distinct canonical k-mers."""
    rng = np.random.default_rng(7)
    genome = seq_to_base_codes(random_dna(rng, 6000))
    codes, valid = canonical_codes_np(genome, K)
    return genome, np.unique(codes[valid])


def _rows(codes, n_blocks: int, seed: int):
    """Union-style row table with n_blocks meta blocks of seeded words."""
    rng = np.random.default_rng(seed)
    t = build_bucket_table(codes, K, row_width=32 + 16 * n_blocks)
    words = [rng.integers(0, 1 << 32, size=t.num_slots, dtype=np.uint64).astype(np.uint32)
             for _ in range(n_blocks)]
    return t, t.with_meta_words(words)


# ---- first half: the multi-word probe -------------------------------------

@pytest.mark.parametrize("n_words,n_blocks", [(2, 2), (7, 9), (16, 16)])
def test_bucket_lookup_words_plain_matches_jax(strain, n_words, n_blocks):
    _, codes = strain
    t, rows = _rows(codes, n_blocks, n_words)
    rng = np.random.default_rng(n_words)
    q = np.where(rng.random(3000) < 0.5, codes[rng.integers(0, codes.size, 3000)],
                 rng.integers(0, 1 << 62, 3000, dtype=np.uint64)).reshape(60, 50)
    qhi, qlo = split_code64_np(q.reshape(-1), K)
    qhi, qlo = qhi.reshape(q.shape), qlo.reshape(q.shape)
    found, slot, words = bucket_lookup_words_plain(
        torch.from_numpy(rows), t.h_bits, t.salt, torch.from_numpy(qhi), torch.from_numpy(qlo), n_words)
    r_found, r_slot, r_words = bucket_lookup_words(
        jnp.asarray(rows), t.h_bits, t.salt, jnp.asarray(qhi), jnp.asarray(qlo), n_words)
    np.testing.assert_array_equal(found.numpy(), np.asarray(r_found))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(r_slot))
    assert len(words) == len(r_words) == n_words
    for w, r in zip(words, r_words):
        assert w.shape == q.shape and w.dtype == torch.uint32
        np.testing.assert_array_equal(w.numpy(), np.asarray(r))
    assert 0 < int(found.sum()) < q.size


def test_bucket_lookup_words_plain_rejects_missing_blocks(strain):
    _, codes = strain
    t, rows = _rows(codes, 2, 0)
    q = torch.zeros(4, dtype=torch.uint32)
    with pytest.raises(ValueError, match="3 meta words > 2 blocks"):
        bucket_lookup_words_plain(torch.from_numpy(rows), t.h_bits, t.salt, q, q, 3)


# ---- second half: per-read, per-strain sums -------------------------------

@pytest.mark.parametrize("q", [1000, 1024])
@pytest.mark.parametrize("n_strains", [1, 16, 20, 97, 256])
def test_boundary_strain_sums_matches_jax(n_strains, q):
    """Random words (bits of strains past S set too: they must be ignored),
    a quarter of the windows masked to 0 as misses; reads of random spans
    with empty ones, padded with Q, the last boundary Q; Q = 1000 is not a
    multiple of the JAX chunk (128), Q = 1024 is."""
    rng = np.random.default_rng(n_strains * 7 + q)
    n_words = words_for_strains(n_strains)
    words = rng.integers(0, 1 << 32, size=(q, n_words), dtype=np.uint64).astype(np.uint32)
    words[rng.random(q) < 0.25] = 0
    cuts = np.sort(rng.integers(0, q + 1, size=40))
    cuts[5:8] = cuts[5]  # empty reads
    bounds = np.concatenate([[0], cuts, np.full(9, q)]).astype(np.int32)
    tot, inf = boundary_strain_sums(torch.from_numpy(words), torch.from_numpy(bounds), n_strains)
    r_tot, r_inf = jax_strain_sums([jnp.asarray(words[:, j]) for j in range(n_words)],
                                   jnp.asarray(bounds), n_strains)
    assert tot.shape == inf.shape == (bounds.size - 1, n_strains)
    assert tot.dtype == inf.dtype == torch.int32
    np.testing.assert_array_equal(tot.numpy(), np.asarray(r_tot))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(r_inf))
    assert tot.numpy().sum() > 0 and (tot.numpy()[-8:] == 0).all()


def test_boundary_strain_sums_checks_arguments():
    words = torch.zeros((10, 2), dtype=torch.uint32)
    b = torch.tensor([0, 5, 10], dtype=torch.int32)
    with pytest.raises(ValueError, match="n_strains 33"):
        boundary_strain_sums(words, b, 33)
    with pytest.raises(ValueError, match="uint32"):
        boundary_strain_sums(words.view(torch.int32), b, 3)
    with pytest.raises(ValueError, match="int32"):
        boundary_strain_sums(words, b.to(torch.int64), 3)


def _batch(genome, rng, rows=8, row_len=256):
    reads = []
    for _ in range(40):
        n = int(rng.integers(20, 200))
        if rng.random() < 0.6:
            s = int(rng.integers(0, genome.size - n))
            r = genome[s : s + n].copy()
        else:
            r = rng.integers(0, 4, size=n, dtype=np.uint8)
        r[rng.random(n) < 0.02] = 4
        reads.append(r)
    batch = next(pack_stream(iter(reads), K, rows, row_len, with_read_ids=True))
    max_reads = max_reads_capacity(K, rows, row_len)
    bounds = np.full(max_reads + 1, rows * (row_len - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    return batch, bounds, max_reads


@pytest.mark.parametrize("n_strains", [3, 40])
def test_multi_hit_words_plain_matches_jax_pieces(strain, n_strains):
    genome, codes = strain
    n_words = words_for_strains(n_strains)
    t, rows = _rows(codes, max(2, n_words), n_strains)
    batch, _, _ = _batch(genome, np.random.default_rng(n_strains))
    win = canonical_windows(jnp.asarray(batch.bases), K)
    if n_strains > 16:
        found, _, words = bucket_lookup_words(jnp.asarray(rows), t.h_bits, t.salt, win.hi, win.lo, n_words)
    else:
        found, _, meta = bucket_lookup(jnp.asarray(rows), t.h_bits, t.salt, win.hi, win.lo)
        words = [meta]
    hit = np.asarray(found & win.valid).reshape(-1)
    want = np.stack([np.where(hit, np.asarray(w).reshape(-1), 0) for w in words], axis=1)
    got = multi_hit_words(torch.from_numpy(rows), torch.from_numpy(batch.bases), t.h_bits, t.salt, K,
                          n_words)
    assert got.dtype == torch.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert hit.any()


@pytest.mark.parametrize("k,n_words", [(1, 1), (15, 2), (16, 3), (17, 16), (20, 1), (31, 3), (32, 16)])
def test_multi_hit_words_plain_edges_match_jax(strain, k, n_words):
    """The edge batches of K6's card test (k and n_words as there, N at row
    and tile edges, an all-N row) through the plain version and the JAX
    pieces."""
    genome = strain[0]
    rng = np.random.default_rng(k)
    codes, valid = canonical_codes_np(genome, k)
    t = build_bucket_table(np.unique(codes[valid]), k, row_width=32 + 16 * max(2, n_words))
    rows = t.with_meta_words([rng.integers(0, 1 << 32, size=t.num_slots, dtype=np.uint64).astype(np.uint32)
                              for _ in range(max(2, n_words))])
    bases = edge_rows(rng, genome, 300)
    win = canonical_windows(jnp.asarray(bases), k)
    found, _, words = bucket_lookup_words(jnp.asarray(rows), t.h_bits, t.salt, win.hi, win.lo, n_words)
    hit = np.asarray(found & win.valid).reshape(-1)
    want = np.stack([np.where(hit, np.asarray(w).reshape(-1), 0) for w in words], axis=1)
    got = multi_hit_words(torch.from_numpy(rows), torch.from_numpy(bases), t.h_bits, t.salt, k, n_words)
    np.testing.assert_array_equal(got.numpy(), want)
    assert hit.any()


def _classify_multi_both(genome, codes, n_strains, rng, duplicate=False):
    """The engine's K6 -> K7 and _classify_multi on an (8, 256) batch, with
    per-strain 2-bit meta (present for ~70% of keys, informative for
    ~30%); with ``duplicate``, a third of the keys held twice in their rows
    (duplicate_keys), whose meta words the JAX lookups sum.  Returns the
    port's (tot, inf) and the JAX package's."""
    t = build_bucket_table(codes, K, row_width=32 + 16 * max(2, words_for_strains(n_strains)))
    present = rng.random((n_strains, codes.size)) < 0.7
    informative = present & (rng.random((n_strains, codes.size)) < 0.4)
    words = []
    for j in range(words_for_strains(n_strains)):
        w = np.zeros(t.num_slots, dtype=np.uint32)
        for s in range(16 * j, min(16 * j + 16, n_strains)):
            sh = 2 * (s % 16)
            w[t.slot_of_key] |= (present[s].astype(np.uint32) << sh) | (informative[s].astype(np.uint32) << (sh + 1))
        words.append(w)
    rows = t.with_meta_words(words)
    if duplicate:
        rows = duplicate_keys(rows, rng)
    batch, bounds, max_reads = _batch(genome, rng)
    ref = _classify_multi(jnp.asarray(rows), batch.bases, jnp.asarray(bounds), k=K,
                          h_bits=t.h_bits, salt=t.salt, max_reads=max_reads,
                          n_strains=n_strains)
    eng = TorchKmerEngine(K, max_reads, device="cpu")
    got = eng.classify_multi_batch(torch.from_numpy(rows), t.h_bits, t.salt, batch.bases,
                                   bounds, n_strains)
    assert got[0].shape == (max_reads, n_strains)
    return [x.numpy() for x in got], [np.asarray(x) for x in ref]


@pytest.mark.parametrize("n_strains", [3, 20, 40])
def test_classify_multi_batch_matches_jax(strain, n_strains):
    """The engine's K6 -> K7 on an (8, 256) batch == _classify_multi, with
    per-strain 2-bit meta (present for ~70% of keys, informative for ~30%)."""
    genome, codes = strain
    (tot, inf), (r_tot, r_inf) = _classify_multi_both(genome, codes, n_strains,
                                                      np.random.default_rng(100 + n_strains))
    np.testing.assert_array_equal(tot, r_tot)
    np.testing.assert_array_equal(inf, r_inf)
    assert r_inf.sum() > 0


@pytest.mark.parametrize("n_strains", [3, 40])
def test_classify_multi_batch_duplicate_keys_match_jax(strain, n_strains):
    """The same on rows where a third of the keys are held twice: the plain
    multi words carry the sum of both cells' words, as bucket_lookup (S <=
    16) and bucket_lookup_words (S > 16) give them to _classify_multi."""
    genome, codes = strain
    (tot, inf), (r_tot, r_inf) = _classify_multi_both(
        genome, codes, n_strains, np.random.default_rng(200 + n_strains), duplicate=True)
    np.testing.assert_array_equal(tot, r_tot)
    np.testing.assert_array_equal(inf, r_inf)
    assert r_inf.sum() > 0


@pytest.mark.parametrize("n_words", [1, 3])
def test_multi_hit_words_plain_duplicate_keys_match_jax(strain, n_words):
    """K6's plain version on rows where a third of the keys are held twice
    equals the JAX pieces, whose words are the sums over equal cells, and
    differs from the same rows held once."""
    genome, codes = strain
    rng = np.random.default_rng(300 + n_words)
    t, once = _rows(codes, max(2, n_words), n_words)
    dup = duplicate_keys(once, rng)
    batch, _, _ = _batch(genome, rng)
    win = canonical_windows(jnp.asarray(batch.bases), K)
    found, _, words = bucket_lookup_words(jnp.asarray(dup), t.h_bits, t.salt, win.hi, win.lo, n_words)
    hit = np.asarray(found & win.valid).reshape(-1)
    want = np.stack([np.where(hit, np.asarray(w).reshape(-1), 0) for w in words], axis=1)
    got = multi_hit_words(torch.from_numpy(dup), torch.from_numpy(batch.bases), t.h_bits, t.salt, K,
                          n_words).numpy()
    np.testing.assert_array_equal(got, want)
    plain_once = multi_hit_words(torch.from_numpy(once), torch.from_numpy(batch.bases), t.h_bits,
                                 t.salt, K, n_words).numpy()
    assert hit.any() and not np.array_equal(got, plain_once)


# ---- edge cases of the per-read sums --------------------------------------

def jnp_gather_strain_sums(words, bounds, n_strains):
    """Per-strain prefix sums read at the boundaries by a jnp gather (the
    formulation of engine._classify_step_bucket, one strain at a time)."""
    s = np.arange(n_strains)
    w = jnp.asarray(words)[:, s // 16]
    out = []
    for bit in (0, 1):
        plane = ((w >> jnp.asarray(2 * (s % 16) + bit, dtype=jnp.uint32)) & 1).astype(jnp.int32)
        cum = jnp.concatenate([jnp.zeros((1, n_strains), jnp.int32), jnp.cumsum(plane, axis=0)])
        b = jnp.asarray(bounds)
        out.append(np.asarray(cum[b[1:]] - cum[b[:-1]]))
    return out


@pytest.mark.parametrize("ones", [False, True], ids=["random", "all_ones"])
@pytest.mark.parametrize("n_strains", [1, 17, 33, 255, 256])
def test_boundary_strain_sums_edge_spans_match_jax(n_strains, ones):
    """The plain K7 on the edge spans: in-range boundaries against
    ops.segsum.boundary_strain_sums; all of them, out-of-range ones
    included, against the jnp gather of per-strain prefix sums (the JAX
    segsum's own result there depends on its chunk)."""
    q, row = 4 * 1000, 1000
    rng = np.random.default_rng(n_strains + 1000 * ones)
    n_words = words_for_strains(n_strains)
    if ones:
        words = np.full((q, n_words), 0xFFFFFFFF, dtype=np.uint32)
    else:
        words = rng.integers(0, 1 << 32, size=(q, n_words), dtype=np.uint64).astype(np.uint32)
    bounds = edge_bounds(q, row)
    tot, inf = boundary_strain_sums(torch.from_numpy(words), torch.from_numpy(bounds), n_strains)
    r_tot, r_inf = jnp_gather_strain_sums(words, bounds, n_strains)
    np.testing.assert_array_equal(tot.numpy(), r_tot)
    np.testing.assert_array_equal(inf.numpy(), r_inf)
    inside = bounds[(bounds >= 0) & (bounds <= q)]
    i_tot, i_inf = boundary_strain_sums(torch.from_numpy(words), torch.from_numpy(inside), n_strains)
    j_tot, j_inf = jax_strain_sums([jnp.asarray(words[:, j]) for j in range(n_words)],
                                   jnp.asarray(inside), n_strains)
    np.testing.assert_array_equal(i_tot.numpy(), np.asarray(j_tot))
    np.testing.assert_array_equal(i_inf.numpy(), np.asarray(j_inf))
    assert (tot.numpy() < 0).any() and (tot.numpy() > 0).any()
    if ones:
        spans = np.diff(np.clip(np.where(bounds < 0, bounds + q + 1, bounds), 0, q))
        np.testing.assert_array_equal(tot.numpy(), np.repeat(spans[:, None], n_strains, axis=1))
