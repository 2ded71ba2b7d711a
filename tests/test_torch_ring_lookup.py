"""The CPU side of K5 (bucket_lookup_ring) against the JAX package's Pallas
DMA-ring lookup (bucket_lookup_pallas_manual, interpret mode) and the jnp
bucket_lookup; its argument checks; and the port's lookup A/B tool on a
small table.  All values are integers: compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strainer2_tpu.index.bucket import build_bucket_table
from strainer2_tpu.ops.lookup import bucket_lookup as jnp_bucket_lookup
from strainer2_tpu.ops.packing_np import split_code64_np
from strainer2_tpu.ops.pallas_lookup import bucket_lookup_pallas_manual
from strainer2_tpu_torch.ops.lookup import bucket_lookup_ring
from strainer2_tpu_torch.tools.bench_lookup import bench, main
from tests.test_torch_kernels import HAND_ROW_WIDTHS, HAND_SALT, hand_built_rows, twice_queries

K = 31
N = 2048


@pytest.fixture(scope="module")
def table():
    """5000 random keys (the JAX builder), a meta word per slot, and N
    queries of which half are present; jnp's lookup as the reference."""
    rng = np.random.default_rng(3)
    codes = np.unique(rng.integers(0, 1 << 62, size=5000, dtype=np.uint64))
    t = build_bucket_table(codes, K)
    meta = (np.arange(t.num_slots, dtype=np.uint32) * 2654435761) & 0xFFFFFFFF
    rows = t.with_meta(meta)
    q = np.where(
        rng.random(N) < 0.5,
        codes[rng.integers(0, codes.size, size=N)],
        rng.integers(0, 1 << 62, size=N, dtype=np.uint64),
    )
    qhi, qlo = split_code64_np(q, K)
    ref = tuple(
        np.asarray(x)
        for x in jnp_bucket_lookup(jnp.asarray(rows), t.h_bits, t.salt, jnp.asarray(qhi), jnp.asarray(qlo))
    )
    return t, rows, qhi, qlo, ref


def _ring(table, **kw):
    t, rows, qhi, qlo, _ = table
    return tuple(
        x.numpy()
        for x in bucket_lookup_ring(torch.from_numpy(rows), t.h_bits, t.salt,
                                    torch.from_numpy(qhi), torch.from_numpy(qlo), **kw)
    )


def test_ring_matches_pallas_manual_on_found_and_jnp_everywhere(table):
    t, rows, qhi, qlo, (r_found, r_slot, r_meta) = table
    found, slot, meta = _ring(table, w=8, d=4, chunk=512)
    p_found, p_slot, p_meta = (
        np.asarray(x)
        for x in bucket_lookup_pallas_manual(jnp.asarray(rows), t.h_bits, t.salt,
                                             jnp.asarray(qhi), jnp.asarray(qlo),
                                             w=8, d=4, chunk=512)
    )
    np.testing.assert_array_equal(found, p_found)
    np.testing.assert_array_equal(slot[found], p_slot[found])
    np.testing.assert_array_equal(meta[found], p_meta[found])
    # where not found the Pallas kernel answers bucket * 16 + 16; the port
    # keeps jnp's bucket * 16 there, everywhere equal to the jnp lookup
    np.testing.assert_array_equal(p_slot[~found], r_slot[~found] + 16)
    np.testing.assert_array_equal(found, r_found)
    np.testing.assert_array_equal(slot, r_slot)
    np.testing.assert_array_equal(meta, r_meta)
    assert 0 < found.sum() < N


@pytest.mark.parametrize("w,d,chunk", [(8, 4, 1024), (8, 8, 64), (16, 4, 128), (16, 8, 2048),
                                       (1, 1, 1), (64, 4, 256)])
def test_ring_shapes_match_jnp(table, w, d, chunk):
    ref = table[4]
    for got, want in zip(_ring(table, w=w, d=d, chunk=chunk), ref):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("row_width", HAND_ROW_WIDTHS)
def test_ring_hand_built_rows_match_pallas_manual_and_jnp(row_width):
    """K5's plain side on the hand-built rows (a key_hi-only cell before the
    matching one, a key twice, key_hi-only and key_lo-only misses): the
    built answers and the jnp bucket_lookup everywhere, the meta of a key
    held twice being the sum of both cells' words; on 64-lane rows also the
    Pallas DMA-ring kernel (interpret mode) where found."""
    rows, qhi, qlo, expect = hand_built_rows(np.random.default_rng(row_width), row_width)
    h_bits = int(np.log2(rows.shape[0]))
    got = [x.numpy() for x in bucket_lookup_ring(torch.from_numpy(rows), h_bits, HAND_SALT,
                                                  torch.from_numpy(qhi), torch.from_numpy(qlo),
                                                  w=8, d=4, chunk=200)]
    ref = jnp_bucket_lookup(jnp.asarray(rows), h_bits, HAND_SALT, jnp.asarray(qhi), jnp.asarray(qlo))
    for g, e, r in zip(got, expect, ref):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, np.asarray(r))
    if row_width == 64:
        found, slot, meta = got
        p_found, p_slot, p_meta = (
            np.asarray(x)
            for x in bucket_lookup_pallas_manual(jnp.asarray(rows), h_bits, HAND_SALT,
                                                 jnp.asarray(qhi), jnp.asarray(qlo),
                                                 w=8, d=4, chunk=200)
        )
        np.testing.assert_array_equal(p_found.astype(bool), found)
        np.testing.assert_array_equal(p_slot[found], slot[found])
        np.testing.assert_array_equal(p_meta[found], meta[found])
        assert found[twice_queries(found.size)].all()


@pytest.mark.parametrize(
    "kw,msg,pallas_too",
    [
        (dict(w=8, d=4, chunk=100), "chunk must be a multiple of w", True),
        (dict(w=8, d=4, chunk=768), "must be a multiple of chunk=768", True),
        (dict(w=8, d=9, chunk=512), "ring shape", False),
        (dict(w=128, d=1, chunk=512), "ring shape", False),
        (dict(w=64, d=8, chunk=512), "ring shape", False),
    ],
)
def test_ring_argument_checks(table, kw, msg, pallas_too):
    """The Pallas kernel's checks with its messages, then the ring's own
    bounds (w <= 64 rows a group, d <= 8 groups in flight, d x w <= 256 key
    spans of 64 bytes a ring)."""
    t, rows, qhi, qlo, _ = table
    with pytest.raises(ValueError, match=msg):
        _ring(table, **kw)
    if pallas_too:
        with pytest.raises(ValueError, match=msg):
            bucket_lookup_pallas_manual(jnp.asarray(rows), t.h_bits, t.salt,
                                        jnp.asarray(qhi), jnp.asarray(qlo), **kw)


@pytest.mark.parametrize("row_width,variants", [(64, "plain,k2,ring8x4,ring8x8,ring16x4,ring16x8"),
                                                (288, "k2,ring16x8")])
def test_bench_lookup_cpu_variants_agree(capsys, row_width, variants):
    res = bench(["--device", "cpu", "--kmers", "5000", "--queries", str(N),
                 "--row-width", str(row_width), "--variants", variants])
    assert res["ok"]
    names = variants.split(",")
    for v in names:
        assert res[v]["err_k2"] == 0 and res[v]["err_plain"] == 0 and res[v]["linear"]
        assert res[v]["mlookups_s"] > 0
    assert len({res[v]["sums"] for v in names}) == 1  # one query stream, one answer
    assert f"x {row_width} lanes" in capsys.readouterr().out


def test_bench_lookup_main_exit_status(capsys):
    assert main(["--device", "cpu", "--kmers", "2000", "--queries", "512",
                 "--variants", "k2,ring8x4"]) == 0
    with pytest.raises(ValueError, match="unknown variant"):
        main(["--device", "cpu", "--kmers", "2000", "--queries", "512", "--variants", "xla"])
