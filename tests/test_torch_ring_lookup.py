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
    bounds (12 w threads a block, D x w x 192 bytes of shared memory)."""
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
