"""CUDA kernels K1-K10 (and the cuckoo instances of K3, K4, K8 and K9) vs
their plain torch versions, on the card, with the edge spans of the
per-read sums (``edge_bounds``, also used by the CPU tests that hold the
plain versions to the JAX functions).

These need an NVIDIA GPU with nvcc (a CUDA kernel has no interpret mode)
and skip elsewhere; ``python3 chip_smoke.py`` runs the same comparisons at
main-path shapes.  Run them on a GPU machine with
``python -m pytest tests/test_torch_kernels.py -m cuda``."""

import numpy as np
import pytest
import torch

from strainer2_tpu_torch.index.bucket import EMPTY, build_bucket_table
from strainer2_tpu_torch.index.cuckoo import build_cuckoo
from strainer2_tpu_torch.index.hashing import cuckoo_slots_torch
from strainer2_tpu_torch.io.batches import max_reads_capacity, pack_stream
from strainer2_tpu_torch.ops import lookup as L
from strainer2_tpu_torch.ops.packing import canonical_windows, canonical_windows_plain
from strainer2_tpu_torch.ops.packing_np import canonical_codes_np, split_code64_np
from strainer2_tpu_torch.ops import segsum as G

pytestmark = pytest.mark.cuda
K = 31


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.fixture
def strain(dev):
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=50_000, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, K)
    table = build_bucket_table(np.unique(codes[valid]), K)
    kinds = np.zeros(table.num_slots, dtype=np.uint32)
    kinds[table.slot_of_key] = np.where(rng.random(table.slot_of_key.size) < 0.3, 2, 1)
    rows = torch.from_numpy(table.with_meta(kinds)).to(dev)
    return rng, genome, codes[valid], table, rows


def edge_bounds(q: int, row: int) -> np.ndarray:
    """Boundaries whose consecutive pairs are the edge spans: short, empty,
    a whole row, spans crossing rows and 256-window tiles, the whole batch,
    reversed spans, bounds below 0 (counted from the end, as a JAX gather
    reads them) and above Q (clamped)."""
    return np.array([0, 3, 3, 3 + row, 2 * row + 17, 2 * row + 717, 0, q, q, 100, 40, -7, 60,
                     q + 50, -(q + 10), 5, q, q], dtype=np.int32)


def _as_i64(t):
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF if t.dtype == torch.uint32 else t.to(torch.int64)


def _equal(a, b):
    torch.cuda.synchronize()
    return all(torch.equal(_as_i64(x), _as_i64(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("k", [15, 20, 31, 32])
def test_canonical_windows_kernel(dev, k):
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, size=(64, 1000), dtype=np.uint8)
    bases[rng.random(bases.shape) < 0.03] = 4
    b = torch.from_numpy(bases).to(dev)
    assert _equal(canonical_windows(b, k), canonical_windows_plain(b, k))


def test_bucket_lookup_kernel(strain):
    rng, _, codes, table, rows = strain
    q = np.where(rng.random(50_000) < 0.5, codes[rng.integers(0, codes.size, 50_000)],
                 rng.integers(0, 1 << 62, 50_000, dtype=np.uint64))
    qhi, qlo = (torch.from_numpy(x).to(rows.device) for x in split_code64_np(q, K))
    out = L.bucket_lookup(rows, table.h_bits, table.salt, qhi, qlo)
    assert _equal(out, L.bucket_lookup_plain(rows, table.h_bits, table.salt, qhi, qlo))
    assert 0 < int(out[0].sum()) < q.size


def test_count_step_kernel(strain):
    rng, genome, _, table, rows = strain
    bases = rng.integers(0, 4, size=(32, 4096), dtype=np.uint8)
    bases[::2, :3000] = genome[: 16 * 3000].reshape(16, 3000)
    b = torch.from_numpy(bases).to(rows.device)
    start = np.zeros(table.num_slots, dtype=np.uint32)
    start[table.slot_of_key[::5]] = 0xFFFFFFFF  # wraps on a hit
    c1 = torch.from_numpy(start).to(rows.device)
    c2 = c1.clone()
    L.count_step(c1, rows, b, table.h_bits, table.salt, K)
    L.count_step_plain(c2, rows, b, table.h_bits, table.salt, K)
    assert _equal((c1,), (c2,))


def test_classify_step_kernel(strain):
    rng, genome, _, table, rows = strain
    reads = [genome[s : s + 150] if i % 2 else rng.integers(0, 4, 150, dtype=np.uint8)
             for i, s in enumerate(rng.integers(0, genome.size - 150, 2000))]
    batch = next(pack_stream(iter(reads), K, 64, 4096, with_read_ids=True))
    bounds = np.full(max_reads_capacity(K, 64, 4096) + 1, 64 * (4096 - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    b = torch.from_numpy(batch.bases).to(rows.device)
    bd = torch.from_numpy(bounds).to(rows.device)
    out = L.classify_step(rows, b, bd, table.h_bits, table.salt, K)
    assert _equal(out, L.classify_step_plain(rows, b, bd, table.h_bits, table.salt, K))
    assert int(out[1].sum()) > 0


@pytest.mark.parametrize("w,d,chunk", [(8, 4, 1024), (8, 8, 64), (16, 4, 128), (16, 8, 256),
                                       (1, 1, 8), (64, 4, 512)])
@pytest.mark.parametrize("row_width", [64, 288])
def test_bucket_lookup_ring_kernel(dev, w, d, chunk, row_width):
    rng = np.random.default_rng(w * d)
    codes = np.unique(rng.integers(0, 1 << 62, 40_000, dtype=np.uint64))
    table = build_bucket_table(codes, K, row_width=row_width)
    meta = (np.arange(table.num_slots, dtype=np.uint64) * 2654435761 & 0xFFFFFFFF).astype(np.uint32)
    rows = torch.from_numpy(table.with_meta(meta)).to(dev)
    n = 32_768
    q = np.where(rng.random(n) < 0.5, codes[rng.integers(0, codes.size, n)],
                 rng.integers(0, 1 << 62, n, dtype=np.uint64))
    qhi, qlo = (torch.from_numpy(x).to(dev) for x in split_code64_np(q, K))
    out = L.bucket_lookup_ring(rows, table.h_bits, table.salt, qhi, qlo, w=w, d=d, chunk=chunk)
    assert _equal(out, L.bucket_lookup_plain(rows, table.h_bits, table.salt, qhi, qlo))
    assert _equal(out, L.bucket_lookup(rows, table.h_bits, table.salt, qhi, qlo))
    assert 0 < int(out[0].sum()) < n


def _multi_rows(strain, n_words, dev):
    rng, genome, codes, _, _ = strain
    table = build_bucket_table(np.unique(codes), K, row_width=32 + 16 * max(2, n_words))
    words = [rng.integers(0, 1 << 32, table.num_slots, dtype=np.uint64).astype(np.uint32)
             for _ in range(max(2, n_words))]
    return table, torch.from_numpy(table.with_meta_words(words)).to(dev)


@pytest.mark.parametrize("n_strains", [1, 16, 32, 96, 256])
def test_multi_hit_words_and_strain_sums_kernels(strain, n_strains):
    rng, genome, codes, _, rows64 = strain
    dev = rows64.device
    n_words = G.words_for_strains(n_strains)
    table, rows = _multi_rows(strain, n_words, dev)
    reads = [genome[s : s + 150] if i % 2 else rng.integers(0, 4, 150, dtype=np.uint8)
             for i, s in enumerate(rng.integers(0, genome.size - 150, 2000))]
    batch = next(pack_stream(iter(reads), K, 64, 4096, with_read_ids=True))
    b = torch.from_numpy(batch.bases).to(dev)
    words = G.multi_hit_words(rows, b, table.h_bits, table.salt, K, n_words)
    assert _equal((words,), (G.multi_hit_words_plain(rows, b, table.h_bits, table.salt, K, n_words),))
    assert int((words != 0).sum()) > 0
    bounds = np.full(max_reads_capacity(K, 64, 4096) + 1, 64 * (4096 - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    bd = torch.from_numpy(bounds).to(dev)
    out = G.boundary_strain_sums(words, bd, n_strains)
    assert _equal(out, G.boundary_strain_sums_plain(words, bd, n_strains))
    assert int(out[0].sum()) > 0


def test_strain_sums_kernel_edge_boundaries(dev):
    """Empty reads, a last boundary of Q, out-of-range and reversed spans
    (clamped, negated as a prefix difference is)."""
    rng = np.random.default_rng(1)
    q = 1000
    words = torch.from_numpy(rng.integers(0, 1 << 32, (q, 2), dtype=np.uint64).astype(np.uint32)).to(dev)
    bounds = torch.tensor([0, 7, 7, 300, 299, 1000, -5, 1200, 1000, 1000], dtype=torch.int32, device=dev)
    out = G.boundary_strain_sums(words, bounds, 20)
    assert _equal(out, G.boundary_strain_sums_plain(words, bounds, 20))


def _edge_batch(strain, n_rows, row_len):
    """Reads of 100-1000 bases crossing rows and tiles, then the edge spans."""
    rng, genome, _, table, rows = strain
    reads = [genome[s : s + n].copy() for s, n in zip(rng.integers(0, genome.size - 1000, 400),
                                                       rng.integers(100, 1000, 400))]
    batch = next(pack_stream(iter(reads), K, n_rows, row_len, with_read_ids=True))
    width = row_len - K + 1
    bounds = np.concatenate([batch.window_starts, edge_bounds(n_rows * width, width)]).astype(np.int32)
    return batch, torch.from_numpy(bounds).to(rows.device)


@pytest.mark.parametrize("n_rows,row_len", [(8, 512), (64, 4096)])
def test_classify_step_kernel_edge_spans(strain, n_rows, row_len):
    _, _, _, table, rows = strain
    batch, bd = _edge_batch(strain, n_rows, row_len)
    b = torch.from_numpy(batch.bases).to(rows.device)
    out = L.classify_step(rows, b, bd, table.h_bits, table.salt, K)
    assert _equal(out, L.classify_step_plain(rows, b, bd, table.h_bits, table.salt, K))
    assert int((out[0] < 0).sum()) > 0 and int(out[1].sum()) > 0


@pytest.mark.parametrize("ones", [False, True], ids=["random", "all_ones"])
@pytest.mark.parametrize("n_strains", [1, 17, 33, 255, 256])
def test_strain_sums_kernel_edge_spans(strain, n_strains, ones):
    """Staged blocks (reads of the batch), blocks read from global memory
    (the whole batch, reversed and clamped spans), S not a multiple of 16."""
    rng, _, _, _, rows = strain
    batch, bd = _edge_batch(strain, 64, 4096)
    q = 64 * (4096 - K + 1)
    n_words = G.words_for_strains(n_strains)
    if ones:
        words = torch.full((q, n_words), -1, dtype=torch.int32, device=rows.device).view(torch.uint32)
    else:
        words = torch.from_numpy(rng.integers(0, 1 << 32, (q, n_words), dtype=np.uint64)
                                 .astype(np.uint32)).to(rows.device)
    out = G.boundary_strain_sums(words, bd, n_strains)
    assert _equal(out, G.boundary_strain_sums_plain(words, bd, n_strains))
    assert int((out[0] < 0).sum()) > 0 and int(out[1].max()) > 0


# ---- K3 and K6 edges: the packed tile (window codes in constant time) ----------

EDGE_K = [1, 15, 16, 17, 20, 31, 32]
EDGE_ROW_LENS = [40, 300, 1000, 4096]


def _table_k(genome, k, row_width=64):
    codes, valid = canonical_codes_np(genome, k)
    return build_bucket_table(np.unique(codes[valid]), k, row_width=row_width)


def edge_rows(rng, genome, row_len, n_rows=6):
    """Rows of random sequence, every other one from the genome, 1% N; N on
    each row's first and last base and on both sides of every 256-window
    tile edge the row has; the last row all N."""
    bases = rng.integers(0, 4, size=(n_rows, row_len), dtype=np.uint8)
    for r in range(0, n_rows, 2):
        s = int(rng.integers(0, genome.size - row_len))
        bases[r] = genome[s : s + row_len]
    bases[rng.random(bases.shape) < 0.01] = 4
    edges = [p for t in range(256, row_len, 256) for p in (t - 1, t)]
    bases[:, [0, row_len - 1, *edges]] = 4
    bases[-1] = 4
    return bases


@pytest.mark.parametrize("row_len", EDGE_ROW_LENS)
@pytest.mark.parametrize("k", EDGE_K)
def test_count_step_kernel_edges(strain, k, row_len):
    """K3 against its plain version for every k the port takes, rows shorter
    than a tile and with partial tiles, N at row and tile edges, and counts
    that wrap past 0xFFFFFFFF."""
    rng, genome, _, _, rows64 = strain
    table = _table_k(genome, k)
    rows = torch.from_numpy(table.with_meta(np.ones(table.num_slots, dtype=np.uint32))).to(rows64.device)
    b = torch.from_numpy(edge_rows(rng, genome, row_len)).to(rows.device)
    start = np.zeros(table.num_slots, dtype=np.uint32)
    start[table.slot_of_key[::3]] = 0xFFFFFFFF  # wraps on a hit
    c0 = torch.from_numpy(start).to(rows.device)
    c1, c2 = c0.clone(), c0.clone()
    L.count_step(c1, rows, b, table.h_bits, table.salt, k)
    L.count_step_plain(c2, rows, b, table.h_bits, table.salt, k)
    assert _equal((c1,), (c2,))
    assert not _equal((c2,), (c0,))


@pytest.mark.parametrize("row_len", EDGE_ROW_LENS)
@pytest.mark.parametrize("k,n_words", [(1, 1), (15, 2), (16, 3), (17, 16), (20, 1), (31, 3), (32, 16)])
def test_multi_hit_words_kernel_edges(strain, k, n_words, row_len):
    """K6 against its plain version: the same edges as K3's, and n_words
    that put most blocks' output runs off 16-byte alignment."""
    rng, genome, _, _, rows64 = strain
    table = _table_k(genome, k, row_width=32 + 16 * max(2, n_words))
    words = [rng.integers(0, 1 << 32, table.num_slots, dtype=np.uint64).astype(np.uint32)
             for _ in range(max(2, n_words))]
    rows = torch.from_numpy(table.with_meta_words(words)).to(rows64.device)
    b = torch.from_numpy(edge_rows(rng, genome, row_len)).to(rows.device)
    out = G.multi_hit_words(rows, b, table.h_bits, table.salt, k, n_words)
    assert _equal((out,), (G.multi_hit_words_plain(rows, b, table.h_bits, table.salt, k, n_words),))
    assert int((out != 0).sum()) > 0



# ---- K1 edges: 1024-window tiles packed by 16-base groups ---------------------

K1_TILE = 1024  # windows a block of canonical_windows_kernel


def _k1_row_len(k, row_len):
    """A row length of EDGE_ROW_LENS, or one window, one whole K1 tile, or
    one window past it."""
    return {"one": k, "tile": k + K1_TILE - 1, "tile+1": k + K1_TILE}.get(row_len, row_len)


@pytest.mark.parametrize("row_len", [*EDGE_ROW_LENS, "one", "tile", "tile+1"])
@pytest.mark.parametrize("k", EDGE_K)
def test_canonical_windows_kernel_edges(strain, k, row_len):
    """K1 against its plain version on every window, valid or not: every k
    the port takes, rows of one window, partial and whole 1024-window
    tiles, N at row edges and on both sides of every 256-window edge (so
    of every 1024-window edge too), an all-N last row, 7 rows, and rows
    that start off 16-byte alignment (L = 40, 300, 1000)."""
    rng, genome, _, _, rows = strain
    b = torch.from_numpy(edge_rows(rng, genome, _k1_row_len(k, row_len), n_rows=7)).to(rows.device)
    assert _equal(canonical_windows(b, k), canonical_windows_plain(b, k))


@pytest.mark.parametrize("offset", [1, 8])
def test_canonical_windows_kernel_unaligned(strain, offset):
    """K1 on a batch whose first base is off 16-byte alignment, so that no
    tile takes the 16-byte loads."""
    rng, genome, _, _, rows = strain
    bases = edge_rows(rng, genome, 4096, n_rows=5)
    buf = torch.zeros(bases.size + offset, dtype=torch.uint8, device=rows.device)
    b = buf[offset:].view(bases.shape)
    b.copy_(torch.from_numpy(bases))
    assert b.data_ptr() % 16
    assert _equal(canonical_windows(b, K), canonical_windows_plain(b, K))


# ---- K2: hand-built rows for the key_hi-first probe ---------------------------

HAND_ROW_WIDTHS = [48, 64, 288]
HAND_SALT = 0x5BD1E995
# what a query's row holds: a key_hi-only cell before the matching one; the
# key twice; key_hi-only cells and no match; key_lo-only cells and no
# match; one matching cell; neither half of the key
HAND_CASES = ("decoy_then_hit", "twice", "hi_only", "lo_only", "hit", "absent")


def hand_built_rows(rng, row_width: int, n_queries: int = 600, h_bits: int = 10):
    """A (2**h_bits, row_width) uint32 table written cell by cell, and
    n_queries (hi, lo) queries of distinct buckets (cuckoo_slots_torch with
    HAND_SALT), the rows of query i built as HAND_CASES[i % 6] says in
    random cells. Returns rows, qhi, qlo and the lookup each query must get:
    found, slot of the first equal cell, meta the uint32-wrapping sum of
    the equal cells' meta words (both cells' where the key is in its row
    twice), bucket * 16 and 0 on a miss."""
    n_rows = 1 << h_bits
    rows = rng.integers(0, 1 << 32, (n_rows, row_width), dtype=np.uint64).astype(np.uint32)
    cand = rng.integers(0, 1 << 32, (2, 4 * n_rows), dtype=np.uint64)
    bucket = cuckoo_slots_torch(torch.from_numpy(cand[0].astype(np.int64)) ^ HAND_SALT,
                                torch.from_numpy(cand[1].astype(np.int64)), h_bits, 0).numpy()
    first = np.sort(np.unique(bucket, return_index=True)[1])[:n_queries]
    assert first.size == n_queries
    qhi, qlo = (cand[i, first].astype(np.uint32) for i in (0, 1))
    bucket = bucket[first]
    found = np.zeros(n_queries, dtype=bool)
    slot = (bucket * 16).astype(np.int32)
    meta = np.zeros(n_queries, dtype=np.uint32)
    for i, (h, l, b) in enumerate(zip(qhi, qlo, bucket)):
        row = rows[b]
        row[:16][row[:16] == h] ^= np.uint32(0x80000000)  # no stray key_hi match
        cells = rng.permutation(16)
        case = HAND_CASES[i % len(HAND_CASES)]
        if case == "decoy_then_hit":
            decoy, cell = sorted(cells[:2])
            row[decoy], row[16 + decoy] = h, l ^ np.uint32(rng.integers(1, 1 << 32))
            row[cell], row[16 + cell] = h, l
        elif case == "twice":
            cell, other = sorted(cells[:2])
            row[[cell, other]], row[[16 + cell, 16 + other]] = h, l
        elif case == "hi_only":
            for c in cells[: 1 + i // 6 % 3]:
                row[c], row[16 + c] = h, l ^ np.uint32(rng.integers(1, 1 << 32))
        elif case == "lo_only":
            for c in cells[: 1 + i // 6 % 3]:
                row[c], row[16 + c] = h ^ np.uint32(rng.integers(1, 1 << 32)), l
        elif case == "hit":
            cell = (0, 15, cells[0])[i // 6 % 3]
            row[cell], row[16 + cell] = h, l
        if case in ("decoy_then_hit", "twice", "hit"):
            found[i], slot[i], meta[i] = True, b * 16 + cell, row[32 + cell]
        if case == "twice":
            meta[i] = (int(row[32 + cell]) + int(row[32 + other])) & 0xFFFFFFFF
    return rows, qhi, qlo, (found, slot, meta)


def twice_queries(n_queries: int) -> np.ndarray:
    """The queries of hand_built_rows whose key is in their row twice."""
    return np.arange(n_queries) % len(HAND_CASES) == HAND_CASES.index("twice")


def duplicate_keys(rows: np.ndarray, rng, share: float = 0.3) -> np.ndarray:
    """A copy of a built table's rows in which a seeded share of the keys is
    written a second time, whole cell (key and every meta lane), into the
    first free cell after its own.  Its slot stays the first cell's; its meta
    words double (wrapping), so a detection class of 1 reads as informative
    (1 + 1 = 2) and one of 2 no longer does, as the JAX lookups' sum over
    equal cells reads them."""
    out = rows.copy()
    used = out[:, :16] != EMPTY
    for r in np.flatnonzero(used.any(axis=1) & ~used.all(axis=1)):
        cells = np.flatnonzero(used[r])
        free = np.flatnonzero(~used[r])
        for c in cells[rng.random(cells.size) < share]:
            later = free[free > c]
            if later.size:
                out[r, later[0] :: 16] = out[r, c :: 16]
                free = free[free != later[0]]
    return out


@pytest.mark.parametrize("row_width", HAND_ROW_WIDTHS)
def test_bucket_lookup_kernel_hand_built_rows(dev, row_width):
    """K2 against its plain version and the built answers: a key_hi match
    without its key_lo is no hit, even before the matching cell; the first
    of two equal cells wins; a key_lo match alone is a miss."""
    rows, qhi, qlo, expect = hand_built_rows(np.random.default_rng(row_width), row_width)
    r, qh, ql = (torch.from_numpy(x).to(dev) for x in (rows, qhi, qlo))
    h_bits = int(np.log2(rows.shape[0]))
    out = L.bucket_lookup(r, h_bits, HAND_SALT, qh, ql)
    assert _equal(out, L.bucket_lookup_plain(r, h_bits, HAND_SALT, qh, ql))
    assert _equal(out, [torch.from_numpy(x).to(dev) for x in expect])


@pytest.mark.parametrize("row_width", HAND_ROW_WIDTHS)
def test_bucket_lookup_ring_kernel_hand_built_rows(dev, row_width):
    """K5 on the same rows: its ring stages key_hi spans, and picks the
    first equal cell and sums the equal cells' meta as K2 does."""
    rows, qhi, qlo, expect = hand_built_rows(np.random.default_rng(row_width), row_width)
    r, qh, ql = (torch.from_numpy(x).to(dev) for x in (rows, qhi, qlo))
    h_bits = int(np.log2(rows.shape[0]))
    out = L.bucket_lookup_ring(r, h_bits, HAND_SALT, qh, ql, w=8, d=4, chunk=200)
    assert _equal(out, [torch.from_numpy(x).to(dev) for x in expect])


# ---- K2, K4, K5, K6: keys held twice (the meta sum of equal cells) -------------

RING_SHAPES = [(8, 4), (8, 8), (16, 4), (16, 8)]  # bench_lookup's default ringWxD variants


@pytest.mark.parametrize("row_width", [64, 128, 288])
@pytest.mark.parametrize("w,d", RING_SHAPES)
def test_bucket_lookup_ring_kernel_ab_shapes_hand_built_rows(dev, w, d, row_width):
    """K5 at each ringWxD shape of the lookup A/B tool (chunk 2 w d) on
    hand-built rows: equal to the built answers (the first equal cell, the
    sum of both cells' meta where a key is held twice), its plain version
    and K2.  The wrapper takes whole chunks only, as the Pallas kernel
    does, so no chunk is ragged."""
    rows, qhi, qlo, expect = hand_built_rows(np.random.default_rng(row_width + w * d), row_width,
                                             n_queries=768)
    r, qh, ql = (torch.from_numpy(x).to(dev) for x in (rows, qhi, qlo))
    h_bits = int(np.log2(rows.shape[0]))
    out = L.bucket_lookup_ring(r, h_bits, HAND_SALT, qh, ql, w=w, d=d, chunk=2 * w * d)
    assert _equal(out, [torch.from_numpy(x).to(dev) for x in expect])
    assert _equal(out, L.bucket_lookup_plain(r, h_bits, HAND_SALT, qh, ql))
    assert _equal(out, L.bucket_lookup(r, h_bits, HAND_SALT, qh, ql))


def test_bucket_lookup_kernel_duplicate_keys(strain):
    """K2 on a built table with a third of its keys held twice."""
    rng, _, codes, table, rows = strain
    dup = torch.from_numpy(duplicate_keys(rows.cpu().numpy(), rng)).to(rows.device)
    q = np.where(rng.random(50_000) < 0.5, codes[rng.integers(0, codes.size, 50_000)],
                 rng.integers(0, 1 << 62, 50_000, dtype=np.uint64))
    qhi, qlo = (torch.from_numpy(x).to(rows.device) for x in split_code64_np(q, K))
    out = L.bucket_lookup(dup, table.h_bits, table.salt, qhi, qlo)
    assert _equal(out, L.bucket_lookup_plain(dup, table.h_bits, table.salt, qhi, qlo))
    assert not _equal(out, L.bucket_lookup(rows, table.h_bits, table.salt, qhi, qlo))


def test_classify_step_kernel_duplicate_keys(strain):
    """K4 on a built table with a third of its keys held twice (a class of
    1 then sums to informative, one of 2 no longer does)."""
    rng, genome, _, table, rows = strain
    dup = torch.from_numpy(duplicate_keys(rows.cpu().numpy(), rng)).to(rows.device)
    reads = [genome[s : s + 150] if i % 2 else rng.integers(0, 4, 150, dtype=np.uint8)
             for i, s in enumerate(rng.integers(0, genome.size - 150, 2000))]
    batch = next(pack_stream(iter(reads), K, 64, 4096, with_read_ids=True))
    bounds = np.full(max_reads_capacity(K, 64, 4096) + 1, 64 * (4096 - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    b = torch.from_numpy(batch.bases).to(rows.device)
    bd = torch.from_numpy(bounds).to(rows.device)
    out = L.classify_step(dup, b, bd, table.h_bits, table.salt, K)
    assert _equal(out, L.classify_step_plain(dup, b, bd, table.h_bits, table.salt, K))
    assert not _equal(out[1:], L.classify_step(rows, b, bd, table.h_bits, table.salt, K)[1:])


@pytest.mark.parametrize("n_strains", [1, 32, 256])
def test_multi_hit_words_kernel_duplicate_keys(strain, n_strains):
    """K6 on multi-word rows with a third of their keys held twice: every
    word of such a key is the sum of both cells' words."""
    rng, genome, _, _, rows64 = strain
    n_words = G.words_for_strains(n_strains)
    table, rows = _multi_rows(strain, n_words, rows64.device)
    dup = torch.from_numpy(duplicate_keys(rows.cpu().numpy(), rng)).to(rows.device)
    b = torch.from_numpy(edge_rows(rng, genome, 4096, n_rows=16)).to(rows.device)
    out = G.multi_hit_words(dup, b, table.h_bits, table.salt, K, n_words)
    assert _equal((out,), (G.multi_hit_words_plain(dup, b, table.h_bits, table.salt, K, n_words),))
    assert not _equal((out,), (G.multi_hit_words(rows, b, table.h_bits, table.salt, K, n_words),))


# ---- K8, K9 and K3 with its valid count (genome_compare, strain-track) ---------

def k9_remainings(valid_total: int) -> list:
    """remaining at 0 and below, the first valid window, the batch's valid
    total (its last valid window), past it, and a sweep between that lands
    in many tiles and rows."""
    return [0, -5, 1, valid_total, valid_total + 1, 2**31 - 1,
            *range(2, valid_total, max(1, valid_total // 41))]


@pytest.mark.parametrize("row_len", EDGE_ROW_LENS)
@pytest.mark.parametrize("k", EDGE_K)
def test_hit_accumulate_and_hit_stats_kernels_edges(strain, k, row_len):
    """K8 and K9 against their plain versions for every k the port takes,
    rows shorter than a tile and with partial tiles, N at row and tile
    edges and an all-N last row, at every edge case of the crossing."""
    rng, genome, _, _, rows64 = strain
    table = _table_k(genome, k)
    rows = torch.from_numpy(table.table).to(rows64.device)
    b = torch.from_numpy(edge_rows(rng, genome, row_len)).to(rows.device)
    acc0 = torch.tensor([5, 2**40], dtype=torch.int64, device=rows.device)
    acc = L.hit_accumulate(acc0.clone(), rows, b, table.h_bits, table.salt, k)
    ref = L.hit_accumulate_plain(acc0.clone(), rows, b, table.h_bits, table.salt, k)
    assert _equal((acc,), (ref,))
    hits, total = (int(x) for x in ref - acc0)
    assert 0 < hits <= total
    for rem in k9_remainings(total):
        got = L.hit_stats(rows, b, rem, table.h_bits, table.salt, k)
        want = L.hit_stats_plain(rows, b, rem, table.h_bits, table.salt, k)
        assert got.tolist() == want.tolist(), rem


@pytest.mark.parametrize("row_len", EDGE_ROW_LENS)
@pytest.mark.parametrize("k", EDGE_K)
def test_count_valid_step_kernel_edges(strain, k, row_len):
    """K3 with its valid count against its plain version, at K3's edges:
    the counts, and the tally's total (kernel and plain) from a tally that
    starts above 2**31."""
    rng, genome, _, _, rows64 = strain
    table = _table_k(genome, k)
    rows = torch.from_numpy(table.table).to(rows64.device)
    b = torch.from_numpy(edge_rows(rng, genome, row_len)).to(rows.device)
    start = np.zeros(table.num_slots, dtype=np.uint32)
    start[table.slot_of_key[::3]] = 0xFFFFFFFF  # wraps on a hit
    c0 = torch.from_numpy(start).to(rows.device)
    t0 = torch.zeros(L.n_tiles(*b.shape, k), dtype=torch.int64, device=rows.device)
    t0[-1] = 2**31 + 7
    t1, t2 = t0.clone(), t0.clone()
    c1 = L.count_valid_step(c0.clone(), t1, rows, b, table.h_bits, table.salt, k)
    c2 = L.count_valid_step_plain(c0.clone(), t2, rows, b, table.h_bits, table.salt, k)
    n1, n2 = L.valid_tally_total(t1), L.valid_tally_total_plain(t2)
    assert _equal((c1, n1), (c2, n2))
    assert n1.dtype == torch.int64 and int(n1) > 2**31 + 7 and not _equal((c1,), (c0,))
    assert int(n1) == int(t1.sum())
    c3 = L.count_step(c0.clone(), rows, b, table.h_bits, table.salt, k)
    assert _equal((c1,), (c3,))


def test_count_valid_step_kernel_stream(strain):
    """K3 with its valid count over a stream of batches of 64, 5, 1 and 64
    rows of 4096 into one tally (the short batches use a prefix of its
    slots), against the plain version's total and counts."""
    rng, genome, _, _, rows64 = strain
    table = _table_k(genome, K)
    rows = torch.from_numpy(table.table).to(rows64.device)
    c1 = torch.zeros(table.num_slots, dtype=torch.uint32, device=rows.device)
    c2 = c1.clone()
    t1 = torch.zeros(L.n_tiles(64, 4096, K), dtype=torch.int64, device=rows.device)
    t2 = t1.clone()
    for n_rows in (64, 5, 1, 64):
        b = torch.from_numpy(edge_rows(rng, genome, 4096, n_rows=max(2, n_rows))[:n_rows]).to(rows.device)
        L.count_valid_step(c1, t1, rows, b, table.h_bits, table.salt, K)
        L.count_valid_step_plain(c2, t2, rows, b, table.h_bits, table.salt, K)
    assert _equal((c1, L.valid_tally_total(t1)), (c2, L.valid_tally_total_plain(t2)))
    assert int(t1.sum()) > 0 and int(t1[L.n_tiles(5, 4096, K):].sum()) > 0
    with pytest.raises(ValueError, match="tiles"):
        L.count_valid_step(c1, t1[:10], rows, b, table.h_bits, table.salt, K)


def test_hit_stats_kernel_back_to_back(strain):
    """K9 called back to back on one stream without a synchronisation
    between calls, at batch shapes that change between calls and at every
    edge of the crossing, equals its plain version each time: each
    crossing block waits for its own masks launch."""
    rng, genome, _, _, rows64 = strain
    table = _table_k(genome, 20)
    rows = torch.from_numpy(table.table).to(rows64.device)
    batches = [torch.from_numpy(edge_rows(rng, genome, n, n_rows=r)).to(rows.device)
               for r, n in ((6, 4096), (2, 40), (64, 1000), (1, 300), (6, 4096))]
    calls = [(b, rem) for b in batches
             for rem in k9_remainings(int(L.hit_stats_plain(rows, b, 1, table.h_bits, table.salt,
                                                            20)[1]))]
    got = [L.hit_stats(rows, b, rem, table.h_bits, table.salt, 20) for b, rem in calls]
    for (b, rem), g in zip(calls, got):
        want = L.hit_stats_plain(rows, b, rem, table.h_bits, table.salt, 20)
        assert g.tolist() == want.tolist(), (tuple(b.shape), rem)


def test_hit_stats_kernel_cuda_graph(strain):
    """K9 captured in a CUDA graph (eight calls at different remaining
    values: the programmatic edge between its two launches is captured)
    and replayed twice equals its plain version after each replay."""
    rng, genome, _, _, rows64 = strain
    table = _table_k(genome, 20)
    rows = torch.from_numpy(table.table).to(rows64.device)
    b = torch.from_numpy(edge_rows(rng, genome, 4096, n_rows=16)).to(rows.device)
    total = int(L.hit_stats_plain(rows, b, 1, table.h_bits, table.salt, 20)[1])
    rems = [0, 1, total // 3, total // 2, total - 1, total, total + 1, -3]
    want = [L.hit_stats_plain(rows, b, r, table.h_bits, table.salt, 20).tolist() for r in rems]
    L.hit_stats(rows, b, 1, table.h_bits, table.salt, 20)  # builds the kernels off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [L.hit_stats(rows, b, r, table.h_bits, table.salt, 20) for r in rems]
    for _ in range(2):
        for o in outs:
            o.fill_(-9)
        graph.replay()
        torch.cuda.synchronize()
        assert [o.tolist() for o in outs] == want


def test_hit_kernels_main_shape(strain):
    """K8 and K9 on 64 x 4096 batches of reads, a third from the strain,
    against their plain versions; the accumulator runs over them all."""
    rng, genome, _, table, rows = strain
    acc = torch.zeros(2, dtype=torch.int64, device=rows.device)
    ref = acc.clone()
    for _ in range(3):
        reads = [genome[s : s + 150] if i % 3 == 0 else rng.integers(0, 4, 150, dtype=np.uint8)
                 for i, s in enumerate(rng.integers(0, genome.size - 150, 1800))]
        b = torch.from_numpy(next(pack_stream(iter(reads), K, 64, 4096)).bases).to(rows.device)
        L.hit_accumulate(acc, rows, b, table.h_bits, table.salt, K)
        L.hit_accumulate_plain(ref, rows, b, table.h_bits, table.salt, K)
        total = int(L.hit_stats_plain(rows, b, 1, table.h_bits, table.salt, K)[1])
        for rem in k9_remainings(total)[:12]:
            assert (L.hit_stats(rows, b, rem, table.h_bits, table.salt, K).tolist()
                    == L.hit_stats_plain(rows, b, rem, table.h_bits, table.salt, K).tolist()), rem
    assert _equal((acc,), (ref,)) and int(acc[0]) > 0


# ---- the cuckoo layout: K10 and the cuckoo instances of K3, K4, K8, K9 --------

def _cuckoo_k(genome, k, dev, h_bits=None):
    """The genome's cuckoo table at k on the device, its CuckooTable, and a
    seeded slot-indexed class array (2 for a third of the keys, else 1)."""
    codes, valid = canonical_codes_np(genome, k)
    table = build_cuckoo(np.unique(codes[valid]), k, h_bits=h_bits)
    meta = np.zeros(table.num_slots, dtype=np.uint32)
    meta[table.slot_of_key] = np.where(np.arange(table.slot_of_key.size) % 3 == 0, 2, 1)
    return (torch.from_numpy(table.table).to(dev), table,
            torch.from_numpy(meta).to(dev))


def poly_t_rows(rng, genome, row_len, n_rows=6):
    """edge_rows with a run of up to 80 T (code 3) in its second row: at
    k = 32 those windows are the empty-slot sentinel (0xFFFFFFFF in both
    halves)."""
    bases = edge_rows(rng, genome, row_len, n_rows)
    bases[1, row_len // 4 : row_len // 4 + 80] = 3  # a random row: the genome's rows keep their hits
    return bases


@pytest.mark.parametrize("salted", [False, True], ids=["salt0", "retried"])
def test_cuckoo_lookup_kernel(strain, salted):
    """K10 against its plain version on present and absent keys, in a table
    built at its own size and in one whose first tries failed (a tiny
    h_bits: a non-zero salt, a grown H)."""
    rng, genome, codes, _, rows = strain
    keys = np.unique(codes)
    t = build_cuckoo(keys[:2000] if salted else keys, K, h_bits=10 if salted else None)
    assert (t.salt != 0) == salted
    table = torch.from_numpy(t.table).to(rows.device)
    q = np.where(rng.random(50_000) < 0.5, keys[rng.integers(0, 2000 if salted else keys.size, 50_000)],
                 rng.integers(0, 1 << 62, 50_000, dtype=np.uint64))
    qhi, qlo = (torch.from_numpy(x).to(rows.device) for x in split_code64_np(q, K))
    out = L.cuckoo_lookup(table, t.h_bits, t.salt, qhi, qlo)
    assert _equal(out, L.cuckoo_lookup_plain(table, t.h_bits, t.salt, qhi, qlo))
    assert 0 < int(out[0].sum()) < q.size


def test_cuckoo_lookup_kernel_key_in_both_slots(dev):
    """A hand-built table holding keys in both of their slots, in slot 1
    only and not at all: found, slot s0 where s0 holds the key (else s1),
    as the jnp lookup picks it."""
    rng = np.random.default_rng(5)
    h_bits, salt = 10, 0x5BD1E995
    h = 1 << h_bits
    table = np.full((2 * h, 2), 0xFFFFFFFF, dtype=np.uint32)
    cand_hi, cand_lo = (rng.integers(0, 1 << 30, 4000, dtype=np.uint64).astype(np.uint32)
                        for _ in range(2))
    sh = torch.from_numpy(cand_hi.astype(np.int64)) ^ salt
    lo = torch.from_numpy(cand_lo.astype(np.int64))
    c0 = cuckoo_slots_torch(sh, lo, h_bits, 0).numpy()
    c1 = cuckoo_slots_torch(sh, lo, h_bits, 1).numpy() + h
    keep, used = [], set()
    for i in range(4000):  # queries whose four slots no other query shares
        if c0[i] not in used and c1[i] not in used and len(keep) < 600:
            keep.append(i)
            used.update((c0[i], c1[i]))
    assert len(keep) == 600
    qhi, qlo, s0, s1 = (x[keep] for x in (cand_hi, cand_lo, c0, c1))
    for i in range(0, 600, 3):  # both slots; slot 1 only; absent
        table[s1[i]] = qhi[i], qlo[i]
        table[s0[i]] = qhi[i], qlo[i]
        table[s1[i + 1]] = qhi[i + 1], qlo[i + 1]
    t, qh, ql = (torch.from_numpy(x).to(dev) for x in (table, qhi, qlo))
    found, slot = L.cuckoo_lookup(t, h_bits, salt, qh, ql)
    assert _equal((found, slot), L.cuckoo_lookup_plain(t, h_bits, salt, qh, ql))
    f, sl = found.cpu().numpy(), slot.cpu().numpy()
    assert f[0::3].all() and (sl[0::3] == s0[0::3]).all()
    assert f[1::3].all() and (sl[1::3] == s1[1::3]).all()


@pytest.mark.parametrize("row_len", EDGE_ROW_LENS)
@pytest.mark.parametrize("k", EDGE_K)
def test_cuckoo_count_and_hit_kernels_edges(strain, k, row_len):
    """Cuckoo K3, K3 with its valid count, K8 and K9 against their plain
    versions at K3's edges (every k, short rows, partial tiles, N at tile
    edges, an all-N row, a poly-T run: at k = 32 the empty-slot sentinel),
    counts that wrap, and every edge of the crossing."""
    rng, genome, _, _, rows64 = strain
    dev = rows64.device
    table, t, _ = _cuckoo_k(genome, k, dev)
    h, salt = t.h_bits, t.salt
    b = torch.from_numpy(poly_t_rows(rng, genome, row_len)).to(dev)
    start = np.zeros(t.num_slots, dtype=np.uint32)
    start[t.slot_of_key[::3]] = 0xFFFFFFFF  # wraps on a hit
    c0 = torch.from_numpy(start).to(dev)
    c1 = L.cuckoo_count_step(c0.clone(), table, b, h, salt, k)
    assert _equal((c1,), (L.cuckoo_count_step_plain(c0.clone(), table, b, h, salt, k),))
    t1 = torch.zeros(L.n_tiles(*b.shape, k), dtype=torch.int64, device=dev)
    t2 = t1.clone()
    c2 = L.cuckoo_count_valid_step(c0.clone(), t1, table, b, h, salt, k)
    c3 = L.cuckoo_count_valid_step_plain(c0.clone(), t2, table, b, h, salt, k)
    assert _equal((c2, L.valid_tally_total(t1)), (c3, L.valid_tally_total_plain(t2)))
    assert _equal((c1,), (c2,)) and not _equal((c1,), (c0,))
    acc0 = torch.tensor([5, 2**40], dtype=torch.int64, device=dev)
    acc = L.cuckoo_hit_accumulate(acc0.clone(), table, b, h, salt, k)
    ref = L.cuckoo_hit_accumulate_plain(acc0.clone(), table, b, h, salt, k)
    assert _equal((acc,), (ref,))
    hits, total = (int(x) for x in ref - acc0)
    assert 0 < hits <= total
    for rem in k9_remainings(total):
        got = L.cuckoo_hit_stats(table, b, rem, h, salt, k)
        assert got.tolist() == L.cuckoo_hit_stats_plain(table, b, rem, h, salt, k).tolist(), rem


@pytest.mark.parametrize("k", [20, 31, 32])
@pytest.mark.parametrize("n_rows,row_len", [(8, 512), (64, 4096)])
def test_cuckoo_classify_step_kernel(strain, k, n_rows, row_len):
    """Cuckoo K4 against its plain version over the edge spans, on reads
    half from the genome and a poly-T read."""
    rng, genome, _, _, rows64 = strain
    dev = rows64.device
    table, t, meta = _cuckoo_k(genome, k, dev)
    reads = [genome[s : s + 150] if i % 2 else rng.integers(0, 4, 150, dtype=np.uint8)
             for i, s in enumerate(rng.integers(0, genome.size - 150, 2000))]
    reads[7] = np.full(150, 3, dtype=np.uint8)
    batch = next(pack_stream(iter(reads), k, n_rows, row_len, with_read_ids=True))
    q = n_rows * (row_len - k + 1)
    bounds = np.full(max_reads_capacity(k, n_rows, row_len) + 1, q, dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    b = torch.from_numpy(batch.bases).to(dev)
    for bd_np in (bounds, edge_bounds(q, row_len - k + 1)):
        bd = torch.from_numpy(bd_np).to(dev)
        out = L.cuckoo_classify_step(table, meta, b, bd, t.h_bits, t.salt, k)
        assert _equal(out, L.cuckoo_classify_step_plain(table, meta, b, bd, t.h_bits, t.salt, k))
    assert int(out[1].sum()) > 0


def test_cuckoo_classify_step_kernel_key_in_both_slots(strain):
    """Cuckoo K4 on a table where a share of the keys held in slot s0 is
    also written into its empty slot s1 with the other class: the class
    read is meta[s0], one word, so the counts equal the built table's (a
    sum over both slots, as the bucket lookups take, would read 3)."""
    rng, genome, _, _, rows64 = strain
    dev = rows64.device
    _, t, meta = _cuckoo_k(genome, K, dev)
    table, meta_np = t.table.copy(), meta.cpu().numpy().copy()
    hi, lo = table[t.slot_of_key, 0], table[t.slot_of_key, 1]
    h = table.shape[0] // 2
    sh = torch.from_numpy(hi.astype(np.int64)) ^ t.salt
    s0 = cuckoo_slots_torch(sh, torch.from_numpy(lo.astype(np.int64)), t.h_bits, 0).numpy()
    s1 = cuckoo_slots_torch(sh, torch.from_numpy(lo.astype(np.int64)), t.h_bits, 1).numpy() + h
    other = np.where(t.slot_of_key == s0, s1, s0)
    pick = np.flatnonzero((rng.random(other.size) < 0.3) & (table[other, 0] == 0xFFFFFFFF)
                          & (t.slot_of_key == s0))
    assert pick.size > 1000
    table[other[pick]] = table[t.slot_of_key[pick]]
    meta_np[other[pick]] = 3 - meta_np[t.slot_of_key[pick]]
    tb, mt = torch.from_numpy(table).to(dev), torch.from_numpy(meta_np).to(dev)
    reads = [genome[s : s + 150] for s in rng.integers(0, genome.size - 150, 2000)]
    batch = next(pack_stream(iter(reads), K, 64, 4096, with_read_ids=True))
    bounds = np.full(max_reads_capacity(K, 64, 4096) + 1, 64 * (4096 - K + 1), dtype=np.int32)
    bounds[: batch.n_reads] = batch.window_starts
    b, bd = torch.from_numpy(batch.bases).to(dev), torch.from_numpy(bounds).to(dev)
    out = L.cuckoo_classify_step(tb, mt, b, bd, t.h_bits, t.salt, K)
    assert _equal(out, L.cuckoo_classify_step_plain(tb, mt, b, bd, t.h_bits, t.salt, K))
    built = torch.from_numpy(t.table).to(dev)
    assert _equal(out, L.cuckoo_classify_step(built, meta, b, bd, t.h_bits, t.salt, K))


def test_cuckoo_hit_stats_kernel_cuda_graph(strain):
    """Cuckoo K9 captured in a CUDA graph (eight calls at different
    remaining values) and replayed twice equals its plain version."""
    rng, genome, _, _, rows64 = strain
    table, t, _ = _cuckoo_k(genome, 20, rows64.device)
    b = torch.from_numpy(edge_rows(rng, genome, 4096, n_rows=16)).to(rows64.device)
    total = int(L.cuckoo_hit_stats_plain(table, b, 1, t.h_bits, t.salt, 20)[1])
    rems = [0, 1, total // 3, total // 2, total - 1, total, total + 1, -3]
    want = [L.cuckoo_hit_stats_plain(table, b, r, t.h_bits, t.salt, 20).tolist() for r in rems]
    L.cuckoo_hit_stats(table, b, 1, t.h_bits, t.salt, 20)  # builds the kernels off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [L.cuckoo_hit_stats(table, b, r, t.h_bits, t.salt, 20) for r in rems]
    for _ in range(2):
        for o in outs:
            o.fill_(-9)
        graph.replay()
        torch.cuda.synchronize()
        assert [o.tolist() for o in outs] == want


def test_cuckoo_wrappers_refuse_mismatched_buffers(strain):
    """A count buffer or a meta array that is not 2H cells, and a bucket
    row table, raise before any launch."""
    rng, genome, _, _, rows64 = strain
    dev = rows64.device
    table, t, meta = _cuckoo_k(genome, K, dev)
    b = torch.from_numpy(edge_rows(rng, genome, 1000)).to(dev)
    short = torch.zeros(t.num_slots - 16, dtype=torch.uint32, device=dev)
    with pytest.raises(ValueError, match="cells"):
        L.cuckoo_count_step(short, table, b, t.h_bits, t.salt, K)
    bd = torch.zeros(5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="cells"):
        L.cuckoo_classify_step(table, meta[:-2], b, bd, t.h_bits, t.salt, K)
    with pytest.raises(ValueError, match="cuckoo table"):
        L.cuckoo_hit_stats(rows64, b, 1, t.h_bits, t.salt, K)
