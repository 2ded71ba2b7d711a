"""The port's library modes (pipeline/multi.py) on the CPU against the
reference goldens under tests/golden/mini/expected/modes, as
tests/test_modes_parity.py holds the JAX package to them, at 8 x 1024
batches; and the plain K3 with its valid count (and the engine's tally
life cycle) against the JAX program _count_valid_step_bucket, its
per-batch valid scalars summed over a stream."""

import io
import os
import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strainer2_tpu.pipeline import engine as jax_engine
from strainer2_tpu_torch.index.bucket import build_bucket_table
from strainer2_tpu_torch.ops import lookup as L
from strainer2_tpu_torch.ops.packing_np import canonical_codes_np

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
MODES = os.path.join(MINI, "expected", "modes")
BATCH = dict(rows=8, row_len=1024)


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def expected(name: str) -> bytes:
    with open(os.path.join(MODES, name), "rb") as f:
        return f.read()


def _stage_data(tmp_path, monkeypatch):
    # the same relative paths the goldens were produced with
    shutil.copytree(os.path.join(MINI, "data"), tmp_path / "data")
    monkeypatch.chdir(tmp_path)


def test_pangenome_single_ref(tmp_path, monkeypatch):
    from strainer2_tpu_torch.pipeline.multi import run_pangenome

    _stage_data(tmp_path, monkeypatch)
    out = io.StringIO()
    run_pangenome("data/pangenomes.txt", ref_file="data/strainA.fna.gz", out=out, device="cpu")
    assert out.getvalue().encode() == expected("pangenome_ref_stdout.txt")
    with open("data/strainA.fna.gz_.pangenome", "rb") as f:
        assert f.read() == expected("strainA.pangenome")


def test_pangenome_all_and_dist(tmp_path, monkeypatch):
    from strainer2_tpu_torch.pipeline.multi import run_pangenome

    _stage_data(tmp_path, monkeypatch)
    out = io.StringIO()
    run_pangenome("data/pangenomes.txt", write_dist=True, out=out, device="cpu")
    assert out.getvalue().encode() == expected("pangenome_all_stdout.txt")
    for name in ("panel1.fna.gz", "panel2.fna", "strainA.fna.gz"):
        with open(f"data/{name}_.pangenome", "rb") as f:
            assert f.read() == expected(f"{name}_.pangenome"), name
    with open("data/pangenomes.txt_.pangenome_dist", "rb") as f:
        assert f.read() == expected("pangenomes.pangenome_dist")


def test_kmer_matrix(tmp_path, monkeypatch):
    from strainer2_tpu_torch.pipeline.multi import run_kmer_matrix

    _stage_data(tmp_path, monkeypatch)
    out = io.StringIO()
    run_kmer_matrix("data/pangenomes.txt", out=out, device="cpu", **BATCH)
    assert out.getvalue().encode() == expected("kmer_matrix.tsv")


def _stage_strain_track(tmp_path, monkeypatch):
    for name in ("strainA.fna.gz", "drug1.fna.gz", "scrubmeta1.fasta.gz"):
        shutil.copy(os.path.join(MINI, "data", name), tmp_path / name)
    with open(tmp_path / "strains2.txt", "w") as f:
        f.write("strainA.fna.gz\ndrug1.fna.gz\n")
    monkeypatch.chdir(tmp_path)


def test_strain_track_with_tracks(tmp_path, monkeypatch):
    from strainer2_tpu_torch.pipeline.multi import run_strain_track

    _stage_strain_track(tmp_path, monkeypatch)
    out = io.StringIO()
    run_strain_track("strains2.txt", "scrubmeta1.fasta.gz", out=out, device="cpu", **BATCH)
    assert out.getvalue().encode() == expected("strain_track_stdout.txt")
    for name in (
        "strainA.fna.gz_scrubmeta1.fasta.gz.strain_track",
        "drug1.fna.gz_scrubmeta1.fasta.gz.strain_track",
    ):
        with open(name, "rb") as f:
            assert f.read() == expected(name), name


def test_strain_track_max_reads_no_track(tmp_path, monkeypatch):
    from strainer2_tpu_torch.pipeline.multi import run_strain_track

    _stage_strain_track(tmp_path, monkeypatch)
    out = io.StringIO()
    run_strain_track("strains2.txt", "scrubmeta1.fasta.gz", print_track=False, max_reads=60,
                     out=out, device="cpu", **BATCH)
    assert out.getvalue().encode() == expected("strain_track_m100_stdout.txt")


def _valid_stream(k):
    """A bucket table of a random genome at k, and a stream of batches: 8 x
    1024 rows, every other one from the genome, 3% N; then 3 rows of the
    same kind (a batch with fewer rows); then 8 rows all N."""
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 30_000, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, k)
    table = build_bucket_table(np.unique(codes[valid]), k)
    stream = []
    for n_rows in (8, 3):
        bases = rng.integers(0, 4, (n_rows, 1024), dtype=np.uint8)
        for r in range(0, n_rows, 2):
            s = int(rng.integers(0, genome.size - 1024))
            bases[r] = genome[s : s + 1024]
        bases[rng.random(bases.shape) < 0.03] = 4
        stream.append(bases)
    stream.append(np.full((8, 1024), 4, dtype=np.uint8))
    return table, stream


def _jax_valid_stream(table, stream, k):
    """counts after the stream, and each batch's valid scalar, from the JAX
    _count_valid_step_bucket."""
    start = np.zeros(table.num_slots, dtype=np.uint32)
    start[table.slot_of_key[::3]] = 0xFFFFFFFF  # wraps on a hit
    step = jax.jit(partial(jax_engine._count_valid_step_bucket, k=k),
                   static_argnames=("h_bits", "salt"))
    counts, per_batch = jnp.asarray(start), []
    for bases in stream:
        counts, n_valid = step(counts, jnp.asarray(table.table), jnp.asarray(bases),
                               h_bits=table.h_bits, salt=table.salt)
        per_batch.append(int(n_valid))
    return start, np.asarray(counts), per_batch


def _check_plain_valid_stream(k, tally_start):
    """The plain K3 with its valid count over _valid_stream into a tally
    whose slot 0 starts at tally_start: counts equal the JAX program's,
    and the total is tally_start plus the sum of its per-batch scalars."""
    table, stream = _valid_stream(k)
    start, j_counts, j_valid = _jax_valid_stream(table, stream, k)
    counts = torch.from_numpy(start.copy())
    tally = torch.zeros(L.n_tiles(8, 1024, k), dtype=torch.int64)
    tally[0] = tally_start
    rows = torch.from_numpy(table.table)
    for bases in stream:
        out = L.count_valid_step_plain(counts, tally, rows, torch.from_numpy(bases),
                                       table.h_bits, table.salt, k)
        assert out is counts
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    total = L.valid_tally_total_plain(tally)
    assert total.dtype == torch.int64 and int(total) == tally_start + sum(j_valid)
    assert j_valid[0] > 0 and j_valid[1] > 0 and j_valid[2] == 0
    assert not np.array_equal(counts.numpy(), start)
    return table, stream, start, j_valid


@pytest.mark.parametrize("k", [20, 31])
def test_count_valid_step_plain_matches_jax(k):
    """The plain K3 with its valid count over a stream (a full batch, one
    with fewer rows, one all N) against the JAX program: equal counts, and
    a tally total equal to the sum of its per-batch scalars; the wrappers
    take the plain path on CPU tensors."""
    table, stream, start, j_valid = _check_plain_valid_stream(k, 0)
    tally = torch.zeros(L.n_tiles(8, 1024, k), dtype=torch.int64)
    L.count_valid_step(torch.from_numpy(start.copy()), tally, torch.from_numpy(table.table),
                       torch.from_numpy(stream[0]), table.h_bits, table.salt, k)
    assert int(L.valid_tally_total(tally)) == j_valid[0]


@pytest.mark.parametrize("k", [20, 31])
def test_count_valid_step_plain_tally_past_2_31(k):
    """The same stream into a tally that starts 5 below 2**31: the total
    passes 2**31 exactly (int64, no wrap)."""
    _check_plain_valid_stream(k, 2**31 - 5)


@pytest.mark.parametrize("k", [20, 31])
def test_engine_valid_tally_matches_jax(k):
    """TorchKmerEngine's tally life cycle on the CPU (init_valid_tally,
    count_batch_with_valid, valid_total) against the JAX program's per-batch
    scalars summed over the stream."""
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    table, stream = _valid_stream(k)
    start, j_counts, j_valid = _jax_valid_stream(table, stream, k)
    engine = TorchKmerEngine(k, device="cpu")
    tally = engine.init_valid_tally(8, 1024)
    assert tally.dtype == torch.int64 and tally.shape == (8 * -(-(1024 - k + 1) // 256),)
    assert not tally.any()
    counts = engine.counts_from_numpy(None, start)
    rows = engine.to_device(table.table)
    for bases in stream:
        counts = engine.count_batch_with_valid(counts, tally, rows, table.h_bits, table.salt, bases)
    np.testing.assert_array_equal(engine.finalize_counts(counts), j_counts)
    total = engine.valid_total(tally)
    assert type(total) is int and total == sum(j_valid) > 0
