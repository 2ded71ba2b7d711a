"""The port's library modes (pipeline/multi.py) on the CPU against the
reference goldens under tests/golden/mini/expected/modes, as
tests/test_modes_parity.py holds the JAX package to them, at 8 x 1024
batches; and the plain K3 with its valid count against the JAX program
_count_valid_step_bucket."""

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


@pytest.mark.parametrize("k", [20, 31])
def test_count_valid_step_plain_matches_jax(k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 30_000, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, k)
    table = build_bucket_table(np.unique(codes[valid]), k)
    bases = rng.integers(0, 4, (8, 1024), dtype=np.uint8)
    for r in range(0, 8, 2):
        s = int(rng.integers(0, genome.size - 1024))
        bases[r] = genome[s : s + 1024]
    bases[rng.random(bases.shape) < 0.03] = 4
    start = np.zeros(table.num_slots, dtype=np.uint32)
    start[table.slot_of_key[::3]] = 0xFFFFFFFF  # wraps on a hit
    step = jax.jit(partial(jax_engine._count_valid_step_bucket, k=k),
                   static_argnames=("h_bits", "salt"))
    j_counts, j_valid = step(jnp.asarray(start), jnp.asarray(table.table), jnp.asarray(bases),
                             h_bits=table.h_bits, salt=table.salt)
    counts, n_valid = L.count_valid_step_plain(torch.from_numpy(start.copy()),
                                               torch.from_numpy(table.table),
                                               torch.from_numpy(bases), table.h_bits, table.salt, k)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    assert n_valid.dtype == torch.int32 and int(n_valid) == int(j_valid) > 0
    assert not np.array_equal(counts.numpy(), start)
