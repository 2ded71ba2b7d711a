"""genome_compare on the port, on the CPU: the six gc_* goldens through
run_genome_compare with the native string engine (the CPU default) and
with the plain torch versions of K8 and K9 (STRAINER2_NATIVE_COMPARE=0),
at 8 x 1024 batches; those plain versions against the JAX programs
_hit_accum_bucket and _hit_stats_bucket, edge cases of the crossing
included; the index built by the JAX package carried into the port's
engine; the reference's errors on unreadable queries; one CLI run.
All comparisons are exact integer or byte equality."""

import contextlib
import io
import os
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


@pytest.fixture(autouse=True)
def _chdir(monkeypatch):
    monkeypatch.chdir(MINI)


# the argv of tools/make_mini_fixtures.py's genome_compare runs
GOLDENS = [
    (dict(b_file="data/panel1.fna.gz", print_header=True), {}, "gc_single.txt"),
    (dict(b_list="data/compare_list.txt"), dict(k=17), "gc_list_s17.txt"),
    (dict(b_list="data/compare_list.txt"), dict(max_seeds=300, threshold_for_fullmap=0.5),
     "gc_rapid.txt"),
    (dict(b_list="data/compare_list.txt"), dict(max_seeds=100_000, threshold_for_fullmap=0.05),
     "gc_strainmode.txt"),
    (dict(b_list="data/compare_list.txt"), dict(k=40), "gc_s40.txt"),
    (dict(b_list="data/compare_list.txt"), dict(k=40, max_seeds=200, threshold_for_fullmap=0.3),
     "gc_s40_rapid.txt"),
]


def _cfg(**kw):
    from strainer2_tpu_torch.pipeline.compare import CompareConfig

    return CompareConfig(rows=ROWS, row_len=ROW_LEN, device="cpu", **kw)


@pytest.mark.parametrize("native", [True, False], ids=["native", "torch"])
@pytest.mark.parametrize("args,cfg_kw,golden", GOLDENS, ids=[g for _, _, g in GOLDENS])
def test_genome_compare_goldens(args, cfg_kw, golden, native, monkeypatch):
    from strainer2_tpu_torch.pipeline.compare import GenomeComparer, run_genome_compare

    if not native:
        monkeypatch.setenv("STRAINER2_NATIVE_COMPARE", "0")
    out = io.StringIO()
    run_genome_compare("data/strainA.fna.gz", cfg=_cfg(**cfg_kw), out=out, **args)
    assert out.getvalue().encode() == expected(golden)
    # the engine each setting chooses
    comparer = GenomeComparer("data/strainA.fna.gz", _cfg(**cfg_kw))
    if native:
        assert type(comparer._host).__name__ == "NativeComparer"
    elif cfg_kw.get("k", 20) > 32:
        assert type(comparer._host).__name__ == "_HostSetComparer"
    else:
        assert comparer._host is None and comparer.engine.device.type == "cpu"


# ---- plain K8 / K9 against the JAX programs --------------------------------------


def _strain_batch(rng, k, n_rows=ROWS, row_len=ROW_LEN):
    """A table of a random genome's k-mers, and a batch of rows: every other
    one from the genome, 3% N, N on each row's edges and around 256-window
    tile edges, the last row all N."""
    genome = rng.integers(0, 4, 30_000, dtype=np.uint8)
    codes, valid = canonical_codes_np(genome, k)
    table = build_bucket_table(np.unique(codes[valid]), k)
    bases = rng.integers(0, 4, (n_rows, row_len), dtype=np.uint8)
    for r in range(0, n_rows, 2):
        s = int(rng.integers(0, genome.size - row_len))
        bases[r] = genome[s : s + row_len]
    bases[rng.random(bases.shape) < 0.03] = 4
    bases[:, [0, row_len - 1, *[p for t in range(256, row_len, 256) for p in (t - 1, t)]]] = 4
    bases[-1] = 4
    return table, bases


def remainings(valid_total: int) -> list:
    """K9's edge cases: at 0 and below, the first valid window, the batch's
    valid total (its last valid window), past it, and a sweep between."""
    sweep = list(range(2, valid_total, max(1, valid_total // 23)))
    return [0, -7, 1, valid_total, valid_total + 1, 2**31 - 1, *sweep]


@pytest.mark.parametrize("k", [17, 20, 31])
def test_hit_stats_and_accumulate_plain_match_jax(k):
    rng = np.random.default_rng(k)
    table, bases = _strain_batch(rng, k)
    rows, b = torch.from_numpy(table.table), torch.from_numpy(bases)
    j_rows, j_bases = jnp.asarray(table.table), jnp.asarray(bases)
    statics = dict(h_bits=table.h_bits, salt=table.salt)
    j_stats = jax.jit(partial(jax_engine._hit_stats_bucket, k=k), static_argnames=("h_bits", "salt"))
    j_accum = jax.jit(partial(jax_engine._hit_accum_bucket, k=k), static_argnames=("h_bits", "salt"))

    acc = L.hit_accumulate_plain(torch.tensor([3, 11], dtype=torch.int64), rows, b,
                                 table.h_bits, table.salt, k)
    ref = j_accum(jnp.asarray([3, 11], dtype=jnp.int32), j_rows, j_bases, **statics)
    assert acc.tolist() == [int(x) for x in ref]
    hits, total = acc[0].item() - 3, acc[1].item() - 11
    assert 0 < hits < total

    for rem in remainings(total):
        got = L.hit_stats_plain(rows, b, rem, table.h_bits, table.salt, k).tolist()
        want = [int(x) for x in j_stats(j_rows, j_bases, jnp.int32(rem), **statics)]
        assert got == want, rem
        if rem <= 0:
            assert got[3] == 0
        elif rem > total:
            assert got[2:] == [0, -1]


def test_index_carries_across_to_the_hit_kernels():
    """StrainIndex.from_fasta(strainA, k=20) in both packages gives the same
    tables, and the port's hit_accumulate and hit_stats on the JAX index's
    table (table_for takes it) equal the JAX engine's."""
    from strainer2_tpu.index.build import StrainIndex as JaxIndex
    from strainer2_tpu.io.batches import pack_stream
    from strainer2_tpu.io.fastx import read_fastx
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    k = 20
    j_eng = jax_engine.KmerEngine(k, layout="bucket")
    j_idx = JaxIndex.from_fasta("data/strainA.fna.gz", j_eng, ROWS, ROW_LEN)
    eng = TorchKmerEngine(k, device="cpu")
    idx = StrainIndex.from_fasta("data/strainA.fna.gz", eng, ROWS, ROW_LEN)
    np.testing.assert_array_equal(idx.codes, j_idx.codes)
    np.testing.assert_array_equal(idx.table.table, j_idx.table.table)
    np.testing.assert_array_equal(idx.table.slot_of_key, j_idx.table.slot_of_key)

    t = j_idx.table
    table, j_table = eng.table_for(j_idx), j_idx.device_table()
    acc, j_acc = eng.init_accumulator(), jnp.zeros(2, dtype=jnp.int32)
    seqs = (r.seq for r in read_fastx("data/panel2.fna"))
    for batch in pack_stream(seqs, k, rows=ROWS, row_len=ROW_LEN):
        eng.hit_accumulate(acc, table, t.h_bits, t.salt, batch.bases)
        j_acc = j_eng.hit_accumulate(j_acc, j_table, t.h_bits, t.salt, batch.bases)
        for rem in (0, 1, 300, 10**6):
            got = eng.hit_stats(table, t.h_bits, t.salt, batch.bases, rem).tolist()
            want = [int(x) for x in j_eng.hit_stats(j_table, t.h_bits, t.salt, batch.bases,
                                                     jnp.int32(rem))]
            assert got == want, rem
    assert acc.tolist() == [int(x) for x in j_acc] == [621, 1021]  # gc_single.txt's panel2 row


# ---- errors and the CLI -------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "torch"])
def test_unreadable_queries_exit_as_the_reference(tmp_path, capsys, monkeypatch, native):
    """The reference's stderr lines and exit 1 (src/genome_compare.c:289,
    251), as tests/test_edge_cases.py holds the JAX package to them; a list
    with an unreadable entry too (the threaded native scoring)."""
    from strainer2_tpu_torch.pipeline.compare import run_genome_compare

    if not native:
        monkeypatch.setenv("STRAINER2_NATIVE_COMPARE", "0")
    genome = str(tmp_path / "a.fa")
    with open(genome, "w") as f:
        f.write(">a\n" + "ACGTTGCA" * 40 + "\n")
    blist = str(tmp_path / "qs.txt")
    with open(blist, "w") as f:
        f.write(genome + "\n/nonexistent_q.fa\n")
    for kw, line in ((dict(b_file="/nonexistent_q.fa"),
                      "could not read file /nonexistent_q.fa in GEN_calculate_coverage()\n"),
                     (dict(b_list="/nonexistent_list.txt"),
                      "could not read file /nonexistent_list.txt in GEN_all_coverage()\n"),
                     (dict(b_list=blist),
                      "could not read file /nonexistent_q.fa in GEN_calculate_coverage()\n")):
        with pytest.raises(SystemExit) as e:
            run_genome_compare(genome, cfg=_cfg(), out=io.StringIO(), **kw)
        assert e.value.code == 1
        assert capsys.readouterr().err.endswith(line)


def test_cli_on_the_cpu():
    from strainer2_tpu_torch.cli.genome_compare import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["-a", "data/strainA.fna.gz", "-B", "data/compare_list.txt", "-S",
                     "--device", "cpu"]) == 0
    assert out.getvalue().encode() == expected("gc_strainmode.txt")
