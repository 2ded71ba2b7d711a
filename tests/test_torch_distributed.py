"""The port's multi-process helpers (strainer2_tpu_torch.parallel.distributed)
on the CPU over gloo: the twins of tests/test_distributed.py's partition,
pass-through, merge and dead-rank tests, and the env-var bring-up of the
CLIs.  Every multi-process case starts real processes
(tests/_torch_dist_worker.py), each on a port bound to port 0, and holds
them to the JAX package's one-process result or to the mini goldens."""

import gzip
import json
import os
import sys
import time

import numpy as np
import pytest

from strainer2_tpu_torch.parallel.distributed import (
    gather_blobs,
    host_file_partition,
    initialize,
    launch_rank,
    merge_across_hosts,
    process_count,
    process_index,
)
from tests._torch_dist_worker import MINI, base_env, free_port, launch, run_ranks

PANELS = ["data/panel1.fna.gz", "data/panel2.fna", "data/scrubmeta1.fasta.gz"]


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


def test_initialize_single_process(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() == (0, 1)
    assert (process_index(), process_count(), launch_rank()) == (0, 1, None)


def test_launch_rank_from_the_env_contract(monkeypatch):
    """Before the group is up, the launch variables name the rank that a
    bare cuda device maps from; a one-process launch names none."""
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert launch_rank() == 3
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert launch_rank() is None


def test_host_file_partition_covers_and_balances(tmp_path):
    paths = []
    rng = np.random.default_rng(0)
    for i in range(13):
        p = tmp_path / f"f{i}.fa"
        p.write_bytes(b"x" * int(rng.integers(10, 10_000)))
        paths.append(str(p))
    shares = [host_file_partition(paths, h, 4) for h in range(4)]
    union = [p for s in shares for p in s]
    assert sorted(union) == sorted(paths)
    assert len(set(union)) == len(paths)
    for s in shares:
        assert s == [p for p in paths if p in set(s)]
    # balanced: no share holds more than the largest file above the mean
    sizes = {p: os.path.getsize(p) for p in paths}
    loads = [sum(sizes[p] for p in s) for s in shares]
    assert max(loads) - min(loads) <= max(sizes.values())


def test_host_file_partition_duplicate_entries_split_by_occurrence(tmp_path):
    """Duplicate list entries (they count again) are split by POSITION:
    each occurrence lands on exactly one rank."""
    p = tmp_path / "f.fa"
    p.write_bytes(b"x" * 100)
    paths = [str(p), str(p)]
    shares = [host_file_partition(paths, h, 2) for h in range(2)]
    assert sorted(len(s) for s in shares) in ([0, 2], [1, 1])
    assert sum(len(s) for s in shares) == 2


def test_single_process_pass_through():
    counts = np.arange(100, dtype=np.uint32)
    np.testing.assert_array_equal(merge_across_hosts(counts), counts)
    assert merge_across_hosts(counts).dtype == np.uint32
    assert gather_blobs(b"payload") == [b"payload"]


def test_merge_across_hosts_two_real_processes(tmp_path):
    """Two gloo ranks each count their host_file_partition share of the
    panel through the production counting path and merge: both merged
    columns equal the JAX package's one-process count over every file, and
    neither rank saw everything.  The collectives keep what gloo cannot
    carry as it is: uint32 sums wrap, uint64 and 2-D arrays keep their
    dtype and shape, blobs of other lengths (one empty) arrive whole."""
    from strainer2_tpu.index import StrainIndex
    from strainer2_tpu.pipeline.engine import KmerEngine
    from strainer2_tpu.pipeline.scrub_count import count_panel_file

    cwd = os.getcwd()
    os.chdir(MINI)
    try:
        engine = KmerEngine(31)
        index = StrainIndex.from_fasta("data/strainA.fna.gz", engine, 8, 1024)
        counts = engine.init_counts(index)
        for p in PANELS:
            counts = count_panel_file(engine, index, counts, p, 8, 1024)
        want = index.key_values(np.asarray(engine.finalize_counts(counts)))
    finally:
        os.chdir(cwd)
    assert int(want.sum()) > 0

    launch(tmp_path, "merge", {"r": "data/strainA.fna.gz", "panels": PANELS})
    locals_ = [np.load(tmp_path / f"local_{i}.npy") for i in range(2)]
    assert any((loc != want).any() for loc in locals_)
    np.testing.assert_array_equal(locals_[0] + locals_[1], want)
    for i in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"merged_{i}.npy"), want)
        with open(tmp_path / f"collectives_{i}.json") as f:
            c = json.load(f)
        assert c["wrap"] == [2**32 - 2, 14, 1] and c["wrap_dtype"] == "uint32"
        assert c["wide"] == [[2**41 + 1] * 3] * 2 and c["wide_dtype"] == "uint64"
        assert c["blobs"] == ["", "rrr"]


@pytest.mark.parametrize("mode", ["merge_dead", "merge_stall"])
def test_dead_rank_produces_timely_error(tmp_path, mode):
    """A peer rank that exits (its sockets close: gloo raises) or stalls
    (the watchdog fires) before a collective turns into a prompt exit 1 on
    the survivor naming the collective: no hang, no traceback, no merged
    file."""
    t0 = time.time()
    # the stalled rank wakes after the survivor's timeout and ends
    outs = launch(tmp_path, mode, {"stall": 20}, extra_env={"STRAINER2_COLLECTIVE_TIMEOUT": "8"},
                  expect_rc=None, timeout=110)
    elapsed = time.time() - t0
    rc, out, err = outs[0]
    text = err.decode(errors="replace")
    assert rc == 1, text
    assert elapsed < 120, f"abort took {elapsed:.0f}s"
    assert not (tmp_path / "merged_dead_0.npy").exists()
    assert "rank 0: count merge (all_gather)" in text, text
    assert "a peer rank likely died or stalled" in text
    assert "Traceback" not in text
    if mode == "merge_dead":
        assert outs[1][0] == 0


def _cli_ranks(module: str, argv: list, nproc: int, extra_env: dict | None = None):
    port = free_port()
    envs = [base_env({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                      "JAX_NUM_PROCESSES": str(nproc), "JAX_PROCESS_ID": str(i),
                      **(extra_env or {})}) for i in range(nproc)]
    argvs = [[sys.executable, "-m", module, *argv] for _ in range(nproc)]
    return run_ranks(argvs, envs)


@pytest.mark.parametrize("cli", ["kmer_scrub_count", "strain_detect"])
def test_env_var_cli_bringup_two_processes(tmp_path, cli):
    """The documented launch: JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES
    and JAX_PROCESS_ID, one CLI process a rank, both given the same -o:
    rank 0's stdout is byte-equal to the golden one-process stdout (the
    count table; strain_detect's messages), rank 1's is empty, and the
    hits payload is the golden's."""
    small = ["--rows", "8", "--row-len", "1024", "--device", "cpu"]
    if cli == "kmer_scrub_count":
        argv = ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt", "-B", "data/metagenomes.txt"]
        want = expected("scrub_counts.tsv")
    else:
        argv = ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt",
                "-B", "data/targets.txt", "-o", str(tmp_path / "hits.gz")]
        want = expected("detect_stdout.txt")
    outs = _cli_ranks(f"strainer2_tpu_torch.cli.{cli}", argv + small, 2)
    for rc, _, err in outs:
        assert rc == 0, err.decode(errors="replace")[-3000:]
    assert outs[0][1] == want
    assert outs[1][1] == b""
    if cli == "strain_detect":
        with gzip.open(tmp_path / "hits.gz", "rb") as f:
            assert f.read() == expected("kmer_hits.txt")
