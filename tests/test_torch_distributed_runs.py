"""Multi-process kmer_scrub_count and strain_detect of the port on the CPU
over gloo (tests/_torch_dist_worker.py): the twins of
tests/test_distributed.py's scrub and detect runs.  Rank 0's table, hits
payload and stdout must equal the mini goldens or the JAX package's
one-process run; the other ranks write nothing."""

import gzip
import io
import json
import os

import numpy as np
import pytest

from strainer2_tpu_torch.parallel.distributed import host_file_partition, partition_by_size
from tests._torch_dist_worker import MINI, launch

SCRUB = {"r": "data/strainA.fna.gz", "a": "data/genomes.txt", "b": "data/metagenomes.txt"}
DETECT = {"r": "data/strainA.fna.gz", "scrubbed": "expected/scrubbed_m05.txt",
          "t": "data/targets.txt"}


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


def _read(path, gz: bool = False) -> bytes:
    with (gzip.open if gz else open)(path, "rb") as f:
        return f.read()


@pytest.fixture
def in_mini(monkeypatch):
    monkeypatch.chdir(MINI)


# ---- kmer_scrub_count ----------------------------------------------------------

@pytest.mark.parametrize("drug", [False, True], ids=["plain", "drug_list"])
def test_run_scrub_count_two_real_processes(tmp_path, drug):
    """Rank 0's table is the golden's byte for byte (with -C, each rank
    skips the strain's own file in its share); rank 1 writes nothing."""
    args = dict(SCRUB, c="data/drugs.txt") if drug else SCRUB
    launch(tmp_path, "scrub", args)
    assert _read(tmp_path / "table_0.tsv") == expected(
        "scrub_counts_drug.tsv" if drug else "scrub_counts.tsv")
    assert _read(tmp_path / "table_1.tsv") == b""


def test_run_scrub_count_two_processes_checkpointed_and_resumed(tmp_path, in_mini):
    """Per-rank checkpoint directories and a partition of the FULL list
    (a duplicate entry included, split by occurrence): a fresh
    checkpointed run and a full resume (every file recorded) both give the
    JAX package's one-process table."""
    from strainer2_tpu.pipeline.scrub_count import run_scrub_count

    panels = ["data/panel1.fna.gz", "data/panel2.fna", "data/scrubmeta1.fasta.gz",
              "data/background1.fasta.gz", "data/panel1.fna.gz"]
    lst = tmp_path / "panels.txt"
    lst.write_text("".join(p + "\n" for p in panels))
    out = io.StringIO()
    run_scrub_count("data/strainA.fna.gz", str(lst), str(lst), out=out)
    want = out.getvalue().encode()

    args = dict(SCRUB, a=str(lst), b=str(lst))
    launch(tmp_path, "scrub_ckpt", args)
    assert _read(tmp_path / "table_0.tsv") == want
    for r in (0, 1):
        with open(tmp_path / "ckpt" / f"rank{r}" / "manifest.json") as f:
            assert json.load(f)["done"], f"rank{r} recorded no finished file"

    os.remove(tmp_path / "table_0.tsv")
    launch(tmp_path, "scrub_ckpt", args)
    assert _read(tmp_path / "table_0.tsv") == want


def test_run_scrub_count_four_processes_fewer_files_than_ranks(tmp_path, in_mini):
    """4 ranks, 2 and 1 panel files: the ranks with empty shares still take
    part in the merge with zero columns, and rank 0's table is the
    golden's."""
    shares = [host_file_partition(["data/panel1.fna.gz", "data/panel2.fna"], r, 4)
              for r in range(4)]
    assert sum(1 for s in shares if not s) >= 2
    launch(tmp_path, "scrub", SCRUB, nproc=4)
    assert _read(tmp_path / "table_0.tsv") == expected("scrub_counts.tsv")
    for r in (1, 2, 3):
        assert _read(tmp_path / f"table_{r}.tsv") == b""


# ---- strain_detect -------------------------------------------------------------

def test_run_detect_two_real_processes(tmp_path):
    """Samples scored across 2 ranks, the background panel counted across
    them too: rank 0's hits payload and stdout are the golden's, rank 1
    opens no hits file and prints nothing."""
    launch(tmp_path, "detect", dict(DETECT, g="data/background.txt"))
    assert _read(tmp_path / "hits_0.gz", gz=True) == expected("kmer_hits_bg.txt")
    assert _read(tmp_path / "detect_stdout_0.txt") == expected("detect_bg_stdout.txt")
    assert not (tmp_path / "hits_1.gz").exists()
    assert _read(tmp_path / "detect_stdout_1.txt") == b""


def test_run_detect_two_processes_checkpointed_and_resumed(tmp_path):
    """Per-rank sample checkpoints: a fresh checkpointed run and a full
    resume (every sample recorded) both give the golden payload and
    stdout, and both ranks scored samples (a real split)."""
    launch(tmp_path, "detect_ckpt", DETECT)
    assert _read(tmp_path / "hits_0.gz", gz=True) == expected("kmer_hits.txt")
    assert _read(tmp_path / "detect_stdout_0.txt") == expected("detect_stdout.txt")
    for r in (0, 1):
        with open(tmp_path / "dckpt" / f"rank{r}" / "detect_manifest.json") as f:
            assert len(json.load(f)["samples"]) > 0, f"rank{r} scored nothing"

    os.remove(tmp_path / "hits_0.gz")
    launch(tmp_path, "detect_ckpt", DETECT)
    assert _read(tmp_path / "hits_0.gz", gz=True) == expected("kmer_hits.txt")
    assert _read(tmp_path / "detect_stdout_0.txt") == expected("detect_stdout.txt")


def test_run_detect_four_processes_fewer_samples_than_ranks(tmp_path, in_mini):
    """4 ranks, 3 samples: a rank with no sample crosses the payload gather
    with an empty share; rank 0's payload and stdout are the golden's."""
    from strainer2_tpu_torch.pipeline.detect import _parse_batch_entries, _sample_sizes

    samples = [v for kind, v in _parse_batch_entries("data/targets.txt") if kind == "sample"]
    assert len(samples) == 3
    assert any(not partition_by_size(_sample_sizes(samples), r, 4) for r in range(4))
    launch(tmp_path, "detect", DETECT, nproc=4)
    assert _read(tmp_path / "hits_0.gz", gz=True) == expected("kmer_hits.txt")
    assert _read(tmp_path / "detect_stdout_0.txt") == expected("detect_stdout.txt")
    for r in (1, 2, 3):
        assert not (tmp_path / f"hits_{r}.gz").exists()


def test_run_detect_failing_sample_two_processes(tmp_path, in_mini):
    """A sample that cannot be read fails the run where the one-process
    loop fails it: every rank exits 1, the reference's message is printed
    by the rank that scored it, and rank 0's partial payload and stdout
    equal the JAX package's one-process partial output."""
    from strainer2_tpu.pipeline.detect import run_detect

    targets = tmp_path / "targets.txt"
    targets.write_text("SE\tdata/target_SE.fastq\nXX\tx\nSE\tmissing.fq\n"
                       "PEI\tdata/target_PEI.fasta\n")
    out = io.StringIO()
    with pytest.raises(SystemExit) as e:
        run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", str(tmp_path / "ref.gz"),
                   batch_list=str(targets), stdout=out)
    assert e.value.code == 1
    outs = launch(tmp_path, "detect", dict(DETECT, t=str(targets)), expect_rc=None)
    assert [rc for rc, _, _ in outs] == [1, 1]
    errs = b"".join(err for _, _, err in outs).decode(errors="replace")
    assert "could not read file (read1) missing.fq in quantify_hits_PE()" in errs
    assert _read(tmp_path / "hits_0.gz", gz=True) == _read(tmp_path / "ref.gz", gz=True)
    assert _read(tmp_path / "detect_stdout_0.txt") == out.getvalue().encode()


def test_partition_of_samples_is_by_size(in_mini):
    """The sample split is partition_by_size over the target files' bytes,
    a PE pair counted as both files."""
    from strainer2_tpu_torch.pipeline.detect import _parse_batch_entries, _sample_sizes

    samples = [v for kind, v in _parse_batch_entries("data/targets.txt") if kind == "sample"]
    sizes = _sample_sizes(samples)
    assert sizes[0] == os.path.getsize("data/target_PE1.fasta.gz") + os.path.getsize(
        "data/target_PE2.fasta.gz")
    assert _sample_sizes([("missing.fq", None, 0)]) == [0]
    shares = [partition_by_size(sizes, r, 2) for r in range(2)]
    assert sorted(i for s in shares for i in s) == [0, 1, 2]
    assert all(shares)
    assert np.argmax(sizes) in shares[0]
