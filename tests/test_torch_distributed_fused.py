"""Multi-process fused pipelines of the port on the CPU over gloo
(tests/_torch_dist_worker.py): the twins of tests/test_distributed.py's
``pipeline`` and ``pipeline-multi`` runs.  Rank 0's artifacts and stdout
must equal the JAX package's one-process run on the mini data; rank 1
writes no artifact."""

import gzip
import io
import os
import shutil

import pytest

from tests._torch_dist_worker import MINI, launch

STRAINS = ["data/strainA.fna.gz", "data/drug1.fna.gz"]
ARGS = {"r": STRAINS[0], "strains": STRAINS, "a": "data/genomes.txt", "b": "data/metagenomes.txt",
        "t": "data/targets.txt", "m": 0.05}
SUFFIXES = (".scrub_kmer_counts.gz", ".scrubbed_kmers.gz", ".kmer_hits.gz", ".coverage_depth")


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


def _payload(path) -> bytes:
    with (gzip.open if str(path).endswith(".gz") else open)(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's one-process pipeline (with and without the
    background panel) and pipeline-multi on the mini data: (out dir,
    stdout) by name."""
    from strainer2_tpu.pipeline.fused import FusedConfig, run_multi_pipeline, run_pipeline

    d = tmp_path_factory.mktemp("jax_fused")
    runs = {}
    cwd = os.getcwd()
    os.chdir(MINI)
    try:
        for name, bg in (("plain", None), ("background", "data/background.txt")):
            out = io.StringIO()
            run_pipeline(ARGS["r"], ARGS["a"], ARGS["b"], ARGS["t"], str(d / name),
                         background_list=bg, fused_cfg=FusedConfig(min_fraction=0.05),
                         err=io.StringIO(), stdout=out)
            runs[name] = (d / name, out.getvalue())
        out = io.StringIO()
        run_multi_pipeline(STRAINS, ARGS["a"], ARGS["b"], ARGS["t"], str(d / "multi"),
                           fused_cfg=FusedConfig(min_fraction=0.05), err=io.StringIO(),
                           stdout=out)
        runs["multi"] = (d / "multi", out.getvalue())
    finally:
        os.chdir(cwd)
    return runs


def _check(got_dir, want_dir, stems) -> None:
    for stem in stems:
        for suffix in SUFFIXES:
            assert _payload(got_dir / (stem + suffix)) == _payload(want_dir / (stem + suffix)), (
                stem, suffix)


def _silent(out_dir) -> bool:
    """Rank 1 wrote no artifact (its out dir may exist, empty)."""
    return not out_dir.exists() or not os.listdir(out_dir)


@pytest.mark.parametrize("case", ["plain", "background"])
def test_fused_pipeline_two_real_processes(tmp_path, jax_runs, case):
    """The fused pipeline with the panel scan, the background panel and
    the detection split across 2 ranks: rank 0's four artifacts and stdout
    equal the JAX package's one-process run; rank 1 writes none."""
    args = dict(ARGS, g="data/background.txt") if case == "background" else ARGS
    launch(tmp_path, "fused", args)
    want_dir, want_stdout = jax_runs[case]
    _check(tmp_path / "fused_out_0", want_dir, ["strainA"])
    assert (tmp_path / "stdout_0.txt").read_text() == want_stdout
    assert (tmp_path / "stdout_1.txt").read_text() == ""
    assert _silent(tmp_path / "fused_out_1")


def test_fused_multi_pipeline_two_real_processes(tmp_path, jax_runs):
    """pipeline-multi with the shared union scan and the multi-strain
    detection split across 2 ranks: every strain's artifacts on rank 0
    equal the JAX package's one-process run; rank 1 writes none."""
    launch(tmp_path, "multi", ARGS)
    want_dir, want_stdout = jax_runs["multi"]
    _check(tmp_path / "multi_out_0", want_dir, ["strainA", "drug1"])
    assert (tmp_path / "stdout_0.txt").read_text() == want_stdout
    assert _silent(tmp_path / "multi_out_1")


def test_fused_multi_pipeline_two_processes_checkpointed_strain_threads(tmp_path, jax_runs):
    """pipeline-multi over 2 ranks with the checkpoint and
    STRAINER2_STRAIN_THREADS=2: per-rank scrub checkpoints and per-pass
    detect checkpoints compose with the rank split and the strain pool;
    the fresh run and a full resume both give the JAX run's artifacts."""
    env = {"STRAINER2_STRAIN_THREADS": "2"}
    want_dir, _ = jax_runs["multi"]
    launch(tmp_path, "multi_ckpt", ARGS, extra_env=env)
    _check(tmp_path / "multi_out_0", want_dir, ["strainA", "drug1"])
    for r in (0, 1):
        assert (tmp_path / "mckpt" / "scrub" / f"rank{r}").is_dir()
    detect_dirs = [d for d in os.listdir(tmp_path / "mckpt") if d.startswith("detect_")]
    assert detect_dirs and all(
        sorted(os.listdir(tmp_path / "mckpt" / d)) == ["rank0", "rank1"] for d in detect_dirs)

    shutil.rmtree(tmp_path / "multi_out_0")
    launch(tmp_path, "multi_ckpt", ARGS, extra_env=env)
    _check(tmp_path / "multi_out_0", want_dir, ["strainA", "drug1"])
