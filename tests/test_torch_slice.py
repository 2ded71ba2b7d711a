"""The port's four stages on the CPU (plain torch versions of the kernels)
reproduce the mini goldens byte for byte, and match the JAX package's own
run; its partition of files and samples across processes is the JAX
package's."""

import contextlib
import gzip
import io
import os

import pytest
import torch

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")


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


@pytest.mark.parametrize("c_list,golden", [(None, "scrub_counts.tsv"),
                                           ("data/drugs.txt", "scrub_counts_drug.tsv")])
def test_scrub_count_matches_golden(c_list, golden):
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    out = io.StringIO()
    run_scrub_count("data/strainA.fna.gz", "data/genomes.txt", "data/metagenomes.txt",
                    c_list=c_list, out=out, cfg=ScrubCountConfig(device="cpu"))
    assert out.getvalue().encode() == expected(golden)


def test_scrub_count_matches_jax_run_in_encounter_order():
    """No golden for first-encounter row order: the JAX package's run is the
    reference."""
    from strainer2_tpu.pipeline.scrub_count import ScrubCountConfig as JaxCfg
    from strainer2_tpu.pipeline.scrub_count import run_scrub_count as jax_run
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    args = ("data/strainA.fna.gz", "data/genomes.txt", "data/metagenomes.txt")
    ours, theirs = io.StringIO(), io.StringIO()
    run_scrub_count(*args, out=ours, cfg=ScrubCountConfig(device="cpu", reference_order=False))
    jax_run(*args, out=theirs, cfg=JaxCfg(reference_order=False))
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().encode() != expected("scrub_counts.tsv")


@pytest.mark.parametrize(
    "kwargs,golden_hits,golden_stdout",
    [
        (dict(batch_list="data/targets.txt"), "kmer_hits.txt", "detect_stdout.txt"),
        (dict(batch_list="data/targets.txt", background_list="data/background.txt"),
         "kmer_hits_bg.txt", "detect_bg_stdout.txt"),
        (dict(b_file="data/target_PE1.fasta.gz", b_file2="data/target_PE2.fasta.gz", file_type=1),
         "kmer_hits_single.txt", "detect_single_stdout.txt"),
    ],
    ids=["batch", "background", "single_pe"],
)
def test_detect_matches_golden_and_jax(tmp_path, kwargs, golden_hits, golden_stdout):
    from strainer2_tpu.pipeline.detect import run_detect as jax_run_detect
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

    hits, out = str(tmp_path / "hits.gz"), io.StringIO()
    run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", hits, stdout=out,
               cfg=DetectConfig(device="cpu"), **kwargs)
    with gzip.open(hits, "rb") as f:
        payload = f.read()
    assert payload == expected(golden_hits)
    assert out.getvalue().encode() == expected(golden_stdout)

    j_hits, j_out = str(tmp_path / "jax_hits.gz"), io.StringIO()
    jax_run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", j_hits, stdout=j_out, **kwargs)
    with gzip.open(j_hits, "rb") as f:
        assert f.read() == payload
    assert j_out.getvalue() == out.getvalue()


def test_detect_no_gzip_and_index_cache(tmp_path):
    """--no-gzip writes the same rows as plain text; an index cached by the
    JAX package (bucket layout) is reused as it is."""
    from strainer2_tpu.index.build import StrainIndex as JaxIndex
    from strainer2_tpu.pipeline.engine import KmerEngine
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

    cache = str(tmp_path / "index.npz")
    JaxIndex.from_fasta("data/strainA.fna.gz", KmerEngine(31, layout="bucket")).save(cache)
    hits, out = str(tmp_path / "hits.txt"), io.StringIO()
    det = run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", hits,
                     batch_list="data/targets.txt", stdout=out, cfg=DetectConfig(device="cpu"),
                     index_cache=cache, gzip_output=False)
    with open(hits, "rb") as f:
        assert f.read() == expected("kmer_hits.txt")
    assert det.index.table.h_bits == JaxIndex.load(cache).table.h_bits


def _cli(module: str, argv: list[str], path: str) -> int:
    import importlib

    main = importlib.import_module(f"strainer2_tpu_torch.cli.{module}").main
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        return main(argv + ["--device", "cpu"])


def _read(path: str, gz: bool = False) -> bytes:
    with (gzip.open if gz else open)(path, "rb") as f:
        return f.read()


def test_cli_chain_reproduces_goldens(tmp_path):
    """The four CLIs chained as the README runs them: count -> filter ->
    detect -> coverage, each fed the previous stage's output."""
    t = lambda name: str(tmp_path / name)  # noqa: E731
    assert _cli("kmer_scrub_count", ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                                     "-B", "data/metagenomes.txt"], t("counts.tsv")) == 0
    assert _read(t("counts.tsv")) == expected("scrub_counts.tsv")
    assert _cli("kmer_scrub_filter", ["-s", t("counts.tsv"), "-m", "0.05"], t("scrubbed.txt")) == 0
    assert _read(t("scrubbed.txt")) == expected("scrubbed_m05.txt")
    assert _cli("strain_detect", ["-r", "data/strainA.fna.gz", "-a", t("scrubbed.txt"),
                                  "-B", "data/targets.txt", "-o", t("strainA_x.kmer_hits.gz")],
                t("detect_stdout.txt")) == 0
    assert _read(t("strainA_x.kmer_hits.gz"), gz=True) == expected("kmer_hits.txt")
    assert _read(t("detect_stdout.txt")) == expected("detect_stdout.txt")
    assert _cli("coverage_depth", ["-k", t("strainA_x.kmer_hits.gz")], t("coverage.tsv")) == 0
    assert _read(t("coverage.tsv")) == expected("coverage_depth.tsv")


@pytest.mark.parametrize("seed,n,ranks", [(0, 13, 4), (1, 7, 2), (2, 3, 4), (3, 40, 3)])
def test_partition_matches_jax(tmp_path, seed, n, ranks):
    """The port's partition_by_size and host_file_partition are the JAX
    package's (strainer2_tpu/parallel/distributed.py:155-188) on seeded
    sizes with zeros and duplicates, and on files (a duplicate path, a
    missing one, an empty one): every rank gets the same share from both."""
    import numpy as np

    from strainer2_tpu.parallel import distributed as jax_dist
    from strainer2_tpu_torch.parallel import distributed as port_dist

    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 5, size=n) * rng.integers(1, 1000, size=n)  # zeros
    sizes[rng.integers(0, n, size=max(1, n // 4))] = int(sizes.max())  # duplicates
    paths = []
    for i, size in enumerate(sizes.tolist()):
        p = tmp_path / f"f{i}.fa"
        p.write_bytes(b"x" * size)
        paths.append(str(p))
    paths += [paths[0], str(tmp_path / "missing.fa")]
    for r in range(ranks):
        assert port_dist.partition_by_size(sizes.tolist(), r, ranks) == \
            jax_dist.partition_by_size(sizes.tolist(), r, ranks)
        assert port_dist.host_file_partition(paths, r, ranks) == \
            jax_dist.host_file_partition(paths, r, ranks)


@pytest.mark.parametrize("module", ["kmer_scrub_count", "strain_detect"])
def test_cli_device_cuda_without_card_fails(tmp_path, capsys, module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    main = importlib.import_module(f"strainer2_tpu_torch.cli.{module}").main
    argv = {"kmer_scrub_count": ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                                 "-B", "data/metagenomes.txt"],
            "strain_detect": ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt",
                              "-B", "data/targets.txt", "-o", str(tmp_path / "h.gz")]}[module]
    assert main(argv) == 1  # --device defaults to cuda
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
