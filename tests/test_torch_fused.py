"""The port's shared-panel scrub (scrub-multi) and fused pipelines
(pipeline, pipeline-multi) on tests/golden/mini: twins of
tests/test_multi_scrub.py and of the fused cases of
tests/test_parity_mini.py on the CPU (plain torch versions of the
kernels), each held against the goldens, the port's staged stages and the
JAX package's run; the CLIs against the JAX CLIs; and, marked ``cuda``,
the fused runners on the card against the goldens and the CPU run."""

import contextlib
import gzip
import io
import os

import pytest
import torch

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
PANELS = ("data/genomes.txt", "data/metagenomes.txt")
TWO_STRAINS = ["data/strainA.fna.gz", "data/drug1.fna.gz"]


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


@pytest.fixture(autouse=True)
def _chdir(monkeypatch):
    monkeypatch.chdir(MINI)


# Small batches for the CPU runs: the plain torch kernels work through every
# window of a batch, padding included, and the mini files fill a few
# thousand bases of the default 256 x 4096.  Outputs do not depend on the
# batch geometry; the JAX runs they are held to keep theirs.
ROWS, ROW_LEN = 8, 1024


@pytest.fixture(autouse=True)
def _small_batches(request, monkeypatch):
    if request.node.get_closest_marker("cuda"):
        return  # the card runs the real geometry
    from dataclasses import dataclass

    from strainer2_tpu_torch.pipeline import detect, scrub_count

    @dataclass
    class SmallScrub(scrub_count.ScrubCountConfig):
        rows: int = ROWS
        row_len: int = ROW_LEN

    @dataclass
    class SmallDetect(detect.DetectConfig):
        rows: int = ROWS
        row_len: int = ROW_LEN

    monkeypatch.setattr(scrub_count, "ScrubCountConfig", SmallScrub)
    monkeypatch.setattr(detect, "DetectConfig", SmallDetect)


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


def _read(path, gz: bool = False) -> bytes:
    with (gzip.open if gz else open)(path, "rb") as f:
        return f.read()


def _scfg():
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig

    return ScrubCountConfig(device="cpu")


def _single(r, c_list=None) -> str:
    from strainer2_tpu_torch.pipeline.scrub_count import run_scrub_count

    out = io.StringIO()
    run_scrub_count(r, *PANELS, c_list=c_list, out=out, cfg=_scfg())
    return out.getvalue()


# ---- scrub-multi ---------------------------------------------------------------

@pytest.mark.parametrize("c_list", [None, "data/drugs.txt"], ids=["no_drug", "drug_own_file_skip"])
def test_multi_scrub_matches_single_runs_and_jax(c_list):
    """Each strain's table equals its single kmer_scrub_count run and the JAX
    package's run_multi_scrub; with -C each strain skips its own genome
    (data/drugs.txt lists strainA itself)."""
    from strainer2_tpu.pipeline.multi_scrub import run_multi_scrub as jax_run
    from strainer2_tpu_torch.pipeline.multi_scrub import run_multi_scrub

    outs = [io.StringIO() for _ in TWO_STRAINS]
    run_multi_scrub(TWO_STRAINS, *PANELS, c_list, outs, cfg=_scfg())
    theirs = [io.StringIO() for _ in TWO_STRAINS]
    jax_run(TWO_STRAINS, *PANELS, c_list, theirs)
    for i, r in enumerate(TWO_STRAINS):
        assert outs[i].getvalue() == _single(r, c_list) == theirs[i].getvalue(), r
    golden = "scrub_counts_drug.tsv" if c_list else "scrub_counts.tsv"
    assert outs[0].getvalue().encode() == expected(golden)


def test_multi_scrub_unreadable_panel_matches_reference_diagnostic(tmp_path, capsys):
    """An unreadable panel file in the union scan exits 1 with the
    reference's stderr line, which the JAX package's line ends with."""
    from strainer2_tpu.pipeline.multi_scrub import run_multi_scrub as jax_run
    from strainer2_tpu_torch.pipeline.multi_scrub import run_multi_scrub

    bad = tmp_path / "bad.txt"
    bad.write_text("/nonexistent_panel.fa.gz\n")
    errs = []
    for run, kw in ((run_multi_scrub, dict(cfg=_scfg())), (jax_run, {})):
        with pytest.raises(SystemExit) as e:
            run(["data/strainA.fna.gz"], str(bad), "data/metagenomes.txt", None,
                [io.StringIO()], **kw)
        assert e.value.code == 1
        errs.append(capsys.readouterr().err)
    line = "could not read file /nonexistent_panel.fa.gz in GEN_calculate_kmer_count()\n"
    assert errs[0] == line and errs[1].endswith(line)


@pytest.mark.parametrize("path", ["multi_scrub_counts", "run_multi_pipeline"])
def test_multi_paths_never_build_per_strain_tables(tmp_path, monkeypatch, path):
    """Only the union's table is built: after the shared scrub (and after the
    whole fused multi-strain pipeline) every per-strain index is
    table-less, and the one table built is the union's."""
    from strainer2_tpu_torch.index import build
    from strainer2_tpu_torch.index.build import StrainIndex

    made, built = [], []
    from_fasta = StrainIndex.from_fasta.__func__
    real_build = build.build_bucket_table

    def recording(cls, *args, **kw):
        made.append(from_fasta(cls, *args, **kw))
        return made[-1]

    def build_table(codes, *args, **kw):
        built.append(codes.size)
        return real_build(codes, *args, **kw)

    monkeypatch.setattr(StrainIndex, "from_fasta", classmethod(recording))
    monkeypatch.setattr(build, "build_bucket_table", build_table)
    if path == "multi_scrub_counts":
        from strainer2_tpu_torch.pipeline.multi_scrub import multi_scrub_counts

        _, columns = multi_scrub_counts(TWO_STRAINS, *PANELS, None, _scfg())
        assert len(columns) == 2
    else:
        from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_multi_pipeline

        run_multi_pipeline(TWO_STRAINS, *PANELS, "data/targets.txt", str(tmp_path),
                           fused_cfg=FusedConfig(min_fraction=0.05, device="cpu"),
                           err=io.StringIO(), stdout=io.StringIO())
    assert len(made) == 2 and len(built) == 1
    assert built[0] == len(set().union(*(set(ix.codes.tolist()) for ix in made)))
    for ix in made:
        assert ix.table_ is None, "per-strain table was built needlessly"


# ---- pipeline and pipeline-multi --------------------------------------------------

def _fused(out_dir, device="cpu", **kw):
    from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_pipeline

    cfg = dict(min_fraction=0.05, device=device)
    cfg.update(kw.pop("cfg", {}))
    stdout = io.StringIO()
    paths = run_pipeline("data/strainA.fna.gz", *PANELS, "data/targets.txt", str(out_dir),
                         fused_cfg=FusedConfig(**cfg), err=io.StringIO(), stdout=stdout, **kw)
    return paths, stdout.getvalue()


def _coverage_of(hits_path) -> bytes:
    """A staged coverage_depth run on the fused hits file itself (coverage
    names come from the hits file's name)."""
    from strainer2_tpu_torch.pipeline.coverage import run_coverage_depth

    out = io.StringIO()
    run_coverage_depth(hits_path, out=out)
    return out.getvalue().encode()


def _check_single_artifacts(paths, stdout):
    assert _read(paths["counts"], gz=True) == expected("scrub_counts.tsv")
    assert _read(paths["scrubbed"], gz=True) == expected("scrubbed_m05.txt")
    assert _read(paths["hits"], gz=True) == expected("kmer_hits.txt")
    assert stdout.encode() == expected("detect_stdout.txt")
    assert _read(paths["coverage"]) == _coverage_of(paths["hits"])


def test_fused_pipeline_artifact_parity(tmp_path):
    """The fused one-process pipeline writes the goldens' bytes for every
    artifact, and the JAX package's fused run the same."""
    from strainer2_tpu.pipeline.fused import FusedConfig as JaxCfg
    from strainer2_tpu.pipeline.fused import run_pipeline as jax_run

    paths, stdout = _fused(tmp_path / "fused")
    _check_single_artifacts(paths, stdout)
    j_out = io.StringIO()
    j_paths = jax_run("data/strainA.fna.gz", *PANELS, "data/targets.txt", str(tmp_path / "jax"),
                      fused_cfg=JaxCfg(min_fraction=0.05), err=io.StringIO(), stdout=j_out)
    assert j_out.getvalue() == stdout
    for key in ("counts", "scrubbed", "hits"):
        assert _read(paths[key], gz=True) == _read(j_paths[key], gz=True), key


def test_fused_pipeline_background_and_no_intermediates(tmp_path):
    paths, stdout = _fused(tmp_path / "fused_bg", background_list="data/background.txt",
                           cfg=dict(write_counts=False, write_scrubbed=False))
    assert paths["counts"] is None and paths["scrubbed"] is None
    assert sorted(os.listdir(tmp_path / "fused_bg")) == ["strainA.coverage_depth",
                                                         "strainA.kmer_hits.gz"]
    assert _read(paths["hits"], gz=True) == expected("kmer_hits_bg.txt")
    assert stdout.encode() == expected("detect_bg_stdout.txt")


def test_fused_multi_pipeline_matches_staged_per_strain(tmp_path):
    """run_multi_pipeline's per-strain artifacts equal the port's staged
    stages run strain by strain (scrub -> filter -> detect -> coverage) and
    the JAX package's run_multi_pipeline; stdout equals the JAX run's."""
    from strainer2_tpu.pipeline.fused import FusedConfig as JaxCfg
    from strainer2_tpu.pipeline.fused import run_multi_pipeline as jax_run
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect
    from strainer2_tpu_torch.pipeline.filter import parse_scrub_tables, run_filter
    from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_multi_pipeline

    staged = []
    for i, r in enumerate(TWO_STRAINS):
        counts = tmp_path / f"c{i}.tsv"
        counts.write_text(_single(r))
        scrub_out = io.StringIO()
        run_filter(parse_scrub_tables([str(counts)]), min_fraction=0.05, out=scrub_out,
                   err=io.StringIO())
        scrubbed = tmp_path / f"s{i}.txt"
        scrubbed.write_text(scrub_out.getvalue())
        hits = tmp_path / f"h{i}.gz"
        run_detect(r, str(scrubbed), str(hits), batch_list="data/targets.txt",
                   stdout=io.StringIO(), cfg=DetectConfig(device="cpu"))
        staged.append((counts.read_bytes(), scrubbed.read_bytes(), _read(hits, gz=True)))

    out = io.StringIO()
    all_paths = run_multi_pipeline(TWO_STRAINS, *PANELS, "data/targets.txt",
                                   str(tmp_path / "fusedm"),
                                   fused_cfg=FusedConfig(min_fraction=0.05, device="cpu"),
                                   err=io.StringIO(), stdout=out)
    j_out = io.StringIO()
    j_paths = jax_run(TWO_STRAINS, *PANELS, "data/targets.txt", str(tmp_path / "jaxm"),
                      fused_cfg=JaxCfg(min_fraction=0.05), err=io.StringIO(), stdout=j_out)
    assert out.getvalue() == j_out.getvalue()
    for paths, jp, want in zip(all_paths, j_paths, staged):
        got = tuple(_read(paths[k], gz=True) for k in ("counts", "scrubbed", "hits"))
        assert got == want
        assert got == tuple(_read(jp[k], gz=True) for k in ("counts", "scrubbed", "hits"))
        assert _read(paths["coverage"]) == _coverage_of(paths["hits"])


def test_fused_multi_pipeline_duplicate_stems_refused(tmp_path):
    from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_multi_pipeline

    with pytest.raises(ValueError, match="duplicate output stems"):
        run_multi_pipeline(["data/strainA.fna.gz", "other/strainA.fa"], *PANELS,
                           "data/targets.txt", str(tmp_path), fused_cfg=FusedConfig(device="cpu"))


# ---- the CLIs -------------------------------------------------------------------------

def _tools(main, argv, stdout_path):
    err = io.StringIO()
    with open(stdout_path, "w") as f, contextlib.redirect_stdout(f), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def _tree(d) -> dict:
    """Every file under d, decompressed where gzip'd."""
    out = {}
    for name in sorted(os.listdir(d)):
        out[name] = _read(os.path.join(d, name), gz=name.endswith(".gz"))
    return out


CLI_CASES = {
    "scrub-multi": ["scrub-multi", "-R", "{r}", "-A", "data/genomes.txt",
                    "-B", "data/metagenomes.txt", "-C", "data/drugs.txt", "-o", "{o}"],
    "pipeline": ["pipeline", "-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                 "-B", "data/metagenomes.txt", "-T", "data/targets.txt", "-m", "0.05",
                 "-g", "data/background.txt", "-o", "{o}"],
    "pipeline-multi": ["pipeline-multi", "-R", "{r}", "-A", "data/genomes.txt",
                       "-B", "data/metagenomes.txt", "-C", "data/drugs.txt",
                       "-T", "data/targets.txt", "-m", "0.05", "-o", "{o}"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_jax_cli(tmp_path, case):
    """scrub-multi, pipeline and pipeline-multi with --device cpu: every
    output file, stdout and stderr (output paths aside) equal the JAX
    CLI's; the second run has --checkpoint and leaves a checkpoint."""
    from strainer2_tpu.cli.strainer2_tools import main as jax_main
    from strainer2_tpu_torch.cli.strainer2_tools import main

    r_list = tmp_path / "r.txt"
    r_list.write_text("".join(r + "\n" for r in TWO_STRAINS))
    fill = lambda o: [a.format(r=r_list, o=o) for a in CLI_CASES[case]]  # noqa: E731
    runs = {}
    for name, fn, extra in (("jax", jax_main, []), ("ours", main, ["--device", "cpu"]),
                            ("ckpt", main, ["--device", "cpu", "--checkpoint",
                                            str(tmp_path / "ck")])):
        o = str(tmp_path / name)
        rc, err = _tools(fn, fill(o) + extra, str(tmp_path / f"{name}.stdout"))
        assert rc == 0, err
        runs[name] = (_tree(o), _read(tmp_path / f"{name}.stdout"), err.replace(o, "OUT"))
    assert runs["ours"] == runs["jax"] == runs["ckpt"]
    assert os.listdir(tmp_path / "ck")
    if case == "pipeline":
        assert runs["ours"][0]["strainA.kmer_hits.gz"] == expected("kmer_hits_bg.txt")


@pytest.mark.parametrize("cli,argv,golden", [
    ("kmer_scrub_count", ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                          "-B", "data/metagenomes.txt"], "scrub_counts.tsv"),
    ("strain_detect", ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt",
                       "-B", "data/targets.txt", "-o", "{o}"], "detect_stdout.txt"),
])
def test_staged_cli_checkpoint_to_golden(tmp_path, cli, argv, golden):
    """kmer_scrub_count --checkpoint and strain_detect --checkpoint give the
    golden bytes on a fresh run and again on a run that resumes from the
    finished checkpoint."""
    import importlib

    main = importlib.import_module(f"strainer2_tpu_torch.cli.{cli}").main
    ck = str(tmp_path / "ck")
    for i in range(2):
        hits = str(tmp_path / f"hits{i}.gz")
        argv_i = [a.format(o=hits) for a in argv] + ["--checkpoint", ck, "--device", "cpu"]
        rc, err = _tools(main, argv_i, str(tmp_path / "stdout.txt"))
        assert rc == 0, err
        assert _read(tmp_path / "stdout.txt") == expected(golden)
        if cli == "strain_detect":
            assert _read(hits, gz=True) == expected("kmer_hits.txt")
    assert os.listdir(ck)


def test_detect_multi_cli_runs_whole_under_launch_env(tmp_path, monkeypatch):
    """detect-multi never brings a process group up, in either package:
    under the launch variables (rank 1 of 2, a coordinator nobody serves)
    it runs whole in this process, as the JAX CLI does under the same
    variables, and both write the golden hits."""
    from strainer2_tpu.cli.strainer2_tools import main as jax_main
    from strainer2_tpu_torch.cli.strainer2_tools import main
    from strainer2_tpu_torch.parallel.distributed import process_count

    for var, value in (("JAX_COORDINATOR_ADDRESS", "127.0.0.1:9"), ("JAX_NUM_PROCESSES", "2"),
                       ("JAX_PROCESS_ID", "1")):
        monkeypatch.setenv(var, value)
    strains = tmp_path / "strains.tsv"
    strains.write_text("data/strainA.fna.gz\texpected/scrubbed_m05.txt\n")
    for name, run, extra in (("port", main, ["--device", "cpu"]), ("jax", jax_main, [])):
        rc, err = _tools(run, ["detect-multi", "-S", str(strains), "-B", "data/targets.txt",
                               "-o", str(tmp_path / name), *extra], str(tmp_path / f"{name}.out"))
        assert rc in (0, None), err
        assert _read(tmp_path / name / "strainA.kmer_hits.gz", gz=True) == expected("kmer_hits.txt")
        assert _read(tmp_path / f"{name}.out") == expected("detect_stdout.txt")
    assert process_count() == 1


def test_pipeline_multi_cli_empty_strain_list(tmp_path, capsys):
    from strainer2_tpu_torch.cli.strainer2_tools import main

    empty = tmp_path / "r.txt"
    empty.write_text("")
    assert main(["pipeline-multi", "-R", str(empty), "-A", "x", "-B", "x", "-T", "x",
                 "-o", str(tmp_path / "o"), "--device", "cpu"]) == 1
    assert "no strain genomes listed" in capsys.readouterr().err


# ---- on the card -------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("checkpoint", [False, True], ids=["plain", "checkpoint"])
def test_fused_pipeline_on_card(tmp_path, cuda_dev, checkpoint):
    """run_pipeline with --device cuda (K1, K3, K4 on the card) writes the
    goldens' bytes and the CPU run's, with and without a checkpoint."""
    ck = {"checkpoint_dir": str(tmp_path / "ck")} if checkpoint else {}
    paths, stdout = _fused(tmp_path / "card", device=cuda_dev, **ck)
    _check_single_artifacts(paths, stdout)
    cpu_paths, cpu_stdout = _fused(tmp_path / "cpu")
    assert stdout == cpu_stdout
    for key in ("counts", "scrubbed", "hits"):
        assert _read(paths[key], gz=True) == _read(cpu_paths[key], gz=True)


@pytest.mark.cuda
@pytest.mark.parametrize("checkpoint", [False, True], ids=["plain", "checkpoint"])
def test_fused_multi_pipeline_on_card(tmp_path, cuda_dev, checkpoint):
    """run_multi_pipeline with --device cuda (K1, K3, K6, K7 on the card)
    equals the CPU run per strain, strainA's artifacts the goldens."""
    from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_multi_pipeline

    def run(out_dir, device, **kw):
        stdout = io.StringIO()
        all_paths = run_multi_pipeline(
            TWO_STRAINS, *PANELS, "data/targets.txt", str(out_dir),
            fused_cfg=FusedConfig(min_fraction=0.05, device=device), err=io.StringIO(),
            stdout=stdout, **kw)
        return [{k: _read(p[k], gz=k != "coverage") for k in p} for p in all_paths], stdout.getvalue()

    ck = {"checkpoint_dir": str(tmp_path / "ck")} if checkpoint else {}
    card, card_stdout = run(tmp_path / "card", cuda_dev, **ck)
    cpu, cpu_stdout = run(tmp_path / "cpu", "cpu")
    assert card == cpu and card_stdout == cpu_stdout
    assert card[0]["counts"] == expected("scrub_counts.tsv")
    assert card[0]["scrubbed"] == expected("scrubbed_m05.txt")
    assert card[0]["hits"] == expected("kmer_hits.txt")
