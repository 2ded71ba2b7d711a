"""The ``--device cpu`` native routes of the port: panel counting by the host
library's fused counter, per-read classification by its fused classifiers
with the read extractor emitting the passing reads, and the ordered sample
pool (the JAX package's CPU routes, strainer2_tpu/pipeline/scrub_count.py,
detect.py, multi_detect.py, multi_scrub.py).

Every case runs on the native route (STRAINER2_NATIVE_COUNT unset) and on
the torch engine's CPU programs (STRAINER2_NATIVE_COUNT=0), and holds the
output to the mini goldens and to the JAX package's own run, byte for
byte; the native route is shown taken by counting the calls of
NativePanelCounter.count_file and of the NativeClassifier streams."""

import contextlib
import gzip
import io
import os
import shutil
import threading

import numpy as np
import pytest

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
DATA = os.path.join(MINI, "data")
K = 31
# small batches for the torch route: the plain kernels work through every
# window of a batch; outputs do not depend on the geometry
ROWS, ROW_LEN = 8, 1024
GEOMETRY = ["--rows", str(ROWS), "--row-len", str(ROW_LEN)]


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


def _gz(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.fixture(autouse=True)
def _chdir(monkeypatch):
    monkeypatch.chdir(MINI)


@pytest.fixture(autouse=True)
def _small_batches(monkeypatch):
    """8 x 1024 batches in the stage configs (the strainer2_tools
    subcommands and the fused runners make their own)."""
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


@pytest.fixture
def calls(monkeypatch):
    """Calls of the port's native counter and classifier streams."""
    from strainer2_tpu_torch import native

    n = {"count_file": 0, "stream": 0}
    lock = threading.Lock()
    for cls, name, key in ((native.NativePanelCounter, "count_file", "count_file"),
                           (native.NativeClassifier, "open_stream", "stream"),
                           (native.NativeClassifier, "open_multi_stream", "stream")):
        def counted(self, *a, _orig=getattr(cls, name), _key=key, **kw):
            with lock:
                n[_key] += 1
            return _orig(self, *a, **kw)

        monkeypatch.setattr(cls, name, counted)
    return n


@pytest.fixture(params=["native", "torch"])
def route(request, monkeypatch):
    from strainer2_tpu_torch import native

    if request.param == "native":
        monkeypatch.delenv("STRAINER2_NATIVE_COUNT", raising=False)
        assert native.available(), native.build_error
    else:
        monkeypatch.setenv("STRAINER2_NATIVE_COUNT", "0")
    return request.param


def _check_route(route, calls, count_file: bool = False, stream: bool = False):
    """The native calls a run made: those named on the native route, none
    on the torch route."""
    if route == "native":
        assert (calls["count_file"] > 0) == count_file, calls
        assert (calls["stream"] > 0) == stream, calls
    else:
        assert calls == {"count_file": 0, "stream": 0}


def _run(main, argv):
    """(exit code, stdout, stderr) of a CLI main run in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


_JAX_RUNS: dict = {}


def _jax(key, fn):
    """A JAX package run, made once a module (its own CPU route)."""
    if key not in _JAX_RUNS:
        saved = os.environ.pop("STRAINER2_NATIVE_COUNT", None)
        try:
            _JAX_RUNS[key] = fn()
        finally:
            if saved is not None:
                os.environ["STRAINER2_NATIVE_COUNT"] = saved
    return _JAX_RUNS[key]


# ---- kmer_scrub_count ----------------------------------------------------------

@pytest.mark.parametrize("c_list,golden", [(None, "scrub_counts.tsv"),
                                           ("data/drugs.txt", "scrub_counts_drug.tsv")],
                         ids=["AB", "ABC"])
def test_scrub_count_cli(route, calls, c_list, golden):
    from strainer2_tpu.cli.kmer_scrub_count import main as jax_main
    from strainer2_tpu_torch.cli.kmer_scrub_count import main

    argv = ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt", "-B", "data/metagenomes.txt"]
    if c_list:
        argv += ["-C", c_list]
    rc, out, _ = _run(main, argv + ["--device", "cpu"] + GEOMETRY)
    assert rc == 0
    assert out.encode() == expected(golden)
    assert out == _jax(("scrub", c_list), lambda: _run(jax_main, argv)[1])
    _check_route(route, calls, count_file=True)


# ---- strain_detect --------------------------------------------------------------

DETECT_CASES = {
    "batch": (["-B", "data/targets.txt"], "kmer_hits.txt", "detect_stdout.txt"),
    "background": (["-B", "data/targets.txt", "-g", "data/background.txt"],
                   "kmer_hits_bg.txt", "detect_bg_stdout.txt"),
    "single_pe": (["-b", "data/target_PE1.fasta.gz", "-c", "data/target_PE2.fasta.gz", "-t", "PE"],
                  "kmer_hits_single.txt", "detect_single_stdout.txt"),
}


def _detect_argv(extra, out_path):
    return ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt", "-o", out_path] + extra


def _jax_detect(tmp_path_factory, key, extra):
    from strainer2_tpu.cli.strain_detect import main as jax_main

    def run():
        hits = str(tmp_path_factory.mktemp("jax_detect") / "hits.gz")
        rc, out, err = _run(jax_main, _detect_argv(extra, hits))
        return rc, out, err, _gz(hits) if os.path.exists(hits) else None

    return _jax(("detect", key), run)


@pytest.mark.parametrize("case", list(DETECT_CASES))
def test_strain_detect_cli(route, calls, tmp_path, tmp_path_factory, case):
    from strainer2_tpu_torch.cli.strain_detect import main

    extra, golden_hits, golden_stdout = DETECT_CASES[case]
    hits = str(tmp_path / "hits.gz")
    rc, out, _ = _run(main, _detect_argv(extra, hits) + ["--device", "cpu"] + GEOMETRY)
    assert rc == 0
    assert _gz(hits) == expected(golden_hits)
    assert out.encode() == expected(golden_stdout)
    j_rc, j_out, _, j_hits = _jax_detect(tmp_path_factory, case, extra)
    assert (rc, out, _gz(hits)) == (j_rc, j_out, j_hits)
    _check_route(route, calls, count_file=case == "background", stream=True)


@pytest.mark.parametrize("threads", ["1", "4"])
def test_sample_pool_threads_give_the_same_bytes(monkeypatch, calls, tmp_path, threads):
    """STRAINER2_DETECT_THREADS=1 scores the samples one after another, 4
    on the pool: the same bytes on every stream, the golden's."""
    from strainer2_tpu_torch.cli.strain_detect import main

    monkeypatch.delenv("STRAINER2_NATIVE_COUNT", raising=False)
    monkeypatch.setenv("STRAINER2_DETECT_THREADS", threads)
    hits = str(tmp_path / "hits.gz")
    rc, out, err = _run(main, _detect_argv(["-B", "data/targets.txt"], hits) + ["--device", "cpu"])
    assert (rc, err) == (0, "")
    assert _gz(hits) == expected("kmer_hits.txt")
    assert out.encode() == expected("detect_stdout.txt")
    assert calls["stream"] == 3


def _failing_targets(d, failure: str) -> str:
    """A batch list whose second sample fails: an unreadable file, a PE2
    file shorter than its PE1, or an interleaved file of an odd number of
    reads; a sample and a malformed line follow it."""
    if failure == "unreadable":
        bad = f"SE\t{d}/missing.fastq"
    elif failure == "pe2_short":
        with gzip.open(os.path.join(DATA, "target_PE2.fasta.gz"), "rt") as f:
            lines = f.read().splitlines(keepends=True)
        with open(d / "short_PE2.fasta", "w") as f:
            f.writelines(lines[: len(lines) // 2 - (len(lines) // 2) % 2])
        bad = f"PE\tdata/target_PE1.fasta.gz\t{d}/short_PE2.fasta"
    else:
        with open(os.path.join(DATA, "target_PEI.fasta")) as f:
            lines = f.read().splitlines(keepends=True)
        with open(d / "odd_PEI.fasta", "w") as f:
            f.writelines(lines[:-2])  # drops the last record of an even count
        bad = f"PEI\t{d}/odd_PEI.fasta"
    path = d / f"targets_{failure}.txt"
    path.write_text("PE\tdata/target_PE1.fasta.gz\tdata/target_PE2.fasta.gz\n"
                    f"{bad}\nSE\tdata/target_SE.fastq\nXX\tdata/target_SE.fastq\n")
    return str(path)


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("failure", ["unreadable", "pe2_short", "odd_interleave"])
def test_error_run_matches_jax(monkeypatch, route, tmp_path, tmp_path_factory, failure, threads):
    """A run whose second sample fails: the first sample's rows, the
    failing sample's partial rows and its diagnostics, nothing after it
    (the later sample and the XX line's message), exit 1: the JAX
    package's run on stdout, stderr, the hits payload and the exit code."""
    from strainer2_tpu_torch.cli.strain_detect import main

    monkeypatch.setenv("STRAINER2_DETECT_THREADS", threads)
    d = tmp_path_factory.getbasetemp() / "failing"
    d.mkdir(exist_ok=True)
    targets = _failing_targets(d, failure)
    hits = str(tmp_path / "hits.gz")
    rc, out, err = _run(main, _detect_argv(["-B", targets], hits) + ["--device", "cpu"] + GEOMETRY)
    got = (rc, out, err, _gz(hits))
    assert rc == 1 and err
    assert "unknown file type" not in out
    assert got == _jax_detect(tmp_path_factory, ("fail", failure), ["-B", targets])


# ---- detect-multi ---------------------------------------------------------------

def _snp_copy(src: str, dst, seed: int) -> None:
    """strainA with a few seeded substitutions (about one base in 150)."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    code = np.zeros(256, np.int64)
    code[alphabet] = np.arange(4)
    with gzip.open(src, "rt") as f:
        lines = f.read().splitlines()
    out = []
    for line in lines:
        if line.startswith(">") or not line:
            out.append(line)
            continue
        b = np.frombuffer(line.encode(), np.uint8).copy()
        at = np.flatnonzero(rng.random(b.size) < 1 / 150)
        b[at] = alphabet[(code[b[at]] + 1 + rng.integers(0, 3, at.size)) % 4]
        out.append(b.tobytes().decode())
    dst.write_text("\n".join(out) + "\n")


@pytest.fixture(scope="module")
def strain_lists(tmp_path_factory):
    """detect-multi strain lists of S = 2, 17 and 33: strainA with its
    golden scrubbed file, drug1, then seeded SNP copies of strainA, each
    with every (3 + i)th of its own k-mers as its -a file."""
    from strainer2_tpu_torch.native import scan_file_codes_native
    from strainer2_tpu_torch.ops.packing_np import decode_codes_np

    d = tmp_path_factory.mktemp("strains")
    genomes = [os.path.join(DATA, "strainA.fna.gz"), os.path.join(DATA, "drug1.fna.gz")]
    for i in range(31):
        p = d / f"copy{i}.fa"
        _snp_copy(genomes[0], p, seed=i)
        genomes.append(str(p))
    rows = [f"{genomes[0]}\t{os.path.join(MINI, 'expected', 'scrubbed_m05.txt')}"]
    for i, g in enumerate(genomes[1:], 1):
        inf = d / f"inf{i}.txt"
        codes = np.unique(scan_file_codes_native(g, K))[:: 3 + i]
        inf.write_text("".join(s + "\n" for s in decode_codes_np(codes, K)))
        rows.append(f"{g}\t{inf}")
    lists = {}
    for n in (2, 17, 33):
        lists[n] = d / f"strains{n}.tsv"
        lists[n].write_text("\n".join(rows[:n]) + "\n")
    return lists


def _stem(path: str) -> str:
    from strainer2_tpu_torch.pipeline.fused import _stem as stem

    return stem(path)


@pytest.mark.parametrize("n_strains", [2, 17, 33])
def test_detect_multi_cli(route, calls, tmp_path, tmp_path_factory, strain_lists, n_strains):
    from strainer2_tpu.cli.strainer2_tools import main as jax_main
    from strainer2_tpu_torch.cli.strainer2_tools import main

    argv = ["detect-multi", "-S", str(strain_lists[n_strains]), "-B", "data/targets.txt",
            "-g", "data/background.txt"]
    rc, out, _ = _run(main, argv + ["-o", str(tmp_path), "--device", "cpu"])
    assert rc == 0

    def jax_run():
        j_dir = tmp_path_factory.mktemp("jax_multi")
        return _run(jax_main, argv + ["-o", str(j_dir)])[:2], j_dir

    (j_rc, j_out), j_dir = _jax(("multi", n_strains), jax_run)
    assert (rc, out) == (j_rc, j_out)
    rows = 0
    with open(strain_lists[n_strains]) as f:
        for line in f:
            name = _stem(line.split("\t")[0]) + ".kmer_hits.gz"
            payload = _gz(tmp_path / name)
            assert payload == _gz(j_dir / name), name
            rows += payload.count(b"\n")
    assert rows > 4 * n_strains * 3
    _check_route(route, calls, count_file=True, stream=True)


def test_detect_multi_strain_a_equals_the_golden(monkeypatch, calls, tmp_path, strain_lists):
    """The first strain of a 33-strain pass (words 2 and up are the native
    classifier's ``extra_words``) writes the single-strain golden."""
    from strainer2_tpu_torch.pipeline.detect import DetectConfig
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    monkeypatch.delenv("STRAINER2_NATIVE_COUNT", raising=False)
    with open(strain_lists[33]) as f:
        strains = [tuple(line.rstrip("\n").split("\t")) for line in f]
    det = MultiStrainDetector(strains, cfg=DetectConfig(device="cpu"), stdout=io.StringIO())
    assert det._native_multi_classifier() is not None
    outs = [str(tmp_path / f"{i}.gz") for i in range(len(strains))]
    det.quantify_all(outs, "data/targets.txt")
    assert _gz(outs[0]) == expected("kmer_hits.txt")
    assert calls["stream"] == 3


# ---- the fused runners ----------------------------------------------------------

def test_pipeline_cli(route, calls, tmp_path):
    from strainer2_tpu_torch.cli.strainer2_tools import main

    rc, _, _ = _run(main, ["pipeline", "-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                           "-B", "data/metagenomes.txt", "-T", "data/targets.txt", "-m", "0.05",
                           "-o", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    for name, golden in (("strainA.scrub_kmer_counts.gz", "scrub_counts.tsv"),
                         ("strainA.scrubbed_kmers.gz", "scrubbed_m05.txt"),
                         ("strainA.kmer_hits.gz", "kmer_hits.txt")):
        assert _gz(tmp_path / name) == expected(golden), name
    _check_route(route, calls, count_file=True, stream=True)


def test_pipeline_multi_cli(route, calls, tmp_path, tmp_path_factory):
    from strainer2_tpu.cli.strainer2_tools import main as jax_main
    from strainer2_tpu_torch.cli.strainer2_tools import main

    r_list = tmp_path_factory.getbasetemp() / "r.txt"
    r_list.write_text("data/strainA.fna.gz\ndata/drug1.fna.gz\n")
    argv = ["pipeline-multi", "-R", str(r_list), "-A", "data/genomes.txt", "-B",
            "data/metagenomes.txt", "-C", "data/drugs.txt", "-T", "data/targets.txt",
            "-m", "0.05"]
    rc, _, _ = _run(main, argv + ["-o", str(tmp_path / "o"), "--device", "cpu"])
    assert rc == 0

    def jax_run():
        j_dir = tmp_path_factory.mktemp("jax_pipeline_multi")
        assert _run(jax_main, argv + ["-o", str(j_dir)])[0] == 0
        return j_dir

    j_dir = _jax("pipeline-multi", jax_run)
    assert _gz(tmp_path / "o" / "strainA.scrub_kmer_counts.gz") == expected("scrub_counts_drug.tsv")
    assert _gz(tmp_path / "o" / "strainA.scrubbed_kmers.gz") == expected("scrubbed_drug_m05.txt")
    for stem in ("strainA", "drug1"):
        for kind in ("scrub_kmer_counts", "scrubbed_kmers", "kmer_hits"):
            name = f"{stem}.{kind}.gz"
            assert _gz(tmp_path / "o" / name) == _gz(j_dir / name), name
    _check_route(route, calls, count_file=True, stream=True)


# ---- --checkpoint resume --------------------------------------------------------

class _Killed(Exception):
    """A run cut short at a chosen file."""


def test_checkpoint_resume(route, calls, monkeypatch, tmp_path):
    """kmer_scrub_count and strain_detect --checkpoint, cut short after
    their first file (a panel genome, a target sample) and run again: the
    second run counts or scores only what the first did not finish, and
    writes the goldens."""
    from strainer2_tpu_torch.cli.kmer_scrub_count import main as scrub_main
    from strainer2_tpu_torch.cli.strain_detect import main as detect_main
    from strainer2_tpu_torch.pipeline import detect, scrub_count

    count_file = scrub_count.count_panel_file
    seen: list = []

    def cut_count(engine, index, counts, path, *a):
        seen.append(path)
        if len(seen) == 2:
            raise _Killed(path)
        return count_file(engine, index, counts, path, *a)

    ck = str(tmp_path / "scrub_ck")
    argv = ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt", "-B", "data/metagenomes.txt",
            "--device", "cpu", "--checkpoint", ck] + GEOMETRY
    with monkeypatch.context() as m:
        m.setattr(scrub_count, "count_panel_file", cut_count)
        with pytest.raises(_Killed):
            _run(scrub_main, argv)
    rc, out, _ = _run(scrub_main, argv)
    assert rc == 0 and out.encode() == expected("scrub_counts.tsv")

    method = ("_quantify_sample_native" if route == "native" else "_quantify_sample")
    quantify = getattr(detect.StrainDetector, method)
    scored: list = []

    def cut_quantify(self, *a):
        f1 = a[1] if route == "native" else a[0]
        scored.append(f1)
        if f1 == "data/target_SE.fastq":
            raise _Killed(f1)
        return quantify(self, *a)

    ck = str(tmp_path / "detect_ck")
    hits = str(tmp_path / "hits.gz")
    argv = _detect_argv(["-B", "data/targets.txt"], hits) + ["--device", "cpu", "--checkpoint",
                                                             ck] + GEOMETRY
    with monkeypatch.context() as m:
        m.setenv("STRAINER2_DETECT_THREADS", "1")
        m.setattr(detect.StrainDetector, method, cut_quantify)
        with pytest.raises(_Killed):
            _run(detect_main, argv)
    assert scored == ["data/target_PE1.fasta.gz", "data/target_SE.fastq"]
    before = calls["stream"]
    rc, out, _ = _run(detect_main, argv)
    assert rc == 0
    assert _gz(hits) == expected("kmer_hits.txt")
    assert out.encode() == expected("detect_stdout.txt")
    if route == "native":
        assert calls["stream"] - before == 2  # the first sample came from the checkpoint
    _check_route(route, calls, count_file=True, stream=True)


# ---- the gate -------------------------------------------------------------------

def test_gate(monkeypatch):
    """The native routes are taken only by the plain engine on the CPU with
    the library built and STRAINER2_NATIVE_COUNT not 0: never on a CUDA
    engine, under a mesh, at 0, or without the library (then the torch
    CPU programs run and still write the goldens)."""
    import torch

    from strainer2_tpu_torch import native
    from strainer2_tpu_torch.parallel.sharding import ShardedPanelEngine
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, StrainDetector
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector
    from strainer2_tpu_torch.pipeline.scrub_count import _use_native_counting

    monkeypatch.delenv("STRAINER2_NATIVE_COUNT", raising=False)
    cpu = TorchKmerEngine(K, device="cpu")
    assert _use_native_counting(cpu)
    card = object.__new__(TorchKmerEngine)  # a CUDA engine, which this host cannot make
    card.__dict__.update(cpu.__dict__, device=torch.device("cuda", 0))
    assert not _use_native_counting(card)
    assert not _use_native_counting(object.__new__(ShardedPanelEngine))

    strain = ("data/strainA.fna.gz", "expected/scrubbed_m05.txt")
    meshed = StrainDetector(*strain, DetectConfig(device="cpu", mesh=(2, 2)), stdout=io.StringIO())
    meshed._finalize_meta()
    assert meshed._native_classifier() is None
    multi = MultiStrainDetector([strain], cfg=DetectConfig(device="cpu", mesh=(1, 2)),
                                stdout=io.StringIO())
    assert multi._native_multi_classifier() is None
    plain = StrainDetector(*strain, DetectConfig(device="cpu"), stdout=io.StringIO())
    plain._finalize_meta()
    assert plain._native_classifier() is not None

    if not torch.cuda.is_available():  # the library built, yet no fallback from a missing card
        from strainer2_tpu_torch.cli.strain_detect import main as detect_main

        rc, _, err = _run(detect_main, _detect_argv(["-B", "data/targets.txt"], "/nonexistent/h.gz")
                          + ["--device", "cuda"])
        assert rc == 1 and "torch.cuda.is_available() is false" in err

    monkeypatch.setenv("STRAINER2_NATIVE_COUNT", "0")
    assert not _use_native_counting(cpu)
    monkeypatch.delenv("STRAINER2_NATIVE_COUNT")
    monkeypatch.setattr(native, "available", lambda: False)
    assert not _use_native_counting(cpu)
    from strainer2_tpu_torch.cli.kmer_scrub_count import main

    rc, out, _ = _run(main, ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt", "-B",
                             "data/metagenomes.txt", "--device", "cpu"] + GEOMETRY)
    assert rc == 0 and out.encode() == expected("scrub_counts.tsv")


def test_stderr_tee_captures_only_the_capturing_thread():
    """_ThreadStderrTee, which the pool puts in sys.stderr for the whole
    process: a worker's writes go to its sample's buffer, every other
    thread's (a prefetch thread, the stage timers) to the real stream."""
    from strainer2_tpu_torch.pipeline.detect import _ThreadStderrTee

    real = io.StringIO()
    tee = _ThreadStderrTee(real)
    bufs = {}

    def worker(name):
        bufs[name] = tee.capture()
        tee.write(f"{name} diag\n")
        tee.flush()
        other = threading.Thread(target=lambda: tee.write(f"{name} helper\n"))
        other.start()
        other.join()
        tee.uncapture()
        tee.write(f"{name} after\n")

    ts = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    tee.write("main\n")
    assert bufs["a"].getvalue() == "a diag\n" and bufs["b"].getvalue() == "b diag\n"
    assert sorted(real.getvalue().splitlines()) == ["a after", "a helper", "b after",
                                                    "b helper", "main"]


# ---- the read extractor and the scanner ------------------------------------------

@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    """Plain and gzip FASTA and FASTQ."""
    d = tmp_path_factory.mktemp("reads")
    fq_gz = d / "target_SE.fastq.gz"
    with open(os.path.join(DATA, "target_SE.fastq"), "rb") as f, gzip.open(fq_gz, "wb") as g:
        shutil.copyfileobj(f, g)
    return {"fasta": os.path.join(DATA, "target_PEI.fasta"),
            "fasta.gz": os.path.join(DATA, "target_PE1.fasta.gz"),
            "fastq": os.path.join(DATA, "target_SE.fastq"), "fastq.gz": str(fq_gz)}


@pytest.mark.parametrize("kind", ["fasta", "fasta.gz", "fastq", "fastq.gz"])
def test_read_extractor_matches_jax(read_files, kind):
    """NativeReadExtractor and scan_file_codes_native against the JAX
    package's: every read, in strides and in full, truncated to a length,
    and the error past the end."""
    from strainer2_tpu import native as j_native
    from strainer2_tpu_torch import native

    path = read_files[kind]
    np.testing.assert_array_equal(native.scan_file_codes_native(path, K),
                                  j_native.scan_file_codes_native(path, K))
    for stride, length in ((1, 1000), (3, 40), (7, 1)):
        ours, theirs = native.NativeReadExtractor(path), j_native.NativeReadExtractor(path)
        o = 0
        while True:
            try:
                want = theirs.read(o, length)
            except OSError:
                with pytest.raises(OSError):
                    ours.read(o, length)
                break
            got = ours.read(o, length)
            assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
            assert got.size <= length
            o += stride
        assert o > 3
        ours.close()
        theirs.close()
    with pytest.raises(OSError):
        native.NativeReadExtractor("/nonexistent/reads.fa")


# ---- ranks ----------------------------------------------------------------------

def test_two_gloo_ranks_on_the_native_route(monkeypatch, tmp_path):
    """kmer_scrub_count and strain_detect (background panel and samples
    split across the ranks) as two gloo ranks on the native route: rank 0
    writes what one process writes, the goldens."""
    from tests._torch_dist_worker import launch

    monkeypatch.delenv("STRAINER2_NATIVE_COUNT", raising=False)
    scrub = tmp_path / "scrub"
    scrub.mkdir()
    launch(scrub, "scrub", {"r": "data/strainA.fna.gz", "a": "data/genomes.txt",
                            "b": "data/metagenomes.txt", "c": "data/drugs.txt"})
    with open(scrub / "table_0.tsv", "rb") as f:
        assert f.read() == expected("scrub_counts_drug.tsv")
    det = tmp_path / "detect"
    det.mkdir()
    launch(det, "detect", {"r": "data/strainA.fna.gz", "scrubbed": "expected/scrubbed_m05.txt",
                           "t": "data/targets.txt", "g": "data/background.txt"})
    assert _gz(det / "hits_0.gz") == expected("kmer_hits_bg.txt")
    with open(det / "detect_stdout_0.txt", "rb") as f:
        assert f.read() == expected("detect_bg_stdout.txt")


# ---- the pools under stress -------------------------------------------------------

def test_pools_under_stress():
    """More workers than cores, a short switch interval: the count pool's
    per-thread buffers add to the sequential counts, its earliest failing
    file is the one raised; the sample pool writes every payload, message
    and worker's stderr in list order and stops at the first failure."""
    import sys
    import time

    from strainer2_tpu_torch.pipeline.detect import _run_sample_pool
    from strainer2_tpu_torch.pipeline.scrub_count import _count_files_parallel

    class Counter:
        def count_file(self, buf, path):
            if path.startswith("bad"):
                raise OSError(f"could not read file {path}")
            i = int(path)
            for _ in range(3):
                buf[i % buf.size] += 1
                time.sleep(0)
            return i

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        paths = [str(i) for i in range(300)]
        counts = np.zeros(17, np.uint32)
        _count_files_parallel(Counter(), counts, paths, 32)
        want = np.zeros(17, np.uint32)
        np.add.at(want, np.arange(300) % 17, 3)
        np.testing.assert_array_equal(counts, want)
        with pytest.raises(OSError, match="bad7"):
            _count_files_parallel(Counter(), np.zeros(17, np.uint32),
                                  paths[:50] + ["bad7"] + paths[50:90] + ["bad3"], 32)

        entries = []
        for i in range(60):
            entries.append(("sample", (i, i % 7 == 3)))
            if i % 5 == 0:
                entries.append(("msg", f"msg {i}\n"))

        def run_one(args, sink):
            i, warn = args
            time.sleep((i * 7919 % 13) * 1e-4)
            sink.write(f"rows {i}\n")
            if warn:
                print(f"warn {i}", file=sys.stderr)
            if i == 45:
                raise SystemExit(1)

        out, payloads, err = io.StringIO(), [], io.StringIO()
        with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
            _run_sample_pool(entries, 24, io.StringIO, run_one, lambda s: s.getvalue(),
                             payloads.append, out)
    finally:
        sys.setswitchinterval(interval)
    assert payloads == [f"rows {i}\n" for i in range(46)]
    assert out.getvalue() == "".join(f"msg {i}\n" for i in range(0, 45, 5))  # none after 45
    assert err.getvalue() == "".join(f"warn {i}\n" for i in range(46) if i % 7 == 3)
