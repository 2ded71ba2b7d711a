"""The port's multi-strain detection (detect-multi) on the CPU, mirroring
tests/test_multi_detect.py on tests/golden/mini: per-strain outputs and
stdout byte-identical to the JAX package's MultiStrainDetector and to the
port's single-strain runs; the CLI through its pass planner, a forced
two-pass split and the device-memory errors; the planner
functions and the pass gate pinned to their JAX originals."""

import contextlib
import gzip
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
GENOMES = ["data/strainA.fna.gz", "data/panel1.fna.gz", "data/panel2.fna"]


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


@pytest.fixture(autouse=True)
def _chdir(monkeypatch):
    monkeypatch.chdir(MINI)


@pytest.fixture(scope="module")
def inf_dir(tmp_path_factory):
    """Scrubbed-k-mer (-a) files: every Nth distinct k-mer of a genome,
    scanned with the port (file name -> path, made once per module)."""
    from strainer2_tpu_torch.index.build import scan_file_codes
    from strainer2_tpu_torch.ops.packing_np import decode_codes_np
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    d = tmp_path_factory.mktemp("informative")
    eng = TorchKmerEngine(31, device="cpu")
    codes = {g: np.unique(scan_file_codes(os.path.join(MINI, g), eng)) for g in GENOMES}

    def make(genome: str, every: int) -> str:
        p = d / f"{os.path.basename(genome)}.{every}.txt"
        if not p.exists():
            p.write_text("".join(s + "\n" for s in decode_codes_np(codes[genome][::every], 31)))
        return str(p)

    return make


def _three(inf_dir):
    return [("data/strainA.fna.gz", "expected/scrubbed_m05.txt"),
            ("data/strainA.fna.gz", "expected/scrubbed_m30.txt"),
            ("data/panel1.fna.gz", inf_dir("data/panel1.fna.gz", 5))]


def _twenty(inf_dir):
    """20 strains: strains 16-19 ride the second meta word."""
    return [(GENOMES[i % 3], inf_dir(GENOMES[i % 3], 3 + i)) for i in range(20)]


def _read(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def _torch_cfg():
    from strainer2_tpu_torch.pipeline.detect import DetectConfig

    return DetectConfig(device="cpu")


@pytest.mark.parametrize("which,background", [("three", None), ("twenty", None),
                                              ("three", "data/background.txt")],
                         ids=["3_strains", "20_strains", "3_strains_background"])
def test_multi_matches_jax_and_single_runs(tmp_path, inf_dir, which, background):
    from strainer2_tpu.pipeline.multi_detect import MultiStrainDetector as JaxMulti
    from strainer2_tpu_torch.pipeline.detect import run_detect
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    strains = _three(inf_dir) if which == "three" else _twenty(inf_dir)
    out = io.StringIO()
    det = MultiStrainDetector(strains, cfg=_torch_cfg(), stdout=out, background_list=background)
    assert det._rows_dev.shape[1] == 32 + 16 * max(2, -(-len(strains) // 16))
    ours = [str(tmp_path / f"t{i}.gz") for i in range(len(strains))]
    det.quantify_all(ours, "data/targets.txt")

    j_out = io.StringIO()
    jdet = JaxMulti(strains, stdout=j_out, background_list=background)
    theirs = [str(tmp_path / f"j{i}.gz") for i in range(len(strains))]
    jdet.quantify_all(theirs, "data/targets.txt")
    assert out.getvalue() == j_out.getvalue()

    for i, (r, a) in enumerate(strains):
        single = str(tmp_path / f"s{i}.gz")
        run_detect(r, a, single, batch_list="data/targets.txt", background_list=background,
                   cfg=_torch_cfg(), stdout=io.StringIO())
        payload = _read(ours[i])
        assert payload == _read(theirs[i]), f"strain {i} differs from the JAX detector"
        assert payload == _read(single), f"strain {i} differs from its single run"
    assert any(b"\t" in _read(p) for p in ours)


@pytest.mark.parametrize("prebuilt", [False, True], ids=["own_indexes", "planner_indexes"])
def test_multi_paths_never_build_per_strain_tables(inf_dir, monkeypatch, prebuilt):
    """The port's twin of tests/test_multi_scrub.py's rule: building a
    MultiStrainDetector leaves every strain index table-less (the -a file's
    k-mers are marked by a host search; lookups go through the union table),
    whether the detector builds the indexes or takes the planner's."""
    from strainer2_tpu_torch.index import build
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    strains = _three(inf_dir)
    made: list = []
    built: list = []
    from_fasta = StrainIndex.from_fasta.__func__

    def recording(cls, *args, **kw):
        made.append(from_fasta(cls, *args, **kw))
        return made[-1]

    def build_table(codes, *args, **kw):
        built.append(codes.size)
        return build_bucket_table(codes, *args, **kw)

    build_bucket_table = build.build_bucket_table
    monkeypatch.setattr(StrainIndex, "from_fasta", classmethod(recording))
    monkeypatch.setattr(build, "build_bucket_table", build_table)
    indexes = None
    if prebuilt:
        eng = TorchKmerEngine(31, device="cpu")
        indexes = [StrainIndex.from_fasta(r, eng) for r, _ in strains]
    det = MultiStrainDetector(strains, cfg=_torch_cfg(), stdout=io.StringIO(), indexes=indexes)
    assert len(det.states) == len(strains) == len(made) and built == []
    for ix in made:
        assert ix.table_ is None, "per-strain table was built needlessly"


def _tools(argv):
    from strainer2_tpu_torch.cli.strainer2_tools import main

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def _strain_list(tmp_path, strains) -> str:
    p = tmp_path / "strains.tsv"
    p.write_text("# genome\tscrubbed\n" + "".join(f"{r}\t{a}\n" for r, a in strains))
    return str(p)


def _cli_strains(inf_dir):
    return [("data/strainA.fna.gz", "expected/scrubbed_m05.txt"),
            ("data/panel1.fna.gz", inf_dir("data/panel1.fna.gz", 5)),
            ("data/panel2.fna", inf_dir("data/panel2.fna", 4))]


def test_detect_multi_cli_through_planner(tmp_path, inf_dir):
    """The CLI end to end against the JAX CLI on the same strain list."""
    from strainer2_tpu.cli.strainer2_tools import main as jax_main
    from strainer2_tpu.pipeline.fused import _stem as jax_stem

    slist = _strain_list(tmp_path, _cli_strains(inf_dir))
    assert _tools(["detect-multi", "-S", slist, "-B", "data/targets.txt",
                   "-o", str(tmp_path / "ours"), "--device", "cpu"]) == 0
    with contextlib.redirect_stdout(io.StringIO()):
        jax_main(["detect-multi", "-S", slist, "-B", "data/targets.txt", "-o", str(tmp_path / "jax")])
    for r, _ in _cli_strains(inf_dir):
        name = jax_stem(r) + ".kmer_hits.gz"
        assert _read(tmp_path / "ours" / name) == _read(tmp_path / "jax" / name), r


def test_detect_multi_forced_split_is_byte_identical(tmp_path, inf_dir, monkeypatch):
    """A budget of the largest single strain's projection splits the three
    strains into several passes without changing a byte."""
    from strainer2_tpu_torch.index.build import scan_file_codes
    from strainer2_tpu_torch.pipeline import multi_detect as md
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    strains = _cli_strains(inf_dir)
    slist = _strain_list(tmp_path, strains)
    argv = ["detect-multi", "-S", slist, "-B", "data/targets.txt", "--device", "cpu"]
    assert _tools(argv + ["-o", str(tmp_path / "one")]) == 0

    eng = TorchKmerEngine(31, device="cpu")
    codes = [np.unique(scan_file_codes(r, eng)) for r, _ in strains]
    budget = max(md.projected_rows_bytes(c.size, 1) for c in codes)
    assert len(md.plan_strain_passes_from_codes(codes, budget=budget)) > 1
    passes = []
    real = md.MultiStrainDetector

    def counting(chunk, **kw):
        passes.append(len(chunk))
        return real(chunk, **kw)

    monkeypatch.setattr(md, "MultiStrainDetector", counting)
    monkeypatch.setenv("STRAINER2_DEVICE_MEM_BUDGET", str(budget))
    assert _tools(argv + ["-o", str(tmp_path / "split")]) == 0
    assert len(passes) > 1 and sum(passes) == len(strains)
    for name in sorted(os.listdir(tmp_path / "one")):
        assert _read(tmp_path / "split" / name) == _read(tmp_path / "one" / name), name


def test_detector_is_freed_without_the_cycle_collector(inf_dir):
    """A pass's detector (and the union rows it holds on the device) goes
    when its last reference does, not when the cycle collector next runs:
    pipeline-multi and detect-multi drop one pass's detector before the
    next uploads its rows."""
    import gc
    import weakref

    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    gc.disable()
    try:
        det = MultiStrainDetector(_three(inf_dir), cfg=_torch_cfg(), stdout=io.StringIO())
        det.quantify_all([os.devnull] * 3, "data/targets.txt")
        rows = weakref.ref(det._rows_dev)
        del det
        assert rows() is None, "the union rows outlived their detector"
    finally:
        gc.enable()


def test_union_over_budget_fails_loudly(monkeypatch):
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    monkeypatch.setenv("STRAINER2_DEVICE_MEM_BUDGET", "4096")
    with pytest.raises(RuntimeError, match="STRAINER2_DEVICE_MEM_BUDGET"):
        MultiStrainDetector([("data/strainA.fna.gz", "expected/scrubbed_m05.txt")], cfg=_torch_cfg())


def test_post_build_budget_recheck_catches_grown_table(monkeypatch):
    """build_bucket_table grows h_bits on a bucket overflow: the built table
    is checked against the budget again."""
    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.pipeline import multi_detect as md
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    real = md.build_bucket_table

    def grown(codes, k, h_bits=None, row_width=64):
        n = np.asarray(codes).shape[0]
        return real(codes, k, h_bits=max(4, int(np.ceil(np.log2(max(n, 1) / 3.3)))) + 2,
                    row_width=row_width)

    monkeypatch.setattr(md, "build_bucket_table", grown)
    idx = StrainIndex.from_fasta("data/strainA.fna.gz", TorchKmerEngine(31, device="cpu"), 256, 256)
    monkeypatch.setenv("STRAINER2_DEVICE_MEM_BUDGET", str(md.projected_rows_bytes(idx.num_kmers, 1)))
    with pytest.raises(RuntimeError, match="BUILT"):
        md.MultiStrainDetector([("data/strainA.fna.gz", "expected/scrubbed_m05.txt")], cfg=_torch_cfg())


def _outcome(main, argv, capsys):
    """(exit code, or the exception's type and text; stderr) of main(argv)."""
    try:
        rc = main(argv)
    except (Exception, SystemExit) as e:  # noqa: BLE001 - the outcome is compared, not handled
        rc = (type(e).__name__, str(e))
    return rc, capsys.readouterr().err


@pytest.mark.parametrize("argv", [["pangenome", "-A", "x"], ["kmer-matrix", "-A", "x"],
                                  ["strain-track", "-A", "x", "-b", "y"]],
                         ids=lambda a: a[0])
def test_library_modes_on_a_missing_list_end_as_jax(tmp_path, monkeypatch, capsys, argv):
    """The library modes on a missing -A list end as the JAX CLI's do."""
    from strainer2_tpu.cli.strainer2_tools import main as jax_main

    monkeypatch.chdir(tmp_path)
    want = _outcome(jax_main, argv, capsys)
    assert _outcome(_tools, argv + ["--device", "cpu"], capsys) == want
    assert want[0] == ("FileNotFoundError", "[Errno 2] No such file or directory: 'x'")


def test_detect_multi_cuda_without_card_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _tools(["detect-multi", "-S", "x", "-B", "x", "-o", str(tmp_path)]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


# ---- pinned copies ---------------------------------------------------------

def test_planners_match_jax():
    from strainer2_tpu.pipeline import multi_detect as J
    from strainer2_tpu_torch.pipeline import multi_detect as T

    for keys, s in [(6_700_000, 2), (6_700_000, 33), (6_700_000, 256), (1, 1), (20_000_000, 32)]:
        assert T.projected_rows_bytes(keys, s) == J.projected_rows_bytes(keys, s)
    b = T.projected_rows_bytes(2 * 6_700_000, 2)
    for counts, kw in [([6_700_000] * 8, dict(budget=None)), ([6_700_000] * 8, dict(budget=b)),
                       ([6_700_000] * 8, dict(budget=b, index_shards=4)),
                       ([10**9], dict(budget=1024)), ([1] * 300, dict(budget=None))]:
        assert T.plan_strain_passes(counts, **kw) == J.plan_strain_passes(counts, **kw)
    rng = np.random.default_rng(3)
    base = np.unique(rng.integers(0, 1 << 60, size=20_000, dtype=np.uint64))
    sets = [np.unique(np.concatenate([base[rng.random(base.size) > 0.01],
                                      rng.integers(0, 1 << 60, size=300, dtype=np.uint64)]))
            for _ in range(4)]
    sets += [np.unique(rng.integers(0, 1 << 60, size=20_000, dtype=np.uint64)) for _ in range(3)]
    for budget in (None, T.projected_rows_bytes(25_000, 4), T.projected_rows_bytes(40_000, 2)):
        assert (T.plan_strain_passes_from_codes(sets, budget=budget)
                == J.plan_strain_passes_from_codes(sets, budget=budget))
    union = None
    for s in sets:
        union = T.union_sorted(union, np.sort(s))
    want = np.unique(np.concatenate(sets))
    np.testing.assert_array_equal(union, want)
    for threads in (1, 3):
        np.testing.assert_array_equal(T.union_sorted_many([np.sort(s) for s in sets], threads), want)
    np.testing.assert_array_equal(T.union_sorted_many([np.sort(sets[0])]), np.sort(sets[0]))
    assert T.union_sorted_many([]).size == 0


def test_estimate_genome_kmers_matches_jax(tmp_path):
    from strainer2_tpu.pipeline.multi_detect import estimate_genome_kmers as jax_estimate
    from strainer2_tpu_torch.pipeline.multi_detect import estimate_genome_kmers

    body = b">g\n" + b"ACGT" * 5000 + b"\n"
    gz = gzip.compress(body)
    files = {"g.fa": body, "g.fa.gz": gz, "m.fa.gz": gz + gzip.compress(b">h\nACAC\n"),
             "b.fa.gz": gz + gzip.compress(b""), "p.fa.gz": gz + b"\0" * 64,
             "t.fa.gz": gz[: len(gz) // 2]}
    for name, blob in files.items():
        (tmp_path / name).write_bytes(blob)
        assert estimate_genome_kmers(str(tmp_path / name)) == jax_estimate(str(tmp_path / name)), name
    for name in ("data/strainA.fna.gz", "data/panel2.fna"):
        assert estimate_genome_kmers(name) == jax_estimate(name)


def test_device_mem_budget(monkeypatch):
    from strainer2_tpu_torch.pipeline.multi_detect import device_mem_budget

    monkeypatch.delenv("STRAINER2_DEVICE_MEM_BUDGET", raising=False)
    assert device_mem_budget("cpu") is None
    monkeypatch.setenv("STRAINER2_DEVICE_MEM_BUDGET", "2e9")
    assert device_mem_budget("cpu") == 2_000_000_000


def test_stem_and_strain_threads_match_jax(monkeypatch):
    from strainer2_tpu.pipeline.fused import _stem as jax_stem
    from strainer2_tpu.pipeline.multi_scrub import strain_threads as jax_threads
    from strainer2_tpu_torch.pipeline.detect import strain_threads
    from strainer2_tpu_torch.pipeline.fused import _stem

    for p in ("data/strainA.fna.gz", "x/y.fasta", "a.fa.gz", "b.fna", "c.fq.gz", "d.fasta.gz.bak"):
        assert _stem(p) == jax_stem(p)
    for env in (None, "1", "5"):
        if env is None:
            monkeypatch.delenv("STRAINER2_STRAIN_THREADS", raising=False)
        else:
            monkeypatch.setenv("STRAINER2_STRAIN_THREADS", env)
        for n in (1, 3, 40):
            assert strain_threads(n) == jax_threads(n)


@pytest.mark.parametrize("paired", [False, True])
def test_pass_gate_matches_jax(paired):
    from strainer2_tpu.pipeline.multi_detect import _gather_passing_rows, _passing_any_pairs
    from strainer2_tpu_torch.pipeline.multi_detect import gather_passing_rows, passing_any_pairs

    rng = np.random.default_rng(int(paired))
    tot = rng.integers(0, 3, size=(64, 20)).astype(np.int32)
    inf = (rng.random((64, 20)) < 0.05).astype(np.int32)
    anyp = passing_any_pairs(torch.from_numpy(tot), torch.from_numpy(inf), paired=paired,
                             min_t=2, min_i=1).numpy()
    ref = np.asarray(_passing_any_pairs(jnp.asarray(tot), jnp.asarray(inf), paired=paired,
                                        min_t=2, min_i=1))
    np.testing.assert_array_equal(anyp, ref)
    sel = np.flatnonzero(anyp)
    assert 0 < sel.size < anyp.size
    got = gather_passing_rows(torch.from_numpy(tot), torch.from_numpy(inf), torch.from_numpy(sel),
                              paired=paired)
    want = _gather_passing_rows(jnp.asarray(tot), jnp.asarray(inf), jnp.asarray(sel.astype(np.int32)),
                                paired=paired)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
