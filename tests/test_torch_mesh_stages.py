"""The port's stages and CLIs with ``--mesh DxI`` on tests/golden/mini, on
the CPU (every shard on the one CPU device): twins of the JAX package's
mesh parity tests (tests/test_parity_mini.py scrub and detect at (4, 2),
tests/test_multi_detect.py 3, 18 and 36 strains at (2, 4), the over-budget
union that runs sharded, the "cannot combine" refusals), the three CLIs at
2x2, and a scrub --checkpoint resumed under a mesh.  Outputs are held
byte for byte to the goldens, to the port's one-device runs and to the JAX
package's mesh runs on its 8 virtual devices."""

import gzip
import io
import json
import os

import numpy as np
import pytest

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
GENOMES = ["data/strainA.fna.gz", "data/panel1.fna.gz", "data/panel2.fna"]
SCRUB_ARGS = ("data/strainA.fna.gz", "data/genomes.txt", "data/metagenomes.txt")


@pytest.fixture(autouse=True)
def _torch_route(monkeypatch):
    """The torch engine's CPU programs, the CPU check of the card route's
    logic (STRAINER2_NATIVE_COUNT=0); the JAX runs keep their own route."""
    from tests._torch_route import torch_route

    torch_route(monkeypatch)


@pytest.fixture(autouse=True)
def _chdir(monkeypatch):
    monkeypatch.chdir(MINI)


@pytest.fixture(autouse=True)
def _small_batches(monkeypatch):
    """8 x 1024 batches for the port's CPU runs, as tests/test_torch_resume.py
    sets them: the plain kernels work through every window of a batch, and
    each of a mesh's shards does; outputs do not depend on the geometry, and
    the JAX runs keep theirs."""
    from dataclasses import dataclass

    from strainer2_tpu_torch.pipeline import detect, scrub_count

    @dataclass
    class SmallScrub(scrub_count.ScrubCountConfig):
        rows: int = 8
        row_len: int = 1024

    @dataclass
    class SmallDetect(detect.DetectConfig):
        rows: int = 8
        row_len: int = 1024

    monkeypatch.setattr(scrub_count, "ScrubCountConfig", SmallScrub)
    monkeypatch.setattr(detect, "DetectConfig", SmallDetect)


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


def _read_gz(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def inf_dir(tmp_path_factory):
    """-a files: every Nth distinct k-mer of a mini genome, as
    tests/test_multi_detect.py's _informative_subset makes them."""
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


def test_scrub_count_mesh_matches_golden_and_jax():
    from strainer2_tpu.pipeline.scrub_count import ScrubCountConfig as JaxCfg
    from strainer2_tpu.pipeline.scrub_count import run_scrub_count as jax_run
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    ours, theirs = io.StringIO(), io.StringIO()
    run_scrub_count(*SCRUB_ARGS, out=ours, cfg=ScrubCountConfig(device="cpu", mesh=(4, 2)))
    jax_run(*SCRUB_ARGS, out=theirs, cfg=JaxCfg(mesh=(4, 2)))
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().encode() == expected("scrub_counts.tsv")


@pytest.mark.parametrize("layout,mesh", [("bucket", (4, 2)), ("cuckoo", (2, 4)),
                                         ("bucket", (1, 8)), ("cuckoo", (1, 8))])
def test_detect_mesh_matches_golden_and_jax(tmp_path, layout, mesh):
    """Bucket K4s at (4, 2) beside the JAX run at (4, 2); the cuckoo K4s at
    (2, 4) (the JAX stage's own layout off the TPU) beside it too; both at
    (1, 8), R over eight shards' scratch."""
    from strainer2_tpu.pipeline.detect import DetectConfig as JaxCfg
    from strainer2_tpu.pipeline.detect import run_detect as jax_run
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

    args = ("data/strainA.fna.gz", "expected/scrubbed_m05.txt")
    ours, theirs = io.StringIO(), io.StringIO()
    det = run_detect(*args, str(tmp_path / "ours.gz"), batch_list="data/targets.txt",
                     cfg=DetectConfig(device="cpu", layout=layout, mesh=mesh), stdout=ours)
    assert det._sharded is not None and det._sharded.layout == layout
    jax_run(*args, str(tmp_path / "jax.gz"), batch_list="data/targets.txt",
            cfg=JaxCfg(mesh=mesh), stdout=theirs)
    assert _read_gz(tmp_path / "ours.gz") == _read_gz(tmp_path / "jax.gz") == expected("kmer_hits.txt")
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().encode() == expected("detect_stdout.txt")


def _strains(inf_dir, n):
    if n == 3:
        return [("data/strainA.fna.gz", "expected/scrubbed_m05.txt"),
                ("data/strainA.fna.gz", "expected/scrubbed_m30.txt"),
                ("data/panel1.fna.gz", inf_dir("data/panel1.fna.gz", 5))]
    return [(GENOMES[i % 3], inf_dir(GENOMES[i % 3], 3 + i)) for i in range(n)]


@pytest.mark.parametrize("n_strains", [3, 18, 36])
def test_multi_mesh_matches_one_device_and_jax(tmp_path, inf_dir, n_strains):
    """K6s, R and K7 over the (2, 4) mesh at 1, 2 and 3 meta words: every
    strain's file equal to the port's one-device pass and to the JAX
    package's pass at (2, 4), and the same stdout."""
    _multi_mesh_case(tmp_path, inf_dir, n_strains, (2, 4))


@pytest.mark.parametrize("mesh", [(4, 2), (1, 8)])
def test_multi_mesh_at_two_and_eight_index_shards(tmp_path, inf_dir, mesh):
    """The same at 2 meta words over I = 2 and I = 8 index shards (R over
    two parts, and over eight)."""
    _multi_mesh_case(tmp_path, inf_dir, 18, mesh)


def _multi_mesh_case(tmp_path, inf_dir, n_strains, mesh):
    from strainer2_tpu.pipeline.detect import DetectConfig as JaxCfg
    from strainer2_tpu.pipeline.multi_detect import MultiStrainDetector as JaxMulti
    from strainer2_tpu_torch.pipeline.detect import DetectConfig
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    strains = _strains(inf_dir, n_strains)
    runs = {}
    for label, make in (
            ("one", lambda out: MultiStrainDetector(strains, cfg=DetectConfig(device="cpu"),
                                                    stdout=out)),
            ("mesh", lambda out: MultiStrainDetector(
                strains, cfg=DetectConfig(device="cpu", mesh=mesh), stdout=out)),
            ("jax", lambda out: JaxMulti(strains, cfg=JaxCfg(mesh=mesh), stdout=out))):
        out = io.StringIO()
        det = make(out)
        paths = [str(tmp_path / f"{label}_{i}.gz") for i in range(n_strains)]
        det.quantify_all(paths, "data/targets.txt")
        runs[label] = ([_read_gz(p) for p in paths], out.getvalue())
        if label == "mesh":
            assert det._sharded is not None and det._sharded.n_index == mesh[1]
    assert runs["mesh"] == runs["one"]
    assert runs["mesh"] == runs["jax"]
    assert sum(b.count(b"\n") for b in runs["mesh"][0]) > 4 * n_strains


def test_over_budget_union_executes_sharded(tmp_path, monkeypatch):
    """A union over one device's budget is refused on one device and runs
    under a (2, 4) mesh (the budget times the 4 index shards), with the
    bytes of an unbudgeted one-device pass."""
    from strainer2_tpu_torch.pipeline.detect import DetectConfig
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector, projected_rows_bytes

    strains = [("data/strainA.fna.gz", "expected/scrubbed_m05.txt"),
               ("data/panel1.fna.gz", "expected/scrubbed_m30.txt")]
    det = MultiStrainDetector(strains, cfg=DetectConfig(device="cpu"), stdout=io.StringIO())
    outs = [str(tmp_path / f"plain_{i}.gz") for i in range(2)]
    det.quantify_all(outs, "data/targets.txt")
    base = [_read_gz(p) for p in outs]
    needed = projected_rows_bytes(det.table.slot_of_key.shape[0], 2)
    monkeypatch.setenv("STRAINER2_DEVICE_MEM_BUDGET", str(needed - 1))
    with pytest.raises(RuntimeError, match="STRAINER2_DEVICE_MEM_BUDGET"):
        MultiStrainDetector(strains, cfg=DetectConfig(device="cpu"), stdout=io.StringIO())
    det_m = MultiStrainDetector(strains, cfg=DetectConfig(device="cpu", mesh=(2, 4)),
                                stdout=io.StringIO())
    assert det_m._sharded is not None
    outs_m = [str(tmp_path / f"mesh_{i}.gz") for i in range(2)]
    det_m.quantify_all(outs_m, "data/targets.txt")
    assert [_read_gz(p) for p in outs_m] == base


def test_over_budget_union_on_one_card_mesh_is_refused(monkeypatch):
    """--device cuda:0 --mesh 1x4 puts every index shard on one card, so the
    union gets that card's budget alone: a union over it is refused before
    any device work (the mesh is built by hand; no card is needed)."""
    import torch

    from strainer2_tpu_torch.parallel import sharding
    from strainer2_tpu_torch.pipeline.detect import DetectConfig
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector, projected_rows_bytes

    strains = [("data/strainA.fna.gz", "expected/scrubbed_m05.txt"),
               ("data/panel1.fna.gz", "expected/scrubbed_m30.txt")]
    det = MultiStrainDetector(strains, cfg=DetectConfig(device="cpu"), stdout=io.StringIO())
    needed = projected_rows_bytes(det.table.slot_of_key.shape[0], 2)
    monkeypatch.setenv("STRAINER2_DEVICE_MEM_BUDGET", str(needed - 1))
    one_card = sharding.Mesh([[torch.device("cuda", 0)] * 4])
    monkeypatch.setattr(sharding, "make_mesh", lambda *a, **kw: one_card)
    with pytest.raises(RuntimeError, match="over the 1x4 mesh"):
        MultiStrainDetector(strains, cfg=DetectConfig(device="cpu", mesh=(1, 4)),
                            stdout=io.StringIO())


@pytest.mark.parametrize("grid, factor", [
    ([["cuda:0"] * 4], 1),                            # --device cuda:0 --mesh 1x4
    ([["cuda:0"] * 2] * 2, 0.5),                      # --device cuda:0 --mesh 2x2
    ([["cuda:0", "cuda:1", "cuda:2", "cuda:3"]], 4),  # --mesh 1x4 on four cards
    ([["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]], 2),
    ([["cpu"] * 4] * 2, 4),                           # XLA's virtual host devices
])
def test_mesh_mem_budget_counts_the_cards(grid, factor):
    import torch

    from strainer2_tpu_torch.parallel.sharding import Mesh
    from strainer2_tpu_torch.pipeline.multi_detect import mesh_mem_budget

    mesh = Mesh([[torch.device(x) for x in row] for row in grid])
    assert mesh_mem_budget(1000, mesh) == int(1000 * factor)
    assert mesh_mem_budget(None, mesh) is None
    assert mesh_mem_budget(1000, None) == 1000


@pytest.mark.parametrize("stage", ["multi", "detect", "scrub"])
def test_mesh_with_multiprocess_refuses(tmp_path, monkeypatch, capsys, stage):
    """--mesh with a multi-process run exits 1 with the JAX stages' "cannot
    combine" (strainer2_tpu/pipeline/scrub_count.py:461-470, detect.py:
    760-769, multi_detect.py:710-732), before any device work."""
    from strainer2_tpu_torch.pipeline import detect, multi_detect, scrub_count

    if stage == "scrub":
        monkeypatch.setattr(scrub_count, "initialize", lambda *a, **kw: (0, 2))
        call = lambda: scrub_count.run_scrub_count(  # noqa: E731
            *SCRUB_ARGS, out=io.StringIO(),
            cfg=scrub_count.ScrubCountConfig(device="cpu", mesh=(1, 8)))
    elif stage == "detect":
        det = detect.StrainDetector("data/strainA.fna.gz", "expected/scrubbed_m05.txt",
                                    detect.DetectConfig(device="cpu", mesh=(2, 4)),
                                    stdout=io.StringIO())
        monkeypatch.setattr(detect, "process_count", lambda: 2)
        call = lambda: det.quantify_all(str(tmp_path / "h.gz"), "data/targets.txt")  # noqa: E731
    else:
        det = multi_detect.MultiStrainDetector(
            [("data/strainA.fna.gz", "expected/scrubbed_m05.txt")],
            detect.DetectConfig(device="cpu", mesh=(2, 4)), stdout=io.StringIO())
        monkeypatch.setattr(multi_detect, "process_count", lambda: 2)
        call = lambda: det.quantify_all([str(tmp_path / "h.gz")], "data/targets.txt")  # noqa: E731
    with pytest.raises(SystemExit) as e:
        call()
    assert e.value.code == 1
    assert "cannot combine" in capsys.readouterr().err
    assert not (tmp_path / "h.gz").exists()


def _cli(module: str, argv: list[str], stdout_path: str) -> int:
    import contextlib
    import importlib

    main = importlib.import_module(f"strainer2_tpu_torch.cli.{module}").main
    with open(stdout_path, "w") as f, contextlib.redirect_stdout(f):
        return main(argv)


def test_clis_with_mesh_2x2(tmp_path):
    """kmer_scrub_count, strain_detect and strainer2_tools detect-multi with
    --mesh 2x2 on the CPU: the goldens."""
    t = lambda name: str(tmp_path / name)  # noqa: E731
    dev = ["--device", "cpu", "--mesh", "2x2"]
    assert _cli("kmer_scrub_count", ["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                                     "-B", "data/metagenomes.txt", *dev], t("counts.tsv")) == 0
    with open(t("counts.tsv"), "rb") as f:
        assert f.read() == expected("scrub_counts.tsv")
    assert _cli("strain_detect", ["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt",
                                  "-B", "data/targets.txt", "-o", t("hits.gz"), *dev],
                t("detect.txt")) == 0
    assert _read_gz(t("hits.gz")) == expected("kmer_hits.txt")
    with open(t("detect.txt"), "rb") as f:
        assert f.read() == expected("detect_stdout.txt")
    with open(t("strains.tsv"), "w") as f:
        f.write("data/strainA.fna.gz\texpected/scrubbed_m05.txt\n")
    assert _cli("strainer2_tools", ["detect-multi", "-S", t("strains.tsv"), "-B",
                                    "data/targets.txt", "-o", t("multi"), *dev],
                t("multi.txt")) == 0
    assert _read_gz(os.path.join(t("multi"), "strainA.kmer_hits.gz")) == expected("kmer_hits.txt")


def test_cli_mesh_on_a_bare_cuda_without_cards_exits_1(capsys):
    """--mesh on the default --device cuda where no card is: exit 1 with the
    device error, never a quiet run on the CPU."""
    from strainer2_tpu_torch.cli.strain_detect import main

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["-r", "data/strainA.fna.gz", "-a", "expected/scrubbed_m05.txt", "-B",
                 "data/targets.txt", "-o", "/dev/null", "--mesh", "2x2"]) == 1
    assert "is_available() is false" in capsys.readouterr().err


class Boom(Exception):
    pass


def test_scrub_checkpoint_resumed_under_a_mesh(tmp_path, monkeypatch):
    """A scrub counted over a (2, 2) mesh with --checkpoint, killed after its
    first panel file, resumes over a (1, 4) mesh without counting that file
    again: the golden table (the checkpoint holds merged counts, whatever
    the mesh)."""
    from strainer2_tpu_torch.pipeline import scrub_count as sc

    ck = str(tmp_path / "ckpt")
    orig = sc.count_panel_file
    calls = {"n": 0}

    def crash_second(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise Boom()
        return orig(*a, **kw)

    monkeypatch.setattr(sc, "count_panel_file", crash_second)
    with pytest.raises(Boom):
        sc.run_scrub_count(*SCRUB_ARGS, out=io.StringIO(),
                           cfg=sc.ScrubCountConfig(device="cpu", mesh=(2, 2)), checkpoint_dir=ck)
    with open(os.path.join(ck, "manifest.json")) as f:
        done = [p for lst in json.load(f)["done"].values() for p in lst]
    assert done == ["data/panel1.fna.gz"]

    def guard(engine, index, counts, path, *a):
        assert path not in done, f"recounted {path}"
        return orig(engine, index, counts, path, *a)

    monkeypatch.setattr(sc, "count_panel_file", guard)
    out = io.StringIO()
    sc.run_scrub_count(*SCRUB_ARGS, out=out, cfg=sc.ScrubCountConfig(device="cpu", mesh=(1, 4)),
                       checkpoint_dir=ck)
    assert out.getvalue().encode() == expected("scrub_counts.tsv")
