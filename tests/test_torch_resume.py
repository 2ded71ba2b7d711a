"""Checkpoint and resume of the port on the CPU (plain torch versions of the
kernels): twins of the one-process cases of tests/test_resume.py, each
also held against the JAX package's run on the same inputs; the
checkpoint classes pinned to their JAX originals; and count checkpoints
carried between the two packages in both directions."""

import gzip
import inspect
import io
import json
import os
import shutil

import numpy as np
import pytest

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")
SCRUB_ARGS = ("data/strainA.fna.gz", "data/genomes.txt", "data/metagenomes.txt")
DETECT_ARGS = ("data/strainA.fna.gz", "expected/scrubbed_m05.txt")
FIRST_SAMPLE = "data/target_PE1.fasta.gz"
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


class Boom(Exception):
    pass


def _crash_on_call(n, fn, calls):
    """fn, raising Boom on its n-th call (counted in calls["n"])."""
    def wrapper(*a, **kw):
        calls["n"] += 1
        if calls["n"] == n:
            raise Boom()
        return fn(*a, **kw)

    return wrapper


def _refuse_first_sample(fn):
    """A _quantify_sample that fails the test if the first sample is scored."""
    def wrapper(self, f1, *a, **kw):
        assert f1 != FIRST_SAMPLE, f"rescored {f1}"
        return fn(self, f1, *a, **kw)

    return wrapper


def _read_gz(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def expected(name: str) -> bytes:
    with open(os.path.join(MINI, "expected", name), "rb") as f:
        return f.read()


def _scfg():
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig

    return ScrubCountConfig(device="cpu")


def _dcfg():
    from strainer2_tpu_torch.pipeline.detect import DetectConfig

    return DetectConfig(device="cpu")


# ---- pinned copies -----------------------------------------------------------

@pytest.mark.parametrize("name", ["ScrubCheckpoint", "DetectCheckpoint"])
def test_progress_classes_are_copies(name):
    from strainer2_tpu.pipeline import progress as J
    from strainer2_tpu_torch.pipeline import progress as T

    assert inspect.getsource(getattr(T, name)) == inspect.getsource(getattr(J, name))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_files_read_by_the_other_package(tmp_path, writer):
    """A directory either package's classes write reads back the same in
    the other's: counts, done files, keys and payloads."""
    from strainer2_tpu.pipeline import progress as J
    from strainer2_tpu_torch.pipeline import progress as T

    w, r = (J, T) if writer == "jax" else (T, J)
    counts = np.arange(40, dtype=np.uint32) * 7
    sc = w.ScrubCheckpoint(str(tmp_path / "s"), key="k1")
    sc.record(1, "a.fa", counts)
    sc.record(1, "b.fa", counts + 1)
    dc = w.DetectCheckpoint(str(tmp_path / "d"))
    key = w.DetectCheckpoint.sample_key("x.fq", None, 0)
    dc.record(0, key, ["rowsé\n", "", "#x\t1\n"])

    back = r.ScrubCheckpoint(str(tmp_path / "s"), key="k1")
    assert back.done_files(1) == ["a.fa", "b.fa"] and back.done_files(2) == []
    np.testing.assert_array_equal(back.counts(1), counts + 1)
    assert r.ScrubCheckpoint(str(tmp_path / "s"), key="k2").counts(1) is None
    dback = r.DetectCheckpoint(str(tmp_path / "d"))
    assert r.DetectCheckpoint.sample_key("x.fq", None, 0) == key
    assert dback.get(0, key) == ["rowsé\n", "", "#x\t1\n"]
    assert dback.get(0, "other") is None and dback.get(1, key) is None


def test_from_unique_codes_matches_jax():
    from strainer2_tpu.index.build import StrainIndex as JaxIndex
    from strainer2_tpu_torch.index.build import StrainIndex

    rng = np.random.default_rng(5)
    codes = np.unique(rng.integers(0, 1 << 62, size=5000, dtype=np.uint64))
    ours = StrainIndex.from_unique_codes(codes, k=31)
    theirs = JaxIndex.from_unique_codes(codes, k=31, layout="bucket")
    np.testing.assert_array_equal(ours.codes, theirs.codes)
    np.testing.assert_array_equal(ours.genome_counts, theirs.genome_counts)
    assert ours.genome_counts.dtype == theirs.genome_counts.dtype and ours.table_ is None
    np.testing.assert_array_equal(ours.table.table, theirs.table.table)
    np.testing.assert_array_equal(ours.table.slot_of_key, theirs.table.slot_of_key)
    with pytest.raises(ValueError):
        StrainIndex.from_unique_codes(np.empty(0, np.uint64))


# ---- single-strain scrub count and detect ----------------------------------

def test_scrub_resume_bit_identical(tmp_path, monkeypatch):
    from strainer2_tpu.pipeline.scrub_count import run_scrub_count as jax_run
    from strainer2_tpu_torch.pipeline import scrub_count as sc

    ck = str(tmp_path / "ckpt")
    orig = sc.count_panel_file
    monkeypatch.setattr(sc, "count_panel_file", _crash_on_call(2, orig, {"n": 0}))
    with pytest.raises(Boom):
        sc.run_scrub_count(*SCRUB_ARGS, out=io.StringIO(), cfg=_scfg(), checkpoint_dir=ck)
    with open(os.path.join(ck, "manifest.json")) as f:
        done = [p for lst in json.load(f)["done"].values() for p in lst]
    assert done == ["data/panel1.fna.gz"]

    def guard(engine, index, counts, path, *a):
        assert path not in done, f"recounted {path}"
        return orig(engine, index, counts, path, *a)

    monkeypatch.setattr(sc, "count_panel_file", guard)
    out, theirs = io.StringIO(), io.StringIO()
    sc.run_scrub_count(*SCRUB_ARGS, out=out, cfg=_scfg(), checkpoint_dir=ck)
    jax_run(*SCRUB_ARGS, out=theirs)
    assert out.getvalue() == theirs.getvalue()
    assert out.getvalue().encode() == expected("scrub_counts.tsv")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_scrub_checkpoint_carries_across_packages(tmp_path, monkeypatch, writer):
    """A count checkpoint one package's run_scrub_count leaves after a crash
    resumes in the other's to the golden table: both count into the same
    bucket geometry (the JAX run is handed a bucket index, as on a TPU)."""
    from strainer2_tpu.index.build import StrainIndex as JaxIndex
    from strainer2_tpu.pipeline import scrub_count as jsc
    from strainer2_tpu.pipeline.engine import KmerEngine
    from strainer2_tpu_torch.pipeline import scrub_count as tsc

    ck = str(tmp_path / "ckpt")
    jax_index = JaxIndex.from_fasta(SCRUB_ARGS[0], KmerEngine(31, layout="bucket"))
    runs = {
        "jax": (jsc, lambda out: jsc.run_scrub_count(*SCRUB_ARGS, out=out, index=jax_index,
                                                      checkpoint_dir=ck)),
        "torch": (tsc, lambda out: tsc.run_scrub_count(*SCRUB_ARGS, out=out, cfg=_scfg(),
                                                        checkpoint_dir=ck)),
    }
    module, first = runs[writer]
    orig = module.count_panel_file
    monkeypatch.setattr(module, "count_panel_file", _crash_on_call(2, orig, {"n": 0}))
    with pytest.raises(Boom):
        first(io.StringIO())
    assert os.path.exists(os.path.join(ck, "counts_1.npy"))
    monkeypatch.setattr(module, "count_panel_file", orig)
    other, resume = runs["torch" if writer == "jax" else "jax"]
    counted = []
    real = other.count_panel_file

    def recording(engine, index, counts, path, *a):
        counted.append(path)
        return real(engine, index, counts, path, *a)

    monkeypatch.setattr(other, "count_panel_file", recording)
    out = io.StringIO()
    resume(out)
    assert counted == ["data/panel2.fna", "data/scrubmeta1.fasta.gz"]  # panel1 was restored
    assert out.getvalue().encode() == expected("scrub_counts.tsv")


def test_detect_checkpoint_fresh_run_identical(tmp_path):
    """A checkpointed batch run (the staged path) is byte-identical to the
    streaming loop and to the JAX package's checkpointed run, stdout
    warning interleaving included."""
    from strainer2_tpu.pipeline.detect import run_detect as jax_run
    from strainer2_tpu_torch.pipeline.detect import run_detect

    runs = {}
    for name, fn, kw in (("stream", run_detect, dict(cfg=_dcfg())),
                         ("staged", run_detect, dict(cfg=_dcfg(), checkpoint_dir=str(tmp_path / "c"))),
                         ("jax", jax_run, dict(checkpoint_dir=str(tmp_path / "j")))):
        out = io.StringIO()
        fn(*DETECT_ARGS, str(tmp_path / f"{name}.gz"), batch_list="data/targets.txt", stdout=out,
           **kw)
        runs[name] = (_read_gz(tmp_path / f"{name}.gz"), out.getvalue())
    assert runs["staged"] == runs["stream"] == runs["jax"]
    assert runs["staged"][0] == expected("kmer_hits.txt")
    assert sorted(os.listdir(tmp_path / "c")) == sorted(os.listdir(tmp_path / "j"))


def test_detect_resume_bit_identical(tmp_path, monkeypatch):
    """Crash on the second sample of a -B batch; the resumed run replays the
    stored payload, scores only the remaining samples, and the output
    equals an uninterrupted run's (and the JAX package's)."""
    from strainer2_tpu.pipeline.detect import run_detect as jax_run
    from strainer2_tpu_torch.pipeline.detect import StrainDetector, run_detect

    p_ref = str(tmp_path / "ref.gz")
    jax_run(*DETECT_ARGS, p_ref, batch_list="data/targets.txt", stdout=io.StringIO())
    ck = str(tmp_path / "ckpt")
    orig = StrainDetector._quantify_sample
    calls = {"n": 0}
    monkeypatch.setattr(StrainDetector, "_quantify_sample", _crash_on_call(2, orig, calls))
    with pytest.raises(Boom):
        run_detect(*DETECT_ARGS, str(tmp_path / "crash.gz"), batch_list="data/targets.txt",
                   stdout=io.StringIO(), cfg=_dcfg(), checkpoint_dir=ck)
    assert calls["n"] == 2

    monkeypatch.setattr(StrainDetector, "_quantify_sample", _refuse_first_sample(orig))
    p2 = str(tmp_path / "resumed.gz")
    run_detect(*DETECT_ARGS, p2, batch_list="data/targets.txt", stdout=io.StringIO(),
               cfg=_dcfg(), checkpoint_dir=ck)
    assert _read_gz(p2) == _read_gz(p_ref) == expected("kmer_hits.txt")


def test_detect_staged_error_matches_sequential(tmp_path, capsys):
    """The staged path keeps the streaming loop's failure semantics (earlier
    samples' output present, the failing sample's diagnostic printed, exit
    1, later samples and warnings discarded), as the JAX package's staged
    path does; a resume after the input is mended completes to the
    uninterrupted bytes."""
    from strainer2_tpu.pipeline.detect import run_detect as jax_run
    from strainer2_tpu_torch.pipeline.detect import run_detect

    missing = tmp_path / "missing.fa.gz"
    batch = tmp_path / "targets_bad.txt"
    with open("data/targets.txt") as f:
        lines = [ln for ln in f if ln.strip() and not ln.startswith("#")]
    batch.write_text(lines[0] + f"SE\t{missing}\n" + "YY\twhatever\n" + lines[1])

    got = {}
    for name, fn, kw in (("seq", run_detect, dict(cfg=_dcfg())),
                         ("staged", run_detect, dict(cfg=_dcfg(), checkpoint_dir=str(tmp_path / "c"))),
                         ("jax", jax_run, dict(checkpoint_dir=str(tmp_path / "j")))):
        out = io.StringIO()
        with pytest.raises(SystemExit) as exc:
            fn(*DETECT_ARGS, str(tmp_path / f"{name}.gz"), stdout=out, batch_list=str(batch), **kw)
        assert (exc.value.code or 0) == 1
        got[name] = (capsys.readouterr().err, _read_gz(tmp_path / f"{name}.gz"), out.getvalue())
    assert got["staged"] == got["seq"] == got["jax"]
    assert "YY" not in got["staged"][2]

    shutil.copy(lines[1].split("\t")[1].strip(), missing)
    full = str(tmp_path / "full.gz")
    run_detect(*DETECT_ARGS, full, stdout=io.StringIO(), batch_list=str(batch), cfg=_dcfg())
    resumed = str(tmp_path / "resumed.gz")
    run_detect(*DETECT_ARGS, resumed, stdout=io.StringIO(), batch_list=str(batch), cfg=_dcfg(),
               checkpoint_dir=str(tmp_path / "c"))
    assert _read_gz(resumed) == _read_gz(full)


def test_multi_detect_checkpoint_fresh_and_resume(tmp_path):
    """Multi-strain staged detection: a checkpointed run equals the
    streaming run per strain (and the JAX detector's), and a full resume
    replays every sample without scoring one."""
    from strainer2_tpu.pipeline.multi_detect import MultiStrainDetector as JaxMulti
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    strains = [("data/strainA.fna.gz", "expected/scrubbed_m05.txt"),
               ("data/strainA.fna.gz", "expected/scrubbed_m30.txt")]
    paths = lambda tag: [str(tmp_path / f"{tag}_{i}.gz") for i in range(len(strains))]  # noqa: E731
    JaxMulti(strains, stdout=io.StringIO()).quantify_all(paths("jax"), "data/targets.txt")
    MultiStrainDetector(strains, _dcfg(), stdout=io.StringIO()).quantify_all(
        paths("ref"), "data/targets.txt")
    ck = str(tmp_path / "ckpt")
    MultiStrainDetector(strains, _dcfg(), stdout=io.StringIO()).quantify_all(
        paths("ck"), "data/targets.txt", checkpoint_dir=ck)
    det = MultiStrainDetector(strains, _dcfg(), stdout=io.StringIO())
    det._quantify_sample = lambda *a, **kw: (_ for _ in ()).throw(AssertionError("rescored"))
    det.quantify_all(paths("re"), "data/targets.txt", checkpoint_dir=ck)
    for j, r, c, re_ in zip(paths("jax"), paths("ref"), paths("ck"), paths("re")):
        assert _read_gz(c) == _read_gz(r) == _read_gz(re_) == _read_gz(j)


# ---- multi-strain scrub and the fused pipelines ----------------------------

def _multi_scrub(module, r_files, outs, **kw):
    kw = dict(kw, cfg=_scfg()) if module == "torch" else kw
    if module == "torch":
        from strainer2_tpu_torch.pipeline.multi_scrub import run_multi_scrub
    else:
        from strainer2_tpu.pipeline.multi_scrub import run_multi_scrub
    run_multi_scrub(r_files, "data/genomes.txt", "data/metagenomes.txt", None, outs, **kw)


def test_multi_scrub_resume_bit_identical(tmp_path, monkeypatch):
    """Crash the shared union panel scan mid-panel; the resumed run skips
    the recorded file, counts only the rest, and every strain's table
    equals the JAX package's uninterrupted run."""
    from strainer2_tpu_torch.pipeline import progress as prog
    from strainer2_tpu_torch.pipeline import scrub_count as sc

    want = [io.StringIO() for _ in TWO_STRAINS]
    _multi_scrub("jax", TWO_STRAINS, want)
    ck = str(tmp_path / "ckpt")
    orig_record = prog.ScrubCheckpoint.record
    monkeypatch.setattr(prog.ScrubCheckpoint, "record", _crash_on_call(2, orig_record, {"n": 0}))
    with pytest.raises(Boom):
        _multi_scrub("torch", TWO_STRAINS, [io.StringIO() for _ in TWO_STRAINS], checkpoint_dir=ck)
    monkeypatch.setattr(prog.ScrubCheckpoint, "record", orig_record)
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    done = [p for lst in manifest["done"].values() for p in lst]
    assert done and manifest.get("key"), "checkpoint must carry the strain-set key"

    orig = sc.count_panel_file

    def guard(engine, index, counts, path, *a):
        assert path not in done, f"recounted {path}"
        return orig(engine, index, counts, path, *a)

    monkeypatch.setattr(sc, "count_panel_file", guard)
    outs = [io.StringIO() for _ in TWO_STRAINS]
    _multi_scrub("torch", TWO_STRAINS, outs, checkpoint_dir=ck)
    assert [o.getvalue() for o in outs] == [o.getvalue() for o in want]


def test_multi_scrub_checkpoint_stale_strain_set_restarts(tmp_path, capsys):
    """A checkpoint of another strain set is discarded (fresh start), not
    mixed in, as in the JAX package."""
    ck = str(tmp_path / "ckpt")
    _multi_scrub("torch", ["data/drug1.fna.gz"], [io.StringIO()], checkpoint_dir=ck)
    want = [io.StringIO() for _ in TWO_STRAINS]
    _multi_scrub("jax", TWO_STRAINS, want)
    capsys.readouterr()
    outs = [io.StringIO() for _ in TWO_STRAINS]
    _multi_scrub("torch", TWO_STRAINS, outs, checkpoint_dir=ck)
    assert [o.getvalue() for o in outs] == [o.getvalue() for o in want]
    assert "starting fresh" in capsys.readouterr().err


def _mini_multi_pipeline(out_dir, module="torch", m=0.05, **kw):
    if module == "torch":
        from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_multi_pipeline

        cfg = FusedConfig(min_fraction=m, device="cpu")
    else:
        from strainer2_tpu.pipeline.fused import FusedConfig, run_multi_pipeline

        cfg = FusedConfig(min_fraction=m)
    return run_multi_pipeline(
        TWO_STRAINS, "data/genomes.txt", "data/metagenomes.txt", "data/targets.txt",
        str(out_dir), fused_cfg=cfg, err=io.StringIO(), stdout=io.StringIO(), **kw,
    )


def _artifact_payloads(all_paths):
    out = []
    for paths in all_paths:
        for key in ("counts", "scrubbed", "hits"):
            out.append(_read_gz(paths[key]))
        with open(paths["coverage"], "rb") as f:
            out.append(f.read())
    return out


def test_pipeline_multi_resume_scrub_crash(tmp_path, monkeypatch):
    """pipeline-multi killed mid-panel in the shared union scan: the resumed
    run's per-strain artifacts (counts, scrubbed, hits, coverage) equal the
    JAX package's uninterrupted run."""
    from strainer2_tpu_torch.pipeline import progress as prog

    want = _artifact_payloads(_mini_multi_pipeline(tmp_path / "ref", "jax"))
    ck = tmp_path / "ckpt"
    orig_record = prog.ScrubCheckpoint.record
    monkeypatch.setattr(prog.ScrubCheckpoint, "record", _crash_on_call(2, orig_record, {"n": 0}))
    with pytest.raises(Boom):
        _mini_multi_pipeline(tmp_path / "crash", checkpoint_dir=str(ck))
    monkeypatch.setattr(prog.ScrubCheckpoint, "record", orig_record)
    assert (ck / "scrub" / "manifest.json").exists()
    assert _artifact_payloads(_mini_multi_pipeline(tmp_path / "resumed", checkpoint_dir=str(ck))) == want


def test_pipeline_multi_resume_detect_crash(tmp_path, monkeypatch):
    """pipeline-multi killed on the second detection sample: the resumed run
    replays the first sample's per-strain payloads without scoring it, and
    all artifacts equal the JAX package's uninterrupted run."""
    from strainer2_tpu_torch.pipeline.multi_detect import MultiStrainDetector

    want = _artifact_payloads(_mini_multi_pipeline(tmp_path / "ref", "jax"))
    ck = tmp_path / "ckpt"
    orig = MultiStrainDetector._quantify_sample
    calls = {"n": 0}
    monkeypatch.setattr(MultiStrainDetector, "_quantify_sample", _crash_on_call(2, orig, calls))
    with pytest.raises(Boom):
        _mini_multi_pipeline(tmp_path / "crash", checkpoint_dir=str(ck))
    assert calls["n"] == 2
    monkeypatch.setattr(MultiStrainDetector, "_quantify_sample", _refuse_first_sample(orig))
    assert _artifact_payloads(_mini_multi_pipeline(tmp_path / "resumed", checkpoint_dir=str(ck))) == want


def test_pipeline_multi_detect_checkpoint_keyed_to_filter_config(tmp_path):
    """A pipeline-multi detect checkpoint is keyed to the strains and the
    filter outcome: another min_fraction lands in another directory, the
    same names the JAX package gives, and the rerun's artifacts equal a
    fresh run's."""
    from strainer2_tpu_torch.pipeline import fused

    ck = str(tmp_path / "ckpt")
    _mini_multi_pipeline(tmp_path / "a", checkpoint_dir=ck)
    before = {d for d in os.listdir(ck) if d.startswith("detect_")}
    jck = str(tmp_path / "jck")
    _mini_multi_pipeline(tmp_path / "ja", "jax", checkpoint_dir=jck)
    assert before and before == {d for d in os.listdir(jck) if d.startswith("detect_")}

    want = _artifact_payloads(_mini_multi_pipeline(tmp_path / "ref30", "jax", m=0.30))
    assert _artifact_payloads(_mini_multi_pipeline(tmp_path / "b", m=0.30, checkpoint_dir=ck)) == want
    assert {d for d in os.listdir(ck) if d.startswith("detect_")} - before, \
        "another filter config must re-key"
    assert fused.FusedConfig().device == "cuda"


def test_pipeline_fused_single_resume_scrub_and_detect(tmp_path, monkeypatch):
    """The single-strain fused pipeline with a checkpoint: a crash during
    panel counting, a resume that crashes during detection, a resume to the
    end; the artifacts equal the JAX package's uninterrupted run."""
    from strainer2_tpu.pipeline.fused import FusedConfig as JaxCfg
    from strainer2_tpu.pipeline.fused import run_pipeline as jax_run
    from strainer2_tpu_torch.pipeline import progress as prog
    from strainer2_tpu_torch.pipeline.detect import StrainDetector
    from strainer2_tpu_torch.pipeline.fused import FusedConfig, run_pipeline

    def run(out_dir, ck=None):
        return run_pipeline(
            *SCRUB_ARGS, "data/targets.txt", str(out_dir),
            fused_cfg=FusedConfig(min_fraction=0.05, device="cpu"),
            err=io.StringIO(), stdout=io.StringIO(), checkpoint_dir=ck,
        )

    ref = jax_run(*SCRUB_ARGS, "data/targets.txt", str(tmp_path / "ref"),
                  fused_cfg=JaxCfg(min_fraction=0.05), err=io.StringIO(), stdout=io.StringIO())
    want = [_read_gz(ref[k]) for k in ("counts", "scrubbed", "hits")]
    ck = str(tmp_path / "ckpt")
    orig_record = prog.ScrubCheckpoint.record
    monkeypatch.setattr(prog.ScrubCheckpoint, "record", _crash_on_call(2, orig_record, {"n": 0}))
    with pytest.raises(Boom):
        run(tmp_path / "crash1", ck=ck)
    monkeypatch.setattr(prog.ScrubCheckpoint, "record", orig_record)
    assert os.path.exists(os.path.join(ck, "scrub", "manifest.json"))

    orig = StrainDetector._quantify_sample
    monkeypatch.setattr(StrainDetector, "_quantify_sample", _crash_on_call(2, orig, {"n": 0}))
    with pytest.raises(Boom):
        run(tmp_path / "crash2", ck=ck)
    monkeypatch.setattr(StrainDetector, "_quantify_sample", _refuse_first_sample(orig))
    got = run(tmp_path / "resumed", ck=ck)
    assert [_read_gz(got[k]) for k in ("counts", "scrubbed", "hits")] == want
