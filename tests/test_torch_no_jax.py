"""strainer2_tpu_torch imports neither jax nor the JAX package
(strainer2_tpu), directly or through the modules it uses: a fresh
interpreter with both blocked imports each module of the package, runs one
CPU count step, and runs kmer_scrub_count on the mini data to its golden
bytes; another imports the multi-strain modules and runs detect-multi and
the lookup A/B tool on the CPU; a third runs pipeline-multi (shared panel
scan, filters, multi-strain detection, coverage) to the goldens of
strainA; a fourth runs genome_compare (the string engine and the plain
K8/K9 path) and strain-track to their goldens; a fifth builds a cuckoo
index (index/cuckoo.py) and runs strain_detect in the cuckoo layout to
its golden.  With the JAX package unimportable, no
code of it (its native/ build step included) can write under
strainer2_tpu/."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = textwrap.dedent(
    """
    import contextlib, importlib, io, os, pkgutil, sys

    def blocked(name):
        return (name in ("jax", "strainer2_tpu")
                or name.startswith(("jax.", "jaxlib", "strainer2_tpu.")))

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")

    sys.meta_path.insert(0, BlockJax())
    """
)

_SCRIPT = _BLOCK + textwrap.dedent(
    """
    import numpy as np
    import strainer2_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(strainer2_tpu_torch.__path__, "strainer2_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    from strainer2_tpu_torch.index.build import StrainIndex
    from strainer2_tpu_torch.io.batches import pack_stream
    from strainer2_tpu_torch.io.fastx import read_fastx
    from strainer2_tpu_torch.pipeline.engine import TorchKmerEngine

    mini = os.path.join(sys.argv[1], "tests", "golden", "mini")
    os.chdir(mini)
    eng = TorchKmerEngine(31, device="cpu")
    idx = StrainIndex.from_fasta("data/strainA.fna.gz", eng)
    t = idx.table
    batch = next(pack_stream((r.seq for r in read_fastx("data/panel2.fna")), 31, 8, 512))
    counts = eng.count_batch(eng.init_counts(idx), eng.table_for(idx), t.h_bits, t.salt, batch.bases)
    assert eng.finalize_counts(counts).sum() > 0

    from strainer2_tpu_torch.cli.kmer_scrub_count import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["-r", "data/strainA.fna.gz", "-A", "data/genomes.txt",
                     "-B", "data/metagenomes.txt", "--device", "cpu"]) == 0
    with open("expected/scrub_counts.tsv") as f:
        assert out.getvalue() == f.read()
    assert not [m for m in sys.modules if blocked(m)]
    print("modules", len(names))
    """
)


_MULTI_SCRIPT = _BLOCK + textwrap.dedent(
    """
    import gzip
    for name in ("ops.segsum", "pipeline.multi_detect", "tools.bench_lookup", "cli.strainer2_tools"):
        importlib.import_module("strainer2_tpu_torch." + name)

    from strainer2_tpu_torch.cli.strainer2_tools import main
    from strainer2_tpu_torch.tools.bench_lookup import bench

    mini = os.path.join(sys.argv[1], "tests", "golden", "mini")
    out_dir = sys.argv[2]
    os.chdir(mini)
    with open(os.path.join(out_dir, "strains.tsv"), "w") as f:
        f.write("data/strainA.fna.gz\\texpected/scrubbed_m05.txt\\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["detect-multi", "-S", os.path.join(out_dir, "strains.tsv"),
                     "-B", "data/targets.txt", "-o", out_dir, "--device", "cpu"]) == 0
        assert bench(["--device", "cpu", "--kmers", "2000", "--queries", "512",
                      "--variants", "k2,ring8x4"])["ok"]
    with gzip.open(os.path.join(out_dir, "strainA.kmer_hits.gz"), "rb") as f:
        hits = f.read()
    with open("expected/kmer_hits.txt", "rb") as g:
        assert hits == g.read()
    assert not [m for m in sys.modules if blocked(m)]
    print("ok")
    """
)


_PIPELINE_MULTI_SCRIPT = _BLOCK + textwrap.dedent(
    """
    import gzip
    from strainer2_tpu_torch.cli.strainer2_tools import main

    mini = os.path.join(sys.argv[1], "tests", "golden", "mini")
    out_dir = sys.argv[2]
    os.chdir(mini)
    r_list = os.path.join(out_dir, "r.txt")
    with open(r_list, "w") as f:
        f.write("data/strainA.fna.gz\\ndata/drug1.fna.gz\\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert main(["pipeline-multi", "-R", r_list, "-A", "data/genomes.txt",
                     "-B", "data/metagenomes.txt", "-T", "data/targets.txt", "-m", "0.05",
                     "-o", os.path.join(out_dir, "o"), "--checkpoint",
                     os.path.join(out_dir, "ck"), "--device", "cpu"]) == 0
    for name, golden in (("strainA.scrub_kmer_counts.gz", "scrub_counts.tsv"),
                         ("strainA.scrubbed_kmers.gz", "scrubbed_m05.txt"),
                         ("strainA.kmer_hits.gz", "kmer_hits.txt")):
        with gzip.open(os.path.join(out_dir, "o", name), "rb") as f:
            with open(os.path.join("expected", golden), "rb") as g:
                assert f.read() == g.read(), name
    assert os.path.exists(os.path.join(out_dir, "o", "drug1.coverage_depth"))
    assert not [m for m in sys.modules if blocked(m)]
    print("ok")
    """
)


_COMPARE_SCRIPT = _BLOCK + textwrap.dedent(
    """
    import shutil
    from strainer2_tpu_torch.cli.genome_compare import main as compare_main
    from strainer2_tpu_torch.cli.strainer2_tools import main as tools_main

    mini = os.path.join(sys.argv[1], "tests", "golden", "mini")
    out_dir = sys.argv[2]
    os.chdir(mini)
    for native in ("1", "0"):
        os.environ["STRAINER2_NATIVE_COMPARE"] = native
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert compare_main(["-a", "data/strainA.fna.gz", "-B", "data/compare_list.txt",
                                 "-r", "300", "-t", "0.5", "--device", "cpu"]) == 0
        with open("expected/gc_rapid.txt") as f:
            assert out.getvalue() == f.read(), native
    for name in ("strainA.fna.gz", "drug1.fna.gz", "scrubmeta1.fasta.gz"):
        shutil.copy(os.path.join("data", name), out_dir)
    os.chdir(out_dir)
    with open("strains2.txt", "w") as f:
        f.write("strainA.fna.gz\\ndrug1.fna.gz\\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert tools_main(["strain-track", "-A", "strains2.txt", "-b", "scrubmeta1.fasta.gz",
                           "-n", "-m", "60", "--device", "cpu"]) == 0
    with open(os.path.join(mini, "expected", "modes", "strain_track_m100_stdout.txt")) as f:
        assert out.getvalue() == f.read()
    assert not [m for m in sys.modules if blocked(m)]
    print("ok")
    """
)


def _run(script: str, *args: str):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script, REPO, *args], capture_output=True, text=True, env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


_CUCKOO_SCRIPT = _BLOCK + textwrap.dedent(
    """
    import numpy as np
    from strainer2_tpu_torch.index.cuckoo import build_cuckoo
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

    mini = os.path.join(sys.argv[1], "tests", "golden", "mini")
    out_dir = sys.argv[2]
    os.chdir(mini)
    assert build_cuckoo(np.arange(1, 5000, dtype=np.uint64), 31).num_slots >= 2 * 4999
    hits = os.path.join(out_dir, "hits.txt")
    det = run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", hits,
                     batch_list="data/targets.txt", stdout=io.StringIO(), gzip_output=False,
                     cfg=DetectConfig(device="cpu", rows=8, row_len=1024, layout="cuckoo"))
    assert det.index.layout == "cuckoo"
    with open(hits, "rb") as f, open("expected/kmer_hits.txt", "rb") as g:
        assert f.read() == g.read()
    assert not [m for m in sys.modules if blocked(m)]
    print("ok")
    """
)


def test_package_imports_and_runs_without_jax():
    assert int(_run(_SCRIPT).split()[-1]) >= 20


def test_detect_multi_and_bench_lookup_run_without_jax(tmp_path):
    assert _run(_MULTI_SCRIPT, str(tmp_path)).split()[-1] == "ok"


def test_pipeline_multi_runs_without_jax(tmp_path):
    assert _run(_PIPELINE_MULTI_SCRIPT, str(tmp_path)).split()[-1] == "ok"


def test_genome_compare_and_strain_track_run_without_jax(tmp_path):
    assert _run(_COMPARE_SCRIPT, str(tmp_path)).split()[-1] == "ok"


def test_cuckoo_detect_runs_without_jax(tmp_path):
    assert _run(_CUCKOO_SCRIPT, str(tmp_path)).split()[-1] == "ok"
