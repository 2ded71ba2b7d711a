"""The kernel build of the port (strainer2_tpu_torch/ops/_build.py) on the
CPU: the library names hash every csrc source and header, every .cu is
compiled (one compiler process each) and every entry point is bound; and
the launch counts stay exact under threads."""

import os
import re
import shutil
import stat
import sys
import threading

import pytest

from strainer2_tpu_torch.ops import _build

# Stands in for nvcc: compiles a C stub with the source's entry points
# (each returns 0) into the requested shared library.
_FAKE_NVCC = r"""#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
stub="$out.c"
grep -o 'int s2t_[a-z_]*(' "$src" | sed 's/($/(void) { return 0; }/' > "$stub"
exec cc -shared -fPIC -o "$out" "$stub"
"""


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(os.path.join(os.path.dirname(_build.__file__), "..", "csrc"), src)
    monkeypatch.setattr(_build, "_CSRC", str(src))
    monkeypatch.setattr(_build, "_BUILD_DIR", str(tmp_path / "build"))
    return src


def test_digest_covers_every_source_and_header(csrc_copy):
    sources, digest = _build._sources()
    assert sorted(os.path.basename(p) for p in sources) == ["strainer2_kernels.cu", "strainer2_multi.cu"]
    for name in ("kmer_device.cuh", "strainer2_multi.cu", "strainer2_kernels.cu"):
        with open(csrc_copy / name, "a") as f:
            f.write("\n// edited\n")
        _, edited = _build._sources()
        assert edited != digest, name
        digest = edited


def test_every_source_builds_and_every_entry_point_binds(csrc_copy, tmp_path, monkeypatch):
    if shutil.which("cc") is None:
        pytest.skip("no C compiler for the stub")
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_fns", None)
    fns = _build.kernels()
    assert sorted(fns) == sorted(_build._SIGNATURES)
    assert _build.built_how == "compiled with nvcc (2 sources in parallel)"
    built = sorted(p for p in os.listdir(tmp_path / "build") if p.endswith(".so"))
    assert [re.sub(r"_[0-9a-f]{16}\.so$", "", p) for p in built] == [
        "libstrainer2_kernels", "libstrainer2_multi"]
    # a second process finds the libraries and loads them without a build
    monkeypatch.setattr(_build, "_fns", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("rebuilt an unchanged source"))
    assert sorted(_build.kernels()) == sorted(_build._SIGNATURES)
    assert _build.built_how.startswith("loaded from")


def test_launch_counts_are_exact_under_threads(monkeypatch):
    monkeypatch.setattr(_build, "launches", dict.fromkeys(_build.launches, 0))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [_build.count_launch("strain_sums") for _ in range(5000)])
                   for _ in range(4 * (os.cpu_count() or 1))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert _build.launches["strain_sums"] == 5000 * len(workers)
    _build.reset_launches()
    assert not any(_build.launches.values())


@pytest.mark.parametrize("mangled,name", [
    ("_ZN53_GLOBAL__N__71946244_20_strainer2_kernels_cu_eda1342120bucket_lookup_kernelEPKjiijS1_S1_lPhPiPj",
     "bucket_lookup_kernel"),
    ("_ZN51_GLOBAL__N__d072f604_18_strainer2_multi_cu_c92f60e918strain_sums_kernelILi16EEEvPKjiPKiiiPiS5_",
     "strain_sums_kernel<16>"),
    ("_ZN51_GLOBAL__N__d072f604_18_strainer2_multi_cu_c92f60e925bucket_lookup_ring_kernelILi8EEEvPKjiijS2_S2_xPhPiPj",
     "bucket_lookup_ring_kernel<8>"),
])
def test_compare_sass_kernel_names(mangled, name):
    """The SASS comparison keys kernels by name and template argument, not
    by the per-file hash of the anonymous namespace (nvcc's names, above,
    differ in it between two checkouts); a name starting with hex letters
    ("bucket") is not eaten by the hash."""
    from strainer2_tpu_torch.tools.compare_sass import kernel_name

    assert kernel_name(mangled) == name


def test_compare_sass_compiles_with_the_build_flags():
    """The SASS comparison compiles a cubin with the build's architecture
    and optimisation flags, not a copy of them, and without the shared
    library's."""
    from strainer2_tpu_torch.tools.compare_sass import _CUBIN_FLAGS

    assert _CUBIN_FLAGS[-1] == "-cubin"
    assert "-shared" not in _CUBIN_FLAGS
    gencode = _build._NVCC_FLAGS.index("-gencode")
    assert _build._NVCC_FLAGS[gencode : gencode + 2] == _CUBIN_FLAGS[:2]
    assert {"-std=c++17", "-O3"} <= set(_CUBIN_FLAGS)
