"""Compare the machine code (SASS) of every CUDA kernel in two checkouts.

    python -m strainer2_tpu_torch.tools.compare_sass DIR_A DIR_B

Compiles each checkout's ``strainer2_tpu_torch/csrc/*.cu`` to a cubin with
the architecture and optimisation flags of ``ops/_build.py``, disassembles
it with ``cuobjdump`` and prints one line a kernel (a template instance
each): ``same`` where its instructions are equal in both, ``DIFFERS``
where they are not, ``new`` or ``gone`` where only DIR_B or only DIR_A
has it.  An edit to the shared header (``csrc/kmer_device.cuh``) should
leave every kernel it does not mean to change ``same``.  Needs the CUDA
toolkit (nvcc, cuobjdump), not a card; exits 1 if a kernel differs or is
gone.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from strainer2_tpu_torch.ops import _build

# the build's flags, less those of a shared library and of ptxas' report
_CUBIN_FLAGS = [f for f in _build._NVCC_FLAGS
                if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")] + ["-cubin"]
# the anonymous namespace's name ends in "_cu_" and an 8-digit hex hash of
# the file; the kernel's name follows as <length><name>
_AFTER_NAMESPACE = re.compile(r"_cu_[0-9a-f]{8}(\d+)")


def kernel_name(mangled: str) -> str:
    """``count_step_kernel`` or ``strain_sums_kernel<16>`` from a mangled
    name, without the per-file hash that differs between checkouts."""
    m = _AFTER_NAMESPACE.search(mangled)
    if m is None:
        return mangled
    end = m.end() + int(m.group(1))
    t = re.match(r"ILi(\d+)EE", mangled[end:])
    return mangled[m.end() : end] + (f"<{t.group(1)}>" if t else "")


def _sass(cubin: str) -> dict[str, list[str]]:
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        # addresses, mangled names and column padding (cuobjdump pads to the
        # file's widest instruction) are not the kernel's instructions
        lines = (" ".join(re.sub(r"/\*[0-9a-f]{4}\*/|_ZN\w+", "", line).split())
                 for line in body.splitlines())
        out[kernel_name(head.strip())] = [x for x in lines if x and not x.startswith(".")]
    return out


def compare(repo_a: str, repo_b: str) -> dict[str, str]:
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(side, src, os.path.join(tmp, f"{side}_{os.path.basename(src)}.cubin"))
                for side, repo in enumerate((repo_a, repo_b))
                for src in sorted(glob.glob(os.path.join(repo, "strainer2_tpu_torch", "csrc", "*.cu")))]

        def build(job):
            subprocess.run([nvcc, *_CUBIN_FLAGS, "-o", job[2], job[1]], check=True)

        with ThreadPoolExecutor(len(jobs)) as ex:
            list(ex.map(build, jobs))
        sides: list[dict] = [{}, {}]
        for side, _, cubin in jobs:
            sides[side].update(_sass(cubin))
    out = {}
    for name in sorted(set(sides[0]) | set(sides[1])):
        if name not in sides[0]:
            out[name] = "new"
        elif name not in sides[1]:
            out[name] = "gone"
        else:
            out[name] = "same" if sides[0][name] == sides[1][name] else "DIFFERS"
    return out


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 2:
        print(__doc__.split("\n\n")[1])
        return 2
    result = compare(*args)
    for name, verdict in result.items():
        print(f"sass {verdict}: {name}")
    return 0 if all(v in ("same", "new") for v in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
