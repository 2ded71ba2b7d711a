"""Build and load the CUDA kernels (every csrc/*.cu) at first use.

Each source is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes: no PyTorch headers, so a build takes
seconds, and the sources compile in parallel, one nvcc each. The libraries
land in ``build/strainer2_tpu_torch/`` beside the package (ignored by git),
named by one hash of every csrc file (sources and headers) and the flags,
so an edit to any of them is never served from a stale build and processes
that share a checkout build once.

Nothing here runs at import time: CPU-only hosts import the package freely
and never reach nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["kernels", "call", "launches", "reset_launches", "build_seconds"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "strainer2_tpu_torch")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_LL = ctypes.c_longlong
_SIGNATURES = {
    "s2t_canonical_windows": [_P, _I, _I, _I, _P, _P, _P, _P],
    "s2t_bucket_lookup": [_P, _I, _I, _U32, _P, _P, _LL, _P, _P, _P, _P],
    "s2t_count_step": [_P, _P, _I, _I, _U32, _P, _I, _I, _I, _P],
    "s2t_count_valid_step": [_P, _P, _I, _I, _U32, _P, _I, _I, _I, _P, _P],
    "s2t_hit_accumulate": [_P, _P, _I, _I, _U32, _P, _I, _I, _I, _P],
    "s2t_valid_tally_total": [_P, _I, _P, _P],
    "s2t_hit_stats": [_P, _I, _I, _U32, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "s2t_classify_step": [_P, _I, _I, _U32, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    "s2t_classify_select": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "s2t_bucket_lookup_ring": [_P, _I, _I, _U32, _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P],
    "s2t_multi_hit_words": [_P, _I, _I, _U32, _P, _I, _I, _I, _I, _P, _P],
    "s2t_strain_sums": [_P, _I, _I, _P, _I, _I, _P, _P, _P],
    "s2t_cuckoo_fingerprints": [_P, _LL, _P, _P],
    "s2t_cuckoo_lookup": [_P, _P, _I, _I, _U32, _P, _P, _LL, _P, _P, _P],
    "s2t_cuckoo_count_step": [_P, _P, _P, _I, _I, _U32, _P, _I, _I, _I, _P],
    "s2t_cuckoo_count_valid_step": [_P, _P, _P, _I, _I, _U32, _P, _I, _I, _I, _P, _P],
    "s2t_cuckoo_hit_accumulate": [_P, _P, _P, _I, _I, _U32, _P, _I, _I, _I, _P],
    "s2t_cuckoo_hit_stats": [_P, _P, _I, _I, _U32, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "s2t_cuckoo_classify_step": [_P, _P, _P, _I, _I, _U32, _P, _I, _I, _I, _P, _I, _P, _P, _P,
                                 _P, _P],
    # the shard-window kernels of a (data, index) mesh (parallel/sharding.py)
    "s2t_shard_count_step": [_P, _P, _I, _I, _U32, _I, _I, _P, _I, _I, _I, _P],
    "s2t_shard_cuckoo_count_step": [_P, _P, _P, _I, _I, _U32, _I, _I, _P, _I, _I, _I, _P],
    "s2t_shard_classify_masks": [_P, _I, _I, _U32, _I, _I, _P, _I, _I, _I, _P, _P, _P],
    "s2t_shard_cuckoo_classify_masks": [_P, _P, _P, _I, _I, _U32, _I, _I, _P, _I, _I, _I, _P,
                                        _P, _P],
    "s2t_shard_multi_hit_words": [_P, _I, _I, _U32, _I, _I, _P, _I, _I, _I, _I, _P, _P],
    "s2t_shard_reduce": [_P, _I, _LL, _I, _P, _P, _P],
    "s2t_classify_sums": [_P, _P, _I, _I, _I, _P, _I, _P, _P, _P],
}

# Kernel launches per wrapper; each wrapper adds one where it launches.
launches = {name[len("s2t_"):]: 0 for name in _SIGNATURES}
build_seconds: float | None = None  # compile (or load) time of the first call
built_how: str | None = None  # "compiled with nvcc" or "loaded from <dir>"

_lock = threading.Lock()
_count_lock = threading.Lock()
_fns: dict | None = None


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources() -> tuple[list[str], str]:
    """The .cu sources, and a digest of every csrc file and the flags."""
    files = sorted(glob.glob(os.path.join(_CSRC, "*.cu")) + glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return [p for p in files if p.endswith(".cu")], h.hexdigest()[:16]


def _compile(sources: list[str], libs: list[str]) -> None:
    """One nvcc per source, all started together; raises on any failure."""
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    jobs = []
    for src, so in zip(sources, libs):
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in jobs:
        out, err = proc.communicate()
        with open(so + ".log", "w") as log:
            log.write(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {src}:\n{err[-4000:]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def kernels() -> dict:
    """Entry point name -> ctypes function of the loaded kernel libraries,
    compiled on first call if needed."""
    global _fns, build_seconds, built_how
    with _lock:
        if _fns is not None:
            return _fns
        sources, digest = _sources()
        libs = [
            os.path.join(_BUILD_DIR, f"lib{os.path.splitext(os.path.basename(s))[0]}_{digest}.so")
            for s in sources
        ]
        t0 = time.perf_counter()
        built_how = f"loaded from {_BUILD_DIR}"
        todo = [(s, so) for s, so in zip(sources, libs) if not os.path.exists(so)]
        if todo:
            built_how = f"compiled with nvcc ({len(todo)} sources in parallel)"
            _compile(*map(list, zip(*todo)))
        fns = {}
        for so in libs:
            lib = ctypes.CDLL(so)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
        missing = sorted(set(_SIGNATURES) - set(fns))
        if missing:
            raise RuntimeError(f"kernel entry points missing from {libs}: {missing}")
        build_seconds = time.perf_counter() - t0
        _fns = fns
        return fns


def call(name: str, device, *args) -> None:
    """Launch one kernel entry point on ``device``'s current PyTorch stream;
    raise if CUDA refused the launch."""
    import torch

    fn = kernels()[f"s2t_{name}"]
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")
    count_launch(name)


def count_launch(name: str) -> None:
    """Add one launch of ``name``; wrappers launch from several threads
    (per-strain set-up, genome scans), so the add holds a lock."""
    with _count_lock:
        launches[name] += 1
