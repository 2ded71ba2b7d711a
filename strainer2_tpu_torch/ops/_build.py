"""Build and load the CUDA kernels (csrc/strainer2_kernels.cu) at first use.

The source is compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes: no PyTorch headers, so a build takes
seconds. The library lands in ``build/strainer2_tpu_torch/`` beside the
package (ignored by git), named by a hash of the source, so an edited
kernel is never served from a stale build and processes that share a
checkout build once.

Nothing here runs at import time: CPU-only hosts import the package freely
and never reach nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["kernels", "call", "launches", "reset_launches", "build_seconds"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "strainer2_kernels.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "strainer2_tpu_torch")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "s2t_canonical_windows": [_P, _I, _I, _I, _P, _P, _P, _P],
    "s2t_bucket_lookup": [_P, _I, _I, _U32, _P, _P, ctypes.c_longlong, _P, _P, _P, _P],
    "s2t_count_step": [_P, _P, _I, _I, _U32, _P, _I, _I, _I, _P],
    "s2t_classify_step": [_P, _I, _I, _U32, _P, _I, _I, _I, _P, _I, _P, _P, _P],
}

# Kernel launches per wrapper; each wrapper adds one where it launches.
launches = {"canonical_windows": 0, "bucket_lookup": 0, "count_step": 0, "classify_step": 0}
build_seconds: float | None = None  # compile (or load) time of the first call
built_how: str | None = None  # "compiled with nvcc" or "loaded from <path>"

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
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


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, compiled on first call if needed."""
    global _lib, build_seconds, built_how
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = _BUILD_DIR
        so = os.path.join(out_dir, f"libstrainer2_kernels_{digest}.so")
        t0 = time.perf_counter()
        built_how = f"loaded from {so}"
        if not os.path.exists(so):
            built_how = "compiled with nvcc"
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SRC],
                capture_output=True, text=True,
            )
            with open(so + ".log", "w") as log:
                log.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {_SRC}:\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return lib


def call(name: str, device, *args) -> None:
    """Launch one kernel entry point on ``device``'s current PyTorch stream;
    raise if CUDA refused the launch."""
    import torch

    fn = getattr(kernels(), f"s2t_{name}")
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")
    launches[name] += 1
