#!/bin/bash
# ThreadSanitizer run of the port's C++ host library over every concurrent
# shape of the port's host plane (strainer2_tpu_torch/tools/tsan_stress.py).
#
#   strainer2_tpu_torch/tools/tsan_stress.sh
#
# Builds csrc/host/strainer2_host.cc with -fsanitize=thread into
# build/strainer2_tpu_torch_tsan/ (git-ignored), points the port at it
# (STRAINER2_TORCH_HOST_LIB) and runs the stress with libtsan preloaded.
# Exits non-zero on any data race TSan reports (halt_on_error, exit code
# 66) or a failed stress.  Needs g++ with libtsan and zlib's headers; runs
# on the CPU only.
set -e
DIR="$(cd "$(dirname "$0")/../.." && pwd)"
OUT="$DIR/build/strainer2_tpu_torch_tsan"
SO="$OUT/libstrainer2host_tsan.so"
mkdir -p "$OUT"
g++ -O1 -g -fsanitize=thread -std=c++17 -fPIC -shared -o "$SO" \
    "$DIR/strainer2_tpu_torch/csrc/host/strainer2_host.cc" -lz
export LD_PRELOAD="$(g++ -print-file-name=libtsan.so)"
export STRAINER2_TORCH_HOST_LIB="$SO"
export TSAN_OPTIONS="halt_on_error=1 exitcode=66 report_signal_unsafe=0"
export PYTHONPATH="$DIR"
exec python "$DIR/strainer2_tpu_torch/tools/tsan_stress.py" "$@"
