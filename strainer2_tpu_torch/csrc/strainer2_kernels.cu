// Hand-written Hopper (sm_90a) kernels of the single-strain k-mer path.
//
// Built by strainer2_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every entry point below has a plain C signature,
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// The shared definitions (k-mer packing, bucket hash, row layout, first
// equal cell) are in kmer_device.cuh.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_device.cuh"

using namespace s2t;

namespace {

constexpr uint32_t kInformative = 2;

// ---------------------------------------------------------------------------
// K1 canonical_windows
//
// Replaces: canonical_windows_pallas, strainer2_tpu/ops/pallas_kernels.py:127
//   (the O(log k) doubling pack of _pack_block / _rc_pack_block).
// Bound on this card: device-memory bytes. Per window it reads ~1 base and
//   writes 9 bytes (hi, lo, valid); the 2k shift-or steps per window are
//   far below the integer issue rate.
// Design: one thread per window; a block stages the bases of 256 windows of
//   one row (plus the k-1 halo) in shared memory, builds forward and
//   reverse-complement codes in one 64-bit register each, and writes
//   coalesced outputs. The doubling trick exists to vectorise across the
//   TPU's lanes; a thread needs no such trick.
// ---------------------------------------------------------------------------
__global__ void canonical_windows_kernel(const uint8_t* __restrict__ bases,
                                         int L, int k,
                                         uint32_t* __restrict__ hi,
                                         uint32_t* __restrict__ lo,
                                         uint8_t* __restrict__ valid) {
  __shared__ uint8_t tile[kTile + kMaxK];
  const int W = L - k + 1;
  const int row = blockIdx.y;
  const int w0 = blockIdx.x * kTile;
  load_tile(tile, bases + static_cast<size_t>(row) * L, w0, L, k);
  const int w = w0 + threadIdx.x;
  if (w >= W) return;
  uint32_t h, l;
  const bool ok = canonical_window(tile + threadIdx.x, k, min(k, 16), &h, &l);
  const size_t o = static_cast<size_t>(row) * W + w;
  hi[o] = h;
  lo[o] = l;
  valid[o] = ok;
}

// ---------------------------------------------------------------------------
// K2 bucket_lookup
//
// Replaces: bucket_lookup_pallas_gridmap, strainer2_tpu/ops/pallas_lookup.py:93
//   (one row DMA per query, vector compare of the 16 cells).
// Bound on this card: random device-memory access latency. Each query reads
//   one 128-byte key span at a hashed address; a 512 MiB table does not fit
//   the 50 MB L2, so nearly every probe is a DRAM round trip.
// Design: one thread per query, 8 independent 16-byte loads in flight per
//   thread and thousands of threads per SM to cover the latency; the first
//   equal cell is the lowest set bit of a 16-bit match mask (__ffs).
//   Where not found: slot = bucket * 16 and meta = 0, exactly what the jnp
//   bucket_lookup returns there.
// ---------------------------------------------------------------------------
__global__ void bucket_lookup_kernel(const uint32_t* __restrict__ rows,
                                     int row_width, int h_bits, uint32_t salt,
                                     const uint32_t* __restrict__ qhi,
                                     const uint32_t* __restrict__ qlo,
                                     int64_t n, uint8_t* __restrict__ found,
                                     int32_t* __restrict__ slot,
                                     uint32_t* __restrict__ meta) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (q >= n) return;
  const uint32_t h = qhi[q], l = qlo[q];
  const uint32_t b = bucket_of(h, l, h_bits, salt);
  const uint32_t* row = rows + static_cast<size_t>(b) * row_width;
  const unsigned m = match_mask(row, h, l);
  const int cell = m ? __ffs(m) - 1 : 0;
  found[q] = m != 0;
  slot[q] = static_cast<int32_t>(b) * kKeysPerBucket + cell;
  meta[q] = m ? __ldg(row + kMetaLane + cell) : 0u;
}

// ---------------------------------------------------------------------------
// K3 count_step
//
// Replaces: the XLA program engine._count_step_bucket +
//   ops/lookup.accumulate_counts (strainer2_tpu/pipeline/engine.py:324-327,
//   strainer2_tpu/ops/lookup.py:104-116): extract, probe, counts[slot] += 1.
// Bound on this card: the probe's random DRAM access, as in K2; the
//   atomics land on a 128 MiB count buffer and are mostly uncontended.
// Design: K1's shared-memory tile and K2's probe fused per thread, so no
//   window code touches device memory; a hit is one atomicAdd on uint32,
//   which wraps like the JAX scatter-add. Integer adds commute, so the
//   count bytes do not depend on the order the atomics land in.
// ---------------------------------------------------------------------------
__global__ void count_step_kernel(uint32_t* __restrict__ counts,
                                  const uint32_t* __restrict__ rows,
                                  int row_width, int h_bits, uint32_t salt,
                                  const uint8_t* __restrict__ bases, int L,
                                  int k) {
  __shared__ uint8_t tile[kTile + kMaxK];
  const int W = L - k + 1;
  const int row = blockIdx.y;
  const int w0 = blockIdx.x * kTile;
  load_tile(tile, bases + static_cast<size_t>(row) * L, w0, L, k);
  const int w = w0 + threadIdx.x;
  if (w >= W) return;
  uint32_t h, l;
  if (!canonical_window(tile + threadIdx.x, k, min(k, 16), &h, &l)) return;
  const uint32_t b = bucket_of(h, l, h_bits, salt);
  const unsigned m = match_mask(rows + static_cast<size_t>(b) * row_width, h, l);
  if (m) atomicAdd(counts + static_cast<size_t>(b) * kKeysPerBucket + (__ffs(m) - 1), 1u);
}

// ---------------------------------------------------------------------------
// K4 classify_step
//
// Replaces: the XLA program engine._classify_step_bucket
//   (strainer2_tpu/pipeline/engine.py:353-364): extract, probe, then each
//   read's (total, informative) hits as differences of a global prefix sum
//   at the read boundaries.
// Bound on this card: the probe's random DRAM access, as in K2.
// Design: reads are contiguous spans [b[r], b[r+1]) of the flat
//   (rows x width) window axis, so one warp owns one read: its lanes stride
//   over the span, probe, and a shuffle reduction gives both sums. No
//   prefix-sum array and no second pass. Boundaries are clamped to
//   [0, n_windows] like the JAX gather; a span with b[r+1] < b[r] gives the
//   negated sum, as the prefix difference does.
// ---------------------------------------------------------------------------
__global__ void classify_step_kernel(const uint32_t* __restrict__ rows,
                                     int row_width, int h_bits, uint32_t salt,
                                     const uint8_t* __restrict__ bases,
                                     int n_rows, int L, int k,
                                     const int32_t* __restrict__ bounds,
                                     int max_reads, int32_t* __restrict__ tot,
                                     int32_t* __restrict__ inf) {
  const int read = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (read >= max_reads) return;  // uniform across the warp
  const int W = L - k + 1;
  const int n_windows = n_rows * W;
  int s = min(max(bounds[read], 0), n_windows);
  int e = min(max(bounds[read + 1], 0), n_windows);
  int sign = 1;
  if (e < s) {
    const int t = s;
    s = e;
    e = t;
    sign = -1;
  }
  const int n_lo = min(k, 16);
  int n_tot = 0, n_inf = 0;
  for (int f = s + lane; f < e; f += 32) {
    const int r = f / W;
    const int c = f - r * W;
    uint32_t h, l;
    if (!canonical_window(bases + static_cast<size_t>(r) * L + c, k, n_lo, &h, &l))
      continue;
    const uint32_t b = bucket_of(h, l, h_bits, salt);
    const uint32_t* row = rows + static_cast<size_t>(b) * row_width;
    const unsigned m = match_mask(row, h, l);
    if (m) {
      ++n_tot;
      n_inf += __ldg(row + kMetaLane + __ffs(m) - 1) == kInformative;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n_tot += __shfl_down_sync(0xffffffffu, n_tot, off);
    n_inf += __shfl_down_sync(0xffffffffu, n_inf, off);
  }
  if (lane == 0) {
    tot[read] = sign * n_tot;
    inf[read] = sign * n_inf;
  }
}

}  // namespace

extern "C" {

int s2t_canonical_windows(const void* bases, int rows, int L, int k, void* hi,
                          void* lo, void* valid, void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, rows);
  canonical_windows_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bases), L, k, static_cast<uint32_t*>(hi),
      static_cast<uint32_t*>(lo), static_cast<uint8_t*>(valid));
  return launch_status();
}

int s2t_bucket_lookup(const void* rows, int row_width, int h_bits,
                      uint32_t salt, const void* qhi, const void* qlo,
                      long long n, void* found, void* slot, void* meta,
                      void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  bucket_lookup_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo), n,
      static_cast<uint8_t*>(found), static_cast<int32_t*>(slot),
      static_cast<uint32_t*>(meta));
  return launch_status();
}

int s2t_count_step(void* counts, const void* rows, int row_width, int h_bits,
                   uint32_t salt, const void* bases, int n_rows, int L, int k,
                   void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, n_rows);
  count_step_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counts), static_cast<const uint32_t*>(rows),
      row_width, h_bits, salt, static_cast<const uint8_t*>(bases), L, k);
  return launch_status();
}

int s2t_classify_step(const void* rows, int row_width, int h_bits,
                      uint32_t salt, const void* bases, int n_rows, int L,
                      int k, const void* bounds, int max_reads, void* tot,
                      void* inf, void* stream) {
  const int threads = 256;  // 8 reads per block
  const int reads_per_block = threads / 32;
  const int blocks = (max_reads + reads_per_block - 1) / reads_per_block;
  classify_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<const uint8_t*>(bases), n_rows, L, k,
      static_cast<const int32_t*>(bounds), max_reads,
      static_cast<int32_t*>(tot), static_cast<int32_t*>(inf));
  return launch_status();
}

}  // extern "C"
