// Hand-written Hopper (sm_90a) kernels of the lookup A/B tool and of the
// multi-strain detection path (strainer2_tools detect-multi).
//
// Built by strainer2_tpu_torch/ops/_build.py like strainer2_kernels.cu
// (nvcc -gencode arch=compute_90a,code=sm_90a, plain C entry points bound
// with ctypes); every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_device.cuh"

using namespace s2t;

namespace {

// ---------------------------------------------------------------------------
// K5 bucket_lookup_ring
//
// Replaces: bucket_lookup_pallas_manual, strainer2_tpu/ops/pallas_lookup.py:211
//   (a hand-rolled ring of W row DMAs per group, D groups outstanding).
// Bound on this card: random device-memory latency, as K2: each query reads
//   one row at a hashed address of a table far larger than the 50 MB L2.
// Design: a block owns `chunk` queries and walks them in groups of w. For a
//   group it issues cp.async 16-byte copies of each query's row into one of
//   D shared-memory stages: the 128-byte key span and the 64-byte first
//   meta block, 12 copies a row, one per thread (blockDim = 12 w). D groups
//   stay in flight (commit_group / wait_group<D-1>); the first w threads
//   compare the landed group from shared memory while the next ones load.
//   The Pallas kernel copies a 512-byte padded row per query; this copies
//   the 192 bytes the contract reads. Results are K2's: the first equal
//   cell by __ffs, and slot = bucket * 16, meta = 0 where not found (the
//   jnp values; the Pallas kernel returns bucket * 16 + 16 there).
// ---------------------------------------------------------------------------
constexpr int kRingPieces = 12;  // 16-byte copies per staged row: 8 key + 4 meta

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// This thread's copy of the row of query q0 + g * w + threadIdx.x / 12 into stage s.
__device__ __forceinline__ void ring_issue(uint4* stages, const uint32_t* rows,
                                           int row_width, int h_bits,
                                           uint32_t salt, const uint32_t* qhi,
                                           const uint32_t* qlo, int64_t q0,
                                           int w, int g, int s) {
  const int j = threadIdx.x / kRingPieces;
  const int p = threadIdx.x - j * kRingPieces;
  const int64_t q = q0 + static_cast<int64_t>(g) * w + j;
  const uint32_t b = bucket_of(__ldg(qhi + q), __ldg(qlo + q), h_bits, salt);
  const int lane = p < 8 ? 4 * p : kMetaLane + 4 * (p - 8);
  cp_async16(stages + (s * w + j) * kRingPieces + p,
             rows + static_cast<size_t>(b) * row_width + lane);
}

template <int D>
__global__ void bucket_lookup_ring_kernel(const uint32_t* __restrict__ rows,
                                          int row_width, int h_bits,
                                          uint32_t salt,
                                          const uint32_t* __restrict__ qhi,
                                          const uint32_t* __restrict__ qlo,
                                          int w, int chunk,
                                          uint8_t* __restrict__ found,
                                          int32_t* __restrict__ slot,
                                          uint32_t* __restrict__ meta) {
  extern __shared__ uint4 stages[];  // D x w rows x 12 pieces
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int ng = chunk / w;
  // prologue: D groups in flight; one commit per step (empty ones too) keeps
  // "group g has landed" equal to "at most D-1 newer groups pending"
  for (int s = 0; s < D; ++s) {
    if (s < ng) ring_issue(stages, rows, row_width, h_bits, salt, qhi, qlo, q0, w, s, s);
    cp_async_commit();
  }
  for (int g = 0; g < ng; ++g) {
    const int s = g % D;
    cp_async_wait<D - 1>();
    __syncthreads();  // every thread's copies of group g are visible
    if (threadIdx.x < w) {
      const int64_t q = q0 + static_cast<int64_t>(g) * w + threadIdx.x;
      const uint32_t h = qhi[q], l = qlo[q];
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(stages + (s * w + threadIdx.x) * kRingPieces);
      unsigned m = 0;
#pragma unroll
      for (int c = 0; c < kKeysPerBucket; ++c)
        m |= static_cast<unsigned>((row[c] == h) & (row[kKeysPerBucket + c] == l)) << c;
      const int cell = m ? __ffs(m) - 1 : 0;
      found[q] = m != 0;
      slot[q] = static_cast<int32_t>(bucket_of(h, l, h_bits, salt)) * kKeysPerBucket + cell;
      meta[q] = m ? row[kMetaLane + cell] : 0u;
    }
    __syncthreads();  // stage s is read before it is refilled
    if (g + D < ng)
      ring_issue(stages, rows, row_width, h_bits, salt, qhi, qlo, q0, w, g + D, s);
    cp_async_commit();
  }
}

template <int D>
int launch_ring(const void* rows, int row_width, int h_bits, uint32_t salt,
                const void* qhi, const void* qlo, long long n, int w, int chunk,
                void* found, void* slot, void* meta, cudaStream_t stream) {
  const long long blocks = n / chunk;
  const size_t smem = static_cast<size_t>(D) * w * kRingPieces * sizeof(uint4);
  bucket_lookup_ring_kernel<D><<<static_cast<unsigned>(blocks), w * kRingPieces, smem, stream>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo), w,
      chunk, static_cast<uint8_t*>(found), static_cast<int32_t*>(slot),
      static_cast<uint32_t*>(meta));
  return launch_status();
}

// ---------------------------------------------------------------------------
// K6 multi_hit_words
//
// Replaces: the XLA program of multi_detect._classify_multi before its
//   segment sum (strainer2_tpu/pipeline/multi_detect.py:1038-1051):
//   canonical_windows, bucket_lookup_words / bucket_lookup
//   (strainer2_tpu/ops/lookup.py:181, :139) and the hit mask.
// Bound on this card: the probe's random DRAM access, as K2, plus the
//   output: n_words x 4 bytes per window (66.6 MB per 256 x 4096 batch at
//   256 strains), written once.
// Design: K3's shared-memory tile and probe, one thread per window; a hit
//   reads lane 32 + 16 j + cell of the matched row for j < n_words and
//   writes them window-major, (Q, n_words), so K7 reads one read's words
//   contiguously. A miss or an invalid window writes zeros. Lane 32 is the
//   first word for every S, as the jnp bucket_lookup branch at S <= 16
//   reads it.
// ---------------------------------------------------------------------------
__global__ void multi_hit_words_kernel(const uint32_t* __restrict__ rows,
                                       int row_width, int h_bits, uint32_t salt,
                                       const uint8_t* __restrict__ bases, int L,
                                       int k, int n_words,
                                       uint32_t* __restrict__ words) {
  __shared__ uint8_t tile[kTile + kMaxK];
  const int W = L - k + 1;
  const int row = blockIdx.y;
  const int w0 = blockIdx.x * kTile;
  load_tile(tile, bases + static_cast<size_t>(row) * L, w0, L, k);
  const int w = w0 + threadIdx.x;
  if (w >= W) return;
  uint32_t* out = words + (static_cast<size_t>(row) * W + w) * n_words;
  uint32_t h, l;
  unsigned m = 0;
  const uint32_t* r = rows;
  if (canonical_window(tile + threadIdx.x, k, min(k, 16), &h, &l)) {
    r = rows + static_cast<size_t>(bucket_of(h, l, h_bits, salt)) * row_width;
    m = match_mask(r, h, l);
  }
  if (m) {
    const uint32_t* cell = r + kMetaLane + (__ffs(m) - 1);
    for (int j = 0; j < n_words; ++j) out[j] = __ldg(cell + kKeysPerBucket * j);
  } else {
    for (int j = 0; j < n_words; ++j) out[j] = 0u;
  }
}

// ---------------------------------------------------------------------------
// K7 strain_sums
//
// Replaces: ops/segsum.boundary_strain_sums + _field_sums16
//   (strainer2_tpu/ops/segsum.py:126, :62): per read r and strain s, tot =
//   windows of [b[r], b[r+1]) with bit 2s of word s/16 set, inf = with bit
//   2s+1 set.
// Bound on this card: integer issue over the words a read spans (each word
//   is read by the 32 (strain, bit) threads of a warp at once: one
//   broadcast load, served from L1 after the first).
// Design: one thread per (read, strain, bit) looping over the read's span;
//   exact int32 counts, so no SWAR counters and no two-level prefix (those
//   vectorise a TPU's lanes). Boundaries are clamped to [0, Q]; a span with
//   b[r+1] < b[r] gives the negated count, as a prefix difference does.
// ---------------------------------------------------------------------------
__global__ void strain_sums_kernel(const uint32_t* __restrict__ words,
                                   int n_windows, int n_words,
                                   const int32_t* __restrict__ bounds,
                                   int n_reads, int n_strains,
                                   int32_t* __restrict__ tot,
                                   int32_t* __restrict__ inf) {
  const int lanes = 2 * n_strains;
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= static_cast<int64_t>(n_reads) * lanes) return;
  const int r = static_cast<int>(g / lanes);
  const int u = static_cast<int>(g - static_cast<int64_t>(r) * lanes);
  const int s = u >> 1;
  const int bit = u & 1;
  const int j = s >> 4;
  const int shift = 2 * (s & 15) + bit;
  int a = min(max(bounds[r], 0), n_windows);
  int e = min(max(bounds[r + 1], 0), n_windows);
  int sign = 1;
  if (e < a) {
    const int t = a;
    a = e;
    e = t;
    sign = -1;
  }
  const uint32_t* src = words + j;
  int n = 0;
  for (int q = a; q < e; ++q)
    n += (__ldg(src + static_cast<size_t>(q) * n_words) >> shift) & 1u;
  (bit ? inf : tot)[static_cast<size_t>(r) * n_strains + s] = sign * n;
}

}  // namespace

extern "C" {

int s2t_bucket_lookup_ring(const void* rows, int row_width, int h_bits,
                           uint32_t salt, const void* qhi, const void* qlo,
                           long long n, int w, int d, int chunk, void* found,
                           void* slot, void* meta, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define S2T_RING_CASE(D) \
  case D:                \
    return launch_ring<D>(rows, row_width, h_bits, salt, qhi, qlo, n, w, chunk, found, slot, meta, st);
    S2T_RING_CASE(1)
    S2T_RING_CASE(2)
    S2T_RING_CASE(3)
    S2T_RING_CASE(4)
    S2T_RING_CASE(5)
    S2T_RING_CASE(6)
    S2T_RING_CASE(7)
    S2T_RING_CASE(8)
#undef S2T_RING_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int s2t_multi_hit_words(const void* rows, int row_width, int h_bits,
                        uint32_t salt, const void* bases, int n_rows, int L,
                        int k, int n_words, void* words, void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, n_rows);
  multi_hit_words_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<const uint8_t*>(bases), L, k, n_words,
      static_cast<uint32_t*>(words));
  return launch_status();
}

int s2t_strain_sums(const void* words, int n_windows, int n_words,
                    const void* bounds, int n_reads, int n_strains, void* tot,
                    void* inf, void* stream) {
  const int threads = 256;
  const long long total = static_cast<long long>(n_reads) * 2 * n_strains;
  const long long blocks = (total + threads - 1) / threads;
  strain_sums_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_windows, n_words,
      static_cast<const int32_t*>(bounds), n_reads, n_strains,
      static_cast<int32_t*>(tot), static_cast<int32_t*>(inf));
  return launch_status();
}

}  // extern "C"
