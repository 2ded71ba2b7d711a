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
// Bound on this card: K3's random DRAM accesses (a valid window's 64
//   bytes of key_hi lanes, 64 more of key_lo lanes where one matches, and
//   a hit's n_words meta words, each in its own 64-byte block of the row),
//   plus the output: n_words x 4 bytes a window (66.6 MB per 256 x 4096
//   batch at 256 strains), written once. On target-like batches (1% hits)
//   the probes and the stores set the time; where half the valid windows
//   hit, a hit's n_words random meta reads do (PERF.md).
// Design: K3's packed tile and probe (pack_tile, probe_window: window codes
//   in constant time, key_hi lanes first); a hit reads lane 32 + 16 j +
//   cell of the matched row for j < n_words. The output is window-major,
//   (Q, n_words), so K7 reads one read's words contiguously, and a block's
//   windows own one contiguous run of it. The block stages that run in
//   shared memory, zeroed (a miss or an invalid window writes zeros), lets
//   its hits fill their words, then writes the run with consecutive
//   threads on consecutive 16-byte chunks; the head and tail chunks, which
//   the run shares with its neighbours, by 4-byte stores. The old kernel's
//   n_words scalar stores a thread, at a stride of 4 n_words bytes, took
//   0.212 ms a batch at 16 words on their own; these take 0.022, 0.89 of
//   the write bound. Lane 32 is the first word for every S, as the jnp
//   bucket_lookup branch at S <= 16 reads it.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTile)
multi_hit_words_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits,
                       uint32_t salt, const uint8_t* __restrict__ bases, int L, int k,
                       int n_words, uint32_t* __restrict__ words) {
  __shared__ PackedTile tile;
  extern __shared__ uint4 stage4[];  // the run, from the 16-byte chunk it starts in
  uint32_t* stage = reinterpret_cast<uint32_t*>(stage4);
  const int W = L - k + 1;
  const int w0 = blockIdx.x * kTile;
  const long long first = (static_cast<long long>(blockIdx.y) * W + w0) * n_words;
  const int off = static_cast<int>(first & 3);            // stage words [off, end)
  const int end = off + min(kTile, W - w0) * n_words;     // hold the run
  const int chunks = (end + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += kTile) stage4[c] = make_uint4(0u, 0u, 0u, 0u);
  pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);  // syncs the zeros too
  uint32_t b;
  const unsigned m = probe_window(tile, threadIdx.x, rows, row_width, h_bits, salt, w0, W, k, &b);
  if (m) {
    const uint32_t* cell = rows + static_cast<size_t>(b) * row_width + kMetaLane + (__ffs(m) - 1);
    uint32_t* dst = stage + off + threadIdx.x * n_words;
    for (int j = 0; j < n_words; ++j) dst[j] = __ldg(cell + kKeysPerBucket * j);
  }
  __syncthreads();
  uint32_t* out = words + (first - off);  // 16-byte aligned: the wrapper allocates words
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (int c = threadIdx.x; c < chunks; c += kTile) {
    const int i0 = 4 * c;
    if (i0 >= off && i0 + 4 <= end) {
      out4[c] = stage4[c];
    } else {
      for (int i = max(i0, off); i < min(i0 + 4, end); ++i) out[i] = stage[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K7 strain_sums
//
// Replaces: ops/segsum.boundary_strain_sums + _field_sums16
//   (strainer2_tpu/ops/segsum.py:126, :62): per read r and strain s, tot =
//   windows of [b[r], b[r+1]) with bit 2s of word s/16 set, inf = with bit
//   2s+1 set.
// Bound on this card: device-memory bytes: the (Q, N) words read once
//   (8.3 MB per 256 x 4096 batch at S = 32, 66.6 MB at S = 256) and the two
//   (R, S) count matrices written (8.4 MB at S = 32, 67 MB at S = 256).
// Design: a warp per read (more reads a warp leave the ~7k real reads of a
//   batch to too few warps), a block per kSumWarps consecutive reads. A
//   read's windows
//   are a contiguous run of the window-major words, so its N words a window
//   are one contiguous run of N x (b[r+1] - b[r]) words, and the block's
//   reads one run of all theirs. The block stages that run in shared
//   memory with cp.async 16-byte copies. A warp then walks its read's run
//   (32 / N) windows at a time, lane i holding word i % N of window i / N
//   (lanes past (32 / N) N idle), and adds each lane's word into 8
//   bit-sliced vertical counters (a carry-save add, 3 instructions a
//   plane): the warp spends O(1) instructions per (window, word), and no
//   shuffle. At the end of the read (or every 255 steps) a 32 x 32 bit
//   transpose of each counter plane in registers (five __shfl_xor_sync
//   rounds) gives lane b bit b of every lane's plane, and the popcount of
//   that under the mask of the lanes holding word j is the plane's share
//   of the count of bit b of word j: strain 16 j + b / 2, tot for even b,
//   inf for odd b. So the stores of lane b are coalesced. Empty spans (the
//   padding reads) store zeros. Spans the stage cannot hold (long, or a
//   block's reads far apart, as reversed or clamped boundaries make them)
//   run the same warp code on loads from global memory. Boundaries are
//   read as the JAX gather reads them (gather_index); a span with
//   b[r+1] < b[r] gives the negated counts, as a prefix difference does.
// ---------------------------------------------------------------------------
constexpr int kSumWarps = 4;        // warps per block
constexpr int kStageWindows = 184;  // staged windows per read (150 bp reads span 151)
constexpr int kPlanes = 8;          // vertical counter bits: 255 steps between folds

// Lanes that hold word j of a window (lane i holds word i % N).
template <int N>
__device__ __forceinline__ uint32_t lanes_of_word(int j) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) m |= static_cast<uint32_t>(i % N == j) << i;
  return m;
}

// Lane b gets the word whose bit i is bit b of lane i's x.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  uint32_t m = 0x0000FFFFu;
#pragma unroll
  for (int j = 16; j; j >>= 1, m ^= m << j) {
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? ((x & ~m) | ((y & ~m) >> j)) : ((x & m) | ((y & m) << j));
  }
  return x;
}

// Per-bit counts of the words of one read's run src[0, len): lane b adds the
// count of bit b of word j into cnt[j].
template <int N>
__device__ __forceinline__ void count_bits(const uint32_t* src, int len, int lane, int* cnt) {
  constexpr int kStep = (32 / N) * N;  // words a step
  const int steps = (len + kStep - 1) / kStep;
  for (int g0 = 0; g0 < steps; g0 += (1 << kPlanes) - 1) {
    const int g1 = min(steps, g0 + (1 << kPlanes) - 1);
    uint32_t v[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) v[p] = 0;
#pragma unroll 4
    for (int g = g0; g < g1; ++g) {
      const int i = g * kStep + lane;
      uint32_t x = lane < kStep && i < len ? src[i] : 0u;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {  // v += x, bit-sliced
        const uint32_t c = v[p] & x;
        v[p] ^= x;
        x = c;
      }
    }
    const int planes = 32 - __clz(g1 - g0);  // bits of the largest count
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (p < planes) {
        const uint32_t t = transpose32(v[p], lane);
#pragma unroll
        for (int j = 0; j < N; ++j) cnt[j] += __popc(t & lanes_of_word<N>(j)) << p;
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kSumWarps * 32)
strain_sums_kernel(const uint32_t* __restrict__ words, int q,
                   const int32_t* __restrict__ bounds, int n_reads,
                   int n_strains, int32_t* __restrict__ tot,
                   int32_t* __restrict__ inf) {
  constexpr long long kCap = static_cast<long long>(kSumWarps) * kStageWindows * N;
  extern __shared__ uint4 stage4[];  // kCap words
  uint32_t* stage = reinterpret_cast<uint32_t*>(stage4);
  __shared__ int lo, hi;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  int a = 0, e = 0, sign = 1;
  if (r < n_reads) {
    a = gather_index(bounds[r], q);
    e = gather_index(bounds[r + 1], q);
    if (e < a) {
      const int t = a;
      a = e;
      e = t;
      sign = -1;
    }
  }
  if (threadIdx.x == 0) {
    lo = q;
    hi = 0;
  }
  __syncthreads();
  if (lane == 0 && a < e) {
    atomicMin(&lo, a);
    atomicMax(&hi, e);
  }
  __syncthreads();
  // the block's run [base, end) of words, base rounded down to 16 bytes
  const long long base = (static_cast<long long>(lo) * N) & ~3LL;
  const long long end = static_cast<long long>(hi) * N;
  const bool staged = lo < hi && end - base <= kCap;
  if (staged) {
    const int n16 = static_cast<int>((end - base) >> 2);
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(stage4 + i, words + base + 4 * static_cast<long long>(i));
    cp_async_commit();
    for (long long i = base + 4LL * n16 + threadIdx.x; i < end; i += blockDim.x)
      stage[i - base] = words[i];  // the last < 4 words
    cp_async_wait<0>();
    __syncthreads();
  }
  if (r >= n_reads) return;  // uniform across the warp
  const long long first = static_cast<long long>(a) * N;
  int cnt[N];
#pragma unroll
  for (int j = 0; j < N; ++j) cnt[j] = 0;
  count_bits<N>(staged ? stage + (first - base) : words + first, (e - a) * N, lane, cnt);
  int32_t* out = ((lane & 1) ? inf : tot) + static_cast<size_t>(r) * n_strains;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int s = 16 * j + (lane >> 1);
    if (s < n_strains) out[s] = sign * cnt[j];
  }
}

template <int N>
int launch_strain_sums(const void* words, int q, const void* bounds, int n_reads,
                       int n_strains, void* tot, void* inf, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kSumWarps) * kStageWindows * N * sizeof(uint32_t);
  const int blocks = (n_reads + kSumWarps - 1) / kSumWarps;
  strain_sums_kernel<N><<<blocks, kSumWarps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(words), q, static_cast<const int32_t*>(bounds),
      n_reads, n_strains, static_cast<int32_t*>(tot), static_cast<int32_t*>(inf));
  return launch_status();
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
  const size_t stage = (static_cast<size_t>(kTile) * n_words + 4) * sizeof(uint32_t);  // 16 KiB at 16 words
  multi_hit_words_kernel<<<grid, kTile, stage, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<const uint8_t*>(bases), L, k, n_words,
      static_cast<uint32_t*>(words));
  return launch_status();
}

int s2t_strain_sums(const void* words, int n_windows, int n_words,
                    const void* bounds, int n_reads, int n_strains, void* tot,
                    void* inf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_words) {
#define S2T_SUMS_CASE(N) \
  case N:                \
    return launch_strain_sums<N>(words, n_windows, bounds, n_reads, n_strains, tot, inf, st);
    S2T_SUMS_CASE(1)
    S2T_SUMS_CASE(2)
    S2T_SUMS_CASE(3)
    S2T_SUMS_CASE(4)
    S2T_SUMS_CASE(5)
    S2T_SUMS_CASE(6)
    S2T_SUMS_CASE(7)
    S2T_SUMS_CASE(8)
    S2T_SUMS_CASE(9)
    S2T_SUMS_CASE(10)
    S2T_SUMS_CASE(11)
    S2T_SUMS_CASE(12)
    S2T_SUMS_CASE(13)
    S2T_SUMS_CASE(14)
    S2T_SUMS_CASE(15)
    S2T_SUMS_CASE(16)
#undef S2T_SUMS_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
