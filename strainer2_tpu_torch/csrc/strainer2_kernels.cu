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
//   writes 9 bytes (hi, lo, valid): 0.0031 ms per 256 x 4096 batch. It
//   takes 0.0055 ms, 0.56-0.57 of that bound, where the k-step loop
//   of canonical_window, a byte load and 64-bit shifts a step, took 0.0241
//   (H100 80GB HBM3, 700 W; PERF.md). The batch is one wave of blocks, so
//   the rest is likely the wait for each block's bases before its stores
//   start (not measured apart).
// Design: a block per kK1Windows windows of one row, kK1Windows / 256
//   windows a thread, strided by the block's width so that each warp's
//   stores stay 32 consecutive windows. The block packs its bases once
//   (pack_tile_wide: a 16-byte load and two multiplies a 16-base group;
//   pack_tile's byte loads took 0.0069-0.0071 ms on this tile) and
//   every window's code and validity come from the packed tile in a
//   constant number of steps (packed_window), as in K3 and K6. A 1024-window
//   tile packs 6% halo, where a 256-window tile packs 25%, and a 256 x 4096
//   batch is 1,024 blocks, one wave of the card's 132 SMs at 8 blocks each.
// ---------------------------------------------------------------------------
constexpr int kK1Threads = 256;
constexpr int kK1Windows = 1024;  // windows a block

__global__ void __launch_bounds__(kK1Threads)
canonical_windows_kernel(const uint8_t* __restrict__ bases, int L, int k,
                         uint32_t* __restrict__ hi, uint32_t* __restrict__ lo,
                         uint8_t* __restrict__ valid) {
  __shared__ PackedBases<kK1Windows + 64> tile;
  const int W = L - k + 1;
  const int w0 = blockIdx.x * kK1Windows;
  pack_tile_wide(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
  const int n_lo = min(k, 16);
  const size_t o = static_cast<size_t>(blockIdx.y) * W + w0;
#pragma unroll
  for (int j = 0; j < kK1Windows / kK1Threads; ++j) {
    const int p = threadIdx.x + j * kK1Threads;
    if (w0 + p < W) {
      uint32_t h, l;
      const bool ok = packed_window(tile, p, k, n_lo, &h, &l);
      hi[o + p] = h;
      lo[o + p] = l;
      valid[o + p] = ok;
    }
  }
}

// ---------------------------------------------------------------------------
// K2 bucket_lookup
//
// Replaces: bucket_lookup_pallas_gridmap, strainer2_tpu/ops/pallas_lookup.py:93
//   (one row DMA per query, vector compare of the 16 cells).
// Bound on this card: random DRAM accesses. A query reads the 16 key_hi
//   lanes of its row (64 bytes at a hashed address; a 512 MiB table does
//   not fit the 50 MB L2), then, only where one matches, the 16 key_lo
//   lanes and, on a hit, one meta lane: two more random accesses. The
//   card serves ~30 G random reads of up to 64 bytes a second there
//   (PERF.md), so a query set of mostly misses costs about one access a
//   query, one of hits three. On an H100 80GB HBM3 at 700 W (PERF.md):
//   the 1.04 M window codes of a counting batch (~25% found) 0.0570 ms,
//   0.53 of the byte bound, where reading key_lo lanes on every query took
//   0.0806; strain_detect's 67,000 present keys 0.0104 ms either way.
// Design: one thread per query, the probe of K3, K4 and K6 (match_mask:
//   key_hi lanes first, four 16-byte loads each half); the first equal
//   cell is the lowest set bit of the 16-bit match mask (__ffs), and meta
//   the sum over its set bits (meta_sum). Where not found: slot = bucket *
//   16 and meta = 0, exactly what the jnp bucket_lookup returns there. More queries a thread do not pay: the
//   limit is the rate of random accesses, not their latency (K3's
//   variants, PERF.md).
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
  meta[q] = m ? meta_sum(row + kMetaLane, m) : 0u;
}

// ---------------------------------------------------------------------------
// K3 count_step
//
// Replaces: the XLA program engine._count_step_bucket +
//   ops/lookup.accumulate_counts (strainer2_tpu/pipeline/engine.py:324-327,
//   strainer2_tpu/ops/lookup.py:104-116): extract, probe, counts[slot] += 1.
// Bound on this card: random DRAM accesses. A valid window reads its row's
//   64 bytes of key_hi lanes (and 64 of key_lo lanes where one matches)
//   at a hashed address of a 512 MiB table; a hit adds into a 128 MiB
//   count buffer. On an H100 80GB HBM3 at 700 W, random reads of 32 or 64
//   bytes there run at ~30 G/s whatever their size, 0.58 of the byte rate
//   at 64 bytes, and random atomicAdds into 128 MiB at ~15.6 G/s (a sector
//   read, then written back) (PERF.md). So a batch of misses can reach
//   ~0.55 of the byte bound, and one where half the valid windows hit
//   ~0.35: its hits cost three more random accesses each.
// Design: a block per 256 windows of one row. The block packs its bases
//   once into 2-bit words and an invalid-base mask in shared memory
//   (pack_tile), so a window's canonical code and validity take a
//   constant number of instructions (packed_window): the k-step byte loop
//   took 0.024 ms a batch on its own, as long as the probes of a `targets`
//   batch; packed, 0.0076. Then one probe a thread, key_hi lanes first
//   (probe_window), so a miss reads 64 bytes, not 128. Two or four
//   windows a thread, more probes in flight, were slower: the rate of
//   random accesses is the limit, not their latency. A hit is one
//   atomicAdd on uint32, which wraps like the JAX scatter-add; integer
//   adds commute, so the count bytes do not depend on the order the
//   atomics land in.
// ---------------------------------------------------------------------------
// probe_window that also says whether the window is valid (K3 with its
// valid count, K8, K9).
__device__ __forceinline__ unsigned probe_valid_window(const PackedTile& t, int p,
                                                       const uint32_t* rows, int row_width,
                                                       int h_bits, uint32_t salt, int w0,
                                                       int W, int k, uint32_t* bucket,
                                                       bool* valid) {
  uint32_t h, l;
  *valid = w0 + p < W && packed_window(t, p, k, min(k, 16), &h, &l);
  if (!*valid) return 0u;
  *bucket = bucket_of(h, l, h_bits, salt);
  return match_mask(rows + static_cast<size_t>(*bucket) * row_width, h, l);
}

// One block of K3. kCountValid adds the tile's valid windows into its own
// slot of the caller's int64 tally (strain-track); the false instance is
// the count step of every other path and compiles to the instructions it
// had before the flag.
template <bool kCountValid>
__device__ __forceinline__ void count_step_tile(uint32_t* __restrict__ counts,
                                                const uint32_t* __restrict__ rows,
                                                int row_width, int h_bits, uint32_t salt,
                                                const uint8_t* __restrict__ bases, int L, int k,
                                                long long* __restrict__ tally) {
  __shared__ PackedTile tile;
  const int w0 = blockIdx.x * kTile;
  uint32_t b;
  if constexpr (kCountValid) {
    // the slot is read before the tile is packed, so its latency hides
    // behind the probe; no other block of the launch touches it
    const size_t t = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    const long long before = threadIdx.x == 0 ? tally[t] : 0;
    pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
    bool valid;
    const unsigned m = probe_valid_window(tile, threadIdx.x, rows, row_width, h_bits, salt, w0,
                                          L - k + 1, k, &b, &valid);
    if (m) atomicAdd(counts + static_cast<size_t>(b) * kKeysPerBucket + (__ffs(m) - 1), 1u);
    const int n_valid = __syncthreads_count(valid);
    if (threadIdx.x == 0 && n_valid) tally[t] = before + n_valid;
  } else {
    pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
    const unsigned m = probe_window(tile, threadIdx.x, rows, row_width, h_bits, salt, w0,
                                    L - k + 1, k, &b);
    if (m) atomicAdd(counts + static_cast<size_t>(b) * kKeysPerBucket + (__ffs(m) - 1), 1u);
  }
}

__global__ void __launch_bounds__(kTile)
count_step_kernel(uint32_t* __restrict__ counts, const uint32_t* __restrict__ rows,
                  int row_width, int h_bits, uint32_t salt,
                  const uint8_t* __restrict__ bases, int L, int k) {
  count_step_tile<false>(counts, rows, row_width, h_bits, salt, bases, L, k, nullptr);
}

// K3 with a valid-window count.
// Replaces: the XLA program engine._count_valid_step_bucket
//   (strainer2_tpu/pipeline/engine.py:330-334): K3's function and
//   jnp.sum(win.valid), the metagenome scan of strain-track.
// Bound on this card: K3's, and a tally slot a tile read and written.
// Design: K3's block; the tile's valid windows (__syncthreads_count) go
//   into slot blockIdx.y * gridDim.x + blockIdx.x of an int64 tally that
//   the caller zeroes once a stream, by a plain load and store of one
//   thread: one block a launch owns each slot, and launches on one stream
//   are ordered, so no atomic is needed. The stream's total is read once,
//   at its end, by valid_tally_total_kernel. It runs within 0.0004 ms of
//   K3 (k = 31: 0.0290-0.0291 ms a `targets` batch, 0.0357 a `count` one;
//   H100 80GB HBM3, 700 W; PERF.md). The first form zeroed one int32 with
//   a memset and added every tile into it by atomicAdd: 4,096 adds a batch
//   on one word behind K3's random atomics cost 0.0051 ms a `targets`
//   batch and 0.016 a `count` one over K3.
__global__ void __launch_bounds__(kTile)
count_valid_step_kernel(uint32_t* __restrict__ counts, const uint32_t* __restrict__ rows,
                        int row_width, int h_bits, uint32_t salt,
                        const uint8_t* __restrict__ bases, int L, int k,
                        long long* __restrict__ tally) {
  count_step_tile<true>(counts, rows, row_width, h_bits, salt, bases, L, k, tally);
}

constexpr int kTotalThreads = 1024;

// The sum of the n slots of a valid-window tally, into *total: one block,
// strided loads, then warp shuffles.
__global__ void __launch_bounds__(kTotalThreads)
valid_tally_total_kernel(const long long* __restrict__ tally, int n,
                         long long* __restrict__ total) {
  __shared__ long long warp_sums[kTotalThreads / 32];
  long long s = 0;
  for (int i = threadIdx.x; i < n; i += kTotalThreads) s += tally[i];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = warp_sums[threadIdx.x];
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) *total = s;
  }
}

// ---------------------------------------------------------------------------
// K8 hit_accumulate
//
// Replaces: the XLA program engine._hit_accum_bucket + _accum_from_masks
//   (strainer2_tpu/pipeline/engine.py:343-345, :252-258): extract, probe,
//   and (hits, valid windows) of the batch added to a (2,) accumulator;
//   genome_compare's fullmap batches.
// Bound on this card: random DRAM accesses, as K3's: the bases, a 64-byte
//   key_hi probe a valid window and 64 bytes of key_lo where one matches.
//   Nothing a window is written.
// Design: K3's block (a 256-window tile of one row, the packed tile, the
//   key_hi-first probe); the tile's hits and valid windows are two
//   __syncthreads_count, and one thread adds them into the int64
//   accumulator (two atomicAdds a block on two addresses), which stays on
//   the card across a file and is read once at its end. int64 keeps the
//   totals exact on any file: the JAX program's int32 lanes needed a host
//   spill every 1024 batches.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kTile)
hit_accumulate_kernel(unsigned long long* __restrict__ acc, const uint32_t* __restrict__ rows,
                      int row_width, int h_bits, uint32_t salt,
                      const uint8_t* __restrict__ bases, int L, int k) {
  __shared__ PackedTile tile;
  const int w0 = blockIdx.x * kTile;
  pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
  uint32_t b;
  bool valid;
  const bool hit = probe_valid_window(tile, threadIdx.x, rows, row_width, h_bits, salt, w0,
                                      L - k + 1, k, &b, &valid) != 0;
  const int n_hit = __syncthreads_count(hit);
  const int n_valid = __syncthreads_count(valid);
  if (threadIdx.x == 0) {
    if (n_hit) atomicAdd(acc, static_cast<unsigned long long>(n_hit));
    if (n_valid) atomicAdd(acc + 1, static_cast<unsigned long long>(n_valid));
  }
}

// ---------------------------------------------------------------------------
// K4 classify_step
//
// Replaces: the XLA program engine._classify_step_bucket
//   (strainer2_tpu/pipeline/engine.py:353-364): extract, probe, then each
//   read's (total, informative) hits as differences of a global prefix sum
//   at the read boundaries.
// Bound on this card: the probe's random DRAM access. A probe must read
//   the 16 key_hi lanes of its row (64 bytes); only where one of them
//   equals the query does it need the 16 key_lo lanes (64 more) and, on a
//   hit, one meta lane. Real reads are ~1% strain, so nearly every probe
//   stops at 64 bytes.
// Design: the JAX formulation, in three launches.
//   1. classify_masks: K3's shape, a block per 256-window tile of one row,
//      the bases in shared memory, one thread per window making one
//      independent probe, hi lanes first; informative where the meta sum
//      (meta_sum) equals kInformative; hit and informative become bits
//      by __ballot_sync, 8 words a tile (tiles padded to whole words), and
//      each tile's two counts come from __syncthreads_count.
//   2. classify_scan: one block turns the tile counts (4,096 per 256 x 4096
//      batch) into exclusive prefixes, plus the totals.
//   3. classify_sums: a thread per read; the prefix at window x (row r,
//      column c) is the tile prefix of tile (r, c / 256) plus the popcounts
//      of its mask words below c (one 32-byte sector), and a read's sums
//      are P(b[r+1]) - P(b[r]). Boundaries are read as the JAX gather reads
//      them (gather_index), so clamped and reversed spans come out as
//      there, by construction.
// ---------------------------------------------------------------------------
constexpr int kTileWords = kTile / 32;  // mask words a tile

__global__ void classify_masks_kernel(const uint32_t* __restrict__ rows,
                                      int row_width, int h_bits, uint32_t salt,
                                      const uint8_t* __restrict__ bases, int L,
                                      int k, uint32_t* __restrict__ hit_mask,
                                      uint32_t* __restrict__ inf_mask,
                                      int32_t* __restrict__ tile_hits,
                                      int32_t* __restrict__ tile_infs) {
  __shared__ uint8_t tile[kTile + kMaxK];
  const int W = L - k + 1;
  const int row = blockIdx.y;
  const int w0 = blockIdx.x * kTile;
  load_tile(tile, bases + static_cast<size_t>(row) * L, w0, L, k);
  const int w = w0 + threadIdx.x;
  bool hit = false, informative = false;
  uint32_t h, l;
  if (w < W && canonical_window(tile + threadIdx.x, k, min(k, 16), &h, &l)) {
    const uint32_t* r = rows + static_cast<size_t>(bucket_of(h, l, h_bits, salt)) * row_width;
    unsigned m = lanes_equal(r, h);                // key_hi lanes
    if (m) m &= lanes_equal(r + kKeysPerBucket, l);  // key_lo lanes, only then
    if (m) {
      hit = true;
      informative = meta_sum(r + kMetaLane, m) == kInformative;
    }
  }
  const unsigned hm = __ballot_sync(0xffffffffu, hit);
  const unsigned im = __ballot_sync(0xffffffffu, informative);
  const size_t t = static_cast<size_t>(row) * gridDim.x + blockIdx.x;
  if ((threadIdx.x & 31) == 0) {
    hit_mask[t * kTileWords + (threadIdx.x >> 5)] = hm;
    inf_mask[t * kTileWords + (threadIdx.x >> 5)] = im;
  }
  const int n_hit = __syncthreads_count(hit);
  const int n_inf = __syncthreads_count(informative);
  if (threadIdx.x == 0) {
    tile_hits[t] = n_hit;
    tile_infs[t] = n_inf;
  }
}

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;  // tiles per thread and pass: one pass per 256 x 4096 batch

// Exclusive prefixes of the n tile counts, and the totals at [n]; one
// block, a pass per kScanThreads * kScanItems tiles.
__global__ void __launch_bounds__(kScanThreads)
classify_scan_kernel(const int32_t* __restrict__ c_hit, const int32_t* __restrict__ c_inf,
                     int n, int32_t* __restrict__ p_hit, int32_t* __restrict__ p_inf) {
  __shared__ int2 warp_sums[kScanThreads / 32];
  __shared__ int2 carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = make_int2(0, 0);
  __syncthreads();
  for (int base = 0; base < n; base += kScanThreads * kScanItems) {
    const int i0 = base + threadIdx.x * kScanItems;
    int ch[kScanItems], ci[kScanItems];
    int sh = 0, si = 0;
#pragma unroll
    for (int t = 0; t < kScanItems; ++t) {
      const int i = i0 + t;
      ch[t] = i < n ? c_hit[i] : 0;
      ci[t] = i < n ? c_inf[i] : 0;
      sh += ch[t];
      si += ci[t];
    }
    int xh = sh, xi = si;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int yh = __shfl_up_sync(0xffffffffu, xh, off);
      const int yi = __shfl_up_sync(0xffffffffu, xi, off);
      if (lane >= off) {
        xh += yh;
        xi += yi;
      }
    }
    if (lane == 31) warp_sums[warp] = make_int2(xh, xi);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the warp totals
      const int2 v = warp_sums[lane];
      int zh = v.x, zi = v.y;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int yh = __shfl_up_sync(0xffffffffu, zh, off);
        const int yi = __shfl_up_sync(0xffffffffu, zi, off);
        if (lane >= off) {
          zh += yh;
          zi += yi;
        }
      }
      warp_sums[lane] = make_int2(zh - v.x, zi - v.y);
    }
    __syncthreads();
    int eh = carry.x + warp_sums[warp].x + xh - sh;
    int ei = carry.y + warp_sums[warp].y + xi - si;
#pragma unroll
    for (int t = 0; t < kScanItems; ++t) {
      const int i = i0 + t;
      if (i < n) {
        p_hit[i] = eh;
        p_inf[i] = ei;
      }
      eh += ch[t];
      ei += ci[t];
    }
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == kScanThreads - 1) carry = make_int2(eh, ei);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    p_hit[n] = carry.x;
    p_inf[n] = carry.y;
  }
}

// Hits before flat window x (row-major, W windows a row, tpr tiles a row).
__device__ __forceinline__ int prefix_at(const int32_t* __restrict__ p,
                                         const uint32_t* __restrict__ mask,
                                         int x, int W, int tpr) {
  const int r = x / W;
  const int c = x - r * W;
  const int t = r * tpr + (c >> 8);
  const int within = c & (kTile - 1);
  int v = __ldg(p + t);
  if (within) {
    const uint4* m4 = reinterpret_cast<const uint4*>(mask + static_cast<size_t>(t) * kTileWords);
    const uint4 a = __ldg(m4), b = __ldg(m4 + 1);
    const uint32_t m[kTileWords] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const int word = within >> 5;
    const uint32_t below = (1u << (within & 31)) - 1u;
#pragma unroll
    for (int j = 0; j < kTileWords; ++j)
      v += j < word ? __popc(m[j]) : j == word ? __popc(m[j] & below) : 0;
  }
  return v;
}

__global__ void classify_sums_kernel(const int32_t* __restrict__ p_hit,
                                     const int32_t* __restrict__ p_inf,
                                     const uint32_t* __restrict__ hit_mask,
                                     const uint32_t* __restrict__ inf_mask,
                                     int n_rows, int W, int tpr,
                                     const int32_t* __restrict__ bounds,
                                     int max_reads, int32_t* __restrict__ tot,
                                     int32_t* __restrict__ inf) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= max_reads) return;
  const int q = n_rows * W;
  const int a = gather_index(bounds[r], q);
  const int e = gather_index(bounds[r + 1], q);
  tot[r] = prefix_at(p_hit, hit_mask, e, W, tpr) - prefix_at(p_hit, hit_mask, a, W, tpr);
  inf[r] = prefix_at(p_inf, inf_mask, e, W, tpr) - prefix_at(p_inf, inf_mask, a, W, tpr);
}

// ---------------------------------------------------------------------------
// K9 hit_stats
//
// Replaces: the XLA program engine._hit_stats_bucket + _stats_from_masks
//   (strainer2_tpu/pipeline/engine.py:348-350, :261-276): extract, probe,
//   then the batch's (hits, valid windows), the flat index row * W + col of
//   its remaining-th valid window (jnp.searchsorted over the valid prefix:
//   0 where remaining <= 0, -1 where the batch ends first) and the
//   inclusive hit prefix there (0 where it ends first); genome_compare's
//   rapid-mode batches before the decision.
// Bound on this card: the probe's random DRAM accesses, as K8's; the
//   function needs no mask words (they are this design's scratch).
// Design: two launches joined by programmatic dependent launch (PDL). The
//   first form ran K4's three launches (masks, a one-block scan, a
//   one-block locate): the two serial one-block nodes cost a fixed ~0.009
//   ms a call over K8 (H100 80GB HBM3, 700 W; PERF.md).
//   1. hit_stats_kernel, K8's block: K3's packed tile and key_hi-first
//      probe; hit and valid become bits by __ballot_sync, 8 words a tile
//      each, and the tile's two counts come from __syncthreads_count.
//      Thread 0 stores the 16 words and the counts packed in one word.
//      Each block first lets the dependent launch start
//      (griddepcontrol.launch_dependents).
//   2. hit_crossing_kernel, one block, launched with
//      cudaLaunchAttributeProgrammaticStreamSerialization: it is resident
//      before the masks launch ends and waits in griddepcontrol.wait, which
//      returns once that launch has finished and its stores are visible.
//      It reads every tile's count word, kStatItems a thread held in
//      registers, and scans their sums over the block; the one thread
//      whose tiles hold the crossing (p_valid[t] < remaining <= p_valid[t
//      + 1]) picks the tile from its registers and walks the tile's valid
//      words by popcount to the window. No prefix array is written; the
//      block waits on two L2 round trips, the counts, then the crossing
//      tile's words (a first form re-read a thread's counts one by one, a
//      chain of L2 round trips). The edge survives CUDA-graph capture.
//   A `targets` batch at k = 20 takes 0.0348-0.0350 ms, K8 + 0.0031-0.0033,
//   0.50 of the bound (H100 80GB HBM3, 700 W; PERF.md). One launch whose
//   last block ran the same epilogue, found by a ticket from a device
//   counter (__threadfence + atomicAdd, or one acq_rel atomic, a block),
//   took 0.0028-0.0038 ms more: 4,096 returning atomics that each hold
//   their block until they return.
// ---------------------------------------------------------------------------
constexpr int kStatItems = 16;  // tile counts a thread scans in one pass: one pass per 256 x 4096 batch

// (hits, flat index) of the need-th valid window of tile t (need >= 1),
// whose hit and valid words are the 16 words at m, hits the hits before
// the tile; tpr tiles a row of W windows.
__device__ __forceinline__ int2 locate_in_tile(const uint32_t* m, int t, int need, int hits,
                                               int W, int tpr) {
  const uint4* m4 = reinterpret_cast<const uint4*>(m);
  const uint4 h0 = __ldcg(m4), h1 = __ldcg(m4 + 1), v0 = __ldcg(m4 + 2), v1 = __ldcg(m4 + 3);
  const uint32_t hw[kTileWords] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const uint32_t vw[kTileWords] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  int word = -1;
  uint32_t mv = 0, mh = 0;
#pragma unroll
  for (int j = 0; j < kTileWords; ++j) {
    if (word < 0) {
      const int pv = __popc(vw[j]);
      if (need <= pv) {
        word = j;
        mv = vw[j];
        mh = hw[j];
      } else {
        need -= pv;
        hits += __popc(hw[j]);
      }
    }
  }
  for (int i = 1; i < need; ++i) mv &= mv - 1u;
  const int bit = __ffs(mv) - 1;
  hits += __popc(mh & ((2u << bit) - 1u));  // bits 0..bit; 2u << 31 wraps to 0
  const int r = t / tpr;
  return make_int2(hits, r * W + (t - r * tpr) * kTile + 32 * word + bit);
}

// The four results of K9 from its n tiles' packed counts (hits << 16 |
// valid) and mask words, by one block of kTile threads (warp_sums: kTile
// / 32 entries of shared memory). Counts and words are read through the
// L2 (__ldcg): the masks launch wrote them while this block waited.
__device__ __forceinline__ void crossing_epilogue(const uint32_t* masks,
                                                  const uint32_t* tile_counts, int n, int W,
                                                  int tpr, int remaining, int32_t* out,
                                                  int2* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry_h = 0, carry_v = 0;  // the same in every thread
  for (int base = 0; base < n; base += kTile * kStatItems) {
    const int i0 = base + threadIdx.x * kStatItems;
    uint32_t c[kStatItems];
    if (i0 + kStatItems <= n) {
      const uint4* c4 = reinterpret_cast<const uint4*>(tile_counts + i0);
#pragma unroll
      for (int j = 0; j < kStatItems / 4; ++j) {
        const uint4 q = __ldcg(c4 + j);
        c[4 * j] = q.x;
        c[4 * j + 1] = q.y;
        c[4 * j + 2] = q.z;
        c[4 * j + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kStatItems; ++j) c[j] = i0 + j < n ? __ldcg(tile_counts + i0 + j) : 0u;
    }
    uint32_t packed = 0;  // each half <= kStatItems * kTile: no carry between them
#pragma unroll
    for (int j = 0; j < kStatItems; ++j) packed += c[j];
    const int sh = packed >> 16, sv = packed & 0xffff;
    int xh = sh, xv = sv;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int yh = __shfl_up_sync(0xffffffffu, xh, off);
      const int yv = __shfl_up_sync(0xffffffffu, xv, off);
      if (lane >= off) {
        xh += yh;
        xv += yv;
      }
    }
    if (lane == 31) warp_sums[warp] = make_int2(xh, xv);
    __syncthreads();
    int eh = carry_h + xh - sh, ev = carry_v + xv - sv;  // before this thread's tiles
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) {
      const int2 s = warp_sums[w];
      if (w < warp) {
        eh += s.x;
        ev += s.y;
      }
      carry_h += s.x;
      carry_v += s.y;
    }
    if (ev < remaining && remaining <= ev + sv) {  // the crossing is in this thread's tiles
      int t = -1;
#pragma unroll
      for (int j = 0; j < kStatItems; ++j) {
        if (t < 0) {
          const int v = c[j] & 0xffff;
          if (remaining <= ev + v) {
            t = i0 + j;
          } else {
            ev += v;
            eh += c[j] >> 16;
          }
        }
      }
      const int2 r = locate_in_tile(masks + static_cast<size_t>(t) * 2 * kTileWords, t,
                                    remaining - ev, eh, W, tpr);
      out[2] = r.x;
      out[3] = r.y;
    }
    __syncthreads();  // warp_sums is written again in the next pass
  }
  if (threadIdx.x == 0) {
    out[0] = carry_h;
    out[1] = carry_v;
    if (remaining <= 0) {  // searchsorted gives 0: the first window, valid or not
      out[2] = static_cast<int32_t>(__ldcg(masks) & 1u);
      out[3] = 0;
    } else if (remaining > carry_v) {  // the batch ends first
      out[2] = 0;
      out[3] = -1;
    }
  }
}

// masks: 16 words a tile (hit, then valid); tile_counts: hits << 16 |
// valid, a word a tile.
__global__ void __launch_bounds__(kTile)
hit_stats_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits, uint32_t salt,
                 const uint8_t* __restrict__ bases, int L, int k,
                 uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_counts) {
  __shared__ PackedTile tile;
  __shared__ __align__(16) uint32_t words[2 * kTileWords];
  asm volatile("griddepcontrol.launch_dependents;");
  const int w0 = blockIdx.x * kTile;
  pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
  uint32_t b;
  bool valid;
  const bool hit = probe_valid_window(tile, threadIdx.x, rows, row_width, h_bits, salt, w0,
                                      L - k + 1, k, &b, &valid) != 0;
  const unsigned hm = __ballot_sync(0xffffffffu, hit);
  const unsigned vm = __ballot_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0) {
    words[threadIdx.x >> 5] = hm;
    words[kTileWords + (threadIdx.x >> 5)] = vm;
  }
  const int n_hit = __syncthreads_count(hit);  // also orders the words above
  const int n_valid = __syncthreads_count(valid);
  if (threadIdx.x == 0) {
    const int t = blockIdx.y * gridDim.x + blockIdx.x;
    uint4* m4 = reinterpret_cast<uint4*>(masks + static_cast<size_t>(t) * 2 * kTileWords);
    const uint4* w4 = reinterpret_cast<const uint4*>(words);
#pragma unroll
    for (int j = 0; j < 4; ++j) m4[j] = w4[j];
    tile_counts[t] = static_cast<uint32_t>(n_hit) << 16 | static_cast<uint32_t>(n_valid);
  }
}

// out = (batch hits, batch valid windows, hits at the crossing, its flat
// index), from the n tiles of hit_stats_kernel, the launch before it.
__global__ void __launch_bounds__(kTile)
hit_crossing_kernel(const uint32_t* __restrict__ masks, const uint32_t* __restrict__ tile_counts,
                    int n, int W, int tpr, int remaining, int32_t* __restrict__ out) {
  __shared__ int2 warp_sums[kTile / 32];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  crossing_epilogue(masks, tile_counts, n, W, tpr, remaining, out, warp_sums);
}

}  // namespace

extern "C" {

int s2t_canonical_windows(const void* bases, int rows, int L, int k, void* hi,
                          void* lo, void* valid, void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kK1Windows - 1) / kK1Windows, rows);
  canonical_windows_kernel<<<grid, kK1Threads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// tally: int64 slots, at least n_rows x ceil(W / 256); each tile adds its
// valid windows into its own slot (no memset: the caller zeroes it once).
int s2t_count_valid_step(void* counts, const void* rows, int row_width, int h_bits,
                         uint32_t salt, const void* bases, int n_rows, int L, int k,
                         void* tally, void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, n_rows);
  count_valid_step_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counts), static_cast<const uint32_t*>(rows),
      row_width, h_bits, salt, static_cast<const uint8_t*>(bases), L, k,
      static_cast<long long*>(tally));
  return launch_status();
}

// total: one int64, the sum of the n int64 slots of tally.
int s2t_valid_tally_total(const void* tally, int n, void* total, void* stream) {
  valid_tally_total_kernel<<<1, kTotalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(tally), n, static_cast<long long*>(total));
  return launch_status();
}

// acc: two int64, (hits, valid windows), added to in place.
int s2t_hit_accumulate(void* acc, const void* rows, int row_width, int h_bits,
                       uint32_t salt, const void* bases, int n_rows, int L, int k,
                       void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, n_rows);
  hit_accumulate_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(acc), static_cast<const uint32_t*>(rows),
      row_width, h_bits, salt, static_cast<const uint8_t*>(bases), L, k);
  return launch_status();
}

// masks: n_tiles x 16 uint32 scratch (a tile's hit words, then its valid
// words), 16-byte aligned; tile_counts: n_tiles uint32 scratch, 16-byte
// aligned; out: four int32; n_tiles = n_rows x ceil(W / 256), n_rows >= 1.
int s2t_hit_stats(const void* rows, int row_width, int h_bits, uint32_t salt,
                  const void* bases, int n_rows, int L, int k, int remaining,
                  void* masks, void* tile_counts, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = L - k + 1;
  const int tpr = (W + kTile - 1) / kTile;
  uint32_t* m = static_cast<uint32_t*>(masks);
  uint32_t* c = static_cast<uint32_t*>(tile_counts);
  hit_stats_kernel<<<dim3(tpr, n_rows), kTile, 0, st>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<const uint8_t*>(bases), L, k, m, c);
  const int rc = launch_status();
  if (rc != 0) return rc;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kTile);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t rc2 = cudaLaunchKernelEx(&cfg, hit_crossing_kernel, m, c, n_rows * tpr, W,
                                             tpr, remaining, static_cast<int32_t*>(out));
  return rc2 != cudaSuccess ? static_cast<int>(rc2) : launch_status();
}

// masks: 2 x n_tiles x 8 uint32 scratch (hit, then informative), 32-byte
// aligned; counts: 2 x n_tiles + 2 x (n_tiles + 1) int32 scratch (tile
// counts, then their prefixes); n_tiles = n_rows x ceil(W / 256).
int s2t_classify_step(const void* rows, int row_width, int h_bits,
                      uint32_t salt, const void* bases, int n_rows, int L,
                      int k, const void* bounds, int max_reads, void* masks,
                      void* counts, void* tot, void* inf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = L - k + 1;
  const int tpr = (W + kTile - 1) / kTile;
  const int n = n_rows * tpr;
  uint32_t* hit_mask = static_cast<uint32_t*>(masks);
  uint32_t* inf_mask = hit_mask + static_cast<size_t>(n) * kTileWords;
  int32_t* c_hit = static_cast<int32_t*>(counts);
  int32_t* c_inf = c_hit + n;
  int32_t* p_hit = c_inf + n;
  int32_t* p_inf = p_hit + n + 1;
  if (n_rows) {
    classify_masks_kernel<<<dim3(tpr, n_rows), kTile, 0, st>>>(
        static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
        static_cast<const uint8_t*>(bases), L, k, hit_mask, inf_mask, c_hit, c_inf);
  }
  classify_scan_kernel<<<1, kScanThreads, 0, st>>>(c_hit, c_inf, n, p_hit, p_inf);
  const int threads = 256;
  classify_sums_kernel<<<(max_reads + threads - 1) / threads, threads, 0, st>>>(
      p_hit, p_inf, hit_mask, inf_mask, n_rows, W, tpr,
      static_cast<const int32_t*>(bounds), max_reads, static_cast<int32_t*>(tot),
      static_cast<int32_t*>(inf));
  return launch_status();
}

}  // extern "C"
