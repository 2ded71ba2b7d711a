// Hand-written Hopper (sm_90a) kernels of the lookup A/B tool and of the
// multi-strain detection path (strainer2_tools detect-multi).
//
// Built by strainer2_tpu_torch/ops/_build.py like strainer2_kernels.cu
// (nvcc -gencode arch=compute_90a,code=sm_90a, plain C entry points bound
// with ctypes); every entry point launches on the stream it is given,
// allocates nothing, and returns cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_device.cuh"

using namespace s2t;

namespace {

// ---------------------------------------------------------------------------
// K5 bucket_lookup_ring
//
// Replaces: bucket_lookup_pallas_manual, strainer2_tpu/ops/pallas_lookup.py:211
//   (a hand-rolled ring of W row DMAs per group, D groups outstanding, one
//   DMA semaphore a slot).
// Bound on this card: random DRAM accesses, as K2: a query reads the 16
//   key_hi lanes of its row (64 bytes at a hashed address of a table far
//   larger than the 50 MB L2), and only where one matches the 16 key_lo
//   lanes and, on a hit, a meta lane. The card serves ~30 G such reads a
//   second (PERF.md), but this kernel meets another limit first: its
//   64-byte bulk copies run at ~14 G a second on an H100 80GB HBM3 at
//   700 W, whatever the query mix or block shape (0.0741-0.0746 ms on the
//   1.04 M window codes of a counting batch, where K2's plain loads take
//   0.0570 and four 16-byte cp.async pieces a query 0.090; PERF.md).
// Design: a ring is a team of min(w, 32) lanes of one warp (32 / that many
//   teams a warp) that walks its own run of a block's chunk in groups of w
//   queries, up to D groups in flight. Lane j of a team issues one 64-byte
//   bulk async copy (cp.async.bulk, the TMA's one-dimensional form) of the
//   key_hi lanes of query j's row (and of j + 32's where w > 32) into the
//   group's stage, and one mbarrier a stage counts the group's bytes
//   (arrive.expect_tx), as the Pallas ring's semaphores count its row DMAs.
//   When a stage's phase completes, each lane compares its query's key_hi
//   lanes in shared memory; only where one matches does it read the key_lo
//   lanes, and on a hit the meta lanes, from global memory (__ldg, K2's
//   match_mask and meta_sum). So a miss moves 64 bytes where the parent's
//   12 cp.async pieces moved 192, hit or miss. Then the lane refills the
//   stage. A block splits its chunk over as many rings as 8 warps and
//   48 KiB of stages hold, so a block keeps about as many queries in
//   flight as K2's 256 threads do. The warp waits on its teams' stages
//   together (__all_sync), so its teams stay converged. Results are K2's:
//   the first equal cell by __ffs, the meta sum over equal cells, and slot
//   = bucket * 16, meta = 0 where not found (the jnp values; the Pallas
//   kernel returns bucket * 16 + 16 there).
// ---------------------------------------------------------------------------
constexpr int kRowSpan = kKeysPerBucket * sizeof(uint32_t);  // a row's key_hi lanes, bytes
constexpr int kRingWarps = 8;                                // warps a block, at most
constexpr int kRingSmem = 48 * 1024;                         // stage bytes a block, at most

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Wait-free test of the phase of parity `parity` of the barrier.
__device__ __forceinline__ bool mbar_done(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// This lane's part of a group: its arrival on the stage's barrier, owing
// the bytes of its copies, then one 64-byte bulk copy a query it holds.
__device__ __forceinline__ void ring_issue(uint4* stage, uint64_t* bar, const uint32_t* rows,
                                           int row_width, int h_bits, uint32_t salt,
                                           const uint32_t* qhi, const uint32_t* qlo,
                                           int64_t q, int w, int t) {
  const unsigned bytes = kRowSpan * ((w - 1 - t) / 32 + 1);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  for (int j = t; j < w; j += 32) {
    const uint32_t b = bucket_of(__ldg(qhi + q + j), __ldg(qlo + q + j), h_bits, salt);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_u32(stage + j * (kRowSpan / 16))),
        "l"(rows + static_cast<size_t>(b) * row_width), "r"(kRowSpan), "r"(smem_u32(bar))
        : "memory");
  }
}

// Bytes of one ring's part of shared memory: its barriers, padded to 16
// bytes, then `stages` stages of w key_hi spans.
__host__ __device__ __forceinline__ int ring_bytes(int stages, int w) {
  return 16 * ((stages + 1) / 2) + stages * w * kRowSpan;
}

__global__ void __launch_bounds__(kRingWarps * 32)
bucket_lookup_ring_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits,
                          uint32_t salt, const uint32_t* __restrict__ qhi,
                          const uint32_t* __restrict__ qlo, int w, int chunk, int rings,
                          int stages, uint8_t* __restrict__ found, int32_t* __restrict__ slot,
                          uint32_t* __restrict__ meta) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  const int tw = min(w, 32);  // lanes a team
  const int team = lane / tw, t = lane - team * tw;
  const int r = (threadIdx.x >> 5) * (32 / tw) + team;  // this lane's ring in the block
  const bool in_ring = team < 32 / tw && r < rings;
  const int ng = chunk / w;
  const int g0 = in_ring ? static_cast<int>(static_cast<int64_t>(r) * ng / rings) : 0;
  const int g1 = in_ring ? static_cast<int>(static_cast<int64_t>(r + 1) * ng / rings) : 0;
  uint4* base = smem + (in_ring ? r : 0) * (ring_bytes(stages, w) / 16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base);
  uint4* stage0 = base + (stages + 1) / 2;
  const int span4 = w * (kRowSpan / 16);  // uint4s a stage
  if (in_ring)
    for (int i = t; i < stages; i += tw) mbar_init(bars + i, tw);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * chunk;
  if (in_ring)
    for (int i = 0; i < stages && g0 + i < g1; ++i)
      ring_issue(stage0 + i * span4, bars + i, rows, row_width, h_bits, salt, qhi, qlo,
                 q0 + static_cast<int64_t>(g0 + i) * w, w, t);
  const int steps = (ng + rings - 1) / rings;  // the most groups a ring has: block-uniform
  int s = 0;
  unsigned parity = 0;
  for (int i = 0; i < steps; ++i) {
    const bool live = in_ring && g0 + i < g1;
    bool ready = !live || mbar_done(bars + s, parity);
    while (!__all_sync(0xffffffffu, ready)) ready = ready || mbar_done(bars + s, parity);
    if (live) {
      const int64_t q = q0 + static_cast<int64_t>(g0 + i) * w;
      for (int j = t; j < w; j += 32) {
        const uint32_t h = __ldg(qhi + q + j), l = __ldg(qlo + q + j);
        const uint32_t b = bucket_of(h, l, h_bits, salt);
        const uint32_t* row = rows + static_cast<size_t>(b) * row_width;
        const uint4* hi4 = stage0 + s * span4 + j * (kRowSpan / 16);
        unsigned m = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) m |= eq4(hi4[c], h) << (4 * c);
        if (m) m &= lanes_equal(row + kKeysPerBucket, l);
        found[q + j] = m != 0;
        slot[q + j] = static_cast<int32_t>(b) * kKeysPerBucket + (m ? __ffs(m) - 1 : 0);
        meta[q + j] = m ? meta_sum(row + kMetaLane, m) : 0u;
      }
    }
    __syncwarp();  // every lane has read stage s before it is refilled
    if (live && g0 + i + stages < g1)
      ring_issue(stage0 + s * span4, bars + s, rows, row_width, h_bits, salt, qhi, qlo,
                 q0 + static_cast<int64_t>(g0 + i + stages) * w, w, t);
    if (++s == stages) {
      s = 0;
      parity ^= 1u;
    }
  }
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
// Design: K3's packed tile and probe (pack_tile, and BucketProbe through
//   probe_valid_window: window codes in constant time, key_hi lanes first,
//   the probe policy of K3, K4, K8 and K9); word j of a hit, j < n_words,
//   is lane 32 + 16 j + cell of its one equal cell, or where a row holds
//   the key twice the sum over its equal cells (meta_sum) on a path of its
//   own: a sum inside the one-cell loop cost up to 40% at 256 strains
//   (PERF.md). The output is window-major,
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
template <class Probe>
__device__ __forceinline__ void multi_hit_words_tile(const Probe& probe,
                                                     const uint8_t* __restrict__ bases, int L,
                                                     int k, int n_words,
                                                     uint32_t* __restrict__ words) {
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
  bool valid;
  const unsigned m = probe_valid_window(tile, threadIdx.x, probe, w0, W, k, &b, &valid);
  if (m) {
    const uint32_t* block = probe.row(b) + kMetaLane;
    uint32_t* dst = stage + off + threadIdx.x * n_words;
    if (m & (m - 1)) {  // a key held twice in its row: no built table holds one
      for (int j = 0; j < n_words; ++j) dst[j] = meta_sum(block + kKeysPerBucket * j, m);
    } else {
      const uint32_t* cell = block + (__ffs(m) - 1);
      for (int j = 0; j < n_words; ++j) dst[j] = __ldg(cell + kKeysPerBucket * j);
    }
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

__global__ void __launch_bounds__(kTile)
multi_hit_words_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits,
                       uint32_t salt, const uint8_t* __restrict__ bases, int L, int k,
                       int n_words, uint32_t* __restrict__ words) {
  multi_hit_words_tile(BucketProbe{rows, row_width, h_bits, salt}, bases, L, k, n_words, words);
}

// ---------------------------------------------------------------------------
// K6s shard_multi_hit_words
//
// Replaces: the probe and masked meta words of
//   ShardedKmerEngine._classify_multi_body_bucket
//   (strainer2_tpu/parallel/sharding.py:265-291, _bucket_local_lookup_words
//   :236-262), the operand of its psum over "index": per window the first
//   n_words meta words of its key where the shard holds the key's bucket
//   and the window is valid, 0 elsewhere; (Q, n_words) uint32, window-major,
//   K6's layout. R adds the I shards' words on the data shard's first
//   device (the psum), then K7 runs unchanged on them.
// Bound on this card: the data shard's bases, the shard's probes (about 1/I
//   of the valid windows; the rest are settled by the hash alone), a hit's
//   n_words meta words, and every window's n_words words written, zeros
//   included: at S = 256 that is 67 MB a 256 x 4096 batch, 0.020 ms at
//   3.35 TB/s, whatever I.
// Design: the block of K3s and K4s (shard_tiles, kmer_device.cuh): tiles
//   of one row packed once by 16-byte loads, each thread taking its window
//   of each tile in turn and probing it only where its bucket is the
//   shard's, under __launch_bounds__(256, 8) (32 registers, 8 blocks an
//   SM). A hit's words are K6's (its one-cell loop, and meta_sum where a
//   row holds the key twice). The host picks the form from n_words
//   (WordsStore), each with the tiles a block that won:
//   - kDirect (n_words 1, 2 or 4: S up to 32, or 49 to 64): four tiles a
//     block, 1,024 blocks a 256 x 4096 batch in one resident wave, as K3s
//     and K4s; a window's words from registers as one 4-, 8- or 16-byte
//     store, so a warp's store is one contiguous run: no shared stage, no
//     barrier after the pack. This cuts the per-batch cost of the first
//     form (K6's one-tile block with ShardBucketProbe: 4,096 blocks in
//     four waves, each a byte-load pack and a zeroed stage): its no-probe
//     pass 0.0097 to 0.0065-0.0066 ms at S = 32.
//   - kWarp (any other n_words): one tile a block (four waves): a warp's
//     32 windows are staged in its own part of shared memory (32 n_words
//     + 4 words, 16.1 KiB a block at 16 words), zeroed before the pack's
//     barrier; after the probe a __syncwarp, then the warp writes its run
//     with consecutive lanes on consecutive 16-byte chunks, evict-first
//     (__stcs: no kernel reads them before they leave the L2); no block
//     barrier after the pack. The head and tail chunks, which a run shares
//     with its neighbours, take 4-byte stores; words stays 16-byte aligned
//     for R's 16-byte loads. At S = 256 the 67 MB of words and the probes'
//     random row reads share the DRAM: with four tiles a block in one wave
//     the shard took 0.0371 ms at I = 4 (0.0394-0.0395 without __stcs),
//     with two 0.0361, with one 0.0354-0.0355, the first form 0.0356
//     (one call).
//   A shard of the whole table (lo = 0, every bucket: I = 1) is K6's work,
//   and the launcher calls K6: these forms took 0.0586 ms there at S = 256
//   against K6's 0.0567-0.0570 (four tiles of kWarp 0.0668 against
//   0.0571), and 0.0325 at S = 32 against 0.0328-0.0329.
//   Shard 0 of a `targets` batch, the first form in the same call: S = 32,
//   I = 2 / 4 0.0180-0.0182 / 0.0125-0.0126 ms against 0.0201-0.0202 /
//   0.0156; S = 256 0.0434-0.0436 / 0.0354 against 0.0430 / 0.0357.
//   Measured beside them and dropped:
//   kDirect at 16 words (four 16-byte stores a window at a 64-byte stride:
//   0.0844 ms at S = 256, I = 4); a tile's 256 windows a stage with two
//   __syncthreads a tile (S = 32 0.0151, S = 256 0.0394); the block's
//   1,024 windows a stage, one barrier after the four tiles (S = 32
//   0.0134; n_words <= 6 only); kWarp at S = 32 (0.0149). After a cuckoo
//   probe in the same process (its L2 window leaves the fingerprints'
//   lines persisting) every form at S = 256 took 29-41% longer (H100 80GB
//   HBM3, 700 W; bench_kernels.py --shard; PERF.md).
// ---------------------------------------------------------------------------
enum class WordsStore { kDirect, kWarp };

// K6s's store form for n_words words a window (the note above), and the
// tiles a block of each form takes.
WordsStore words_store(int n_words) {
  return n_words == 1 || n_words == 2 || n_words == 4 ? WordsStore::kDirect : WordsStore::kWarp;
}
template <WordsStore kStore>
constexpr int kWordsTiles = kStore == WordsStore::kDirect ? kShardTiles : 1;

// Dynamic shared memory of a K6s block: kWarp's stages, one a warp.
size_t words_stage_bytes(WordsStore store, int n_words) {
  return store == WordsStore::kWarp ? static_cast<size_t>(kTile / 32) * (8 * n_words + 1) * 16 : 0;
}

// A hit's n_words words into dst, as K6 writes them: word j is lane
// 32 + 16 j of the key's one equal cell (block = its row's first meta lane,
// m the mask of its equal cells), or the sum over its cells where a row
// holds the key twice.
__device__ __forceinline__ void hit_words(uint32_t* dst, const uint32_t* block, unsigned m,
                                          int n_words) {
  if (m & (m - 1)) {  // a key held twice in its row: no built table holds one
    for (int j = 0; j < n_words; ++j) dst[j] = meta_sum(block + kKeysPerBucket * j, m);
  } else {
    const uint32_t* cell = block + (__ffs(m) - 1);
    for (int j = 0; j < n_words; ++j) dst[j] = __ldg(cell + kKeysPerBucket * j);
  }
}

// kDirect: a window's V words (0 where m is 0) as one V-word store.
template <int V>
__device__ __forceinline__ void direct_words(uint32_t* dst, const uint32_t* block, unsigned m) {
  uint32_t v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0u;
  if (m) hit_words(v, block, m, V);
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}

template <WordsStore kStore, class Probe>
__device__ __forceinline__ void shard_words_tiles(const Probe& probe,
                                                  const uint8_t* __restrict__ bases, int L,
                                                  int k, int n_words,
                                                  uint32_t* __restrict__ words) {
  constexpr int kTiles = kWordsTiles<kStore>;
  const int W = L - k + 1;
  const int w0 = blockIdx.x * kTiles * kTile;
  const long long row0 = static_cast<long long>(blockIdx.y) * W;  // the row's first window
  if constexpr (kStore == WordsStore::kDirect) {
    shard_tiles<kTiles>(probe, bases, L, k, [&](int j, unsigned m, const uint32_t& where) {
      const int w = w0 + j * kTile + threadIdx.x;
      if (w >= W) return;
      uint32_t* dst = words + (row0 + w) * n_words;
      const uint32_t* block = m ? probe.row(where) + kMetaLane : nullptr;
      if (n_words == 4) {
        direct_words<4>(dst, block, m);
      } else if (n_words == 2) {
        direct_words<2>(dst, block, m);
      } else {
        direct_words<1>(dst, block, m);
      }
    });
  } else {
    static_assert(kTiles == 1, "a warp's stage holds its windows of one tile");
    extern __shared__ uint4 stage4[];
    const int lane = threadIdx.x & 31;
    const int span = 8 * n_words + 1;  // chunks a warp's stage: 32 windows' words, 3 more before
    uint4* st4 = stage4 + (threadIdx.x >> 5) * span;
    uint32_t* st = reinterpret_cast<uint32_t*>(st4);
    for (int c = lane; c < span; c += 32) st4[c] = make_uint4(0u, 0u, 0u, 0u);  // before the
                                                                                 // pack's barrier
    const int g0 = w0 + (threadIdx.x & ~31);  // the warp's first window
    const int off = static_cast<int>(((row0 + g0) * n_words) & 3);  // its run's first word
    shard_tiles<1>(probe, bases, L, k, [&](int, unsigned m, const uint32_t& where) {
      if (m) hit_words(st + off + lane * n_words, probe.row(where) + kMetaLane, m, n_words);
    });
    if (g0 >= W) return;  // uniform over the warp
    __syncwarp();
    // the run: words [off, end) of the stage, from the 16-byte chunk of word off
    const int end = off + min(32, W - g0) * n_words;
    uint32_t* out = words + (row0 + g0) * n_words - off;  // 16-byte aligned
    for (int c = lane; 4 * c < end; c += 32) {
      const int i0 = 4 * c;
      if (i0 >= off && i0 + 4 <= end) {
        __stcs(reinterpret_cast<uint4*>(out) + c, st4[c]);  // evict first
      } else {
        for (int i = max(i0, off); i < min(i0 + 4, end); ++i) out[i] = st[i];
      }
    }
  }
}

template <WordsStore kStore>
__global__ void __launch_bounds__(kTile, 8)
shard_multi_hit_words_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits,
                             uint32_t salt, uint32_t lo, uint32_t n,
                             const uint8_t* __restrict__ bases, int L, int k, int n_words,
                             uint32_t* __restrict__ words) {
  shard_words_tiles<kStore>(ShardBucketProbe{rows, row_width, h_bits, salt, lo, n}, bases, L, k,
                            n_words, words);
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

// A block per chunk; its chunk / w groups split over as many rings (teams
// of min(w, 32) lanes) as kRingWarps warps and kRingSmem bytes of stages
// hold, each ring with min(d, its groups) stages.
int s2t_bucket_lookup_ring(const void* rows, int row_width, int h_bits,
                           uint32_t salt, const void* qhi, const void* qlo,
                           long long n, int w, int d, int chunk, void* found,
                           void* slot, void* meta, void* stream) {
  if (w < 1 || w > 64 || d < 1 || d > 8 || chunk < w || chunk % w || n % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ng = chunk / w;
  const int per_warp = 32 / std::min(w, 32);
  const auto stages_for = [&](int rings) { return std::min(d, (ng + rings - 1) / rings); };
  int rings = std::min(ng, kRingWarps * per_warp);
  while (rings > 1 && rings * ring_bytes(stages_for(rings), w) > kRingSmem) --rings;
  const int stages = stages_for(rings);
  const int threads = 32 * ((rings + per_warp - 1) / per_warp);
  bucket_lookup_ring_kernel<<<static_cast<unsigned>(n / chunk), threads,
                              rings * ring_bytes(stages, w), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo), w, chunk, rings,
      stages, static_cast<uint8_t*>(found), static_cast<int32_t*>(slot),
      static_cast<uint32_t*>(meta));
  return launch_status();
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

// K6s: rows the shard's n union rows, lo its first bucket; a block takes
// its store form's tiles of a row. A shard of the whole table (lo = 0,
// every bucket: I = 1) is K6's work, and K6 does it.
int s2t_shard_multi_hit_words(const void* rows, int row_width, int h_bits, uint32_t salt, int lo,
                              int n, const void* bases, int n_rows, int L, int k, int n_words,
                              void* words, void* stream) {
  if (lo == 0 && static_cast<long long>(n) == 1ll << h_bits)
    return s2t_multi_hit_words(rows, row_width, h_bits, salt, bases, n_rows, L, k, n_words, words,
                               stream);
  const int W = L - k + 1;
  const WordsStore store = words_store(n_words);
  const int windows = kTile * (store == WordsStore::kDirect ? kWordsTiles<WordsStore::kDirect>
                                                            : kWordsTiles<WordsStore::kWarp>);
  const dim3 grid((W + windows - 1) / windows, n_rows);
  const auto kernel = store == WordsStore::kDirect
                          ? &shard_multi_hit_words_kernel<WordsStore::kDirect>
                          : &shard_multi_hit_words_kernel<WordsStore::kWarp>;
  kernel<<<grid, kTile, words_stage_bytes(store, n_words), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt, static_cast<uint32_t>(lo),
      static_cast<uint32_t>(n), static_cast<const uint8_t*>(bases), L, k, n_words,
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
