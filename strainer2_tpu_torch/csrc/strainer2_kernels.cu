// Hand-written Hopper (sm_90a) kernels of the single-strain k-mer path.
//
// Built by strainer2_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every entry point below has a plain C signature,
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// The shared definitions (k-mer packing, bucket hash, row layout, first
// equal cell, the cuckoo hash) are in kmer_device.cuh.  K3, K4, K8 and K9
// take their table through a probe policy (BucketProbe, CuckooProbe): each
// runs in the bucket layout and, as its cuckoo_ instance, in the cuckoo
// layout, with K10 (cuckoo_lookup) the cuckoo twin of K2.

#include <algorithm>
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
//   of a byte load and 64-bit shifts a step took 0.0241
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

// The probe policies of the bucket layout (BucketProbe, ShardBucketProbe) and
// probe_valid_window are in kmer_device.cuh; the cuckoo ones follow.

// The slot fingerprint of the cuckoo layout: 8 bits of a hash of the
// unsalted key, with multipliers and a finalizer of its own, so that it
// does not follow cuckoo_slot's bits (ops/lookup.py cuckoo_fingerprint_plain
// is its twin).  An empty slot holds the fingerprint of the sentinel
// (0xFFFFFFFF, 0xFFFFFFFF) like any other key.  Equal keys have equal
// fingerprints, so a slot whose fingerprint is not the query's cannot hold
// the query.
__device__ __forceinline__ uint32_t cuckoo_fingerprint(uint32_t hi, uint32_t lo) {
  uint32_t x = (hi * 0x2C1B3C6Du) ^ (lo * 0x297A2D39u) ^ 0x61C88647u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >> 24;
}

// The cuckoo table (K10's probe): where = s0 if slot s0 holds the key, else
// s1, found or not, as the JAX cuckoo_lookup picks it; the class is meta[slot].
// A slot's 8-byte (hi, lo) pair is read only where its fingerprint (fp, a
// byte a slot, 16 MiB for 2 x 2^23 slots: it stays in the 50 MB L2) is the
// query's: a miss is settled in the L2 but for one slot in 256.
struct CuckooProbe {
  const uint2* table;  // 2H (hi, lo) slots
  const uint8_t* fp;   // 2H slot fingerprints
  int h_bits;
  uint32_t salt;
  uint32_t H;
  const uint32_t* meta_words;  // 2H classes (K4 only)

  __device__ __forceinline__ unsigned find(uint32_t h, uint32_t l, uint32_t* where) const {
    const uint32_t sh = h ^ salt;  // the salt enters the hash only
    const uint32_t s0 = cuckoo_slot(sh, l, h_bits, 0);
    const uint32_t s1 = cuckoo_slot(sh, l, h_bits, 1) + H;
    const uint32_t f0 = __ldg(fp + s0);  // both fingerprints in flight before either compare
    const uint32_t f1 = __ldg(fp + s1);
    const uint32_t f = cuckoo_fingerprint(h, l);
    const bool m0 = f0 == f, m1 = f1 == f;
    uint2 a = make_uint2(0u, 0u), b = make_uint2(0u, 0u);
    if (m0) a = __ldg(table + s0);  // both slot loads, where taken, before either compare
    if (m1) b = __ldg(table + s1);
    const bool hit0 = m0 & (a.x == h) & (a.y == l);
    const bool hit1 = m1 & (b.x == h) & (b.y == l);
    *where = hit0 ? s0 : s1;
    return hit0 | hit1;
  }
  __device__ __forceinline__ size_t slot(uint32_t where, unsigned) const { return where; }
  __device__ __forceinline__ uint32_t meta(uint32_t where, unsigned) const {
    return __ldg(meta_words + where);
  }
};

// One index shard of the cuckoo table (the sharded twin of JAX's
// _local_lookup, strainer2_tpu/parallel/sharding.py:53-78): table and fp hold
// the n slots [lo, lo + n) and their fingerprints, meta_words their classes;
// a slot of the key outside them is not probed and reads nothing.  where =
// the local slot of the match: s1's where the shard holds the key in both
// of its slots, as JAX's loop lets an s1 match overwrite an s0 one
// (CuckooProbe picks s0; neither package's builder places a key twice, so
// the two agree on every table they build).
struct ShardCuckooProbe {
  const uint2* table;  // the shard's n (hi, lo) slots
  const uint8_t* fp;   // their fingerprints
  int h_bits;
  uint32_t salt;
  uint32_t H;
  uint32_t lo;  // the shard's first slot
  uint32_t n;   // its slots
  const uint32_t* meta_words;  // its n classes (K4s only)

  __device__ __forceinline__ unsigned find(uint32_t h, uint32_t l, uint32_t* where) const {
    const uint32_t sh = h ^ salt;
    const uint32_t s0 = cuckoo_slot(sh, l, h_bits, 0) - lo;  // local; wraps below lo
    const uint32_t s1 = cuckoo_slot(sh, l, h_bits, 1) + H - lo;
    uint32_t f0 = 0x100u, f1 = 0x100u;  // no fingerprint's value
    if (s0 < n) f0 = __ldg(fp + s0);
    if (s1 < n) f1 = __ldg(fp + s1);
    const uint32_t f = cuckoo_fingerprint(h, l);
    const bool m0 = f0 == f, m1 = f1 == f;
    uint2 a = make_uint2(0u, 0u), b = make_uint2(0u, 0u);
    if (m0) a = __ldg(table + s0);
    if (m1) b = __ldg(table + s1);
    const bool hit0 = m0 & (a.x == h) & (a.y == l);
    const bool hit1 = m1 & (b.x == h) & (b.y == l);
    *where = hit1 ? s1 : s0;
    return hit0 | hit1;
  }
  __device__ __forceinline__ size_t slot(uint32_t where, unsigned) const { return where; }
  __device__ __forceinline__ uint32_t meta(uint32_t where, unsigned) const {
    return __ldg(meta_words + where);
  }
};

// ShardCuckooProbe on a shard whose n slots all lie on one side of H, as
// every shard of an even split at I >= 2 does: only a key's s0 (kSide 0,
// a shard below H) or only its s1 (kSide 1, a shard from H) can be the
// shard's, so a window takes one hash where ShardCuckooProbe takes two.
// Found, slot and class are ShardCuckooProbe's on such a shard.
template <int kSide>
struct ShardCuckooSideProbe {
  ShardCuckooProbe p;

  __device__ __forceinline__ unsigned find(uint32_t h, uint32_t l, uint32_t* where) const {
    const uint32_t s = cuckoo_slot(h ^ p.salt, l, p.h_bits, kSide) + (kSide ? p.H : 0u) - p.lo;
    if (s >= p.n || __ldg(p.fp + s) != cuckoo_fingerprint(h, l)) return 0u;
    const uint2 a = __ldg(p.table + s);
    *where = s;
    return (a.x == h) & (a.y == l);
  }
  __device__ __forceinline__ size_t slot(uint32_t where, unsigned m) const {
    return p.slot(where, m);
  }
  __device__ __forceinline__ uint32_t meta(uint32_t where, unsigned m) const {
    return p.meta(where, m);
  }
};

// ---------------------------------------------------------------------------
// cuckoo_fingerprints: fp[s] = cuckoo_fingerprint(table[s]) over the 2H
// slots, once an index (TorchKmerEngine.table_for).
//
// Replaces: nothing of the JAX package: the array is this port's own, made
//   on the device from the uploaded table, never saved; the probe of
//   strainer2_tpu/ops/lookup.py:39 (cuckoo_lookup) is what it serves.
// Bound on this card: device-memory bytes, 8 read and 1 written a slot.
// Design: a thread a slot; a warp reads 256 consecutive bytes and writes
//   32.
// ---------------------------------------------------------------------------
__global__ void cuckoo_fingerprints_kernel(const uint2* __restrict__ table, int64_t n,
                                           uint8_t* __restrict__ fp) {
  const int64_t s = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (s >= n) return;
  const uint2 key = __ldg(table + s);
  fp[s] = static_cast<uint8_t>(cuckoo_fingerprint(key.x, key.y));
}

// The L2 window of a probe launch: the fingerprint array's accesses persist
// in the L2's set-aside (cudaLimitPersistingL2CacheSize, raised to the
// array's size or the card's most by s2t_cuckoo_fingerprints), a share of
// them (hitRatio) where the array is larger than the set-aside or the
// card's largest window.
cudaAccessPolicyWindow fp_window(const uint8_t* fp, size_t n) {
  int dev = 0, max_window = 0;
  size_t set_aside = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
  cudaDeviceGetLimit(&set_aside, cudaLimitPersistingL2CacheSize);
  cudaAccessPolicyWindow w = {};
  w.base_ptr = const_cast<uint8_t*>(fp);
  w.num_bytes = n < static_cast<size_t>(max_window) ? n : static_cast<size_t>(max_window);
  w.hitRatio = w.num_bytes <= set_aside ? 1.0f : static_cast<float>(set_aside) / w.num_bytes;
  w.hitProp = cudaAccessPropertyPersisting;
  w.missProp = cudaAccessPropertyStreaming;
  return w;
}

// Launch a probing kernel of the cuckoo layout on st, with the L2 window
// on its 2H fingerprints as a launch attribute (a kernel node's attribute
// under CUDA-graph capture); a refused attribute is a refused launch.
// Without the window a `count` batch of cuckoo K3 took 0.0273 ms, with it
// 0.0240; `targets` batches the same either way (H100 80GB HBM3, 700 W;
// PERF.md).
// launch_windowed puts the window on n_fp bytes from fp (an index shard's
// fingerprints); launch_cuckoo on a whole table's 2H.
template <class... Params, class... Args>
int launch_windowed(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t st,
                    const uint8_t* fp, size_t n_fp, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow = fp_window(fp, n_fp);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return rc != cudaSuccess ? static_cast<int>(rc) : launch_status();
}

template <class... Params, class... Args>
int launch_cuckoo(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t st,
                  const uint8_t* fp, uint32_t H, Args... args) {
  return launch_windowed(kernel, grid, block, st, fp, 2 * static_cast<size_t>(H), args...);
}

// ---------------------------------------------------------------------------
// K10 cuckoo_lookup
//
// Replaces: the jnp cuckoo_lookup, strainer2_tpu/ops/lookup.py:39-72 (two
//   gathers from the hi and lo planes of each slot, then the compares).
// Bound on this card: random accesses. A query reads its two slots'
//   fingerprints (bytes of an array the L2 holds) and, only where one is
//   the query's, that slot's 8-byte (hi, lo) pair, a 32-byte DRAM sector
//   at a hashed address; it writes 5 bytes.
// Design: one thread a query, CuckooProbe's filtered probe (the
//   fingerprints first, both in flight before either compare); the table
//   is read interleaved, (2H, 2) uint32 as the npz stores it, so one
//   8-byte __ldg a slot brings hi and lo from one sector (the JAX planes
//   are for a v5e XLA gather rule).
// ---------------------------------------------------------------------------
__global__ void cuckoo_lookup_kernel(const uint2* __restrict__ table,
                                     const uint8_t* __restrict__ fp, int h_bits, uint32_t H,
                                     uint32_t salt, const uint32_t* __restrict__ qhi,
                                     const uint32_t* __restrict__ qlo, int64_t n,
                                     uint8_t* __restrict__ found, int32_t* __restrict__ slot) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (q >= n) return;
  const CuckooProbe probe{table, fp, h_bits, salt, H, nullptr};
  uint32_t where;
  found[q] = probe.find(qhi[q], qlo[q], &where) != 0;
  slot[q] = static_cast<int32_t>(where);
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
//   (BucketProbe), so a miss reads 64 bytes, not 128. Two or four
//   windows a thread, more probes in flight, were slower: the rate of
//   random accesses is the limit, not their latency. A hit is one
//   atomicAdd on uint32, which wraps like the JAX scatter-add; integer
//   adds commute, so the count bytes do not depend on the order the
//   atomics land in.
// ---------------------------------------------------------------------------
// One block of K3. kCountValid adds the tile's valid windows into its own
// slot of the caller's int64 tally (strain-track).
template <bool kCountValid, class Probe>
__device__ __forceinline__ void count_step_tile(uint32_t* __restrict__ counts, const Probe& probe,
                                                const uint8_t* __restrict__ bases, int L, int k,
                                                long long* __restrict__ tally) {
  __shared__ PackedTile tile;
  const int w0 = blockIdx.x * kTile;
  uint32_t where;
  bool valid;
  if constexpr (kCountValid) {
    // the slot is read before the tile is packed, so its latency hides
    // behind the probe; no other block of the launch touches it
    const size_t t = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    const long long before = threadIdx.x == 0 ? tally[t] : 0;
    pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
    const unsigned m = probe_valid_window(tile, threadIdx.x, probe, w0, L - k + 1, k, &where,
                                          &valid);
    if (m) atomicAdd(counts + probe.slot(where, m), 1u);
    const int n_valid = __syncthreads_count(valid);
    if (threadIdx.x == 0 && n_valid) tally[t] = before + n_valid;
  } else {
    pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
    const unsigned m = probe_valid_window(tile, threadIdx.x, probe, w0, L - k + 1, k, &where,
                                          &valid);
    if (m) atomicAdd(counts + probe.slot(where, m), 1u);
  }
}

__global__ void __launch_bounds__(kTile)
count_step_kernel(uint32_t* __restrict__ counts, const uint32_t* __restrict__ rows,
                  int row_width, int h_bits, uint32_t salt,
                  const uint8_t* __restrict__ bases, int L, int k) {
  count_step_tile<false>(counts, BucketProbe{rows, row_width, h_bits, salt}, bases, L, k,
                         nullptr);
}

// K3 in the cuckoo layout.
// Replaces: the XLA program engine._count_step + accumulate_counts
//   (strainer2_tpu/pipeline/engine.py:301-304, ops/lookup.py:104-116).
// Bound on this card: random accesses. A valid window reads its two
//   slots' fingerprint bytes (L2 sectors of a 2H-byte array, read at most
//   once in all), a 32-byte DRAM sector of the table for each slot whose
//   fingerprint matched (a hit's, and 0.0039 of the probed slots besides),
//   and a count sector a hit. Two DRAM sectors a valid window, hit or
//   miss, took 0.0461 ms a `targets` batch (0.34 of that unfiltered
//   bound): the card's random DRAM read rate. Filtered, 0.0159 ms (1.6 M
//   fingerprint reads at ~100 G L2 sectors/s), and 0.0240 a `count`
//   batch, where it took 0.0365 (H100 80GB HBM3, 700 W; PERF.md).
// Design: K3's block with CuckooProbe's filtered probe, launched with an
//   L2 access-policy window that makes the fingerprints persist
//   (launch_cuckoo): without it a `count` batch took 0.0273 ms, its table
//   and count sectors evicting fingerprints; counts[slot] over 2H cells.
__global__ void __launch_bounds__(kTile)
cuckoo_count_step_kernel(uint32_t* __restrict__ counts, const uint2* __restrict__ table,
                         const uint8_t* __restrict__ fp, int h_bits, uint32_t H, uint32_t salt,
                         const uint8_t* __restrict__ bases, int L, int k) {
  count_step_tile<false>(counts, CuckooProbe{table, fp, h_bits, salt, H, nullptr}, bases, L, k,
                         nullptr);
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
  count_step_tile<true>(counts, BucketProbe{rows, row_width, h_bits, salt}, bases, L, k, tally);
}

// K3 with its valid count in the cuckoo layout.
// Replaces: the XLA program engine._count_valid_step
//   (strainer2_tpu/pipeline/engine.py:294-298).
// Bound and design: cuckoo K3's, and the tally slot a tile of K3 with its
//   valid count.
__global__ void __launch_bounds__(kTile)
cuckoo_count_valid_step_kernel(uint32_t* __restrict__ counts, const uint2* __restrict__ table,
                               const uint8_t* __restrict__ fp, int h_bits, uint32_t H,
                               uint32_t salt, const uint8_t* __restrict__ bases, int L, int k,
                               long long* __restrict__ tally) {
  count_step_tile<true>(counts, CuckooProbe{table, fp, h_bits, salt, H, nullptr}, bases, L, k,
                        tally);
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
template <class Probe>
__device__ __forceinline__ void hit_accumulate_tile(unsigned long long* __restrict__ acc,
                                                    const Probe& probe,
                                                    const uint8_t* __restrict__ bases, int L,
                                                    int k) {
  __shared__ PackedTile tile;
  const int w0 = blockIdx.x * kTile;
  pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
  uint32_t where;
  bool valid;
  const bool hit = probe_valid_window(tile, threadIdx.x, probe, w0, L - k + 1, k, &where,
                                      &valid) != 0;
  const int n_hit = __syncthreads_count(hit);
  const int n_valid = __syncthreads_count(valid);
  if (threadIdx.x == 0) {
    if (n_hit) atomicAdd(acc, static_cast<unsigned long long>(n_hit));
    if (n_valid) atomicAdd(acc + 1, static_cast<unsigned long long>(n_valid));
  }
}

__global__ void __launch_bounds__(kTile)
hit_accumulate_kernel(unsigned long long* __restrict__ acc, const uint32_t* __restrict__ rows,
                      int row_width, int h_bits, uint32_t salt,
                      const uint8_t* __restrict__ bases, int L, int k) {
  hit_accumulate_tile(acc, BucketProbe{rows, row_width, h_bits, salt}, bases, L, k);
}

// K8 in the cuckoo layout.
// Replaces: the XLA program engine._hit_accum + _accum_from_masks
//   (strainer2_tpu/pipeline/engine.py:279-281, :252-258).
// Bound on this card: the bases, the fingerprint bytes and the table
//   sectors of cuckoo K3, and nothing a window written. Unfiltered, a
//   k = 20 `targets` batch took 0.0481 ms; filtered 0.0189 (H100 80GB
//   HBM3, 700 W; PERF.md).
// Design: K8's block with CuckooProbe's filtered probe, launched with the
//   L2 window on the fingerprints (launch_cuckoo).
__global__ void __launch_bounds__(kTile)
cuckoo_hit_accumulate_kernel(unsigned long long* __restrict__ acc,
                             const uint2* __restrict__ table, const uint8_t* __restrict__ fp,
                             int h_bits, uint32_t H, uint32_t salt,
                             const uint8_t* __restrict__ bases, int L, int k) {
  hit_accumulate_tile(acc, CuckooProbe{table, fp, h_bits, salt, H, nullptr}, bases, L, k);
}

// ---------------------------------------------------------------------------
// Tile masks and tile-count scans of K4 and K9: a block of kTile windows
// keeps two bits a window as 8 words each and their counts; a later launch
// scans the counts of every tile.
// ---------------------------------------------------------------------------
constexpr int kTileWords = kTile / 32;  // mask words a tile
constexpr int kStatItems = 16;  // tile counts a thread scans in one pass: one pass per 256 x 4096 batch
constexpr int kScanTiles = kTile * kStatItems;  // tiles a pass of a block-wide scan: 4,096

// Store the block's bits a and b as the 16 words of tile t = blockIdx.y *
// gridDim.x + blockIdx.x at masks + 16 t (a's 8 words, then b's 8), four
// 16-byte stores of thread 0 staged in words (2 kTileWords of the
// caller's shared memory, 16-byte aligned), and their counts, each at most
// kTile, packed as a << 16 | b at tile_counts[t].
__device__ __forceinline__ void store_tile_masks(bool a, bool b, uint32_t* words,
                                                 uint32_t* __restrict__ masks,
                                                 uint32_t* __restrict__ tile_counts) {
  const unsigned am = __ballot_sync(0xffffffffu, a);
  const unsigned bm = __ballot_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) {
    words[threadIdx.x >> 5] = am;
    words[kTileWords + (threadIdx.x >> 5)] = bm;
  }
  const int n_a = __syncthreads_count(a);  // also orders the words above
  const int n_b = __syncthreads_count(b);
  if (threadIdx.x == 0) {
    const int t = blockIdx.y * gridDim.x + blockIdx.x;
    uint4* m4 = reinterpret_cast<uint4*>(masks + static_cast<size_t>(t) * 2 * kTileWords);
    const uint4* w4 = reinterpret_cast<const uint4*>(words);
#pragma unroll
    for (int j = 0; j < 4; ++j) m4[j] = w4[j];
    tile_counts[t] = static_cast<uint32_t>(n_a) << 16 | static_cast<uint32_t>(n_b);
  }
}

// One pass of a block-wide scan (kTile threads) over the packed counts of
// tiles [base, base + kScanTiles), 0 from n on, read through the L2
// (__ldcg: the launch before this one wrote them): thread i holds the
// counts of tiles base + kStatItems i on in c, their sums in (sa, sb),
// and the sums of every tile before its own, from tile 0, in (ea, eb);
// (carry_a, carry_b) advance by the pass's totals, the same in every
// thread. warp_sums: kTile / 32 entries; sync before the next pass.
__device__ __forceinline__ void scan_pass(const uint32_t* tile_counts, int n, int base,
                                          uint32_t (&c)[kStatItems], int2* warp_sums,
                                          int& carry_a, int& carry_b, int& sa, int& sb, int& ea,
                                          int& eb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = base + threadIdx.x * kStatItems;
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
  sa = packed >> 16;
  sb = packed & 0xffff;
  int xa = sa, xb = sb;  // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, xa, off);
    const int yb = __shfl_up_sync(0xffffffffu, xb, off);
    if (lane >= off) {
      xa += ya;
      xb += yb;
    }
  }
  if (lane == 31) warp_sums[warp] = make_int2(xa, xb);
  __syncthreads();
  ea = carry_a + xa - sa;  // before this thread's tiles
  eb = carry_b + xb - sb;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) {
    const int2 s = warp_sums[w];
    if (w < warp) {
      ea += s.x;
      eb += s.y;
    }
    carry_a += s.x;
    carry_b += s.y;
  }
}

// Launch kernel (kTile threads a block) on st; where pdl, chained to the
// launch before it by programmatic dependent launch (PDL): it may start
// once every block of that launch has run griddepcontrol.launch_dependents,
// and waits in griddepcontrol.wait until that launch has finished and its
// stores are visible. A refused launch before it is returned first.
template <class... Params, class... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, cudaStream_t st, bool pdl,
                     Args... args) {
  const int rc = launch_status();
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTile);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t rc2 = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return rc2 != cudaSuccess ? static_cast<int>(rc2) : launch_status();
}

// ---------------------------------------------------------------------------
// K4 classify_step
//
// Replaces: the XLA program engine._classify_step_bucket
//   (strainer2_tpu/pipeline/engine.py:353-364): extract, probe, then each
//   read's (total, informative) hits as differences of a global prefix sum
//   at the read boundaries.
// Bound on this card: the probe's random DRAM accesses, as K3's: the
//   bases, a 64-byte key_hi probe a valid window, 64 bytes of key_lo and a
//   meta lane a hit, the boundaries, 8 bytes a read out. The function needs
//   no mask words or tile counts (they are this design's scratch).
// Design: two launches joined by programmatic dependent launch (PDL), as
//   K9's.
//   1. classify_masks_kernel, K3's block: the packed tile (pack_tile,
//      packed_window) and the key_hi-first probe (probe_valid_window);
//      informative where the meta sum (meta_sum) equals kInformative; the
//      tile's hit and informative words and counts go out as K9's do
//      (store_tile_masks: four 16-byte stores and one packed count word a
//      tile). Each block then lets the sums launch start
//      (griddepcontrol.launch_dependents after its stores).
//   2. classify_sums_kernel, a thread a read, launched by launch_dependent:
//      it reads its two boundaries (gather_index, as the JAX gather reads
//      them, so clamped and reversed spans come out as there) before
//      griddepcontrol.wait, since the masks launch does not write them,
//      then the 16 words of each boundary's tile. Every block scans all n
//      count words itself (scan_pass, a pass per kScanTiles tiles), leaving
//      each pass's exclusive prefixes in shared memory (34 KiB with the
//      padding), and a thread takes its tiles' prefixes in the pass that
//      holds them. The prefix at window x (row r, column c) is the tile
//      prefix of tile (r, c / 256) plus the popcounts of its words below c,
//      and a read's sums are P(b[r + 1]) - P(b[r]). A 256 x 4096 batch is
//      4,096 tiles, one pass of 16 KiB of count words a block from the L2.
//   On an H100 80GB HBM3 at 700 W (PERF.md): a `targets` batch 0.0343-0.0344
//   ms (0.46 of the bound; K3 + 0.0060 on the same batches), a `phase2`
//   batch 0.0312 (0.32; K3 + 0.0020-0.0021), where the first form, the
//   k-step byte loop in three plain launches (masks, a one-block scan,
//   sums), took 0.0417 and 0.0419-0.0420. The masks launch alone takes
//   K3's time on `targets` batches and less on `phase2` ones (no count
//   atomics); the sums launch ends 0.005-0.006 ms after it.
//   Measured beside this form: the trigger at each masks block's start
//   (the sums blocks then sit resident through the masks launch's last
//   wave) 0.0012-0.0015 ms more; the sums launch without PDL 0.0000-0.0005
//   ms less; K9's chain (masks, a one-block scan writing the prefixes,
//   sums, PDL on both edges) 0.0022-0.0026 ms more than the folded scan
//   with the early trigger; pack_tile_wide within 0.0004 ms of pack_tile
//   either way on this 320-base tile, which one of its warps packs alone.
// ---------------------------------------------------------------------------
template <class Probe>
__device__ __forceinline__ void classify_masks_tile(const Probe& probe,
                                                    const uint8_t* __restrict__ bases, int L,
                                                    int k, uint32_t* __restrict__ masks,
                                                    uint32_t* __restrict__ tile_counts) {
  __shared__ PackedTile tile;
  __shared__ __align__(16) uint32_t words[2 * kTileWords];
  const int w0 = blockIdx.x * kTile;
  pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
  uint32_t where;
  bool valid;
  const unsigned m = probe_valid_window(tile, threadIdx.x, probe, w0, L - k + 1, k, &where,
                                        &valid);
  const bool informative = m && probe.meta(where, m) == kInformative;
  store_tile_masks(m != 0, informative, words, masks, tile_counts);
  asm volatile("griddepcontrol.launch_dependents;");  // after the stores: see K4's note
}

__global__ void __launch_bounds__(kTile)
classify_masks_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits, uint32_t salt,
                      const uint8_t* __restrict__ bases, int L, int k,
                      uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_counts) {
  classify_masks_tile(BucketProbe{rows, row_width, h_bits, salt}, bases, L, k, masks,
                      tile_counts);
}

// K4's first launch in the cuckoo layout.
// Replaces: the XLA program engine._classify_step
//   (strainer2_tpu/pipeline/engine.py:307-320), its probe and meta gather.
// Bound on this card: the bases, the boundaries, the filtered probe of
//   cuckoo K3 (the fingerprint bytes, a table sector a matched slot), a
//   meta word a hit, 8 bytes a read out.
// Design: classify_masks' block with CuckooProbe, launched with the L2
//   window on the fingerprints (launch_cuckoo); informative where the
//   separate slot-indexed meta word is kInformative: one word, never a sum
//   (a key held in both of its slots reads meta[s0]). classify_sums_kernel
//   follows it unchanged, chained by PDL.
//   A `targets` batch 0.0220-0.0221 ms (0.25 of the filtered bound;
//   cuckoo K3 + 0.0061-0.0063), a `phase2` one 0.0233 (0.31; + 0.0033),
//   where the first form took 0.0384-0.0385 and 0.0392-0.0394 (H100 80GB
//   HBM3, 700 W; PERF.md). The masks launch alone takes cuckoo K3's time
//   + 0.0008 ms on `targets` batches.
__global__ void __launch_bounds__(kTile)
cuckoo_classify_masks_kernel(const uint2* __restrict__ table, const uint8_t* __restrict__ fp,
                             const uint32_t* __restrict__ meta, int h_bits, uint32_t H,
                             uint32_t salt, const uint8_t* __restrict__ bases, int L, int k,
                             uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_counts) {
  classify_masks_tile(CuckooProbe{table, fp, h_bits, salt, H, meta}, bases, L, k, masks,
                      tile_counts);
}

// Shared index of a pass's tile i in classify_sums' prefixes: a pad entry
// after every 16, so that a half warp's 8-byte stores, one for each of its
// threads' 16 consecutive tiles, fall in distinct banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// (hits, informative) among the windows of tile t below column `within`
// of the tile, from its 16 words at masks + 16 t (read only where within
// is not 0).
__device__ __forceinline__ int2 below_in_tile(const uint32_t* masks, int t, int within) {
  int2 v = make_int2(0, 0);
  if (within) {
    const uint4* m4 = reinterpret_cast<const uint4*>(masks + static_cast<size_t>(t) * 2 * kTileWords);
    const uint4 h0 = __ldcg(m4), h1 = __ldcg(m4 + 1), i0 = __ldcg(m4 + 2), i1 = __ldcg(m4 + 3);
    const uint32_t hw[kTileWords] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    const uint32_t iw[kTileWords] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
    const int word = within >> 5;
    const uint32_t below = (1u << (within & 31)) - 1u;
#pragma unroll
    for (int j = 0; j < kTileWords; ++j) {
      v.x += j < word ? __popc(hw[j]) : j == word ? __popc(hw[j] & below) : 0;
      v.y += j < word ? __popc(iw[j]) : j == word ? __popc(iw[j] & below) : 0;
    }
  }
  return v;
}

// (total, informative) of reads [0, max_reads) from the n tiles of the
// masks launch before it; W windows a row of tpr tiles, n_rows rows.
__global__ void __launch_bounds__(kTile)
classify_sums_kernel(const uint32_t* __restrict__ masks, const uint32_t* __restrict__ tile_counts,
                     int n, int n_rows, int W, int tpr, const int32_t* __restrict__ bounds,
                     int max_reads, int32_t* __restrict__ tot, int32_t* __restrict__ inf) {
  __shared__ int2 prefix[kScanTiles + kScanTiles / 16];
  __shared__ int2 warp_sums[kTile / 32];
  const int r = blockIdx.x * kTile + threadIdx.x;
  const bool live = r < max_reads;
  const int q = n_rows * W;
  int t[2] = {0, 0}, within[2] = {0, 0};  // each boundary's tile and column in it
  if (live) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = gather_index(__ldg(bounds + r + e), q);
      const int row = x / W;
      const int c = x - row * W;
      t[e] = row * tpr + (c >> 8);
      within[e] = c & (kTile - 1);
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int2 below0 = below_in_tile(masks, t[0], within[0]);
  const int2 below1 = below_in_tile(masks, t[1], within[1]);
  int2 p[2] = {make_int2(0, 0), make_int2(0, 0)};
  int carry_h = 0, carry_i = 0;
  int base = 0;
  for (; base < n; base += kScanTiles) {
    uint32_t c[kStatItems];
    int sh, si, eh, ei;
    scan_pass(tile_counts, n, base, c, warp_sums, carry_h, carry_i, sh, si, eh, ei);
    const int j0 = threadIdx.x * kStatItems;
#pragma unroll
    for (int j = 0; j < kStatItems; ++j) {  // past n: the totals
      prefix[padded(j0 + j)] = make_int2(eh, ei);
      eh += c[j] >> 16;
      ei += c[j] & 0xffff;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = t[e] - base;
      if (i >= 0 && i < kScanTiles) p[e] = prefix[padded(i)];
    }
    __syncthreads();  // prefix and warp_sums are written again in the next pass
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // t = n at the end of a whole pass: the totals
    if (t[e] == base) p[e] = make_int2(carry_h, carry_i);
  }
  if (live) {
    tot[r] = p[1].x + below1.x - p[0].x - below0.x;
    inf[r] = p[1].y + below1.y - p[0].y - below0.y;
  }
}

// ---------------------------------------------------------------------------
// K4e classify_select
//
// Replaces: the host's selection of strain_detect's emitted rows
//   (strainer2_tpu/pipeline/detect.py, the emission after the pass gate;
//   this package's StrainDetector._emit_sums): the pass rule over every
//   read or pair, then each passing read rebuilt from the batch, every
//   window's canonical code recomputed and searched among the genome's
//   codes, and the informative ones kept. K4 has already probed every
//   valid window: its informative bits (found, class kInformative) over a
//   read's span [b[r], b[r + 1]) are that read's rows, in window order
//   (the halo leaves a split read no duplicate window), and inf[r] counts
//   them.
// Bound on this card: the per-read (tot, inf) and boundaries read once,
//   a tile's 32 bytes of informative words and k bases a row read, 20
//   bytes a passing read or pair and 12 bytes a row written. A 256 x 4096
//   `targets` batch: ~7,000 reads, under 100 rows.
// Design: one launch after K4's sums launch, chained by PDL; a thread
//   holds kSelItems consecutive units (reads, or pairs (2j, 2j + 1) of
//   the first n_reads - n_reads % 2 reads), a block kSelUnits.
//   1. Before griddepcontrol.wait the thread reads its units' boundaries
//      (no launch of K4 writes them).
//   2. A passing unit has exactly inf[r] (+ inf[r + 1]) rows, so the row
//      offsets are a scan over units, never over bits: each block sums
//      the passes and rows of every unit before its own (K4's own
//      pattern: every block scans what it needs itself), then scans its
//      own units (block_scan2). The last block writes the totals.
//   3. A passing unit writes (r1, t1, i1, t2, i2) at its place among the
//      passing units, and each of its reads walks its span a tile at a
//      time: the tile's 8 informative words in two 16-byte loads, each set
//      bit in the span a row (the window's canonical code from its k
//      bases by at most nine 4-byte loads, window_code; the read's
//      ordinal). It reads masks only: both layouts' K4 feed it.
// ---------------------------------------------------------------------------
constexpr int kSelItems = 2;  // units a thread
constexpr int kSelUnits = kTile * kSelItems;  // units a block

// Exclusive prefixes (ea, eb) of the threads' (a, b) in thread order and
// the block's totals (ta, tb); kTile threads, warp_sums kTile / 32 entries.
__device__ __forceinline__ void block_scan2(int a, int b, int2* warp_sums, int& ea, int& eb,
                                            int& ta, int& tb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int xa = a, xb = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, xa, off);
    const int yb = __shfl_up_sync(0xffffffffu, xb, off);
    if (lane >= off) {
      xa += ya;
      xb += yb;
    }
  }
  if (lane == 31) warp_sums[warp] = make_int2(xa, xb);
  __syncthreads();
  ea = xa - a;
  eb = xb - b;
  ta = tb = 0;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) {
    const int2 s = warp_sums[w];
    if (w < warp) {
      ea += s.x;
      eb += s.y;
    }
    ta += s.x;
    tb += s.y;
  }
  __syncthreads();  // warp_sums is written again by the next call
}

// One unit's (t1, i1, t2, i2) from K4's per-read sums (all 0 from
// n_units on), and whether it passes.
struct SelUnit {
  int t1, i1, t2, i2;
  bool pass;
};

template <bool kPaired>
__device__ __forceinline__ SelUnit load_unit(const int32_t* tot, const int32_t* inf, int u,
                                             int n_units, int min_t, int min_i) {
  SelUnit s = {0, 0, 0, 0, false};
  if (u < n_units) {
    const int r = kPaired ? 2 * u : u;
    s.t1 = __ldcg(tot + r);
    s.i1 = __ldcg(inf + r);
    if constexpr (kPaired) {
      s.t2 = __ldcg(tot + r + 1);
      s.i2 = __ldcg(inf + r + 1);
    }
    s.pass = s.t1 + s.t2 >= min_t && s.i1 + s.i2 >= min_i;
  }
  return s;
}

__device__ __forceinline__ int unit_rows(const SelUnit& s) {
  return s.pass ? max(s.i1, 0) + max(s.i2, 0) : 0;
}

// The canonical code of the k (<= 32) valid bases at p, as packed_window
// computes it: the run of 32 bases from p (base i at pair i) from at most
// nine aligned 4-byte loads, each 4-byte group packed by pack4.
__device__ __forceinline__ unsigned long long window_code(const uint8_t* p, int k) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
  const int skip = static_cast<int>(a & 3);
  const int nw = (skip + k + 3) >> 2;
  uint32_t v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = i < nw ? __ldg(w + i) : 0u;
  uint64_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t code, bad;
    pack4(__funnelshift_r(v[i], v[i + 1], 8 * skip), &code, &bad);  // bases 4i .. 4i + 3
    x |= static_cast<uint64_t>(code) << (8 * i);
  }
  const int drop = 64 - 2 * k;  // 0 at k = 32: no shift by 64
  const uint64_t rc = ~x & (~0ull >> drop);
  const uint64_t fwd = reverse_pairs(x) >> drop;
  return fwd >= rc ? fwd : rc;
}

// The rows of one read: the windows of flat span [x0, x1) whose
// informative bit is set, in order, at most cap of them, at codes[0..]
// and ords[0..] (the window's canonical code, the read's ordinal ord).
__device__ __forceinline__ void select_read_rows(const uint32_t* __restrict__ masks,
                                                 const uint8_t* __restrict__ bases, int L,
                                                 int W, int tpr, int k, int x0, int x1, int ord,
                                                 int cap, unsigned long long* __restrict__ codes,
                                                 int32_t* __restrict__ ords) {
  int n = 0;
  for (int x = x0; x < x1 && n < cap;) {
    const int row = x / W;
    const int c = x - row * W;
    const int t0 = c & ~(kTile - 1);  // the tile's first column
    const int end = min(min(W, t0 + kTile), c + (x1 - x));  // the span's end in this tile
    const uint4* m4 = reinterpret_cast<const uint4*>(
        masks + (static_cast<size_t>(row) * tpr + (c >> 8)) * 2 * kTileWords + kTileWords);
    const uint4 lo4 = __ldcg(m4), hi4 = __ldcg(m4 + 1);
    const uint32_t iw[kTileWords] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
    const uint8_t* src = bases + static_cast<size_t>(row) * L;
#pragma unroll
    for (int j = 0; j < kTileWords; ++j) {
      const int lo = t0 + 32 * j;  // the word's first column
      const int s = max(c - lo, 0), e = min(end - lo, 32);  // its bits [s, e) lie in the span
      uint32_t m = 0;
      if (s < e) m = (iw[j] >> s << s) & (e < 32 ? (1u << e) - 1u : ~0u);
      while (m && n < cap) {
        const int col = lo + __ffs(m) - 1;
        m &= m - 1;
        codes[n] = window_code(src + col, k);
        ords[n] = ord;
        ++n;
      }
    }
    x += end - c;
  }
}

// Units [0, n_units): the passing ones' sums in order at sums (5 int32 a
// unit) and their reads' rows in order at codes and ords; counts = (passing
// units, rows). masks, tot and inf: K4's launches before it on the stream.
template <bool kPaired>
__global__ void __launch_bounds__(kTile)
classify_select_kernel(const uint32_t* __restrict__ masks, const uint8_t* __restrict__ bases,
                       int n_rows, int L, int k, int tpr, const int32_t* __restrict__ bounds,
                       const int32_t* __restrict__ tot, const int32_t* __restrict__ inf,
                       int n_units, int min_t, int min_i, int32_t* __restrict__ counts,
                       int32_t* __restrict__ sums, unsigned long long* __restrict__ codes,
                       int32_t* __restrict__ ords) {
  constexpr int kPer = kPaired ? 2 : 1;  // reads a unit
  __shared__ int2 warp_sums[kTile / 32];
  const int W = L - k + 1;
  const int q = n_rows * W;
  const int u0 = blockIdx.x * kSelUnits + threadIdx.x * kSelItems;
  int x[kPer * kSelItems + 1];  // the boundaries of this thread's reads
#pragma unroll
  for (int j = 0; j <= kPer * kSelItems; ++j) {
    const int r = kPer * u0 + j;
    x[j] = r <= kPer * n_units ? gather_index(__ldg(bounds + r), q) : 0;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  int before_p = 0, before_r = 0;  // passing units and rows before this block's
  for (int u = threadIdx.x * kSelItems; u < blockIdx.x * kSelUnits; u += kSelUnits) {
#pragma unroll
    for (int j = 0; j < kSelItems; ++j) {
      const SelUnit s = load_unit<kPaired>(tot, inf, u + j, n_units, min_t, min_i);
      before_p += s.pass;
      before_r += unit_rows(s);
    }
  }
  int ep, er, pre_p, pre_r;
  block_scan2(before_p, before_r, warp_sums, ep, er, pre_p, pre_r);
  SelUnit s[kSelItems];
  int my_p = 0, my_r = 0;
#pragma unroll
  for (int j = 0; j < kSelItems; ++j) {
    s[j] = load_unit<kPaired>(tot, inf, u0 + j, n_units, min_t, min_i);
    my_p += s[j].pass;
    my_r += unit_rows(s[j]);
  }
  int tp, tr;
  block_scan2(my_p, my_r, warp_sums, ep, er, tp, tr);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    counts[0] = pre_p + tp;
    counts[1] = pre_r + tr;
  }
  int p = pre_p + ep, off = pre_r + er;
#pragma unroll
  for (int j = 0; j < kSelItems; ++j) {
    if (!s[j].pass) continue;
    const int r = kPer * (u0 + j);
    int32_t* o = sums + 5 * static_cast<size_t>(p++);
    o[0] = r;
    o[1] = s[j].t1;
    o[2] = s[j].i1;
    o[3] = s[j].t2;
    o[4] = s[j].i2;
    // a read writes at most its inf rows, and never past the q cells of
    // codes and ords (spans that overlap, which no packer writes)
    select_read_rows(masks, bases, L, W, tpr, k, x[kPer * j], x[kPer * j + 1], r,
                     min(max(s[j].i1, 0), q - off), codes + off, ords + off);
    off += max(s[j].i1, 0);
    if constexpr (kPaired) {
      select_read_rows(masks, bases, L, W, tpr, k, x[kPer * j + 1], x[kPer * j + 2], r + 1,
                       min(max(s[j].i2, 0), q - off), codes + off, ords + off);
      off += max(s[j].i2, 0);
    }
  }
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
//      Thread 0 stores the 16 words and the counts packed in one word
//      (store_tile_masks). Each block first lets the dependent launch
//      start (griddepcontrol.launch_dependents).
//   2. hit_crossing_kernel, one block, launched with
//      cudaLaunchAttributeProgrammaticStreamSerialization (launch_dependent):
//      it is resident before the masks launch ends and waits in
//      griddepcontrol.wait, which returns once that launch has finished and
//      its stores are visible. It reads every tile's count word, kStatItems
//      a thread held in registers, and scans their sums over the block
//      (scan_pass); the one thread
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
  int carry_h = 0, carry_v = 0;  // the same in every thread
  for (int base = 0; base < n; base += kScanTiles) {
    const int i0 = base + threadIdx.x * kStatItems;
    uint32_t c[kStatItems];
    int sh, sv, eh, ev;
    scan_pass(tile_counts, n, base, c, warp_sums, carry_h, carry_v, sh, sv, eh, ev);
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
template <class Probe>
__device__ __forceinline__ void hit_stats_tile(const Probe& probe,
                                               const uint8_t* __restrict__ bases, int L, int k,
                                               uint32_t* __restrict__ masks,
                                               uint32_t* __restrict__ tile_counts) {
  __shared__ PackedTile tile;
  __shared__ __align__(16) uint32_t words[2 * kTileWords];
  asm volatile("griddepcontrol.launch_dependents;");
  const int w0 = blockIdx.x * kTile;
  pack_tile(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
  uint32_t where;
  bool valid;
  const bool hit = probe_valid_window(tile, threadIdx.x, probe, w0, L - k + 1, k, &where,
                                      &valid) != 0;
  store_tile_masks(hit, valid, words, masks, tile_counts);
}

__global__ void __launch_bounds__(kTile)
hit_stats_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits, uint32_t salt,
                 const uint8_t* __restrict__ bases, int L, int k,
                 uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_counts) {
  hit_stats_tile(BucketProbe{rows, row_width, h_bits, salt}, bases, L, k, masks, tile_counts);
}

// K9's first launch in the cuckoo layout.
// Replaces: the XLA program engine._hit_stats + _stats_from_masks
//   (strainer2_tpu/pipeline/engine.py:284-286, :261-276).
// Bound on this card: the bases, the probe of cuckoo K3, 16 B out.
//   Design: hit_stats_kernel's block with CuckooProbe; the one-block
//   hit_crossing_kernel follows it unchanged, chained by PDL.
__global__ void __launch_bounds__(kTile)
cuckoo_hit_stats_kernel(const uint2* __restrict__ table, const uint8_t* __restrict__ fp,
                        int h_bits, uint32_t H, uint32_t salt,
                        const uint8_t* __restrict__ bases, int L, int k,
                        uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_counts) {
  hit_stats_tile(CuckooProbe{table, fp, h_bits, salt, H, nullptr}, bases, L, k, masks,
                 tile_counts);
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


// ---------------------------------------------------------------------------
// The shard-window kernels of --mesh DxI (strainer2_tpu/parallel/sharding.py).
//
// Replaces: the shard_map bodies of ShardedKmerEngine: _count_body
//   (sharding.py:167) and _count_body_bucket (:304), K3s; the probe and
//   class planes of _classify_body (:179) and _classify_body_bucket (:317),
//   K4s; and the psum over the index axis of both (:191-192, :328-329), R.
// Bound on this card: a shard reads its data shard's bases and probes only
//   the windows whose bucket (or slot) it holds, about 1/I of the valid
//   windows (the rest are settled by the hash alone, no read); K3s adds into
//   the shard's private counts, K4s writes K4's 16 mask words and a count
//   word a tile. R reads I copies of the masks and writes one.
// Design: K3s and K4s share one block with K6s (shard_tiles in
//   kmer_device.cuh, K4s's note below): four tiles of a row, packed once,
//   each thread taking its window of the four in turn through a window
//   policy (ShardBucketProbe, ShardCuckooProbe, ShardCuckooSideProbe): a
//   key outside the shard's block is a miss with no memory read, and
//   slot() is the shard's local count index. A key lives in one shard,
//   so the OR of the shards' hit bits is the psum's hit_g > 0,
//   and the OR of their informative bits its class_g == 2 (the two differ
//   only for a key held twice, which no builder makes); R ORs the shards'
//   words on the data shard's first device and recounts each tile's packed
//   count word from them by popcount (a sum of the shards' count words
//   would count a window twice if two shards set its bit), then K4's
//   classify_sums_kernel runs unchanged on the data shard's boundaries,
//   clipped to its window range (sharding.py:333-340).
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// K4s shard_classify_masks, in both layouts
//
// Replaces: the probe and class planes of ShardedKmerEngine._classify_body_bucket
//   (strainer2_tpu/parallel/sharding.py:317-326, _bucket_local_lookup) and
//   _classify_body (:179-190, _local_lookup), up to their psum over "index".
// Bound on this card: the data shard's bases, the shard's probes (about
//   1/I of the valid windows: a bucket row's 64 bytes of key_hi lanes; in
//   the cuckoo layout the fingerprint bytes of the slots it holds and a
//   table sector a matched one), a meta word a hit, and K4's scratch out,
//   68 bytes a 256-window tile. The windows whose bucket (slot) lies
//   outside the shard are settled by the hash alone.
// Design: the per-batch cost that does not shrink with I is cut. The first
//   form ran K4's block with the window policies: a 256-window tile a
//   block, 4,096 blocks a 256 x 4096 batch in four waves, each waiting out
//   a byte-load pack, the probe and two block-wide counts. Its no-probe
//   pass (a shard that no window probes) took 0.0091 ms, 0.0113 in the
//   cuckoo layout, 60-95% of a shard's time. Here:
//   - a block takes kShardTiles tiles of one row (1,024 windows), so a
//     256 x 4096 batch is 1,024 blocks, one resident wave at 8 blocks an
//     SM (__launch_bounds__: 32 registers); its 1,088 bases are packed once
//     by 16-byte loads (pack_tile_wide), 6% halo where a tile packs 25%;
//   - each thread takes its window of the four tiles in turn, probing it
//     where its bucket (slot) is the shard's, so that a warp's ALU work
//     on one tile overlaps other warps' probes; a tile's hit and
//     informative words are its warps' ballots, kept in shared memory;
//   - one __syncthreads, then warp 0 stores the block's mask words as
//     16-byte vectors and the last warp each tile's count word from
//     popcounts; the PDL trigger follows the stores, as in K4;
//   - in the cuckoo layout a shard whose slots lie on one side of H (every
//     shard of an even split at I >= 2) hashes a window once, not twice
//     (ShardCuckooSideProbe): the no-probe pass 0.0082 to 0.0059 ms.
//   The output is K4's scratch (16 mask words and a count word
//   hits << 16 | informative a tile), which R and classify_sums_kernel
//   read unchanged. Shard 0 of a `targets` batch: I = 2 / 4 0.0151-0.0152
//   / 0.0116 ms (0.54 / 0.37 of the bound; the first form 0.0166-0.0167 /
//   0.0142-0.0143 in the same call), cuckoo 0.0100-0.0101 / 0.0075
//   (0.0127-0.0128 / 0.0120-0.0121); the no-probe pass 0.0058 / 0.0059
//   (0.0091-0.0092 / 0.0113); I = 1 0.0301-0.0302, 0.0014 ms slower than
//   the first form (cuckoo 0.0164-0.0165 against 0.0169). The bucket probes
//   at I = 2 meet the card's random-read rate (~30 G rows/s at 512 MiB).
//   Measured beside it: the shard's windows compacted into a list by warp
//   ballots and probed densely after all four tiles are screened, 0.0169
//   / 0.0104 (cuckoo 0.0147 / 0.0113: the screening runs with no probe in
//   flight); 2 or 8 tiles a block 0.0155 / 0.0116 and 0.0160 / 0.0126; no
//   register bound 0.0150 / 0.0116 (H100 80GB HBM3, 700 W;
//   bench_kernels.py --shard; PERF.md). Its screening loop is K3s's too
//   (shard_tiles, the per-window action a lambda): against its own loop in
//   the same call, I = 2 / 4 0.0150-0.0152 / 0.0115 ms against
//   0.0151-0.0153 / 0.0115, cuckoo 0.0099 / 0.0075 against 0.0100 /
//   0.0072-0.0075, the no-probe pass 0.0058-0.0059 in both (H100 80GB
//   HBM3, 700 W).
// ---------------------------------------------------------------------------
static_assert(kShardTiles <= 8, "a K4s block's mask words are one warp's 16-byte stores");

template <class Probe>
__device__ __forceinline__ void shard_masks_tiles(const Probe& probe,
                                                  const uint8_t* __restrict__ bases, int L, int k,
                                                  uint32_t* __restrict__ masks,
                                                  uint32_t* __restrict__ tile_counts) {
  constexpr int kWords = 2 * kTileWords;  // a tile's hit words, then its informative words
  __shared__ __align__(16) uint32_t words[kShardTiles * kWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // tile j: window j * kTile + threadIdx.x, so warp w's ballots are word w
  shard_tiles(probe, bases, L, k, [&](int j, unsigned m, const uint32_t& where) {
    const bool informative = m && probe.meta(where, m) == kInformative;
    const unsigned hit_word = __ballot_sync(0xffffffffu, m != 0);
    const unsigned inf_word = __ballot_sync(0xffffffffu, informative);
    if (lane == 0) {
      words[j * kWords + warp] = hit_word;
      words[j * kWords + kTileWords + warp] = inf_word;
    }
  });
  __syncthreads();
  // the block's tiles of its row: warp 0 stores the words, the last warp the count words
  const int W = L - k + 1;
  const int tpr = (W + kTile - 1) / kTile;
  const int col = blockIdx.x * kShardTiles;
  const int n_mine = min(kShardTiles, tpr - col);
  const size_t t0 = static_cast<size_t>(blockIdx.y) * tpr + col;
  const int c = static_cast<int>(threadIdx.x) - (kTile - 32);
  if (static_cast<int>(threadIdx.x) < 4 * n_mine) {
    reinterpret_cast<uint4*>(masks + t0 * kWords)[threadIdx.x] =
        reinterpret_cast<const uint4*>(words)[threadIdx.x];
  } else if (c >= 0 && c < n_mine) {
    const uint4* w4 = reinterpret_cast<const uint4*>(words + c * kWords);
    int n[2] = {0, 0};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = w4[q];
      n[q >> 1] += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    tile_counts[t0 + c] = static_cast<uint32_t>(n[0]) << 16 | static_cast<uint32_t>(n[1]);
  }
  asm volatile("griddepcontrol.launch_dependents;");  // after the stores: see K4's note
}

__global__ void __launch_bounds__(kTile, 8)
shard_classify_masks_kernel(const uint32_t* __restrict__ rows, int row_width, int h_bits,
                            uint32_t salt, uint32_t lo, uint32_t n,
                            const uint8_t* __restrict__ bases, int L, int k,
                            uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_counts) {
  shard_masks_tiles(ShardBucketProbe{rows, row_width, h_bits, salt, lo, n}, bases, L, k, masks,
                    tile_counts);
}

// kSide -1: a shard across H (ShardCuckooProbe); 0 or 1: ShardCuckooSideProbe.
template <int kSide>
__global__ void __launch_bounds__(kTile, 8)
shard_cuckoo_classify_masks_kernel(const uint2* __restrict__ table,
                                   const uint8_t* __restrict__ fp,
                                   const uint32_t* __restrict__ meta, int h_bits, uint32_t H,
                                   uint32_t salt, uint32_t lo, uint32_t n,
                                   const uint8_t* __restrict__ bases, int L, int k,
                                   uint32_t* __restrict__ masks,
                                   uint32_t* __restrict__ tile_counts) {
  const ShardCuckooProbe probe{table, fp, h_bits, salt, H, lo, n, meta};
  if constexpr (kSide < 0) {
    shard_masks_tiles(probe, bases, L, k, masks, tile_counts);
  } else {
    shard_masks_tiles(ShardCuckooSideProbe<kSide>{probe}, bases, L, k, masks, tile_counts);
  }
}

// ---------------------------------------------------------------------------
// K3s shard_count_step, in both layouts
//
// Replaces: ShardedKmerEngine._count_body_bucket
//   (strainer2_tpu/parallel/sharding.py:304-315, _bucket_local_lookup) and
//   _count_body (:167-177, _local_lookup): counts_loc[slot_loc] += 1
//   (uint32, wrapping) for every valid window whose key the shard holds,
//   misses dropped.
// Bound on this card: the data shard's bases, the shard's probes (as
//   K4s's), and a count read and written a hit (a 32-byte sector in the
//   cuckoo layout); nothing where no window hits. The no-probe pass (a
//   shard that no window probes) moves the bases alone.
// Design: K4s's block (shard_tiles) with one atomicAdd a hit into the
//   shard's counts: four tiles of a row a block, one resident wave of
//   1,024 blocks a 256 x 4096 batch at 32 registers, the bases packed once
//   by 16-byte loads, each thread probing its window of the four tiles in
//   turn where its bucket (slot) is the shard's. No ballot, barrier, store
//   or PDL trigger: K3s has no dependent launch. A cuckoo shard on one
//   side of H takes ShardCuckooSideProbe (one hash a window), chosen on
//   the host from lo, n and H; a shard across H (I = 3) keeps
//   ShardCuckooProbe and its s1-over-s0 rule. A shard of the whole table
//   (I = 1, chosen on the host from lo and n) keeps the first form, K3's
//   one-tile block (count_step_tile): in the bucket layout that is K3
//   itself (ShardBucketProbe at lo = 0 over every bucket is BucketProbe),
//   so the launcher calls s2t_count_step; the cuckoo layout keeps its own
//   one-tile kernel (shard_cuckoo_count_step_kernel), because CuckooProbe
//   picks s0 for a key held in both of its slots where the shard's rule
//   (JAX's _local_lookup) picks s1. The first form: 4,096 blocks a batch
//   in four waves, a byte-load pack a tile, two hashes a cuckoo window.
//   Shard 0 of a `targets` batch,
//   this form against the first in the same call: I = 2 / 4 0.0147 /
//   0.0104-0.0105 ms (0.55 / 0.40 of the bound) against 0.0155-0.0156 /
//   0.0123-0.0124; cuckoo 0.0091 / 0.0063 (0.32 / 0.26) against
//   0.0107-0.0108 / 0.0099-0.0100; the no-probe pass 0.0052 (cuckoo 0.0050)
//   against 0.0076 (0.0095-0.0096): it was 49-96% of a shard's time. On a
//   `count` batch (half the valid windows hit) I = 2 0.0199-0.0200 against
//   0.0198-0.0199 (cuckoo 0.0162 against 0.0159-0.0161): ~200,000 probes and
//   ~100,000 atomicAdds into 128 MiB meet the card's random-access rates
//   (~30 G rows/s, ~15.6 G atomics/s), so the pack saved hides; I = 4
//   0.0128 against 0.0138 (0.0091-0.0095 against 0.0113-0.0115). At I = 1
//   this block lost: 0.0292-0.0294 against 0.0284-0.0285 (`count`
//   0.0395-0.0398 against 0.0384; cuckoo `count` 0.0253-0.0255 against
//   0.0248), since the first form's four waves overlap one wave's pack
//   with another's probes (H100 80GB HBM3, 700 W; bench_kernels.py
//   --shard; PERF.md).
// ---------------------------------------------------------------------------
template <class Probe>
__device__ __forceinline__ void shard_count_tiles(uint32_t* __restrict__ counts,
                                                  const Probe& probe,
                                                  const uint8_t* __restrict__ bases, int L,
                                                  int k) {
  shard_tiles(probe, bases, L, k, [&](int, unsigned m, const uint32_t& where) {
    if (m) atomicAdd(counts + probe.slot(where, m), 1u);
  });
}

__global__ void __launch_bounds__(kTile, 8)
shard_count_tiles_kernel(uint32_t* __restrict__ counts, const uint32_t* __restrict__ rows,
                         int row_width, int h_bits, uint32_t salt, uint32_t lo, uint32_t n,
                         const uint8_t* __restrict__ bases, int L, int k) {
  shard_count_tiles(counts, ShardBucketProbe{rows, row_width, h_bits, salt, lo, n}, bases, L, k);
}

// kSide as shard_cuckoo_classify_masks_kernel's.
template <int kSide>
__global__ void __launch_bounds__(kTile, 8)
shard_cuckoo_count_tiles_kernel(uint32_t* __restrict__ counts, const uint2* __restrict__ table,
                                const uint8_t* __restrict__ fp, int h_bits, uint32_t H,
                                uint32_t salt, uint32_t lo, uint32_t n,
                                const uint8_t* __restrict__ bases, int L, int k) {
  const ShardCuckooProbe probe{table, fp, h_bits, salt, H, lo, n, nullptr};
  if constexpr (kSide < 0) {
    shard_count_tiles(counts, probe, bases, L, k);
  } else {
    shard_count_tiles(counts, ShardCuckooSideProbe<kSide>{probe}, bases, L, k);
  }
}

// Cuckoo K3s on a shard of the whole table (lo = 0, all 2H slots: I = 1):
// the first form, K3's one-tile block with ShardCuckooProbe (the note
// above).
__global__ void __launch_bounds__(kTile)
shard_cuckoo_count_step_kernel(uint32_t* __restrict__ counts, const uint2* __restrict__ table,
                               const uint8_t* __restrict__ fp, int h_bits, uint32_t H,
                               uint32_t salt, uint32_t lo, uint32_t n,
                               const uint8_t* __restrict__ bases, int L, int k) {
  count_step_tile<false>(counts, ShardCuckooProbe{table, fp, h_bits, salt, H, lo, n, nullptr},
                         bases, L, k, nullptr);
}

// ---------------------------------------------------------------------------
// R shard_reduce
//
// Replaces: the psum over the index axis of K4s's planes and K6s's words
//   (strainer2_tpu/parallel/sharding.py:191-192, :285-291, :328-329): out[j]
//   = OR (kMasks) or uint32-wrapping sum of part p's word j over the I
//   shards' buffers, each read where it lies. The sum form is the psum of
//   K6s's meta words: a key lives in one shard, so it adds one nonzero word
//   to zeros. In the masks form n is 16 words a tile (K4's layout: 8 hit
//   words, 8 informative words), and each tile's count word hits << 16 |
//   informative is recounted from the OR, never summed: a bit set on two
//   shards counts once.
// Bound on this card: device-memory bytes, I + 1 copies of the words (the
//   masks form adds a count word a tile). K6s's words of a 256 x 4096
//   batch at S = 256, I = 4: 0.1079-0.1090 ms, 0.91-0.92 of its bound,
//   where torch's sum of the stacked words took 0.1091-0.1103 and the
//   stack alone 0.180-0.222; I = 2 0.0667-0.0687 (0.87-0.89), I = 8
//   0.194-0.197 (0.91-0.92); S = 32, I = 4 0.0144-0.0148 (0.84-0.86). The
//   earlier form, a thread a word reading the parts one after another from
//   the stack, took 0.1344-0.1345 at S = 256, I = 4 (0.74). The masks form
//   is launch-bound: 0.0018-0.0021 ms at I = 2-8. A grid-stride loop of 8
//   blocks an SM took 0.1131, two vectors a thread 0.1081, loads that skip
//   the L1 0.1110 (H100 80GB HBM3, 700 W; bench_kernels.py --reduce and
//   chip_smoke.py phase 2c; PERF.md).
// Design: the I part pointers by value (ReduceParts, up to kReduceMaxParts;
//   a longer list folds in passes, each adding out as its first part); a
//   thread owns a 16-byte vector of 4 words, loads it from every part
//   through the read-only path before its first add (kParts is a template
//   parameter, so the parts loop unrolls), and stores one uint4. A part
//   that is not 16-byte aligned (a view at an offset) is read by four
//   4-byte loads, the choice uniform over the grid (bit p of `flags`);
//   out, read back as part 0 of a later pass, by plain loads (kAcc); the
//   n % 4 words past the last vector are added by thread 0. In the
//   masks form a tile is a quad of threads: lanes 0-1 hold its hit words,
//   2-3 its informative words; two shuffles inside the quad give the
//   counts and the quad's first lane writes the count word. The
//   griddepcontrol trigger follows the stores, so K4's sums launch follows
//   by PDL.
// ---------------------------------------------------------------------------
constexpr int kReduceThreads = 256;
constexpr int kReduceMaxParts = 8;

struct ReduceParts {
  const uint32_t* p[kReduceMaxParts];
};

constexpr unsigned kAcc = 1u << kReduceMaxParts;  // flags: part 0 is out, written by this pass

__device__ __forceinline__ uint4 load_words4(const uint32_t* p, bool aligned, bool acc) {
  if (acc) return *reinterpret_cast<const uint4*>(p);  // out is always aligned
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool kMasks>
__device__ __forceinline__ uint4 reduce4(uint4 a, uint4 b) {
  return kMasks ? make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w)
                : make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <bool kMasks, int kParts>
__global__ void __launch_bounds__(kReduceThreads)
shard_reduce_kernel(ReduceParts parts, unsigned flags, long long n, uint32_t* out,
                    uint32_t* __restrict__ tile_counts) {
  const long long n4 = n >> 2;
  const long long v = blockIdx.x * static_cast<long long>(kReduceThreads) + threadIdx.x;
  uint4 r = make_uint4(0, 0, 0, 0);
  if (v < n4) {
    uint4 x[kParts];
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      x[p] = load_words4(parts.p[p] + 4 * v, flags >> p & 1, p == 0 && (flags & kAcc));
    r = x[0];
#pragma unroll
    for (int p = 1; p < kParts; ++p) r = reduce4<kMasks>(r, x[p]);
    *reinterpret_cast<uint4*>(out + 4 * v) = r;
  }
  if constexpr (kMasks) {  // n4 is 4 a tile: a quad is wholly in or past the tiles
    const unsigned quad = 0xFu << (threadIdx.x & 28);
    const int c = __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
    const int s = c + __shfl_xor_sync(quad, c, 1, 4);  // lane 0: hits, lane 2: informative
    const int inf = __shfl_down_sync(quad, s, 2, 4);
    if (v < n4 && (threadIdx.x & 3) == 0)
      tile_counts[v >> 2] = static_cast<uint32_t>(s) << 16 | static_cast<uint32_t>(inf);
    asm volatile("griddepcontrol.launch_dependents;");  // the sums launch follows by PDL
  } else if (v == 0) {
    for (long long w = 4 * n4; w < n; ++w) {
      uint32_t t = 0;
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        t += p == 0 && (flags & kAcc) ? out[w] : __ldg(parts.p[p] + w);
      out[w] = t;
    }
  }
}

using ReduceKernel = void (*)(ReduceParts, unsigned, long long, uint32_t*, uint32_t*);

template <bool kMasks>
ReduceKernel reduce_kernel(int n_parts) {
  switch (n_parts) {
    case 2: return shard_reduce_kernel<kMasks, 2>;
    case 3: return shard_reduce_kernel<kMasks, 3>;
    case 4: return shard_reduce_kernel<kMasks, 4>;
    case 5: return shard_reduce_kernel<kMasks, 5>;
    case 6: return shard_reduce_kernel<kMasks, 6>;
    case 7: return shard_reduce_kernel<kMasks, 7>;
    default: return shard_reduce_kernel<kMasks, 8>;
  }
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
  return launch_dependent(hit_crossing_kernel, dim3(1), st, true, m, c, n_rows * tpr, W, tpr,
                          remaining, static_cast<int32_t*>(out));
}

// masks: n_tiles x 16 uint32 scratch (a tile's hit words, then its
// informative words), 16-byte aligned; counts: n_tiles uint32 scratch (a
// tile's hits << 16 | informative), 16-byte aligned; n_tiles = n_rows x
// ceil(W / 256); max_reads >= 1. The sums launch follows the masks launch
// by PDL (a plain launch where n_rows is 0 and there is no masks launch).
int s2t_classify_step(const void* rows, int row_width, int h_bits,
                      uint32_t salt, const void* bases, int n_rows, int L,
                      int k, const void* bounds, int max_reads, void* masks,
                      void* counts, void* tot, void* inf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = L - k + 1;
  const int tpr = (W + kTile - 1) / kTile;
  uint32_t* m = static_cast<uint32_t*>(masks);
  uint32_t* c = static_cast<uint32_t*>(counts);
  if (n_rows) {
    classify_masks_kernel<<<dim3(tpr, n_rows), kTile, 0, st>>>(
        static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
        static_cast<const uint8_t*>(bases), L, k, m, c);
  }
  return launch_dependent(classify_sums_kernel, dim3((max_reads + kTile - 1) / kTile), st,
                          n_rows > 0, m, c, n_rows * tpr, n_rows, W, tpr,
                          static_cast<const int32_t*>(bounds), max_reads,
                          static_cast<int32_t*>(tot), static_cast<int32_t*>(inf));
}

// K4e after K4 (s2t_classify_step or s2t_cuckoo_classify_step) on the same
// stream, chained by PDL: masks, tot and inf are K4's, bounds its
// boundaries (non-decreasing, as the packer writes them); the units are
// the first n_reads reads, or their n_reads / 2 pairs where paired. counts:
// two int32; sums: 5 int32 a unit; codes (uint64) and ords (int32): a
// cell a window of the batch; bases 4-byte aligned.
int s2t_classify_select(const void* masks, const void* bases, int n_rows, int L, int k,
                        const void* bounds, const void* tot, const void* inf, int n_reads,
                        int paired, int min_t, int min_i, void* counts, void* sums, void* codes,
                        void* ords, void* stream) {
  const int tpr = (L - k + 1 + kTile - 1) / kTile;
  const int n_units = paired ? n_reads / 2 : n_reads;
  const dim3 grid(std::max(1, (n_units + kSelUnits - 1) / kSelUnits));
  return launch_dependent(paired ? classify_select_kernel<true> : classify_select_kernel<false>,
                          grid, static_cast<cudaStream_t>(stream), true,
                          static_cast<const uint32_t*>(masks), static_cast<const uint8_t*>(bases),
                          n_rows, L, k, tpr, static_cast<const int32_t*>(bounds),
                          static_cast<const int32_t*>(tot), static_cast<const int32_t*>(inf),
                          n_units, min_t, min_i, static_cast<int32_t*>(counts),
                          static_cast<int32_t*>(sums), static_cast<unsigned long long*>(codes),
                          static_cast<int32_t*>(ords));
}

// ---- the cuckoo layout: table is 2H (hi, lo) uint32 pairs, 8-byte aligned;
// fp its 2H slot fingerprints (s2t_cuckoo_fingerprints); slots are int32 in
// [0, 2H); counts and meta hold 2H uint32 cells.  Every probing launch
// carries the L2 window on fp.

// fp[s] for the n slots of table; raises the card's persisting-L2 set-aside
// to n bytes (at most the card's largest) for the probes' windows.
int s2t_cuckoo_fingerprints(const void* table, long long n, void* fp, void* stream) {
  int dev = 0, max_persist = 0;
  size_t set_aside = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
  cudaDeviceGetLimit(&set_aside, cudaLimitPersistingL2CacheSize);
  const size_t want = static_cast<size_t>(n) < static_cast<size_t>(max_persist)
                          ? static_cast<size_t>(n) : static_cast<size_t>(max_persist);
  if (want > set_aside) {
    const cudaError_t rc = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, want);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int threads = 256;
  cuckoo_fingerprints_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(table), n, static_cast<uint8_t*>(fp));
  return launch_status();
}

int s2t_cuckoo_lookup(const void* table, const void* fp, int h_bits, int H, uint32_t salt,
                      const void* qhi, const void* qlo, long long n, void* found, void* slot,
                      void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  return launch_cuckoo(cuckoo_lookup_kernel, dim3(static_cast<unsigned>(blocks)), dim3(threads),
                       static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(fp),
                       static_cast<uint32_t>(H), static_cast<const uint2*>(table),
                       static_cast<const uint8_t*>(fp), h_bits, static_cast<uint32_t>(H), salt,
                       static_cast<const uint32_t*>(qhi), static_cast<const uint32_t*>(qlo),
                       static_cast<int64_t>(n), static_cast<uint8_t*>(found),
                       static_cast<int32_t*>(slot));
}

int s2t_cuckoo_count_step(void* counts, const void* table, const void* fp, int h_bits, int H,
                          uint32_t salt, const void* bases, int n_rows, int L, int k,
                          void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, n_rows);
  return launch_cuckoo(cuckoo_count_step_kernel, grid, dim3(kTile),
                       static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(fp),
                       static_cast<uint32_t>(H), static_cast<uint32_t*>(counts),
                       static_cast<const uint2*>(table), static_cast<const uint8_t*>(fp), h_bits,
                       static_cast<uint32_t>(H), salt, static_cast<const uint8_t*>(bases), L, k);
}

int s2t_cuckoo_count_valid_step(void* counts, const void* table, const void* fp, int h_bits,
                                int H, uint32_t salt, const void* bases, int n_rows, int L, int k,
                                void* tally, void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, n_rows);
  return launch_cuckoo(cuckoo_count_valid_step_kernel, grid, dim3(kTile),
                       static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(fp),
                       static_cast<uint32_t>(H), static_cast<uint32_t*>(counts),
                       static_cast<const uint2*>(table), static_cast<const uint8_t*>(fp), h_bits,
                       static_cast<uint32_t>(H), salt, static_cast<const uint8_t*>(bases), L, k,
                       static_cast<long long*>(tally));
}

int s2t_cuckoo_hit_accumulate(void* acc, const void* table, const void* fp, int h_bits, int H,
                              uint32_t salt, const void* bases, int n_rows, int L, int k,
                              void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kTile - 1) / kTile, n_rows);
  return launch_cuckoo(cuckoo_hit_accumulate_kernel, grid, dim3(kTile),
                       static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(fp),
                       static_cast<uint32_t>(H), static_cast<unsigned long long*>(acc),
                       static_cast<const uint2*>(table), static_cast<const uint8_t*>(fp), h_bits,
                       static_cast<uint32_t>(H), salt, static_cast<const uint8_t*>(bases), L, k);
}

int s2t_cuckoo_hit_stats(const void* table, const void* fp, int h_bits, int H, uint32_t salt,
                         const void* bases, int n_rows, int L, int k, int remaining, void* masks,
                         void* tile_counts, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = L - k + 1;
  const int tpr = (W + kTile - 1) / kTile;
  uint32_t* m = static_cast<uint32_t*>(masks);
  uint32_t* c = static_cast<uint32_t*>(tile_counts);
  const int rc = launch_cuckoo(cuckoo_hit_stats_kernel, dim3(tpr, n_rows), dim3(kTile), st,
                               static_cast<const uint8_t*>(fp), static_cast<uint32_t>(H),
                               static_cast<const uint2*>(table), static_cast<const uint8_t*>(fp),
                               h_bits, static_cast<uint32_t>(H), salt,
                               static_cast<const uint8_t*>(bases), L, k, m, c);
  if (rc != 0) return rc;
  return launch_dependent(hit_crossing_kernel, dim3(1), st, true, m, c, n_rows * tpr, W, tpr,
                          remaining, static_cast<int32_t*>(out));
}

// masks, counts and max_reads as s2t_classify_step's.
int s2t_cuckoo_classify_step(const void* table, const void* fp, const void* meta, int h_bits,
                             int H, uint32_t salt, const void* bases, int n_rows, int L, int k,
                             const void* bounds, int max_reads, void* masks, void* counts,
                             void* tot, void* inf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = L - k + 1;
  const int tpr = (W + kTile - 1) / kTile;
  uint32_t* m = static_cast<uint32_t*>(masks);
  uint32_t* c = static_cast<uint32_t*>(counts);
  if (n_rows) {
    const int rc = launch_cuckoo(
        cuckoo_classify_masks_kernel, dim3(tpr, n_rows), dim3(kTile), st,
        static_cast<const uint8_t*>(fp), static_cast<uint32_t>(H),
        static_cast<const uint2*>(table), static_cast<const uint8_t*>(fp),
        static_cast<const uint32_t*>(meta), h_bits, static_cast<uint32_t>(H), salt,
        static_cast<const uint8_t*>(bases), L, k, m, c);
    if (rc != 0) return rc;
  }
  return launch_dependent(classify_sums_kernel, dim3((max_reads + kTile - 1) / kTile), st,
                          n_rows > 0, m, c, n_rows * tpr, n_rows, W, tpr,
                          static_cast<const int32_t*>(bounds), max_reads,
                          static_cast<int32_t*>(tot), static_cast<int32_t*>(inf));
}


// ---- the shard-window kernels: lo and n are the shard's first bucket (or
// slot) and its count; rows, table, fp, meta and counts hold the shard's own
// n buckets or slots.

// K3s: a block counts kShardTiles tiles of a row (shard_count_tiles_kernel);
// a shard of the whole table is K3's work, and K3 counts it.
int s2t_shard_count_step(void* counts, const void* rows, int row_width, int h_bits,
                         uint32_t salt, int lo, int n, const void* bases, int n_rows, int L,
                         int k, void* stream) {
  if (lo == 0 && static_cast<long long>(n) == 1ll << h_bits)
    return s2t_count_step(counts, rows, row_width, h_bits, salt, bases, n_rows, L, k, stream);
  const int W = L - k + 1;
  shard_count_tiles_kernel<<<dim3((W + kShardWindows - 1) / kShardWindows, n_rows), kTile, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counts), static_cast<const uint32_t*>(rows), row_width, h_bits, salt,
      static_cast<uint32_t>(lo), static_cast<uint32_t>(n), static_cast<const uint8_t*>(bases), L,
      k);
  return launch_status();
}

int s2t_shard_cuckoo_count_step(void* counts, const void* table, const void* fp, int h_bits,
                                int H, uint32_t salt, int lo, int n, const void* bases,
                                int n_rows, int L, int k, void* stream) {
  const int W = L - k + 1;
  const bool whole = lo == 0 && n == 2 * H;
  const int windows = whole ? kTile : kShardWindows;
  const auto kernel = whole       ? &shard_cuckoo_count_step_kernel
                      : lo + n <= H ? &shard_cuckoo_count_tiles_kernel<0>
                      : lo >= H     ? &shard_cuckoo_count_tiles_kernel<1>
                                    : &shard_cuckoo_count_tiles_kernel<-1>;
  return launch_windowed(kernel, dim3((W + windows - 1) / windows, n_rows), dim3(kTile),
                         static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(fp),
                         static_cast<size_t>(n), static_cast<uint32_t*>(counts),
                         static_cast<const uint2*>(table), static_cast<const uint8_t*>(fp), h_bits,
                         static_cast<uint32_t>(H), salt, static_cast<uint32_t>(lo),
                         static_cast<uint32_t>(n), static_cast<const uint8_t*>(bases), L, k);
}

// masks and counts as s2t_classify_step's scratch: n_rows x ceil(W / 256)
// tiles of 16 mask words and a count word; a block screens kShardTiles
// tiles of a row.
int s2t_shard_classify_masks(const void* rows, int row_width, int h_bits, uint32_t salt, int lo,
                             int n, const void* bases, int n_rows, int L, int k, void* masks,
                             void* counts, void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kShardWindows - 1) / kShardWindows, n_rows);
  shard_classify_masks_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), row_width, h_bits, salt, static_cast<uint32_t>(lo),
      static_cast<uint32_t>(n), static_cast<const uint8_t*>(bases), L, k,
      static_cast<uint32_t*>(masks), static_cast<uint32_t*>(counts));
  return launch_status();
}

int s2t_shard_cuckoo_classify_masks(const void* table, const void* fp, const void* meta,
                                    int h_bits, int H, uint32_t salt, int lo, int n,
                                    const void* bases, int n_rows, int L, int k, void* masks,
                                    void* counts, void* stream) {
  const int W = L - k + 1;
  const dim3 grid((W + kShardWindows - 1) / kShardWindows, n_rows);
  const auto kernel = lo + n <= H ? &shard_cuckoo_classify_masks_kernel<0>
                      : lo >= H   ? &shard_cuckoo_classify_masks_kernel<1>
                                  : &shard_cuckoo_classify_masks_kernel<-1>;
  return launch_windowed(kernel, grid, dim3(kTile),
                         static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(fp),
                         static_cast<size_t>(n), static_cast<const uint2*>(table),
                         static_cast<const uint8_t*>(fp), static_cast<const uint32_t*>(meta),
                         h_bits, static_cast<uint32_t>(H), salt, static_cast<uint32_t>(lo),
                         static_cast<uint32_t>(n), static_cast<const uint8_t*>(bases), L, k,
                         static_cast<uint32_t*>(masks), static_cast<uint32_t*>(counts));
}

// R over the n_parts buffers of n words each whose addresses are parts[0..n_parts)
// (a host array; n_parts >= 2): masks != 0 ORs K4s's masks (n = 16 x tiles)
// and writes each tile's count word into tile_counts; masks == 0 adds K6s's
// words (tile_counts unused). out must be 16-byte aligned.
int s2t_shard_reduce(const void* parts, int n_parts, long long n, int masks, void* out,
                     void* tile_counts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t* const*>(parts);
  auto* dst = static_cast<uint32_t*>(out);
  if (n_parts < 2 || reinterpret_cast<uintptr_t>(dst) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(
      std::max<long long>(1, ((n >> 2) + kReduceThreads - 1) / kReduceThreads));
  // a pass: up to kReduceMaxParts parts, out the first of them after the first pass
  for (int done = 0; done < n_parts;) {
    ReduceParts rp{};
    int k = 0;
    unsigned flags = 0;
    if (done > 0) {
      rp.p[k++] = dst;
      flags = kAcc;
    }
    while (k < kReduceMaxParts && done < n_parts) rp.p[k++] = in[done++];
    for (int p = 0; p < k; ++p)
      flags |= (reinterpret_cast<uintptr_t>(rp.p[p]) % 16 == 0 ? 1u : 0u) << p;
    const ReduceKernel kernel = masks ? reduce_kernel<true>(k) : reduce_kernel<false>(k);
    kernel<<<blocks, kReduceThreads, 0, st>>>(rp, flags, n, dst,
                                              masks ? static_cast<uint32_t*>(tile_counts) : nullptr);
    if (const int rc = launch_status()) return rc;
  }
  return 0;
}

// K4's second launch on its own: per-read (total, informative) of reads
// [0, max_reads) from the n_rows x ceil(W / 256) tiles of masks and counts
// (a K4s launch's, or R's), chained by PDL to the launch before it.
int s2t_classify_sums(const void* masks, const void* counts, int n_rows, int L, int k,
                      const void* bounds, int max_reads, void* tot, void* inf, void* stream) {
  const int W = L - k + 1;
  const int tpr = (W + kTile - 1) / kTile;
  return launch_dependent(classify_sums_kernel, dim3((max_reads + kTile - 1) / kTile),
                          static_cast<cudaStream_t>(stream), n_rows > 0,
                          static_cast<const uint32_t*>(masks),
                          static_cast<const uint32_t*>(counts), n_rows * tpr, n_rows, W, tpr,
                          static_cast<const int32_t*>(bounds), max_reads,
                          static_cast<int32_t*>(tot), static_cast<int32_t*>(inf));
}

}  // extern "C"
