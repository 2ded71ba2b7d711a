// Device helpers shared by the port's CUDA sources (strainer2_kernels.cu,
// strainer2_multi.cu).  Every definition here must equal the JAX package's
// bit for bit:
// - a k-mer (k <= 32) is packed MSB-first, A=0 C=1 G=2 T=3; the canonical
//   code is max(forward, reverse complement), forward on ties; it is split
//   at a base boundary into lo = last min(k,16) bases, hi = the rest
//   (strainer2_tpu/ops/packing.py:22-26);
// - a window is valid when all k bases are < INVALID_BASE (4);
// - a bucket row is row_width uint32 lanes: 16 key_hi | 16 key_lo | 16 meta
//   | ... (strainer2_tpu/index/bucket.py); bucket = cuckoo_slots(hi ^ salt,
//   lo, h_bits, 0) (strainer2_tpu/index/hashing.py); slot = bucket * 16 +
//   cell of the FIRST equal cell, as jnp.argmax picks it
//   (strainer2_tpu/ops/lookup.py:128); a meta word is the uint32-wrapping
//   SUM of that lane over every equal cell, as _meta_block sums it
//   (strainer2_tpu/ops/lookup.py:133-136; meta_sum);
// - a cuckoo table is 2H slots of (hi, lo) uint32 pairs
//   (strainer2_tpu/index/cuckoo.py); a key's slots are cuckoo_slot(hi ^ salt,
//   lo, h_bits, 0) and cuckoo_slot(hi ^ salt, lo, h_bits, 1) + H;
// - an index shard (strainer2_tpu/parallel/sharding.py) is a contiguous
//   block of whole buckets or of slots; a key is the shard's where its
//   bucket (or slot) lies in the block.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace s2t {

constexpr uint32_t kInvalidBase = 4;
constexpr int kKeysPerBucket = 16;
constexpr int kMetaLane = 32;
constexpr int kTile = 256;  // windows per block of K3, K4, K6, K8 and K9
constexpr int kPackedBases = kTile + 64;  // a packed tile: its windows' bases and the 64
                                          // that packed_window's reads run past them

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// cuckoo_slots(hi, lo, h_bits, which) (strainer2_tpu/index/hashing.py), with
// both constant sets; the cuckoo layout salts hi before it calls this.
// Same values as the host library's cuckoo_slot (csrc/host/strainer2_host.cc).
__device__ __forceinline__ uint32_t cuckoo_slot(uint32_t hi, uint32_t lo, int h_bits, int which) {
  const uint32_t a = which ? 0x27D4EB2Fu : 0x9E3779B1u;
  const uint32_t b = which ? 0x165667B1u : 0x85EBCA77u;
  const uint32_t c = which ? 0xD3A2646Du : 0xC2B2AE3Du;
  const uint32_t x = mix32((hi * a) ^ (lo * b) ^ c);
  return h_bits < 32 ? x >> (32 - h_bits) : x;
}

// cuckoo_slots(hi ^ salt, lo, h_bits, which=0)
__device__ __forceinline__ uint32_t bucket_of(uint32_t hi, uint32_t lo,
                                              int h_bits, uint32_t salt) {
  uint32_t x = ((hi ^ salt) * 0x9E3779B1u) ^ (lo * 0x85EBCA77u) ^ 0xC2B2AE3Du;
  x = mix32(x);
  return h_bits < 32 ? x >> (32 - h_bits) : x;
}

// The bases of one row's tile packed for constant-time window codes:
// kBases bases from the tile's first (its windows' bases and the 64 that
// packed_window's reads run past them), as 2-bit codes b & 3, LSB-first,
// 16 a word (base i at bits 2 (i % 16) of code[i / 16]), and one bit a
// base that is invalid (>= 4), 32 a word (bit i % 32 of bad[i / 32]).
// Bases past the row's end pack as invalid; no window of the row reads
// them.  K3, K4, K6, K8 and K9 use PackedTile (kTile windows), K1 a
// larger tile.
template <int kBases>
struct PackedBases {
  static_assert(kBases % 32 == 0, "a packed tile holds whole bad words");
  uint32_t code[kBases / 16];
  uint32_t bad[kBases / 32];
};
using PackedTile = PackedBases<kPackedBases>;

// Pack bases [w0, w0 + kBases) of the row at src (L bases) into t; every
// thread of the block calls it (blockDim a multiple of 32).  A warp packs
// 32 consecutive bases a step: its invalid bits are one __ballot_sync, and
// each half warp ORs its 16 shifted 2-bit codes together in four shuffles.
template <int kBases>
__device__ __forceinline__ void pack_tile(PackedBases<kBases>& t, const uint8_t* src, int w0, int L) {
  const int span = min(kBases, L - w0);
  const int lane = threadIdx.x & 31;
  for (int i0 = threadIdx.x - lane; i0 < kBases; i0 += blockDim.x) {  // warp-uniform
    const int i = i0 + lane;
    const uint32_t b = i < span ? src[w0 + i] : kInvalidBase;
    const unsigned bad = __ballot_sync(0xffffffffu, b >= kInvalidBase);
    uint32_t v = (b & 3u) << (2 * (lane & 15));
#pragma unroll
    for (int m = 8; m; m >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, m);
    if ((lane & 15) == 0) t.code[i >> 4] = v;
    if (lane == 0) t.bad[i >> 5] = bad;
  }
  __syncthreads();
}

// The 32 2-bit pairs of x in reverse order.
__device__ __forceinline__ uint64_t reverse_pairs(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// The 2-bit codes b & 3 (byte j's at bits 2j) and the invalid bits (bit j
// where byte j >= 4) of the four bases in the bytes of x, without a loop:
// a multiply gathers byte j's low pair at bits 2j of the top byte (every
// partial sum stays below 256, so nothing carries), and the top byte of a
// second multiply gathers each byte's "not below 4" bit.
__device__ __forceinline__ void pack4(uint32_t x, uint32_t* code, uint32_t* bad) {
  *code = ((x & 0x03030303u) * 0x01041040u) >> 24;
  const uint32_t high = x & 0xFCFCFCFCu;                                   // byte != 0 iff >= 4
  const uint32_t nz = (((high & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | high) & 0x80808080u;
  *bad = ((nz >> 7) * 0x01020408u) >> 24;
}

// pack_tile by 16-base groups (K1): a thread packs group g, bases
// [16 g, 16 g + 16), into code[g] and half of bad[g / 2] (the other half
// from its neighbour lane by one shuffle).  Where the tile's first base
// is 16-byte aligned (rows of L = 4096 are), a whole group is one 16-byte
// load; a group past the row's end, or every group of an unaligned tile,
// is read a byte at a time.  Same words as pack_tile; on K1's 1,088-base
// tile 1.25-1.29x faster than it (H100 80GB HBM3, 700 W; PERF.md).
template <int kBases>
__device__ __forceinline__ void pack_tile_wide(PackedBases<kBases>& t, const uint8_t* src, int w0,
                                               int L) {
  constexpr int kGroups = kBases / 16;
  const uint8_t* p = src + w0;
  const int span = min(kBases, L - w0);
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const int lane = threadIdx.x & 31;
  for (int g0 = threadIdx.x - lane; g0 < kGroups; g0 += blockDim.x) {  // warp-uniform
    const int g = g0 + lane;
    const int i = 16 * g;
    uint32_t x[4];
    if (aligned && i + 16 <= span) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + i));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = i + 4 * j + b;
          x[j] |= static_cast<uint32_t>(n < span ? p[n] : kInvalidBase) << (8 * b);
        }
      }
    }
    uint32_t code = 0, bad = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t c, b;
      pack4(x[j], &c, &b);
      code |= c << (8 * j);
      bad |= b << (4 * j);
    }
    const uint32_t next = __shfl_down_sync(0xffffffffu, bad, 1);  // group g + 1's bits
    if (g < kGroups) {
      t.code[g] = code;
      if (!(g & 1)) t.bad[g >> 1] = bad | next << 16;
    }
  }
  __syncthreads();
}

// The canonical (hi, lo) of the k bases at tile position p < kBases - 64
// (it reads three code words and two bad words from p's on), and whether
// the window is valid, in a constant number of steps: the 64-bit run x of
// the 32 bases from p (base p + i at pair i) comes from three code words
// by two funnel shifts; the reverse complement is ~x cut to k pairs, the
// forward code x with its pairs reversed, shifted down to k pairs; the
// window is valid when its k bits of the invalid-base mask are 0.  Invalid
// bases pack as b & 3, as the plain version (ops/packing.py) packs them,
// so the two agree on every window, valid or not, k in [1, 32].
template <int kBases>
__device__ __forceinline__ bool packed_window(const PackedBases<kBases>& t, int p, int k, int n_lo,
                                              uint32_t* hi, uint32_t* lo) {
  const int j = p >> 4;
  const int s = 2 * (p & 15);
  const uint32_t a = t.code[j], b = t.code[j + 1], c = t.code[j + 2];
  const uint64_t x = static_cast<uint64_t>(__funnelshift_r(b, c, s)) << 32 | __funnelshift_r(a, b, s);
  const int drop = 64 - 2 * k;  // 0 at k = 32: no shift by 64
  const uint64_t rc = ~x & (~0ull >> drop);
  const uint64_t fwd = reverse_pairs(x) >> drop;
  const uint64_t code = fwd >= rc ? fwd : rc;
  *lo = static_cast<uint32_t>(code & ((1ull << (2 * n_lo)) - 1ull));
  *hi = static_cast<uint32_t>(code >> (2 * n_lo));
  const int q = p >> 5;
  const uint32_t bad = __funnelshift_r(t.bad[q], t.bad[q + 1], p & 31);
  return (bad & (0xffffffffu >> (32 - k))) == 0;
}

// 4-bit mask of the four lanes of a that equal v.
__device__ __forceinline__ unsigned eq4(uint4 a, uint32_t v) {
  return static_cast<unsigned>((a.x == v) | (a.y == v) << 1 | (a.z == v) << 2 | (a.w == v) << 3);
}

// 16-bit mask of the 16 lanes at p that equal v: four 16-byte loads.
__device__ __forceinline__ unsigned lanes_equal(const uint32_t* p, uint32_t v) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) m |= eq4(__ldg(p4 + i), v) << (4 * i);
  return m;
}

// 16-bit mask of the row's cells whose key equals (hi, lo).  The 16 key_lo
// lanes are read only where a key_hi lane matches, so a miss usually costs
// 64 bytes, not 128; a cell whose key_hi matches and key_lo does not is
// not in the mask.
__device__ __forceinline__ unsigned match_mask(const uint32_t* row,
                                               uint32_t hi, uint32_t lo) {
  const unsigned m = lanes_equal(row, hi);
  return m ? m & lanes_equal(row + kKeysPerBucket, lo) : 0u;
}

// The meta word of a key from the 16-lane block at p, m (not 0) the mask of
// its equal cells: the uint32-wrapping sum of p[cell] over the set bits of
// m, as the JAX lookups sum it.  A built table holds each key once, so this
// is one load and one more test; it loops only where a row holds a key twice.
__device__ __forceinline__ uint32_t meta_sum(const uint32_t* p, unsigned m) {
  uint32_t v = __ldg(p + __ffs(m) - 1);
  for (m &= m - 1; m; m &= m - 1) v += __ldg(p + __ffs(m) - 1);
  return v;
}

// ---------------------------------------------------------------------------
// Probe policies of K3, K4, K6, K8 and K9 (and their shard-window forms):
// find() returns nonzero where the table holds the key (hi, lo) and sets
// *where; slot() is the count index of a hit, meta() its detection class,
// row() (bucket policies) the row that holds it.  The cuckoo policies are
// in strainer2_kernels.cu.
// ---------------------------------------------------------------------------
// The bucket rows (K2's probe): where = the bucket, the mask its equal cells.
struct BucketProbe {
  const uint32_t* rows;
  int row_width;
  int h_bits;
  uint32_t salt;

  __device__ __forceinline__ unsigned find(uint32_t h, uint32_t l, uint32_t* where) const {
    *where = bucket_of(h, l, h_bits, salt);
    return match_mask(rows + static_cast<size_t>(*where) * row_width, h, l);
  }
  __device__ __forceinline__ const uint32_t* row(uint32_t where) const {
    return rows + static_cast<size_t>(where) * row_width;
  }
  __device__ __forceinline__ size_t slot(uint32_t where, unsigned m) const {
    return static_cast<size_t>(where) * kKeysPerBucket + (__ffs(m) - 1);
  }
  __device__ __forceinline__ uint32_t meta(uint32_t where, unsigned m) const {
    return meta_sum(row(where) + kMetaLane, m);
  }
};

// One index shard of the bucket rows (the sharded twin of JAX's
// _bucket_local_lookup, strainer2_tpu/parallel/sharding.py:209): rows holds
// the n buckets [lo, lo + n) of the table; a key whose bucket lies outside
// them is a miss with no memory read.  where = the local bucket, so slot()
// is the shard's own count index (local bucket * 16 + the first equal cell).
struct ShardBucketProbe {
  const uint32_t* rows;  // the shard's n rows
  int row_width;
  int h_bits;
  uint32_t salt;
  uint32_t lo;  // the shard's first bucket
  uint32_t n;   // its buckets

  __device__ __forceinline__ unsigned find(uint32_t h, uint32_t l, uint32_t* where) const {
    const uint32_t b = bucket_of(h, l, h_bits, salt) - lo;  // wraps below lo
    if (b >= n) return 0u;
    *where = b;
    return match_mask(rows + static_cast<size_t>(b) * row_width, h, l);
  }
  __device__ __forceinline__ const uint32_t* row(uint32_t where) const {
    return rows + static_cast<size_t>(where) * row_width;
  }
  __device__ __forceinline__ size_t slot(uint32_t where, unsigned m) const {
    return static_cast<size_t>(where) * kKeysPerBucket + (__ffs(m) - 1);
  }
  __device__ __forceinline__ uint32_t meta(uint32_t where, unsigned m) const {
    return meta_sum(row(where) + kMetaLane, m);
  }
};

// The probe of window w0 + p of a packed tile (K3, K4, K6, K8, K9): nonzero
// where the window is valid and its key is in the table (*where as the
// probe sets it); *valid says whether the window is valid.
template <class Probe>
__device__ __forceinline__ unsigned probe_valid_window(const PackedTile& t, int p,
                                                       const Probe& probe, int w0, int W, int k,
                                                       uint32_t* where, bool* valid) {
  uint32_t h, l;
  *valid = w0 + p < W && packed_window(t, p, k, min(k, 16), &h, &l);
  if (!*valid) return 0u;
  return probe.find(h, l, where);
}

// The block of the shard-window kernels K3s, K4s (strainer2_kernels.cu) and
// K6s (strainer2_multi.cu): kTiles 256-window tiles of one row (block x of
// row y), packed once by 16-byte loads (pack_tile_wide), then for each
// tile j, act(j, m, where) on this thread's window j * kTile + threadIdx.x,
// m the probe's mask (0 where the window is past the row's end, invalid,
// or its key not the shard's; act takes where by reference and reads it
// only where m is not 0). Every thread reaches every act, so act may
// ballot or sync its warp.
constexpr int kShardTiles = 4;  // 256-window tiles a K3s or K4s block screens
constexpr int kShardWindows = kShardTiles * kTile;

template <int kTiles = kShardTiles, class Probe, class Act>
__device__ __forceinline__ void shard_tiles(const Probe& probe, const uint8_t* __restrict__ bases,
                                            int L, int k, Act act) {
  __shared__ PackedBases<kTiles * kTile + 64> tile;
  const int w0 = blockIdx.x * kTiles * kTile;
  const int W = L - k + 1;
  const int n_lo = min(k, 16);
  pack_tile_wide(tile, bases + static_cast<size_t>(blockIdx.y) * L, w0, L);
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const int p = j * kTile + threadIdx.x;
    uint32_t h, l, where;
    unsigned m = 0u;
    if (w0 + p < W && packed_window(tile, p, k, n_lo, &h, &l)) m = probe.find(h, l, &where);
    act(j, m, where);  // by reference: where is set only where m is not 0
  }
}

// Index b of a read boundary into a prefix of q + 1 entries, as a JAX gather
// reads it: a negative b counts from the end (b + q + 1), then the index is
// clamped to [0, q].
__device__ __forceinline__ int gather_index(int b, int q) {
  if (b < 0) b += q + 1;
  return min(max(b, 0), q);
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace s2t
