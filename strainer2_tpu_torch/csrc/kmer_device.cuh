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
//   (strainer2_tpu/ops/lookup.py:128).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace s2t {

constexpr uint32_t kInvalidBase = 4;
constexpr int kKeysPerBucket = 16;
constexpr int kMetaLane = 32;
constexpr int kTile = 256;  // windows per block of the window-parallel kernels
constexpr int kMaxK = 32;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// cuckoo_slots(hi ^ salt, lo, h_bits, which=0)
__device__ __forceinline__ uint32_t bucket_of(uint32_t hi, uint32_t lo,
                                              int h_bits, uint32_t salt) {
  uint32_t x = ((hi ^ salt) * 0x9E3779B1u) ^ (lo * 0x85EBCA77u) ^ 0xC2B2AE3Du;
  x = mix32(x);
  return h_bits < 32 ? x >> (32 - h_bits) : x;
}

// Canonical (hi, lo) of the k bases at p; returns window validity.
// Invalid bases pack as (b & 3), exactly as the plain torch version does,
// so the two agree on every window and not only the valid ones.
__device__ __forceinline__ bool canonical_window(const uint8_t* p, int k,
                                                 int n_lo, uint32_t* hi,
                                                 uint32_t* lo) {
  uint64_t fwd = 0, rc = 0;
  bool ok = true;
  for (int i = 0; i < k; ++i) {
    const uint32_t b = p[i];
    ok &= b < kInvalidBase;
    const uint64_t t = b & 3u;
    fwd = (fwd << 2) | t;
    rc |= (3ull - t) << (2 * i);
  }
  const uint64_t c = fwd >= rc ? fwd : rc;
  *lo = static_cast<uint32_t>(c & ((1ull << (2 * n_lo)) - 1ull));
  *hi = static_cast<uint32_t>(c >> (2 * n_lo));
  return ok;
}

// 16-bit mask of the 16 lanes at p that equal v: four 16-byte loads.
__device__ __forceinline__ unsigned lanes_equal(const uint32_t* p, uint32_t v) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 a = __ldg(p4 + i);
    m |= static_cast<unsigned>((a.x == v) | (a.y == v) << 1 | (a.z == v) << 2 | (a.w == v) << 3) << (4 * i);
  }
  return m;
}

// 16-bit mask of the row's cells whose key equals (hi, lo).
__device__ __forceinline__ unsigned match_mask(const uint32_t* row,
                                               uint32_t hi, uint32_t lo) {
  return lanes_equal(row, hi) & lanes_equal(row + kKeysPerBucket, lo);
}

// Stage one row's bases [w0, w0 + kTile + k - 1) in shared memory, so the
// k reads of each window hit shared memory instead of global.
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* src,
                                          int w0, int L, int k) {
  const int span = min(kTile + k - 1, L - w0);
  for (int i = threadIdx.x; i < span; i += blockDim.x) tile[i] = src[w0 + i];
  __syncthreads();
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
