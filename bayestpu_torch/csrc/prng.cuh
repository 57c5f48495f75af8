// Counter-hash PRNG shared by every masked kernel of bayestpu_torch.
//
// Replaces the Pallas helpers _mix, _seed_stream, _coord_bits and
// _keep_threshold (bayestpu/kernels/masked_matmul.py:63-107) and the mask
// bits of masked_conv._tile_mask_bits. The bits of element (row, col) are a
// pure function of (seeds, global row, global col), all uint32 with
// wraparound, so a mask never depends on a kernel's tiling and the CUDA
// kernels reproduce the JAX package's masks bit for bit. An element is kept
// iff coord_bits(row, col, seed_stream(s0, s1)) < threshold, where the
// threshold min(round((1 - rate) * 2^32), 2^32 - 1) is computed on the host.
// A launch on a slice of a batch (one rank's rows under data sharding) takes
// row0, the global row of its first row, and hashes row row0 + r: the sum is
// uint32 and wraps as the JAX package's does, and it enters row_term, which
// a kernel computes once a row, never an element's hash.
#pragma once

#include <cstdint>

namespace bayestpu {

// murmur3/triple32-style avalanche finalizer
__host__ __device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Per-(seed pair) stream constant; int32 seeds are reinterpreted as uint32.
__host__ __device__ __forceinline__ uint32_t seed_stream(int32_t s0,
                                                         int32_t s1) {
  return mix(static_cast<uint32_t>(s0) * 0x9E3779B1u ^
             static_cast<uint32_t>(s1) * 0x85EBCA77u ^ 0xC2B2AE35u);
}

// The row's part of coord_bits, computed once for a row's elements.
__host__ __device__ __forceinline__ uint32_t row_term(uint32_t grow,
                                                      uint32_t stream) {
  return grow * 0x27D4EB2Fu ^ stream;
}

// coord_bits of column gcol of the row whose row_term is rterm
__host__ __device__ __forceinline__ uint32_t row_bits(uint32_t rterm,
                                                      uint32_t gcol) {
  const uint32_t x = mix(rterm ^ gcol);
  return mix(x ^ gcol * 0x165667B1u);
}

__host__ __device__ __forceinline__ uint32_t coord_bits(uint32_t grow,
                                                        uint32_t gcol,
                                                        uint32_t stream) {
  return row_bits(row_term(grow, stream), gcol);
}

// coord_bits factored for a kernel that masks many rows of the same
// columns: keyed_bits(row_key(rterm), col_key1(gcol), col_key2(gcol)) ==
// row_bits(rterm, gcol). A logical shift distributes over xor, so the first
// xorshift of mix(rterm ^ gcol) splits into a row's and a column's part; and
// since (y ^ y >> 16) >> 16 == y >> 16, the last xorshift of the first mix
// cancels against the first one of the second, leaving that mix's input
// xored with the column's key2. 13 operations an element, not 20.
__host__ __device__ __forceinline__ uint32_t row_key(uint32_t rterm) {
  return rterm ^ (rterm >> 16);
}

__host__ __device__ __forceinline__ uint32_t col_key1(uint32_t gcol) {
  return gcol ^ (gcol >> 16);
}

__host__ __device__ __forceinline__ uint32_t col_key2(uint32_t gcol) {
  const uint32_t h = gcol * 0x165667B1u;
  return h ^ (h >> 16);
}

__host__ __device__ __forceinline__ uint32_t keyed_bits(uint32_t rkey,
                                                        uint32_t key1,
                                                        uint32_t key2) {
  uint32_t x = (rkey ^ key1) * 0x7FEB352Du;
  x ^= x >> 15;
  x = (x * 0x846CA68Bu) ^ key2;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

}  // namespace bayestpu
