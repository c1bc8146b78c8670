// xxHash32 of one 16-byte message, the hashing unit of the CUDA kernels,
// shared by seed_buckets.cu and xxhash.cu as repro's xxhash/kernel.py ::
// xxhash32_lanes is shared by seed_buckets_pallas and xxhash32_pallas.
// Native uint32_t arithmetic: every add, multiply and shift wraps mod 2^32
// as the specification's.
#pragma once

#include "common.cuh"

namespace repro {

constexpr uint32_t XX_PRIME1 = 2654435761u;
constexpr uint32_t XX_PRIME2 = 2246822519u;
constexpr uint32_t XX_PRIME3 = 3266489917u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t xx_round(uint32_t acc, uint32_t lane) {
  return rotl(acc + lane * XX_PRIME2, 13) * XX_PRIME1;
}

// xxHash32 of a 16-byte message given as four little-endian words.
__device__ __forceinline__ uint32_t xxhash32_16(uint32_t w0, uint32_t w1,
                                                uint32_t w2, uint32_t w3,
                                                uint32_t seed) {
  const uint32_t v1 = xx_round(seed + XX_PRIME1 + XX_PRIME2, w0);
  const uint32_t v2 = xx_round(seed + XX_PRIME2, w1);
  const uint32_t v3 = xx_round(seed, w2);
  const uint32_t v4 = xx_round(seed - XX_PRIME1, w3);
  uint32_t acc = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
  acc += 16u;  // total length in bytes
  acc ^= acc >> 15;
  acc *= XX_PRIME2;
  acc ^= acc >> 13;
  acc *= XX_PRIME3;
  acc ^= acc >> 16;
  return acc;
}

}  // namespace repro
