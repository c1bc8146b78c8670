// xxhash32: xxHash32 of (N, 4) 32-bit words, one 16-byte message per row.
//
// Replaces the TPU kernel repro/kernels/xxhash/kernel.py :: xxhash32_pallas
// (its unit xxhash32_lanes is xxhash.cuh here, which seed_buckets.cu
// shares).
//
// Bound on the H100: 16 bytes in and 8 bytes out per hash against ~50
// integer operations, so memory bytes bound it.  Design: one thread per
// hash, the row read as one 16-byte vector load (the wrapper hands a
// 16-byte aligned tensor), neighbouring threads on neighbouring rows; the
// hash is written as the int64 value in [0, 2^32) the wrapper returns, so
// no conversion pass follows.
#include "xxhash.cuh"

namespace {

__global__ void xxhash32_kernel(const uint4* __restrict__ words, long long n,
                                uint32_t seed, long long* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= n) return;
  const uint4 w = words[t];
  out[t] = repro::xxhash32_16(w.x, w.y, w.z, w.w, seed);
}

}  // namespace

// words: (n, 4) 32-bit words, 16-byte aligned; out: (n,) int64 hashes.
extern "C" int xxhash32_launch(const void* words, long long n, unsigned seed,
                               void* out, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  xxhash32_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(words), n, seed, static_cast<long long*>(out));
  return repro::launch_status();
}
