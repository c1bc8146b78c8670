// seed_buckets: Partitioned Seeding (§4.3) of both mates of a batch.
//
// Replaces the TPU kernel repro/kernels/pair_frontend/kernel.py ::
// seed_buckets_pallas (its hashing unit is xxhash/kernel.py ::
// xxhash32_lanes, here xxhash.cuh, which xxhash.cu shares).  For each read
// and each of its S seeds it 2-bit packs seed_len <= 64 bases at a fixed
// offset into four 32-bit words (zero padded, words are sums of shifted
// codes as in pack_2bit), hashes them with xxHash32 and writes the SeedMap
// bucket id hash & (T-1).
//
// Bound on the H100: pure 32-bit integer arithmetic, ~2 ops per packed
// base plus ~40 for the hash, against a few bytes of input per seed, so it
// is bound by integer operations.  Design: one thread per (read, seed)
// running the hash in native uint32_t registers; both mates in one launch
// (rows [0, B) are mate 1, [B, 2B) mate 2), no padding of the batch.
#include "xxhash.cuh"

namespace {

__global__ void seed_buckets_kernel(const uint8_t* __restrict__ reads1,
                                    const uint8_t* __restrict__ reads2,
                                    int B, int R, repro::SeedOffsets offs,
                                    int S, int seed_len, uint32_t hash_seed,
                                    uint32_t mask, int* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= 2LL * B * S) return;
  const int s = static_cast<int>(t % S);
  const long long row = t / S;
  const uint8_t* read = row < B ? reads1 + row * R : reads2 + (row - B) * R;
  const uint8_t* seed = read + offs.v[s];
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  for (int i = 0; i < seed_len; ++i) {
    const uint32_t v = static_cast<uint32_t>(seed[i]) << (2 * (i & 15));
    const int q = i >> 4;
    if (q == 0) w0 += v;
    else if (q == 1) w1 += v;
    else if (q == 2) w2 += v;
    else w3 += v;
  }
  out[t] = static_cast<int>(
      repro::xxhash32_16(w0, w1, w2, w3, hash_seed) & mask);
}

}  // namespace

// reads1, reads2: (B, R) uint8; offs_host: S host ints; out: (2B, S) int32.
extern "C" int seed_buckets_launch(const void* reads1, const void* reads2,
                                   int B, int R, const void* offs_host, int S,
                                   int seed_len, unsigned hash_seed,
                                   unsigned mask, void* out, void* stream) {
  const long long n = 2LL * B * S;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  seed_buckets_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads1), static_cast<const uint8_t*>(reads2),
      B, R, repro::seed_offsets(static_cast<const int*>(offs_host), S), S,
      seed_len, hash_seed, mask, static_cast<int*>(out));
  return repro::launch_status();
}
