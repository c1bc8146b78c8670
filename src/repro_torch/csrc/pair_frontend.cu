// pair_frontend: SeedMap row gather + sorted merge + Paired-Adjacency
// filter (§4.4-4.5) for a batch of read pairs.
//
// Replaces the TPU kernel repro/kernels/pair_frontend/kernel.py ::
// pair_frontend_pallas (its math is merge_filter_block).  For each pair it
// gathers the S padded Location-Table rows of K int32 of both mates and
// runs merge_filter.cuh's merge_filter_block on them: location -> read
// start conversion, a sort of each mate's valid starts (the reference's
// stable sort of all M = S*K), the Δ filter and front compaction of <= C
// candidates.
//
// Bound on the H100: the function reads 2*S random 128-byte rows per pair
// (K = 32), about 870 bytes with its ids and outputs, and needs only a
// stable sort, a searchsorted and a linear dedup/compaction of the few
// valid starts per mate (O(h log h), h << M = 96), so bytes bound it.
// Design: one warp per pair, `warps` pairs per block (8 by default; a
// launch argument the tuner sets), running merge_filter.cuh's warp block;
// lane l reads slot l of a row (a row of K = 32 is one coalesced 128-byte
// load) with 64-bit row indices, and the warp sorts only the valid
// starts.  Pairs are independent, so the result does not depend on
// `warps`.  The bucket ids come straight
// from seed_buckets: no bucket*K offset tables.
#include "merge_filter.cuh"

namespace {

// Slot k of seed s of a mate: slot k of the row of the seed's bucket.
struct RowLocs {
  const int* rows;
  const int* buckets;
  int B, S, K;
  long long b;
  // the bucket of seed row q = mate*S + s
  __device__ int key(int q) const {
    const int mate = q >= S;
    return buckets[(static_cast<long long>(mate) * B + b) * S + q - mate * S];
  }
  __device__ int operator()(int bucket, int, int, int k) const {
    return rows[static_cast<long long>(bucket) * K + k];
  }
};

__global__ void pair_frontend_kernel(
    const int* __restrict__ rows, int K, const int* __restrict__ buckets,
    int B, int S, repro::SeedOffsets offs, int delta, int C,
    int* __restrict__ pos1, int* __restrict__ pos2, int* __restrict__ n_out,
    int* __restrict__ nh1, int* __restrict__ nh2) {
  extern __shared__ int sh[];
  const int warp = threadIdx.x >> 5, M = S * K;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  repro::merge_filter_block(RowLocs{rows, buckets, B, S, K, b}, S, K, offs,
                            delta, C, b, sh + warp * 4 * M, pos1, pos2,
                            n_out, nh1, nh2);
}

}  // namespace

// rows: (T, K) int32; buckets: (2B, S) int32 (mate 1 rows first);
// pos1/pos2: (B, C) int32; n_out/nh1/nh2: (B,) int32; warps: pairs per
// block, <= 0 for merge_filter_warps(S * K).
extern "C" int pair_frontend_launch(const void* rows, int K,
                                    const void* buckets, int B, int S,
                                    const void* offs_host, int delta, int C,
                                    void* pos1, void* pos2, void* n_out,
                                    void* nh1, void* nh2, int warps,
                                    void* stream) {
  if (B == 0) return 0;
  if (warps <= 0) warps = repro::merge_filter_warps(S * K);
  pair_frontend_kernel<<<(B + warps - 1) / warps, 32 * warps,
                         warps * repro::merge_filter_warp_smem(S * K),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), K, static_cast<const int*>(buckets), B,
      S, repro::seed_offsets(static_cast<const int*>(offs_host), S), delta, C,
      static_cast<int*>(pos1), static_cast<int*>(pos2),
      static_cast<int*>(n_out), static_cast<int*>(nh1),
      static_cast<int*>(nh2));
  return repro::launch_status();
}
