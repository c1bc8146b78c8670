// merge_filter: sorted merge + Paired-Adjacency filter (§4.4-4.5) of
// SeedMap locations already gathered, the post-query half of the front
// end that the sharded-index serve step runs after its bucket-sharded
// lookup and all_reduce.
//
// Replaces the TPU kernel repro/kernels/pair_frontend/kernel.py ::
// merge_filter_pallas (its math is merge_filter_block, as for
// pair_frontend_pallas).  For each pair it reads the (S*K) int32 locations
// of both mates and runs merge_filter.cuh's merge_filter_block: location
// -> read start conversion, a sort of each mate's valid starts (the
// reference's stable sort of all M = S*K), the Δ filter and front
// compaction of <= C candidates.
//
// Bound on the H100: the function reads 2*M*4 bytes per pair and writes
// (2C+3)*4 (880 bytes at S=3, K=32, C=8) and needs only a stable sort, a
// searchsorted and a linear dedup/compaction of the few valid starts per
// mate (O(h log h), h << M = 96), so bytes bound it.  Design: one warp
// per pair, `warps` pairs per block (8 by default, as in
// pair_frontend.cu); lane l reads element 32t + l of the pair's rows of
// the (B, M) inputs, so a warp's loads are coalesced, with 64-bit row
// offsets.
#include "merge_filter.cuh"

namespace {

// Slot k of seed s of a mate: locs1/locs2[b*M + s*K + k] of the row-major
// (B, M) input.
struct GatheredLocs {
  const int* locs1;
  const int* locs2;
  long long row;
  int K;
  __device__ int key(int) const { return 0; }
  __device__ int operator()(int, int mate, int s, int k) const {
    return (mate ? locs2 : locs1)[row + s * K + k];
  }
};

__global__ void merge_filter_kernel(
    const int* __restrict__ locs1, const int* __restrict__ locs2, int B,
    int S, int K, repro::SeedOffsets offs, int delta, int C,
    int* __restrict__ pos1, int* __restrict__ pos2, int* __restrict__ n_out,
    int* __restrict__ nh1, int* __restrict__ nh2) {
  extern __shared__ int sh[];
  const int warp = threadIdx.x >> 5, M = S * K;
  const long long b =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  repro::merge_filter_block(GatheredLocs{locs1, locs2, b * M, K}, S, K,
                            offs, delta, C, b, sh + warp * 4 * M, pos1,
                            pos2, n_out, nh1, nh2);
}

}  // namespace

// locs1/locs2: (B, S*K) int32 seed-major locations; pos1/pos2: (B, C)
// int32; n_out/nh1/nh2: (B,) int32; warps: pairs per block, <= 0 for
// merge_filter_warps(S * K).
extern "C" int merge_filter_launch(const void* locs1, const void* locs2,
                                   int B, int S, int K, const void* offs_host,
                                   int delta, int C, void* pos1, void* pos2,
                                   void* n_out, void* nh1, void* nh2,
                                   int warps, void* stream) {
  if (B == 0) return 0;
  if (warps <= 0) warps = repro::merge_filter_warps(S * K);
  merge_filter_kernel<<<(B + warps - 1) / warps, 32 * warps,
                        warps * repro::merge_filter_warp_smem(S * K),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(locs1), static_cast<const int*>(locs2), B, S,
      K, repro::seed_offsets(static_cast<const int*>(offs_host), S), delta,
      C, static_cast<int*>(pos1), static_cast<int*>(pos2),
      static_cast<int*>(n_out), static_cast<int*>(nh1),
      static_cast<int*>(nh2));
  return repro::launch_status();
}
