// merge_filter: sorted merge + Paired-Adjacency filter (§4.4-4.5) of
// SeedMap locations already gathered, the post-query half of the front
// end that the sharded-index serve step runs after its bucket-sharded
// lookup and all_reduce.
//
// Replaces the TPU kernel repro/kernels/pair_frontend/kernel.py ::
// merge_filter_pallas (its math is merge_filter_block, as for
// pair_frontend_pallas).  For each pair it reads the (S*K) int32 locations
// of both mates and runs merge_filter.cuh's merge_filter_block: location
// -> read start conversion, a stable sort of each mate's M = S*K starts,
// the Δ filter and front compaction of <= C candidates.
//
// Bound on the H100: the function reads 2*M*4 bytes per pair and writes
// (2C+3)*4 (880 bytes at S=3, K=32, C=8) and needs only a stable sort, a
// searchsorted and a linear dedup/compaction of the few valid starts per
// mate (O(h log h), h << M = 96), so bytes bound it.  The shared block
// spends O(M^2) compares per mate instead, where the time over the bound
// goes.  Design: one thread block per pair, as in pair_frontend.cu; thread
// i of the block reads element i of mate 1, then of mate 2, so a block's
// loads are coalesced rows of the (B, M) inputs, with 64-bit row offsets.
#include "merge_filter.cuh"

namespace {

// Element e of a mate: locs1/locs2[b*M + e] of the row-major (B, M) input.
struct GatheredLocs {
  const int* locs1;
  const int* locs2;
  long long row;
  __device__ int operator()(int mate, int e) const {
    return (mate ? locs2 : locs1)[row + e];
  }
};

__global__ void merge_filter_kernel(
    const int* __restrict__ locs1, const int* __restrict__ locs2, int M,
    int K, repro::SeedOffsets offs, int delta, int C,
    int* __restrict__ pos1, int* __restrict__ pos2, int* __restrict__ n_out,
    int* __restrict__ nh1, int* __restrict__ nh2) {
  extern __shared__ int sh[];
  const long long b = blockIdx.x;
  repro::merge_filter_block(GatheredLocs{locs1, locs2, b * M}, M, K, offs,
                            delta, C, b, sh, pos1, pos2, n_out, nh1, nh2);
}

}  // namespace

// locs1/locs2: (B, S*K) int32 seed-major locations; pos1/pos2: (B, C)
// int32; n_out/nh1/nh2: (B,) int32.
extern "C" int merge_filter_launch(const void* locs1, const void* locs2,
                                   int B, int S, int K, const void* offs_host,
                                   int delta, int C, void* pos1, void* pos2,
                                   void* n_out, void* nh1, void* nh2,
                                   void* stream) {
  if (B == 0) return 0;
  const int M = S * K;
  merge_filter_kernel<<<B, repro::merge_filter_threads(M),
                        repro::merge_filter_smem(M),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(locs1), static_cast<const int*>(locs2), M, K,
      repro::seed_offsets(static_cast<const int*>(offs_host), S), delta, C,
      static_cast<int*>(pos1), static_cast<int*>(pos2),
      static_cast<int*>(n_out), static_cast<int*>(nh1),
      static_cast<int*>(nh2));
  return repro::launch_status();
}
