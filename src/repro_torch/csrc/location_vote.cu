// location_vote: the Location Voting reduction of the long-read lane (§4.7).
//
// Replaces the TPU kernel repro/kernels/location_vote/kernel.py ::
// location_vote_pallas.  Each long read's (M,) row of candidate read-start
// diagonals (INVALID_LOC padded) reduces to (win_bin, votes): the bins are
// floored diagonal / vote_bin, a slot's count is its bin's multiplicity
// among the valid slots, votes is the largest count and win_bin the
// smallest bin at that count (0 when votes == 0).  C++ `/` truncates
// toward zero, so the bins take a floored divide of their own: truncation
// would fold the near-origin bins -1 and 0 together.
//
// Bound on the H100: 4*M bytes in and 8 bytes out per read, and the
// O(M log M) sort the function needs; at M = 256 both are far below a
// microsecond for 2,048 reads, so launch latency bounds it.  Design: one
// block per read loads its row's bins into shared memory; each thread
// counts its slots' multiplicities with an all-pairs scan (broadcast
// shared reads, M^2 / threads compares each, like the TPU kernel's
// all-pairs count); a warp-shuffle then block reduction keeps the larger
// count and, on a tie, the smaller bin.  The TPU kernel's `did` output and
// DMA row table served its ping-pong protocol and have no counterpart.
#include "common.cuh"

namespace {

using repro::INVALID_LOC;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Keep (v, b) if it has more votes, or as many votes and a smaller bin.
__device__ __forceinline__ void take_better(int& votes, int& bin, int v,
                                            int b) {
  if (v > votes || (v == votes && b < bin)) {
    votes = v;
    bin = b;
  }
}

__device__ __forceinline__ void warp_best(int& votes, int& bin) {
  for (int s = 16; s > 0; s >>= 1) {
    const int v = __shfl_down_sync(0xffffffffu, votes, s);
    const int b = __shfl_down_sync(0xffffffffu, bin, s);
    take_better(votes, bin, v, b);
  }
}

__global__ void location_vote_kernel(const int* __restrict__ diag, int M,
                                     int vote_bin, int* __restrict__ win_bin,
                                     int* __restrict__ votes_out) {
  extern __shared__ int bins[];  // (M,) bins; INVALID_LOC: invalid slot
  __shared__ int warp_votes[32], warp_bin[32];
  const int* row = diag + static_cast<long long>(blockIdx.x) * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int d = row[i];
    bins[i] = d == INVALID_LOC ? INVALID_LOC : floor_div(d, vote_bin);
  }
  __syncthreads();

  int votes = 0, bin = INVALID_LOC;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int b = bins[i];
    if (b == INVALID_LOC) continue;
    int c = 0;
    for (int j = 0; j < M; ++j) c += bins[j] == b;
    take_better(votes, bin, c, b);
  }
  warp_best(votes, bin);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_votes[warp] = votes;
    warp_bin[warp] = bin;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < static_cast<int>(blockDim.x >> 5);
    votes = live ? warp_votes[lane] : 0;
    bin = live ? warp_bin[lane] : INVALID_LOC;
    warp_best(votes, bin);
    if (lane == 0) {
      win_bin[blockIdx.x] = votes > 0 ? bin : 0;
      votes_out[blockIdx.x] = votes;
    }
  }
}

}  // namespace

// diag: (B, M) int32; win_bin, votes: (B,) int32.  threads: a multiple of
// 32, at most 1024; M * 4 bytes of shared memory per block.
extern "C" int location_vote_launch(const void* diag, int B, int M,
                                    int vote_bin, int threads, void* win_bin,
                                    void* votes, void* stream) {
  if (B == 0) return 0;
  const size_t smem = static_cast<size_t>(M) * sizeof(int);
  location_vote_kernel<<<B, threads, smem, static_cast<cudaStream_t>(
                                               stream)>>>(
      static_cast<const int*>(diag), M, vote_bin, static_cast<int*>(win_bin),
      static_cast<int*>(votes));
  return repro::launch_status();
}
