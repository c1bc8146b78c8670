// banded_sw: banded semiglobal Gotoh DP of gathered read / window pairs,
// the long-read lane's anchor-segment alignment at the voted diagonal
// (§4.7).
//
// Replaces the TPU kernel repro/kernels/banded_sw/kernel.py ::
// banded_sw_pallas.  (B, R) uint8 reads and (B, W) uint8 windows become
// (B,) int32 score and ref_end: the 2*band+1 moving frame around the
// window's centre diagonal, or the full W+1-column DP when band < 0 (the
// wrapper passes -1 for band >= W).  The recurrence is gotoh.cuh's, the
// one residual_dp.cu runs too; only the window read differs (a gathered
// uint8 window here, the padded reference there).
//
// Bound on the H100: ~R*(2*band+1)*14 integer ops per read against
// R + W + 8 bytes, so integer operations bound it.  Design: one thread
// per read, its H and E rows in shared memory (gotoh.cuh).  At 2,048
// reads that is a few dozen blocks on 132 SMs, so the launch is latency-
// bound and far from its bound; spreading one read over a warp (an
// anti-diagonal wavefront) is the obvious next step.
#include "gotoh.cuh"

namespace {

using repro::Scoring;

// Base j of one read's gathered window.
struct GatheredWindow {
  const uint8_t* win;
  __device__ int operator()(int j) const { return win[j]; }
};

__global__ void banded_sw_kernel(const uint8_t* __restrict__ reads,
                                 const uint8_t* __restrict__ wins, int B,
                                 int R, int W, int band, Scoring sc,
                                 int* __restrict__ score,
                                 int* __restrict__ end) {
  extern __shared__ int sh[];
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= B) return;
  const GatheredWindow win{wins + t * W};
  const repro::DPOut r = repro::gotoh_dp(reads + t * R, R, W, band, sc, win,
                                         sh + threadIdx.x, blockDim.x);
  score[t] = r.score;
  end[t] = r.end;
}

}  // namespace

// reads: (B, R) uint8; wins: (B, W) uint8; score/end: (B,) int32.
// band < 0: full DP.
extern "C" int banded_sw_launch(const void* reads, const void* wins, int B,
                                int R, int W, int band, int threads,
                                int match, int mismatch, int gap_open,
                                int gap_extend, void* score, void* end,
                                void* stream) {
  if (B == 0) return 0;
  const size_t smem = repro::gotoh_smem(W, band, threads);
  const unsigned blocks = static_cast<unsigned>((B + threads - 1) / threads);
  banded_sw_kernel<<<blocks, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads), static_cast<const uint8_t*>(wins),
      B, R, W, band, Scoring{match, mismatch, gap_open, gap_extend},
      static_cast<int*>(score), static_cast<int*>(end));
  return repro::launch_status();
}
