// residual_dp: banded semiglobal Gotoh DP of the failed mates of the
// residual buffer (§7.4, pipeline step 5, the GenDP analogue).
//
// Replaces the TPU kernel repro/kernels/residual_dp/kernel.py ::
// residual_dp_pallas (its recurrence is banded_sw/kernel.py :: dp_block).
// Work items are (residual row, mate) pairs whose Light Alignment failed,
// compacted to the front by the Python wrapper; the live item count is
// read from device memory, so no host sync sizes the launch.  Each live
// item reads its R + 2*dp_pad reference window (raw or 2-bit packed) and
// runs the Gotoh DP over the 2*band+1 frame around the window's centre
// diagonal (frame slot k of row i is column i + c - band + k), or over all
// W+1 columns when band >= W.  Score is the max of the last row, ref_end
// the first column that reaches it.  Items past the count write NEG / 0 /
// did = 0 without reading a window.
//
// Bound on the H100: ~R*(2*band+1)*14 integer ops per item against a
// ~200-byte window, so integer operations bound it.  Design: one thread
// per item runs the shared recurrence of gotoh.cuh, reading window bases
// straight from the padded reference.
#include "gotoh.cuh"

namespace {

using repro::NEG;
using repro::Scoring;

template <bool PACKED>
__global__ void residual_dp_kernel(
    const void* __restrict__ ref, const int* __restrict__ sdma,
    const int* __restrict__ off, const int* __restrict__ n_items,
    const uint8_t* __restrict__ reads, int n, int R, int W, int band,
    Scoring sc, int* __restrict__ score, int* __restrict__ end,
    int* __restrict__ did) {
  extern __shared__ int sh[];
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= n) return;
  if (t >= *n_items) {
    score[t] = NEG;
    end[t] = 0;
    did[t] = 0;
    return;
  }
  const repro::RefWindow<PACKED> win{ref, sdma[t], off[t]};
  const repro::DPOut r = repro::gotoh_dp(reads + t * R, R, W, band, sc, win,
                                         sh + threadIdx.x, blockDim.x);
  score[t] = r.score;
  end[t] = r.end;
  did[t] = 1;
}

}  // namespace

// ref: packed int32 words (back-padded) or uint8 bases (edge-padded);
// sdma/off: (n,) int32 window starts; n_items: (1,) int32 on the device;
// reads: (n, R) uint8; score/end/did: (n,) int32.  band < 0: full DP.
extern "C" int residual_dp_launch(const void* ref, int packed,
                                  const void* sdma, const void* off,
                                  const void* n_items, const void* reads,
                                  int n, int R, int W, int band, int threads,
                                  int match, int mismatch, int gap_open,
                                  int gap_extend, void* score, void* end,
                                  void* did, void* stream) {
  if (n == 0) return 0;
  const size_t smem = repro::gotoh_smem(W, band, threads);
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                        \
  ref, static_cast<const int*>(sdma), static_cast<const int*>(off),       \
      static_cast<const int*>(n_items), static_cast<const uint8_t*>(reads), \
      n, R, W, band, sc, static_cast<int*>(score), static_cast<int*>(end), \
      static_cast<int*>(did)
  if (packed)
    residual_dp_kernel<true><<<blocks, threads, smem, s>>>(REPRO_ARGS);
  else
    residual_dp_kernel<false><<<blocks, threads, smem, s>>>(REPRO_ARGS);
#undef REPRO_ARGS
  return repro::launch_status();
}
