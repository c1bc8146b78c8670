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
// R + W + 8 bytes, so integer operations bound it.  Two kernels, chosen
// by shape in the launcher (not on failure):
//
// banded_sw_warp_kernel, for rows of up to 32*32 columns: one warp per
// read, up to WARPS warps a block.  The warp stages its read and its
// window in its own shared memory (the window between
// gotoh_warp_stage's pads, lanes on neighbouring bytes), then runs
// gotoh_dp_warp<CPL, FULL>: CPL frame slots per lane in registers, a
// warp max-scan for the row's horizontal gap.  At the long lane's 2,048
// reads that is ~15.5 warps per SM, so the launch is bound by the
// latency of the row's dependent chain (shuffles included), not by the
// integer rate.  Reads whose staged read and window exceed 48 KB take
// the other kernel too.
//
// banded_sw_thread_kernel, for wider rows (the one-thread design of the
// first port; up to 6,144 columns, the wrapper's limit): one thread per
// read runs gotoh_dp with its H and E rows in shared memory, reading the
// read and the window from device memory.
#include <algorithm>

#include "gotoh.cuh"

namespace {

using repro::Scoring;

constexpr int WARPS = 8;                 // reads per block, at most
constexpr size_t MAX_SMEM = 48 * 1024;   // static shared-memory limit

// Base j of one read's gathered window.
struct GatheredWindow {
  const uint8_t* win;
  __device__ int operator()(int j) const { return win[j]; }
};

__global__ void banded_sw_thread_kernel(const uint8_t* __restrict__ reads,
                                        const uint8_t* __restrict__ wins,
                                        int B, int R, int W, int band,
                                        Scoring sc, int* __restrict__ score,
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

template <int CPL, bool FULL>
__global__ void __launch_bounds__(WARPS * 32) banded_sw_warp_kernel(
    const uint8_t* __restrict__ reads, const uint8_t* __restrict__ wins,
    int B, int R, int W, int band, int wleft, int wbytes, Scoring sc,
    int* __restrict__ score, int* __restrict__ end) {
  extern __shared__ uint8_t staged[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= B) return;
  // this warp's read, then its window between the pads (0)
  const int read_bytes = (R + 3) & ~3;
  uint8_t* s_read = staged + warp * (read_bytes + wbytes);
  uint8_t* s_win = s_read + read_bytes;
  const uint8_t* rd = reads + t * R;
  const uint8_t* wn = wins + t * W;
  for (int j = lane; j < R; j += 32) s_read[j] = rd[j];
  for (int j = lane; j < wbytes; j += 32) {
    const int q = j - wleft;
    s_win[j] = q >= 0 && q < W ? wn[q] : 0;
  }
  __syncwarp();
  const repro::DPOut r =
      repro::gotoh_dp_warp<CPL, FULL>(s_read, R, s_win + wleft, W, band, sc);
  if (lane == 0) {
    score[t] = r.score;
    end[t] = r.end;
  }
}

template <int CPL>
int launch_warp(bool full, int warps, size_t smem, cudaStream_t s,
                const uint8_t* reads, const uint8_t* wins, int B, int R,
                int W, int band, const repro::WarpStage& ws, Scoring sc,
                int* score, int* end) {
  const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
  if (full)
    banded_sw_warp_kernel<CPL, true><<<blocks, warps * 32, smem, s>>>(
        reads, wins, B, R, W, band, ws.left, ws.bytes, sc, score, end);
  else
    banded_sw_warp_kernel<CPL, false><<<blocks, warps * 32, smem, s>>>(
        reads, wins, B, R, W, band, ws.left, ws.bytes, sc, score, end);
  return repro::launch_status();
}

}  // namespace

// reads: (B, R) uint8; wins: (B, W) uint8; score/end: (B,) int32.
// band < 0: full DP.  cpl: frame slots per lane of the warp kernel (1, 2,
// 3, 4, 6, 8, 16 or 32, with 32 * cpl >= the row's columns), or 0 for a
// row wider than 1,024 columns; threads: the one-thread kernel's block
// size (its H and E rows fit 48 KB), used where the warp kernel is not.
extern "C" int banded_sw_launch(const void* reads, const void* wins, int B,
                                int R, int W, int band, int cpl, int threads,
                                int match, int mismatch, int gap_open,
                                int gap_extend, void* score, void* end,
                                void* stream) {
  if (B == 0) return 0;
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  auto s = static_cast<cudaStream_t>(stream);
  auto rd = static_cast<const uint8_t*>(reads);
  auto wn = static_cast<const uint8_t*>(wins);
  auto sco = static_cast<int*>(score);
  auto en = static_cast<int*>(end);
  if (cpl > 0) {
    const repro::WarpStage ws = repro::gotoh_warp_stage(R, W, band, cpl);
    const size_t per_warp = static_cast<size_t>((R + 3) & ~3) + ws.bytes;
    const int warps =
        static_cast<int>(std::min<size_t>(WARPS, MAX_SMEM / per_warp));
    if (warps >= 1) {
      const size_t smem = warps * per_warp;
      const bool full = band < 0;
#define REPRO_ARGS \
  full, warps, smem, s, rd, wn, B, R, W, band, ws, sc, sco, en
      switch (cpl) {
        case 1: return launch_warp<1>(REPRO_ARGS);
        case 2: return launch_warp<2>(REPRO_ARGS);
        case 3: return launch_warp<3>(REPRO_ARGS);
        case 4: return launch_warp<4>(REPRO_ARGS);
        case 6: return launch_warp<6>(REPRO_ARGS);
        case 8: return launch_warp<8>(REPRO_ARGS);
        case 16: return launch_warp<16>(REPRO_ARGS);
        case 32: return launch_warp<32>(REPRO_ARGS);
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
#undef REPRO_ARGS
    }
  }
  const size_t smem = repro::gotoh_smem(W, band, threads);
  const unsigned blocks = static_cast<unsigned>((B + threads - 1) / threads);
  banded_sw_thread_kernel<<<blocks, threads, smem, s>>>(rd, wn, B, R, W, band,
                                                        sc, sco, en);
  return repro::launch_status();
}
