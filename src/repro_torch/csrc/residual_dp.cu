// residual_dp: banded semiglobal Gotoh DP of the failed mates of the
// residual buffer (§7.4, pipeline step 5, the GenDP analogue).
//
// Replaces the TPU kernel repro/kernels/residual_dp/kernel.py ::
// residual_dp_pallas (its recurrence is banded_sw/kernel.py :: dp_block).
// A (row, mate) slot of the buffer needs DP when its `need` flag is set.
// Such a slot reads its R + 2*dp_pad reference window (raw or 2-bit
// packed) and runs the Gotoh DP over the 2*band+1 frame around the
// window's centre diagonal (frame slot k of row i is column
// i + c - band + k), or over all W+1 columns when band >= W.  Score is the
// max of the last row, ref_end the first column that reaches it.  Slots
// that need no DP get NEG / 0 without reading anything.
//
// Bound on the H100: ~R*(2*band+1)*14 integer ops per live slot against a
// ~200-byte window, so integer operations bound it.  Design: one warp per
// (row, mate) slot, `warps` warps per block (8 by default and at most; a
// launch argument the tuner sets; slots are independent, so the result
// does not depend on it), no compaction: a warp whose
// slot needs no DP writes NEG / 0 and exits, which costs less than
// compacting the live slots would.  A live warp computes its window's
// start with kernels/_util.window_starts's clamp, stages the read and the
// window (unpacked from the 2-bit words in the packed flavor) in its own
// shared memory, and runs gotoh.cuh's warp recurrence: each lane owns CPL
// neighbouring frame slots in registers, the row's horizontal gap is a
// warp max-scan.  One call is one launch.
#include "gotoh.cuh"

namespace {

using repro::INVALID_LOC;
using repro::NEG;
using repro::Scoring;

// Warps (slots) per block: 8 by default, and the most the kernel's
// __launch_bounds__ admit.  Bounds of 256 threads leave ptxas the register
// budget the CPL 32 variants use (up to 245); wider bounds change the
// allocation of every variant (kernels/residual_dp/ops.py::residual_warps).
constexpr int MAX_WARPS = 8;

// The window of a slot, as kernels/_util.window_starts computes it: an
// invalid slot reads the window at 0; packed, start pos - dp_pad (wrapping
// as int32 does) clamped to [0, win_hi] and split into word and offset;
// unpacked, pos clamped to [dp_pad - W, ref_len - 1 + dp_pad] in the
// reference edge-padded by `pad` bases.
template <bool PACKED>
__device__ repro::RefWindow<PACKED> slot_window(const void* ref, int pos,
                                                int W, int dp_pad,
                                                int ref_len, int win_hi,
                                                int pad) {
  const bool valid = pos != INVALID_LOC;
  if constexpr (PACKED) {
    int st = valid ? static_cast<int>(static_cast<unsigned>(pos) -
                                      static_cast<unsigned>(dp_pad))
                   : 0;
    st = min(max(st, 0), win_hi);
    return repro::RefWindow<true>{ref, st >> 4, st & 15};
  } else {
    const int p = min(max(valid ? pos : 0, dp_pad - W), ref_len - 1 + dp_pad);
    return repro::RefWindow<false>{
        ref, static_cast<long long>(p) + (pad - dp_pad), 0};
  }
}

template <int CPL, bool FULL, bool PACKED>
__global__ void __launch_bounds__(MAX_WARPS * 32) residual_dp_kernel(
    const void* __restrict__ ref, const uint8_t* __restrict__ reads1,
    const uint8_t* __restrict__ reads2, const int* __restrict__ pos1,
    const int* __restrict__ pos2, const uint8_t* __restrict__ need1,
    const uint8_t* __restrict__ need2, int N, int R, int W, int band,
    int dp_pad, int ref_len, int win_hi, int pad, int wleft, int wbytes,
    Scoring sc, int* __restrict__ score, int* __restrict__ end) {
  extern __shared__ uint8_t sh[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (slot >= 2LL * N) return;
  const long long row = slot >> 1;
  const int mate = static_cast<int>(slot & 1);
  if (!(mate ? need2 : need1)[row]) {
    if (lane == 0) {
      score[slot] = NEG;
      end[slot] = 0;
    }
    return;
  }
  // this warp's read, then its window between the pads of
  // gotoh.cuh::gotoh_warp_stage (pad bytes are 0)
  uint8_t* s_read = sh + warp * (((R + 3) & ~3) + wbytes);
  uint8_t* s_win = s_read + ((R + 3) & ~3);
  const uint8_t* rd = (mate ? reads2 : reads1) + row * R;
  for (int j = lane; j < R; j += 32) s_read[j] = rd[j];
  const repro::RefWindow<PACKED> win = slot_window<PACKED>(
      ref, (mate ? pos2 : pos1)[row], W, dp_pad, ref_len, win_hi, pad);
  for (int j = lane; j < wbytes; j += 32) {
    const int q = j - wleft;
    s_win[j] = q >= 0 && q < W ? static_cast<uint8_t>(win(q)) : 0;
  }
  __syncwarp();
  const repro::DPOut r =
      repro::gotoh_dp_warp<CPL, FULL>(s_read, R, s_win + wleft, W, band, sc);
  if (lane == 0) {
    score[slot] = r.score;
    end[slot] = r.end;
  }
}

template <int CPL, bool FULL, bool PACKED>
int launch(long long blocks, int warps, size_t smem, cudaStream_t s,
           const void* ref,
           const void* reads1, const void* reads2, const void* pos1,
           const void* pos2, const void* need1, const void* need2, int N,
           int R, int W, int band, int dp_pad, int ref_len, int win_hi,
           int pad, int wleft, int wbytes, Scoring sc, void* score,
           void* end) {
  residual_dp_kernel<CPL, FULL, PACKED>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, s>>>(
          ref, static_cast<const uint8_t*>(reads1),
          static_cast<const uint8_t*>(reads2), static_cast<const int*>(pos1),
          static_cast<const int*>(pos2), static_cast<const uint8_t*>(need1),
          static_cast<const uint8_t*>(need2), N, R, W, band, dp_pad, ref_len,
          win_hi, pad, wleft, wbytes, sc, static_cast<int*>(score),
          static_cast<int*>(end));
  return repro::launch_status();
}

template <int CPL>
int launch_cpl(bool full, bool packed, long long blocks, int warps,
               size_t smem, cudaStream_t s, const void* ref,
               const void* reads1, const void* reads2, const void* pos1,
               const void* pos2,
               const void* need1, const void* need2, int N, int R, int W,
               int band, int dp_pad, int ref_len, int win_hi, int pad,
               int wleft, int wbytes, Scoring sc, void* score, void* end) {
#define REPRO_ARGS                                                          \
  blocks, warps, smem, s, ref, reads1, reads2, pos1, pos2, need1, need2, N, \
      R, W, band, dp_pad, ref_len, win_hi, pad, wleft, wbytes, sc, score, end
  if (full)
    return packed ? launch<CPL, true, true>(REPRO_ARGS)
                  : launch<CPL, true, false>(REPRO_ARGS);
  return packed ? launch<CPL, false, true>(REPRO_ARGS)
                : launch<CPL, false, false>(REPRO_ARGS);
#undef REPRO_ARGS
}

}  // namespace

// ref: packed int32 words (back-padded) or uint8 bases (edge-padded by
// `pad` in front), of ref_len words or bases before the padding;
// reads1/reads2: (N, R) uint8; pos1/pos2: (N,) int32 window anchors,
// INVALID_LOC for none; need1/need2: (N,) bool; win_hi: the packed window
// start's clamp; cpl: frame slots per lane, one of 1, 2, 3, 4, 6, 8, 16, 32,
// with 32 * cpl >= the frame's columns; score/end: (N, 2) int32, slot
// 2*row + mate.  band < 0: full DP.  warps: slots a block, <= 0 for 8;
// the wrapper holds it to MAX_WARPS and 48 KB of shared memory.
extern "C" int residual_dp_launch(
    const void* ref, int packed, const void* reads1, const void* reads2,
    const void* pos1, const void* pos2, const void* need1, const void* need2,
    int N, int R, int W, int band, int dp_pad, int ref_len, int win_hi,
    int pad, int cpl, int match, int mismatch, int gap_open, int gap_extend,
    void* score, void* end, int warps, void* stream) {
  if (N == 0) return 0;
  if (warps <= 0) warps = MAX_WARPS;
  const bool full = band < 0;
  const repro::WarpStage ws = repro::gotoh_warp_stage(R, W, band, cpl);
  const size_t smem =
      static_cast<size_t>(warps) * (((R + 3) & ~3) + ws.bytes);
  const long long blocks = (2LL * N + warps - 1) / warps;
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                          \
  full, packed != 0, blocks, warps, smem, s, ref, reads1, reads2, pos1,    \
      pos2, need1, need2, N, R, W, band, dp_pad, ref_len, win_hi, pad,      \
      ws.left, ws.bytes, sc, score, end
  switch (cpl) {
    case 1: return launch_cpl<1>(REPRO_ARGS);
    case 2: return launch_cpl<2>(REPRO_ARGS);
    case 3: return launch_cpl<3>(REPRO_ARGS);
    case 4: return launch_cpl<4>(REPRO_ARGS);
    case 6: return launch_cpl<6>(REPRO_ARGS);
    case 8: return launch_cpl<8>(REPRO_ARGS);
    case 16: return launch_cpl<16>(REPRO_ARGS);
    case 32: return launch_cpl<32>(REPRO_ARGS);
    default: break;
  }
#undef REPRO_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
