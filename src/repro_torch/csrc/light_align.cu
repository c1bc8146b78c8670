// light_align: Light Alignment (§4.6) of (B, R) reads against their
// (B, R + 2E) reference windows, the standalone building block.
//
// Replaces the TPU kernel repro/kernels/light_align/kernel.py ::
// light_align_pallas (its unit align_block is light_align.cuh here, which
// candidate_align.cu shares).  Each row gives score, edit type, length and
// position, and the chosen hypothesis' mismatch count; `ok` is derived by
// the wrapper, as in repro's ops.py.
//
// Bound on the H100: ~(2E+1)*R*6 integer operations per row against
// R + (R+2E) + 20 bytes, so integer operations bound it.  Design: one
// thread per row.  Each thread walks its own rows, so from global memory
// a warp's byte load would touch 32 rows' cache lines on each of the 2E+1
// passes; instead the block first copies its rows (contiguous in global
// memory) into shared memory, coalesced, each row at an odd number of
// 4-byte words so that the 32 rows of a warp sit in 32 different banks,
// and the passes read shared memory only.
#include "light_align.cuh"

namespace {

using repro::Scoring;

__global__ void light_align_kernel(const uint8_t* __restrict__ reads,
                                   const uint8_t* __restrict__ wins, int B,
                                   int R, int E, int sr, int sw, int paper,
                                   Scoring sc, int* __restrict__ out) {
  extern __shared__ uint8_t sh[];
  const int W = R + 2 * E;
  uint8_t* sread = sh;                        // blockDim rows of sr bytes
  uint8_t* swin = sh + blockDim.x * sr;       // blockDim rows of sw bytes
  const long long b0 = blockIdx.x * static_cast<long long>(blockDim.x);
  const int rows = static_cast<int>(min(static_cast<long long>(blockDim.x),
                                        B - b0));
  const uint8_t* gr = reads + b0 * R;
  for (int j = threadIdx.x; j < rows * R; j += blockDim.x)
    sread[(j / R) * sr + j % R] = gr[j];
  const uint8_t* gw = wins + b0 * W;
  for (int j = threadIdx.x; j < rows * W; j += blockDim.x)
    swin[(j / W) * sw + j % W] = gw[j];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const long long b = b0 + threadIdx.x;
  const repro::RowWindow win{swin + threadIdx.x * sw};
  const repro::AlignOut a = repro::light_align_one(
      sread + threadIdx.x * sr, win, R, E, paper != 0, sc);
  out[b] = a.score;
  out[B + b] = a.type;
  out[2LL * B + b] = a.len;
  out[3LL * B + b] = a.pos;
  out[4LL * B + b] = a.mm;
}

}  // namespace

// reads: (B, R) uint8; wins: (B, R + 2E) uint8; out: (5, B) int32 = score,
// edit type, edit length, edit position, mismatches.  sr, sw: the staged
// row strides in bytes, threads * (sr + sw) bytes of shared memory.
extern "C" int light_align_launch(const void* reads, const void* wins, int B,
                                  int R, int E, int sr, int sw, int threads,
                                  int paper, int match, int mismatch,
                                  int gap_open, int gap_extend, void* out,
                                  void* stream) {
  if (B == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(threads) * (sr + sw);
  light_align_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(reads), static_cast<const uint8_t*>(wins),
      B, R, E, sr, sw, paper, Scoring{match, mismatch, gap_open, gap_extend},
      static_cast<int*>(out));
  return repro::launch_status();
}
