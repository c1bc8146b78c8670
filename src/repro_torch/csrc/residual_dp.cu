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
// per item, the H and E rows of its frame in shared memory laid out
// column-major ([slot][thread], conflict-free).  The horizontal gap is the
// reference's running max of h_tmp + ext*k taken sequentially along the
// row (the TPU kernel's Hillis-Steele prefix max computes the same
// maximum), so every cell equals the reference's, dead cells included.
#include "common.cuh"

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
  const bool full = band < 0;
  const int cols = full ? W + 1 : 2 * band + 1;
  const int stride = blockDim.x;
  int* H = sh + threadIdx.x;                    // H[k * stride]
  int* E = sh + cols * stride + threadIdx.x;    // E[k * stride]
  const uint8_t* read = reads + t * R;
  const long long start = sdma[t];
  const int o = off[t];
  const int op = sc.gap_open, ext = sc.gap_extend, first = op + ext;
  const int c = (W - R) / 2;                    // band centre diagonal

  if (full) {
    for (int j = 0; j <= W; ++j) {
      H[j * stride] = 0;
      E[j * stride] = NEG;
    }
    for (int i = 1; i <= R; ++i) {
      const int rb = read[i - 1];
      int diag = H[0];                           // h_prev[j-1]
      E[0] = max(H[0] - first, E[0] - ext);
      const int h0 = -(op + ext * i);
      H[0] = max(h0, NEG - op);
      int gmax = h0;                             // running max of g[0..j-1]
      for (int j = 1; j <= W; ++j) {
        const int hp = H[j * stride];
        const int e = max(hp - first, E[j * stride] - ext);
        E[j * stride] = e;
        const int wb = repro::window_base<PACKED>(ref, start, o, j - 1);
        const int ht = max(diag + (rb == wb ? sc.match : -sc.mismatch), e);
        diag = hp;
        const int f = gmax - op - ext * j;
        gmax = max(gmax, ht + ext * j);
        H[j * stride] = max(ht, f);
      }
    }
  } else {
    for (int k = 0; k < cols; ++k) {
      const int j0 = c - band + k;
      H[k * stride] = (j0 >= 0 && j0 <= W) ? 0 : NEG;
      E[k * stride] = NEG;
    }
    for (int i = 0; i < R; ++i) {
      const int rb = read[i];
      int gmax = 0;
      for (int k = 0; k < cols; ++k) {
        const int jcol = i + 1 + c - band + k;
        const int h_up = k + 1 < cols ? H[(k + 1) * stride] : NEG;
        const int e_up = k + 1 < cols ? E[(k + 1) * stride] : NEG;
        const int e = max(h_up - first, e_up - ext);
        const int wb = (jcol >= 1 && jcol <= W)
                           ? repro::window_base<PACKED>(ref, start, o, jcol - 1)
                           : -1;
        int ht = max(H[k * stride] + (rb == wb ? sc.match : -sc.mismatch), e);
        if (jcol == 0) ht = -(op + ext * (i + 1));
        const bool valid = jcol >= 0 && jcol <= W;
        if (!valid) ht = NEG;
        const int f = (k == 0 ? NEG : gmax) - op - ext * k;
        const int g = ht + ext * k;
        gmax = k == 0 ? g : max(gmax, g);
        H[k * stride] = valid ? max(ht, f) : NEG;
        E[k * stride] = e;
      }
    }
  }
  int best = H[0], arg = 0;
  for (int k = 1; k < cols; ++k) {
    const int h = H[k * stride];
    if (h > best) {
      best = h;
      arg = k;
    }
  }
  score[t] = best;
  end[t] = full ? arg : R + c - band + arg;
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
  const int cols = band < 0 ? W + 1 : 2 * band + 1;
  const size_t smem = 2 * static_cast<size_t>(cols) * threads * sizeof(int);
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
