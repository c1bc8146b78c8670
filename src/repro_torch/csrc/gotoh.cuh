// The one semiglobal Gotoh recurrence of the CUDA kernels, shared by
// residual_dp.cu and banded_sw.cu as repro's banded_sw/kernel.py ::
// dp_block is shared by residual_dp_pallas and banded_sw_pallas.
//
// One thread aligns one (R,) read against one (W,) reference window:
// over the 2*band+1 frame around the window's centre diagonal c =
// (W - R) / 2 (frame slot k of row i is column i + c - band + k; cells
// outside [0, W] are NEG), or over all W+1 columns when band < 0.  Score
// is the max of the last row, ref_end the first column that reaches it.
// The horizontal gap is the reference's running max of h_tmp + ext*k
// taken sequentially along the row (the TPU kernel's Hillis-Steele prefix
// max computes the same maximum), so every cell equals the plain
// version's, dead cells included.  The thread's H and E rows live in
// shared memory at H[k * stride] and H[(cols + k) * stride], so a block's
// threads sit column-major side by side (conflict-free).
//
// `Window` is how a window base is read: win(j) is base j of the window,
// 0 <= j < W.
#pragma once

#include "common.cuh"

namespace repro {

struct DPOut {
  int score, end;
};

template <class Window>
__device__ DPOut gotoh_dp(const uint8_t* read, int R, int W, int band,
                          Scoring sc, const Window& win, int* H,
                          int stride) {
  const bool full = band < 0;
  const int cols = full ? W + 1 : 2 * band + 1;
  int* E = H + cols * stride;
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
        const int wb = win(j - 1);
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
        const int wb = (jcol >= 1 && jcol <= W) ? win(jcol - 1) : -1;
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
  return DPOut{best, full ? arg : R + c - band + arg};
}

// Shared memory a block of `threads` DP threads needs.
inline size_t gotoh_smem(int W, int band, int threads) {
  const int cols = band < 0 ? W + 1 : 2 * band + 1;
  return 2 * static_cast<size_t>(cols) * threads * sizeof(int);
}

}  // namespace repro
