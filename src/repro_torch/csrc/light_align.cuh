// Light Alignment of one read against its reference window, the alignment
// unit of the CUDA kernels, shared by candidate_align.cu and light_align.cu
// as repro's light_align/kernel.py :: align_block is shared by
// candidate_align_pallas and light_align_pallas.  Mirrors
// core/light_align.light_align.
//
// Window base E + s + i faces read base i under shift s in [-E, E].  The
// mismatch-only hypothesis and, per gap length k in [1, E], the best
// single deletion (suffix at shift +k) and insertion (suffix at shift -k)
// split by min-split, or the paper's zero-mismatch rule.  One pass per
// shift carries the two running mismatch counts instead of storing the
// 2E+1 prefix rows, keeping the first arg-min split (argmin's tie-break);
// a later hypothesis replaces the best only when it scores strictly more
// (argmax's first maximum).
//
// `Window` is how a window base is read: win(j) is base j of the window,
// 0 <= j < R + 2E (`RowWindow`: a row staged in shared memory, as both
// kernels stage theirs).  Needs R >= E.
#pragma once

#include <climits>

#include "common.cuh"

namespace repro {

// Base j of a window staged in a row of shared memory.
struct RowWindow {
  const uint8_t* win;
  __device__ __forceinline__ int operator()(int j) const { return win[j]; }
};

struct AlignOut {
  int score, type, len, pos;
  int mm;  // mismatches of the chosen hypothesis (BIG for none)
};

template <class Window>
__device__ AlignOut light_align_one(const uint8_t* __restrict__ read,
                                    const Window& win, int R, int E,
                                    bool paper, const Scoring& sc) {
  auto mis = [&](int i, int s) -> int {
    return static_cast<int>(read[i]) != win(E + s + i);
  };
  const int m2 = sc.match + sc.mismatch;
  int mm_none = 0;
  for (int i = 0; i < R; ++i) mm_none += mis(i, 0);
  AlignOut best{sc.match * R - m2 * mm_none, 0, 0, 0, mm_none};

  for (int k = 1; k <= E; ++k) {
    const int gap = sc.gap_open + sc.gap_extend * k;
    // deletion of k: mm(p) = cum0[p] + cum_{+k}[R] - cum_{+k}[p],
    // p in [1, R-1]
    {
      int c0 = 0, cd = 0, best_d = INT_MAX, arg = 0;
      for (int p = 0; p <= R; ++p) {
        if (p >= 1 && p <= R - 1 && c0 - cd < best_d) {
          best_d = c0 - cd;
          arg = p;
        }
        if (p < R) {
          c0 += mis(p, 0);
          cd += mis(p, k);
        }
      }
      int mm = best_d == INT_MAX ? BIG : best_d + cd;
      if (mm >= BIG || (paper && mm != 0)) {
        mm = BIG;
        arg = 0;
      }
      const int score = mm >= BIG ? -BIG : sc.match * R - m2 * mm - gap;
      if (score > best.score) best = AlignOut{score, 2, k, arg, mm};
    }
    // insertion of k: mm(p) = cum0[p] + cum_{-k}[R] - cum_{-k}[p+k],
    // p in [1, R-k-1]
    {
      int c0 = 0, ci = 0, best_i = INT_MAX, arg = 0;
      for (int q = 0; q < k; ++q) ci += mis(q, -k);
      for (int p = 0; p <= R - k; ++p) {
        if (p >= 1 && p <= R - k - 1 && c0 - ci < best_i) {
          best_i = c0 - ci;
          arg = p;
        }
        if (p < R - k) {
          c0 += mis(p, 0);
          ci += mis(p + k, -k);
        }
      }
      int mm = best_i == INT_MAX ? BIG : best_i + ci;
      if (mm >= BIG || (paper && mm != 0)) {
        mm = BIG;
        arg = 0;
      }
      const int score =
          mm >= BIG ? -BIG : sc.match * (R - k) - m2 * mm - gap;
      if (score > best.score) best = AlignOut{score, 1, k, arg, mm};
    }
  }
  return best;
}

}  // namespace repro
