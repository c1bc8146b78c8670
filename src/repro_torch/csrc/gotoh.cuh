// The semiglobal Gotoh recurrence of the CUDA kernels, shared by
// residual_dp.cu and banded_sw.cu as repro's banded_sw/kernel.py ::
// dp_block is shared by residual_dp_pallas and banded_sw_pallas.  Both
// align one (R,) read against one (W,) reference window, over the
// 2*band+1 frame around the window's centre diagonal c = floor((W - R) /
// 2) (frame slot k of row i is column i + c - band + k; cells outside
// [0, W] are NEG), or over all W+1 columns when band < 0.  Score is the
// max of the last row, ref_end the first column that reaches it.
//
// Row i of a banded frame reads its K = 2*band+1 window bases where
// repro's dynamic_slice_in_dim takes them from the padded window: from
// row_start(i + c + 1) - band - 1 on.  That is column j - 1 for slot k,
// except in the first or last rows of a window shorter than the read,
// whose start repro wraps or clamps; their in-band cells then score
// against shifted bases, or against the padding (a mismatch), as repro's
// do.  Two recurrences compute the same cells:
//
// gotoh_dp (banded_sw.cu, rows wider than the warp covers): one thread
// aligns one read.  The horizontal gap is the reference's running max of
// h_tmp + ext*k taken sequentially along the row.  The thread's H and E
// rows live in shared memory at H[k * stride] and H[(cols + k) * stride],
// so a block's threads sit column-major side by side (conflict-free).
// `Window` is how a window base is read: win(j) is base j of the window,
// 0 <= j < W.
//
// gotoh_dp_warp (residual_dp.cu and banded_sw.cu): the 32 lanes of a
// warp align one read.  Lane l owns the CPL contiguous frame slots
// l*CPL .. l*CPL+CPL-1 (slots past the frame are padding, always dead)
// and keeps their H and E in registers.  The vertical neighbour of the
// banded frame is slot k+1 of the previous row, one __shfl_down_sync at
// the lane's last slot; the full DP's diagonal is column j-1, one
// __shfl_up_sync at the lane's first.  The horizontal gap's running max
// is an in-lane running max, an inclusive warp max-scan of the lane
// totals (5 shuffles) and a shift to the exclusive prefix: max is exact
// on int32, so every cell equals the sequential version's (repro's TPU
// kernel computes the same maximum with a Hillis-Steele scan), dead cells
// and the column-0 rule included.  Only the first and last rows of a
// banded frame can hold column 0 or columns past W, or a moved start;
// the rows between skip those tests, and slots past the frame then hold
// values nothing reads (the frame's last slot takes NEG from the row
// above in their place).  The caller stages the read and the window in
// the warp's shared memory, the window between pads (gotoh_warp_stage)
// so that no read of it needs a bounds check.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

struct DPOut {
  int score, end;
};

// Floor of (W - R) / 2: core/dp_fallback.py::band_center.
__host__ __device__ inline int band_centre(int R, int W) {
  const int d = W - R;
  return d >= 0 ? d / 2 : -((1 - d) / 2);
}

// Start, in the window padded by band+1 on each side, of the K bases a
// banded row compares, given its unclamped start s = i + c + 1:
// core/dp_fallback.py::slice_start, except that a start below -2*band
// (which wraps into [0, W+1] there) also gives W+1: such a row holds no
// cell in [0, W], so nothing it reads is used.
__host__ __device__ inline int row_start(int s, int W) {
  return s < 0 || s > W + 1 ? W + 1 : s;
}

template <class Window>
__device__ DPOut gotoh_dp(const uint8_t* read, int R, int W, int band,
                          Scoring sc, const Window& win, int* H,
                          int stride) {
  const bool full = band < 0;
  const int cols = full ? W + 1 : 2 * band + 1;
  int* E = H + cols * stride;
  const int op = sc.gap_open, ext = sc.gap_extend, first = op + ext;
  const int c = band_centre(R, W);

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
      // the window index slot k reads is q0 + k (jcol - 1 unless moved)
      const int q0 = row_start(i + c + 1, W) - band - 1;
      int gmax = 0;
      for (int k = 0; k < cols; ++k) {
        const int jcol = i + 1 + c - band + k;
        const int h_up = k + 1 < cols ? H[(k + 1) * stride] : NEG;
        const int e_up = k + 1 < cols ? E[(k + 1) * stride] : NEG;
        const int e = max(h_up - first, e_up - ext);
        const int q = q0 + k;
        const int wb = (jcol >= 1 && jcol <= W && q >= 0 && q < W) ? win(q)
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
  return DPOut{best, full ? arg : R + c - band + arg};
}

// Shared-memory layout of one warp's staged window: W bases at
// [left, left + W) of `bytes` (a multiple of 4), with pads on both sides
// wide enough that gotoh_dp_warp reads window index
// row_start(i + c + 1) - band - 1 + k (FULL: k - 1) for every row i and
// slot k < 32*cpl without a bounds check.  Pad bytes (0) only meet cells
// whose substitution score is never used (NEG, or column 0's fixed
// value), or cells of a moved row, which test the index themselves.
// Row starts grow with i; a moved start is W + 1.
struct WarpStage {
  int left, bytes;
};

__host__ __device__ inline WarpStage gotoh_warp_stage(int R, int W, int band,
                                                      int cpl) {
  const bool full = band < 0;
  const int c = band_centre(R, W);
  // least and greatest row start (row_start of rows 0 and R - 1, or W + 1
  // where a first row's start moved)
  const int s_lo = c + 1 < 0 ? 0 : c + 1;
  const int s_hi = c + 1 < 0 || R + c > W + 1 ? W + 1 : R + c;
  const int lo = full ? -1 : s_lo - band - 1;       // least index read
  const int hi = full ? 32 * cpl - 2 : s_hi - band + 32 * cpl - 2;
  const int left = lo < 0 ? -lo : 0;
  const int end = left + (hi + 1 > W ? hi + 1 : W);
  return WarpStage{left, (end + 3) & ~3};
}

// One warp aligns `read` (R bases) against the window staged at `win`
// (W bases, padded as gotoh_warp_stage says), both in shared memory;
// every lane returns the result.  FULL: all W+1 columns (cols = W+1);
// otherwise the 2*band+1 frame.  CPL * 32 >= cols.
template <int CPL, bool FULL>
__device__ DPOut gotoh_dp_warp(const uint8_t* read, int R,
                               const uint8_t* win, int W, int band,
                               Scoring sc) {
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int cols = FULL ? W + 1 : 2 * band + 1;
  const int op = sc.gap_open, ext = sc.gap_extend, first = op + ext;
  const int c = band_centre(R, W);
  const int k0 = lane * CPL;                    // this lane's first slot
  // column of slot t in row i: i + 1 + j_off + t (FULL: k0 + t)
  const int j_off = FULL ? k0 : c - band + k0;
  int H[CPL], E[CPL];
  bool frame[CPL], up_live[CPL];   // slot k, and slot k+1, in the frame
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int k = k0 + t;
    const int j0 = FULL ? k : c - band + k;
    frame[t] = k < cols;
    up_live[t] = k + 1 < cols;
    H[t] = (frame[t] && j0 >= 0 && j0 <= W) ? 0 : NEG;
    E[t] = NEG;
  }
  // One row.  CHECK: the row may hold column 0 or columns past W, or
  // have a moved start (the first and last rows of a banded frame, every
  // row of the full DP); otherwise every frame slot is a column in
  // [1, W], read at window index j - 1, and needs no test.
  // Slots past the frame are not kept dead: the frame's last slot takes
  // NEG from the row above in their place, and nothing else reads them.
  auto row = [&](int i, auto check) {
    constexpr bool CHECK = decltype(check)::value;
    const int rb = read[i];
    const int h0 = -(op + ext * (i + 1));        // column 0 of this row
    // the row above's neighbour across the lane edge
    const int h_edge = FULL ? __shfl_up_sync(ALL, H[CPL - 1], 1)
                            : __shfl_down_sync(ALL, H[0], 1);
    [[maybe_unused]] const int e_edge =
        FULL ? NEG : __shfl_down_sync(ALL, E[0], 1);
    const int jr = FULL ? j_off : i + 1 + j_off;   // column of slot 0
    // window index of slot 0: jr - 1, or the moved start's (CHECK rows)
    const int q0 = FULL || !CHECK ? jr - 1
                                  : row_start(i + c + 1, W) - band - 1 + k0;
    const uint8_t* wrow = win + q0;
    int ht[CPL];
    bool valid[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int j = jr + t;
      bool hit = rb == wrow[t];
      if (!FULL && CHECK)        // a moved row may read pads in its band
        hit = hit && static_cast<unsigned>(q0 + t) <
                         static_cast<unsigned>(W);
      const int sub = hit ? sc.match : -sc.mismatch;
      int v, e;
      if constexpr (FULL) {
        e = max(H[t] - first, E[t] - ext);
        const int diag = t > 0 ? H[t - 1] : h_edge;
        v = j == 0 ? h0 : max(diag + sub, e);
      } else {
        int h_up = t + 1 < CPL ? H[t + 1] : h_edge;
        int e_up = t + 1 < CPL ? E[t + 1] : e_edge;
        if (!up_live[t]) h_up = e_up = NEG;
        e = max(h_up - first, e_up - ext);
        v = max(H[t] + sub, e);
        if (CHECK && j == 0) v = h0;
      }
      valid[t] = !CHECK || (frame[t] && static_cast<unsigned>(j) <=
                                           static_cast<unsigned>(W));
      ht[t] = valid[t] ? v : NEG;
      E[t] = e;
    }
    int run[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int g = ht[t] + ext * (k0 + t);
      if (t == 0) run[t] = g;
      else run[t] = max(run[t - 1], g);
    }
    int scan = run[CPL - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      scan = max(scan, __shfl_up_sync(ALL, scan, d));
    const int below = __shfl_up_sync(ALL, scan, 1);
    const int before = lane == 0 ? INT32_MIN : below;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int pre = t == 0 ? (lane == 0 ? NEG : below)
                             : max(before, run[t - 1]);
      const int f = pre - op - ext * (k0 + t);
      H[t] = valid[t] ? max(ht[t], f) : NEG;
    }
  };
  // banded rows [i_head, i_tail) hold only columns in [1, W]
  const int i_head = FULL ? R : min(R, max(0, band - c));
  const int i_tail = FULL ? R : max(i_head, min(R, W - c - band));
  int i = 0;
  for (; i < i_head; ++i) row(i, std::true_type{});
  for (; i < i_tail; ++i) row(i, std::false_type{});
  for (; i < R; ++i) row(i, std::true_type{});
  // the first slot of the last row that reaches its maximum
  int best = INT32_MIN, arg = INT32_MAX;
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    if (frame[t] && H[t] > best) {
      best = H[t];
      arg = k0 + t;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ob = __shfl_xor_sync(ALL, best, d);
    const int oa = __shfl_xor_sync(ALL, arg, d);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  return DPOut{best, FULL ? arg : R + c - band + arg};
}

// Shared memory a block of `threads` DP threads needs.
inline size_t gotoh_smem(int W, int band, int threads) {
  const int cols = band < 0 ? W + 1 : 2 * band + 1;
  return 2 * static_cast<size_t>(cols) * threads * sizeof(int);
}

}  // namespace repro
