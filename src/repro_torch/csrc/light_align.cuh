// Light Alignment of one read against its reference window, the alignment
// unit of the CUDA kernels, as repro's light_align/kernel.py ::
// align_block is shared by candidate_align_pallas and light_align_pallas.
// Mirrors core/light_align.light_align.  Two designs of the same function:
// `light_align_lanes` (L lanes a read; light_align.cu, and candidate_align.cu
// up to 1,024 bases) and `light_align_one` (one thread a read;
// candidate_align.cu past that).
//
// Window base E + s + i faces read base i under shift s in [-E, E].  The
// mismatch-only hypothesis and, per gap length k in [1, E], the best
// single deletion (suffix at shift +k) and insertion (suffix at shift -k)
// split by min-split, or the paper's zero-mismatch rule.  The first
// arg-min split is kept (argmin's tie-break), and a later hypothesis
// replaces the best only when it scores strictly more (argmax's first
// maximum).
//
// light_align_one: one pass per shift carries the two running mismatch
// counts instead of storing the 2E+1 prefix rows.  `Window` is how a
// window base is read: win(j) is base j of the window, 0 <= j < R + 2E
// (`RowWindow`: a row staged in shared memory).  Needs R >= E.
//
// light_align_lanes: L lanes (a power of two, aligned in the warp) share
// a read, lane li holding positions [a, a + 4 NW), a = 4 NW li.  Each
// shift's mismatch flags are computed once, four bases per 32-bit word
// (XOR, a carry-free nonzero-byte test and one multiply gather the four
// flags into a nibble), as a bitmask of the lane's positions.  A gap
// hypothesis with suffix mask h scores tot_h + min over splits p of
// D(p) = sum_{i < p} (m0[i] - h[i]), where tot_h counts h over its range:
// deletion of k, h[i] = read[i] != win[E + k + i] over i < R, splits
// [1, R-1]; insertion of k, h[i] = read[i + k] != win[E + i] over
// i < R - k, splits [1, R-k-1].  D(p) is the inclusive prefix of the
// +-1/0 walk at i = p - 1, so p = 0 never competes; positions past the
// last split step +1 (m0 set, h cleared) and can never be a first
// minimum.  Each lane walks its positions a nibble at a time through a
// 256-entry table (`nibble_entry`: the nibble's first minimum and its net
// step as keys v * 1024 + p, so one integer min keeps the first arg-min),
// then a shuffle scan carries the walk's prefix across the read's lanes
// and a shuffle min picks the first minimum.  Needs R <= 4 NW L <= 1024.
#pragma once

#include <climits>

#include "common.cuh"

namespace repro {

constexpr int LANE_KEY_SHIFT = 10;    // walk keys v * 1024 + p, p < 1024

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

// Table entry `idx` of the lane walk: bits 0-3 of idx are m0 at the four
// positions of a nibble, bits 4-7 the suffix mask h.  x: the first
// minimum over t of P_t * 1024 + t + 1 (P_t the inclusive prefix of the
// steps m0 - h), y: the net step P_3 * 1024 + 4.
__device__ inline int2 nibble_entry(int idx) {
  int P = 0, first = INT_MAX;
  for (int t = 0; t < 4; ++t) {
    P += ((idx >> t) & 1) - ((idx >> (4 + t)) & 1);
    first = min(first, P * (1 << LANE_KEY_SHIFT) + t + 1);
  }
  return make_int2(first, P * (1 << LANE_KEY_SHIFT) + 4);
}

// Mismatch flags of the four byte pairs of a and b, as bits 0-3.
__device__ __forceinline__ uint32_t mismatch_nibble(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  // bit 7 of each byte: the byte is nonzero (no carry leaves a byte)
  const uint32_t t = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return (t * 0x00204081u) >> 28;      // bits 7, 15, 23, 31 -> 28 .. 31
}

// NW words of the bytes from byte x of the 4-byte-aligned w (NW + 1
// aligned loads, funnel-shifted).
template <int NW>
__device__ __forceinline__ void words_at(const uint32_t* w, int x,
                                         uint32_t (&out)[NW]) {
  const uint32_t* p = w + (x >> 2);
  const int sh = 8 * (x & 3);
  uint32_t lo = p[0];
#pragma unroll
  for (int t = 0; t < NW; ++t) {
    const uint32_t hi = p[t + 1];
    out[t] = __funnelshift_r(lo, hi, sh);
    lo = hi;
  }
}

template <int NW>
__device__ __forceinline__ uint32_t mismatch_mask(const uint32_t (&a)[NW],
                                                  const uint32_t (&b)[NW]) {
  uint32_t m = 0u;
#pragma unroll
  for (int t = 0; t < NW; ++t) m |= mismatch_nibble(a[t], b[t]) << (4 * t);
  return m;
}

// Bits of the positions below n of a 32-bit lane mask.
__device__ __forceinline__ uint32_t low_bits(int n) {
  return n <= 0 ? 0u : n >= 32 ? ~0u : (1u << n) - 1u;
}

struct LaneGroup {
  int li, L;            // lane within the read's group, group size
};

__device__ __forceinline__ int group_sum(int v, const LaneGroup& g) {
  for (int d = 1; d < g.L; d <<= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// (mm, split) of one gap hypothesis: suffix mask h against m0, splits up
// to `last`, h counted over positions below n.  Every lane of the group
// returns the same pair.
template <int NW>
__device__ __forceinline__ int2 lane_hypothesis(const int2* tab, uint32_t m0,
                                                uint32_t h, int a, int last,
                                                int n, const LaneGroup& g) {
  const uint32_t past = ~low_bits(last - a);   // positions >= last step +1
  const uint32_t s0 = m0 | past, s1 = h & ~past;
  // table index of nibble q (m0's nibble q | h's << 4): byte q / 2 of
  // `even` for even q, of `odd` for odd q
  const uint32_t even = (s0 & 0x0f0f0f0fu) | ((s1 << 4) & 0xf0f0f0f0u);
  const uint32_t odd = ((s0 >> 4) & 0x0f0f0f0fu) | (s1 & 0xf0f0f0f0u);
  int key = a, best = INT_MAX;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const int idx = ((q & 1 ? odd : even) >> (8 * (q >> 1))) & 0xff;
    const int2 e = tab[idx];
    best = min(best, key + e.x);
    key += e.y;
  }
  const int net = (key - a - 4 * NW) >> LANE_KEY_SHIFT;
  // one scan carries both sums: the walk's net (low 16 bits, signed) and
  // the suffix mismatches (high bits)
  const int mine = (__popc(h & low_bits(n - a)) << 16) + net;
  int incl = mine;
  for (int d = 1; d < g.L; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d, g.L);
    if (g.li >= d) incl += y;
  }
  const int before = static_cast<int16_t>(incl - mine);
  const int all = __shfl_sync(0xffffffffu, incl, g.L - 1, g.L);
  const int tot = (all - static_cast<int16_t>(all)) >> 16;
  best += before * (1 << LANE_KEY_SHIFT);
  for (int d = 1; d < g.L; d <<= 1)
    best = min(best, __shfl_xor_sync(0xffffffffu, best, d));
  return make_int2(tot + (best >> LANE_KEY_SHIFT),
                   best & ((1 << LANE_KEY_SHIFT) - 1));
}

// The read's alignment, the same on every lane of its group.  rw, ww: the
// 4-byte-aligned shared memory holding the read and the window, which
// start at bytes r0 and w0; it is read up to byte r0 + 4 NW L + E + 8 and
// w0 + 4 NW L + 2E + 8 (bytes past the row's own only meet positions the
// masks drop).  tab: the 256 `nibble_entry`s.  E + 2 <= R <= 4 NW L.
template <int NW>
__device__ AlignOut light_align_lanes(const uint32_t* rw, int r0,
                                      const uint32_t* ww, int w0, int R,
                                      int E, bool paper, const Scoring& sc,
                                      const int2* tab, const LaneGroup& g) {
  const int a = 4 * NW * g.li;
  uint32_t rd[NW], wd[NW], moved[NW];
  words_at<NW>(rw, r0 + a, rd);
  words_at<NW>(ww, w0 + E + a, wd);
  const uint32_t m0 = mismatch_mask<NW>(rd, wd);
  const int m2 = sc.match + sc.mismatch;
  const int mm_none = group_sum(__popc(m0 & low_bits(R - a)), g);
  AlignOut best{sc.match * R - m2 * mm_none, 0, 0, 0, mm_none};
  auto consider = [&](int2 h, int type, int k, int len) {
    int mm = h.x, pos = h.y;
    if (paper && mm != 0) {
      mm = BIG;
      pos = 0;
    }
    const int score = mm >= BIG ? -BIG
                                : sc.match * len - m2 * mm -
                                      (sc.gap_open + sc.gap_extend * k);
    if (score > best.score) best = AlignOut{score, type, k, pos, mm};
  };
  for (int k = 1; k <= E; ++k) {
    words_at<NW>(ww, w0 + E + k + a, moved);    // deletion: window at +k
    consider(lane_hypothesis<NW>(tab, m0, mismatch_mask<NW>(rd, moved), a,
                                 R - 1, R, g),
             2, k, R);
    words_at<NW>(rw, r0 + k + a, moved);        // insertion: read at +k
    consider(lane_hypothesis<NW>(tab, m0, mismatch_mask<NW>(moved, wd), a,
                                 R - k - 1, R - k, g),
             1, k, R - k);
  }
  return best;
}

}  // namespace repro
