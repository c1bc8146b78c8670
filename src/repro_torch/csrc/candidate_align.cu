// candidate_align: Light Alignment of every candidate pair + best-pair
// reduction (§4.6, pipeline step 4).
//
// Replaces the TPU kernel repro/kernels/candidate_align/kernel.py ::
// candidate_align_pallas (its alignment math is light_align/kernel.py ::
// align_block).  For each pair and each of its C candidates it reads the
// R + 2E reference window of both mates, optionally ranks candidate pairs
// by summed zero-shift mismatches and keeps the top P, aligns each mate
// under the 2E+1 shift hypotheses (best single gap run by min-split, or
// the paper's zero-mismatch rule), and picks the pair maximising
// (score1 + score2) * C - j.
//
// Bound on the H100: the windows are 2*C*(R+2E) bases per pair (2 bits
// each when packed), ~6 KB unpacked, against ~(2E+1)*R*4 integer ops per
// alignment, so integer operations bound it.  Design: one thread per
// (pair, mate, candidate), 2*C threads per pair.  The thread streams its
// window straight from global memory (raw uint8 bases of the edge-padded
// reference, or base i of a packed window as
// (w[(off+i)>>4] >> 2*((off+i)&15)) & 3) and never stores the 2E+1 prefix
// rows: per shift it makes one pass carrying the two running mismatch
// counts, keeping the first arg-min split (argmin's tie-break).  The
// prescreen rank and the final reduction go through shared memory among
// the pair's threads.
#include <climits>

#include "common.cuh"

namespace {

using repro::BIG;
using repro::Scoring;

constexpr int NEG_BIG = -(1 << 20);   // masked-candidate score
constexpr int MM_BIG = 1 << 20;       // masked-candidate Hamming distance
constexpr int N_FIELDS = 12;

struct AlignOut {
  int score, type, len, pos;
};

// Light Alignment of one read against its window (window base E + s + i
// faces read base i under shift s).  Mirrors core/light_align.light_align.
template <bool PACKED>
__device__ AlignOut light_align_one(const uint8_t* __restrict__ read,
                                    const void* ref, long long start, int off,
                                    int R, int E, bool paper,
                                    const Scoring& sc) {
  auto mis = [&](int i, int s) -> int {
    return static_cast<int>(read[i]) !=
           repro::window_base<PACKED>(ref, start, off, E + s + i);
  };
  const int m2 = sc.match + sc.mismatch;
  int mm_none = 0;
  for (int i = 0; i < R; ++i) mm_none += mis(i, 0);
  AlignOut best{sc.match * R - m2 * mm_none, 0, 0, 0};

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
      if (score > best.score) best = AlignOut{score, 2, k, arg};
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
      if (score > best.score) best = AlignOut{score, 1, k, arg};
    }
  }
  return best;
}

template <bool PACKED>
__global__ void candidate_align_kernel(
    const void* __restrict__ ref, const uint8_t* __restrict__ reads1,
    const uint8_t* __restrict__ reads2, const int* __restrict__ sdma1,
    const int* __restrict__ sdma2, const int* __restrict__ off1,
    const int* __restrict__ off2, const int* __restrict__ valid1,
    const int* __restrict__ valid2, int B, int R, int C, int E, int P,
    int paper, Scoring sc, int threshold, int* __restrict__ out) {
  extern __shared__ int sh[];
  const int tpp = 2 * C;                     // threads per pair
  const int ppb = blockDim.x / tpp;          // pairs per block
  const int lp = threadIdx.x / tpp;
  const int t = threadIdx.x % tpp;
  const int mate = t / C, c = t % C;
  const long long b = static_cast<long long>(blockIdx.x) * ppb + lp;
  const bool active = b < B;
  // per-pair shared slots, indexed [mate * C + j] (j: prescreen order)
  int* mmsh = sh + lp * 13 * C;
  int* scsh = mmsh + 2 * C;
  int* oksh = scsh + 2 * C;
  int* etsh = oksh + 2 * C;
  int* elsh = etsh + 2 * C;
  int* epsh = elsh + 2 * C;
  int* slotsh = epsh + 2 * C;

  const long long idx = b * C + c;
  const uint8_t* read = (mate ? reads2 : reads1) + b * R;
  int valid = 0, off = 0;
  long long start = 0;
  if (active) {
    valid = (mate ? valid2 : valid1)[idx];
    start = (mate ? sdma2 : sdma1)[idx];
    off = (mate ? off2 : off1)[idx];
  }

  const bool prescreen = P > 0 && P < C;
  const int n_align = prescreen ? P : C;
  int j = c;
  if (prescreen) {
    if (active) {
      int mm0 = 0;
      for (int i = 0; i < R; ++i)
        mm0 += static_cast<int>(read[i]) !=
               repro::window_base<PACKED>(ref, start, off, E + i);
      mmsh[mate * C + c] = mm0;
    }
    __syncthreads();
    if (active) {
      auto pair_mm = [&](int cc) {
        const bool v = valid1[b * C + cc] && valid2[b * C + cc];
        return v ? mmsh[cc] + mmsh[C + cc] : MM_BIG;
      };
      const int mine = pair_mm(c);
      int r = 0;
      for (int cc = 0; cc < C; ++cc) {
        const int o = pair_mm(cc);
        r += (o < mine) | ((o == mine) & (cc < c));
      }
      j = r;
    }
  }
  if (active && j < n_align) {
    const AlignOut a = light_align_one<PACKED>(read, ref, start, off, R, E,
                                               paper != 0, sc);
    const int k = mate * C + j;
    scsh[k] = valid ? a.score : NEG_BIG;
    oksh[k] = (a.score >= threshold) && valid;
    etsh[k] = a.type;
    elsh[k] = a.len;
    epsh[k] = a.pos;
    if (mate == 0) slotsh[j] = c;
  }
  __syncthreads();
  if (active && t == 0) {
    int best = 0, best_key = 0;
    for (int jj = 0; jj < n_align; ++jj) {
      const int key = (scsh[jj] + scsh[C + jj]) * C - jj;
      if (jj == 0 || key > best_key) {
        best_key = key;
        best = jj;
      }
    }
    const int fields[N_FIELDS] = {
        slotsh[best],       best,
        scsh[best],         scsh[C + best],
        oksh[best],         oksh[C + best],
        etsh[best],         elsh[best],         epsh[best],
        etsh[C + best],     elsh[C + best],     epsh[C + best]};
    for (int f = 0; f < N_FIELDS; ++f) out[f * static_cast<long long>(B) + b] = fields[f];
  }
}

}  // namespace

// ref: packed int32 words (back-padded) or uint8 bases (edge-padded);
// reads1/2: (B, R) uint8; sdma/off/valid: (B, C) int32;
// out: (12, B) int32 = slot, rank, score1, score2, ok1, ok2, edit
// type/len/pos of mate 1, edit type/len/pos of mate 2.
extern "C" int candidate_align_launch(
    const void* ref, int packed, const void* reads1, const void* reads2,
    const void* sdma1, const void* sdma2, const void* off1, const void* off2,
    const void* valid1, const void* valid2, int B, int R, int C, int E, int P,
    int paper, int match, int mismatch, int gap_open, int gap_extend,
    int threshold, void* out, void* stream) {
  if (B == 0) return 0;
  const int tpp = 2 * C;
  const int ppb = tpp >= 128 ? 1 : 128 / tpp;
  const int threads = ppb * tpp;
  const long long blocks = (static_cast<long long>(B) + ppb - 1) / ppb;
  const size_t smem = static_cast<size_t>(ppb) * 13 * C * sizeof(int);
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                         \
  ref, static_cast<const uint8_t*>(reads1),                                \
      static_cast<const uint8_t*>(reads2), static_cast<const int*>(sdma1), \
      static_cast<const int*>(sdma2), static_cast<const int*>(off1),       \
      static_cast<const int*>(off2), static_cast<const int*>(valid1),      \
      static_cast<const int*>(valid2), B, R, C, E, P, paper, sc, threshold, \
      static_cast<int*>(out)
  if (packed)
    candidate_align_kernel<true>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(REPRO_ARGS);
  else
    candidate_align_kernel<false>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(REPRO_ARGS);
#undef REPRO_ARGS
  return repro::launch_status();
}
