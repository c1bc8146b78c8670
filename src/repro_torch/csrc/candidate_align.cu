// candidate_align: Light Alignment of every candidate pair + best-pair
// reduction (§4.6, pipeline step 4).
//
// Replaces the TPU kernel repro/kernels/candidate_align/kernel.py ::
// candidate_align_pallas (its alignment math is light_align/kernel.py ::
// align_block, here light_align.cuh, which light_align.cu shares).  For
// each pair and each of its C candidates it reads the R + 2E reference
// window of both mates, optionally ranks candidate pairs by summed
// zero-shift mismatches and keeps the top P, aligns each mate under the
// 2E+1 shift hypotheses (best single gap run by min-split, or the paper's
// zero-mismatch rule), and picks the pair maximising
// (score1 + score2) * C - j.
//
// Bound on the H100: the windows are 2*C*(R+2E) bases per pair (2 bits
// each when packed), ~6 KB unpacked, against ~(2E+1)*R*4 integer ops per
// alignment, so integer operations bound it.  Design: one thread per
// (pair, mate, candidate), 2*C threads per pair.  The thread streams its
// window straight from global memory (raw uint8 bases of the edge-padded
// reference, or base i of a packed window as
// (w[(off+i)>>4] >> 2*((off+i)&15)) & 3) into light_align.cuh's one pass
// per shift.  The prescreen rank and the final reduction go through shared
// memory among the pair's threads.
#include "light_align.cuh"

namespace {

using repro::Scoring;

constexpr int NEG_BIG = -(1 << 20);   // masked-candidate score
constexpr int MM_BIG = 1 << 20;       // masked-candidate Hamming distance
constexpr int N_FIELDS = 12;

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

  const repro::RefWindow<PACKED> win{ref, start, off};

  const bool prescreen = P > 0 && P < C;
  const int n_align = prescreen ? P : C;
  int j = c;
  if (prescreen) {
    if (active) {
      int mm0 = 0;
      for (int i = 0; i < R; ++i)
        mm0 += static_cast<int>(read[i]) != win(E + i);
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
    const repro::AlignOut a =
        repro::light_align_one(read, win, R, E, paper != 0, sc);
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
