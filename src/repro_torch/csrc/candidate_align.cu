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
// Bound on the H100: ~(2E+1)*R*6 integer operations per alignment against
// the R + (R+2E) bases it reads, so integer operations bound it, and the
// function needs only the alignments of valid mates: an invalid slot's
// score is NEG_BIG whatever its window holds.  Design: one block of
// `threads` threads per `ppb` pairs, one launch per call.
//   1. With a prescreen (0 < P < C), the zero-shift Hamming distance of
//      both mates of each fully valid slot (others rank as MM_BIG), then a
//      stable rank per slot; the top P slots, in rank order, are the
//      aligned set (without a prescreen, all C slots in slot order).
//   2. The valid (pair, mate, rank) items of the aligned set go into a
//      work list in shared memory (a shared counter, compacted), so the
//      block's threads align only live items; a pair without any valid
//      item wins at rank 0 (every key (2 NEG_BIG) C - j), so both mates of
//      its rank-0 slot join the list too, for their edit fields.
//   3. Each thread takes items from the list, copies the item's read and
//      window into its own rows of shared memory (raw bases, or the packed
//      words unpacked; each row an odd number of 4-byte words, so a
//      warp's rows lie in 32 different banks), and runs light_align.cuh's
//      passes on shared memory only.
//   4. One thread per pair takes the first maximum of the keys; a winner
//      with an invalid mate that was not aligned (a pair whose only valid
//      mates lie in other slots) puts that mate in a second list, aligned
//      as in 3 ("invalid slots read the window at 0": its edit fields are
//      reported).
// Results equal the plain version's bit for bit: the same integer
// arithmetic, the same tie-breaks, and a list order that only decides
// which thread computes an item, never its result.  The kernel also does
// the wrapper's former prep and epilogue, so a call is one launch: each
// window's coordinates (kernels/_util.window_starts's rule), the winner's
// positions and its CIGAR runs.  `count`, when given, receives the
// number of alignments the launch ran.
#include "light_align.cuh"

namespace {

using repro::Scoring;

constexpr int NEG_BIG = -(1 << 20);   // masked-candidate score
constexpr int MM_BIG = 1 << 20;       // masked-candidate Hamming distance
constexpr int N_FIELDS = 8;

constexpr int EDIT_NONE = 0, EDIT_INS = 1;   // light_align.cuh's types
constexpr int CIG_M = 0, CIG_I = 1, CIG_D = 2;

// The (3, 2) CIGAR runs of an edit, as core/light_align.py::cigar_ops:
// [(M, R)], [(M, p), (D, k), (M, R-p)] or [(M, p), (I, k), (M, R-p-k)],
// zero-length runs as padding.
__device__ void write_cigar(int* __restrict__ cig, int type, int k, int p,
                            int R) {
  const bool none = type == EDIT_NONE, ins = type == EDIT_INS;
  const int tail = none ? 0 : ins ? R - p - k : R - p;
  const int runs[6] = {CIG_M, none ? R : p, ins ? CIG_I : CIG_D,
                       none ? 0 : k, CIG_M, tail};
  for (int i = 0; i < 6; ++i) cig[i] = runs[i];
}

template <bool PACKED>
__global__ void candidate_align_kernel(
    const void* __restrict__ ref, const uint8_t* __restrict__ reads1,
    const uint8_t* __restrict__ reads2, const int* __restrict__ pos1,
    const int* __restrict__ pos2, int B, int R, int C, int E, int P,
    int paper, Scoring sc, int threshold, int ppb, int sr, int sw,
    int ref_len, int win_hi, int pad, int* __restrict__ out,
    int* __restrict__ cigar1, int* __restrict__ cigar2,
    int* __restrict__ count) {
  extern __shared__ int sh[];
  const int PC = ppb * C;
  // per item k = (pair * 2 + mate) * C + rank: its score, and its edit
  // type | len << 2 | pos << 17 (len <= E and pos < R, both below 2^14)
  int* score = sh;
  int* edit = score + 2 * PC;
  int* slot_of = edit + 2 * PC;   // [pair][rank] -> slot
  int* pmm = slot_of + PC;        // [pair][slot] -> prescreen distance
  int* work = pmm + PC;           // item list, up to 2 PC entries
  int* flag = work + 2 * PC;      // [pair]: has a valid item, then winner
  int* n_work = flag + ppb;
  uint8_t* rows = reinterpret_cast<uint8_t*>(n_work + 1);
  uint8_t* my_read = rows + threadIdx.x * sr;
  uint8_t* my_win = rows + blockDim.x * sr + threadIdx.x * sw;

  const long long b0 = static_cast<long long>(blockIdx.x) * ppb;
  const int np = static_cast<int>(min(static_cast<long long>(ppb), B - b0));
  const bool prescreen = P > 0 && P < C;
  const int n_align = prescreen ? P : C;
  const int W = R + 2 * E;

  auto pos_at = [&](int mate, int lp, int c) {
    return (mate ? pos2 : pos1)[(b0 + lp) * C + c];
  };
  auto valid_at = [&](int mate, int lp, int c) {
    return pos_at(mate, lp, c) != repro::INVALID_LOC;
  };
  // the window coordinates of kernels/_util.window_starts: an invalid
  // slot reads the window at 0; packed, start pos - E (wrapping as int32
  // does) clamped to [0, win_hi] and split into word and offset;
  // unpacked, pos clamped to [E - W, ref_len - 1 + E] in the reference
  // edge-padded by `pad` bases
  auto window = [&](int mate, int lp, int c) {
    const int p = valid_at(mate, lp, c) ? pos_at(mate, lp, c) : 0;
    if constexpr (PACKED) {
      int st = valid_at(mate, lp, c)
                   ? static_cast<int>(static_cast<unsigned>(p) -
                                      static_cast<unsigned>(E))
                   : 0;
      st = min(max(st, 0), win_hi);
      return repro::RefWindow<true>{ref, st >> 4, st & 15};
    } else {
      const int st = min(max(p, E - W), ref_len - 1 + E);
      return repro::RefWindow<false>{
          ref, static_cast<long long>(st) + (pad - E), 0};
    }
  };
  // align item k in this thread's rows
  auto align_item = [&](int k) {
    const int lp = k / (2 * C), mate = k / C % 2, j = k % C;
    const int c = slot_of[lp * C + j];
    const uint8_t* rd = (mate ? reads2 : reads1) + (b0 + lp) * R;
    for (int i = 0; i < R; ++i) my_read[i] = rd[i];
    const repro::RefWindow<PACKED> win = window(mate, lp, c);
    if constexpr (PACKED) {
      const uint32_t* w = static_cast<const uint32_t*>(ref) + win.start;
      uint32_t word = w[0] >> (2 * win.off);
      int left = 16 - win.off;
      for (int i = 0, next = 1; i < W; ++i) {
        if (left == 0) {
          word = w[next++];
          left = 16;
        }
        my_win[i] = word & 3;
        word >>= 2;
        --left;
      }
    } else {
      const uint8_t* w = static_cast<const uint8_t*>(ref) + win.start;
      for (int i = 0; i < W; ++i) my_win[i] = w[i];
    }
    const repro::AlignOut a = repro::light_align_one(
        my_read, repro::RowWindow{my_win}, R, E, paper != 0, sc);
    score[k] = valid_at(mate, lp, c) ? a.score : NEG_BIG;
    edit[k] = a.type | a.len << 2 | a.pos << 17;
  };

  // 1. the aligned set, in rank order
  if (threadIdx.x == 0) *n_work = 0;
  for (int i = threadIdx.x; i < np; i += blockDim.x) flag[i] = 0;
  if (prescreen) {
    for (int i = threadIdx.x; i < np * C; i += blockDim.x) {
      const int lp = i / C, c = i % C;
      int mm = MM_BIG;
      if (valid_at(0, lp, c) && valid_at(1, lp, c)) {
        mm = 0;
        for (int mate = 0; mate < 2; ++mate) {
          const uint8_t* rd = (mate ? reads2 : reads1) + (b0 + lp) * R;
          const repro::RefWindow<PACKED> win = window(mate, lp, c);
          for (int q = 0; q < R; ++q)
            mm += static_cast<int>(rd[q]) != win(E + q);
        }
      }
      pmm[i] = mm;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < np * C; i += blockDim.x) {
      const int lp = i / C, c = i % C;
      const int mine = pmm[i];
      int r = 0;
      for (int cc = 0; cc < C; ++cc) {
        const int o = pmm[lp * C + cc];
        r += (o < mine) | ((o == mine) & (cc < c));
      }
      if (r < n_align) slot_of[lp * C + r] = c;
    }
  } else {
    for (int i = threadIdx.x; i < np * C; i += blockDim.x)
      slot_of[i] = i % C;
  }
  __syncthreads();

  // 2. the work list: every valid item of the aligned set
  for (int i = threadIdx.x; i < np * n_align; i += blockDim.x) {
    const int lp = i / n_align, j = i % n_align;
    const int c = slot_of[lp * C + j];
    for (int mate = 0; mate < 2; ++mate) {
      const int k = (lp * 2 + mate) * C + j;
      if (valid_at(mate, lp, c)) {
        work[atomicAdd(n_work, 1)] = k;
        flag[lp] = 1;
      } else {
        score[k] = NEG_BIG;
      }
    }
  }
  __syncthreads();
  for (int lp = threadIdx.x; lp < np; lp += blockDim.x) {
    if (!flag[lp]) {   // winner at rank 0, both mates invalid
      const int at = atomicAdd(n_work, 2);
      work[at] = lp * 2 * C;
      work[at + 1] = (lp * 2 + 1) * C;
    }
  }
  __syncthreads();

  // 3. align the list
  const int n_aligned = *n_work;
  for (int i = threadIdx.x; i < n_aligned; i += blockDim.x)
    align_item(work[i]);
  __syncthreads();
  if (threadIdx.x == 0) *n_work = 0;
  __syncthreads();

  // 4. the winner per pair, and its invalid mates not yet aligned
  for (int lp = threadIdx.x; lp < np; lp += blockDim.x) {
    int best = 0, best_key = 0;
    for (int j = 0; j < n_align; ++j) {
      const int key =
          (score[lp * 2 * C + j] + score[(lp * 2 + 1) * C + j]) * C - j;
      if (j == 0 || key > best_key) {
        best_key = key;
        best = j;
      }
    }
    const int c = slot_of[lp * C + best];
    for (int mate = 0; mate < 2; ++mate)
      if (flag[lp] && !valid_at(mate, lp, c))
        work[atomicAdd(n_work, 1)] = (lp * 2 + mate) * C + best;
    flag[lp] = best;
  }
  __syncthreads();
  const int n_late = *n_work;
  for (int i = threadIdx.x; i < n_late; i += blockDim.x) align_item(work[i]);
  __syncthreads();
  if (count != nullptr && threadIdx.x == 0)
    atomicAdd(count, n_aligned + n_late);

  for (int lp = threadIdx.x; lp < np; lp += blockDim.x) {
    const int best = flag[lp];
    const int c = slot_of[lp * C + best];
    const int k1 = lp * 2 * C + best, k2 = k1 + C;
    const int fields[N_FIELDS] = {
        c,                best,
        score[k1],        score[k2],
        valid_at(0, lp, c) && score[k1] >= threshold,
        valid_at(1, lp, c) && score[k2] >= threshold,
        pos_at(0, lp, c), pos_at(1, lp, c)};
    for (int f = 0; f < N_FIELDS; ++f)
      out[f * static_cast<long long>(B) + b0 + lp] = fields[f];
    const int e1 = edit[k1], e2 = edit[k2];
    write_cigar(cigar1 + (b0 + lp) * 6, e1 & 3, e1 >> 2 & 0x7FFF, e1 >> 17,
                R);
    write_cigar(cigar2 + (b0 + lp) * 6, e2 & 3, e2 >> 2 & 0x7FFF, e2 >> 17,
                R);
  }
}

}  // namespace

// ref: packed int32 words (back-padded) or uint8 bases (edge-padded by
// `pad` in front), of ref_len words or bases before the padding; reads1/2:
// (B, R) uint8; pos1/2: (B, C) int32 candidate starts, INVALID_LOC
// padded; win_hi: the packed window start's clamp; out: (8, B) int32 =
// slot, rank, score1, score2, ok1, ok2, pos1, pos2 of the winner;
// cigar1/2: (B, 3, 2) int32 runs; count: null, or one int32 that the
// launch adds its number of alignments to.  threads per block, ppb pairs
// per block and the staged row strides sr, sw come from the wrapper:
// 4 (8 ppb C + ppb + 1) + threads (sr + sw) bytes of shared memory;
// R < 2^14.
extern "C" int candidate_align_launch(
    const void* ref, int packed, const void* reads1, const void* reads2,
    const void* pos1, const void* pos2, int B, int R, int C, int E, int P,
    int paper, int match, int mismatch, int gap_open, int gap_extend,
    int threshold, int threads, int ppb, int sr, int sw, int ref_len,
    int win_hi, int pad, void* out, void* cigar1, void* cigar2, void* count,
    void* stream) {
  if (B == 0) return 0;
  const long long blocks = (static_cast<long long>(B) + ppb - 1) / ppb;
  const size_t smem =
      4 * (8 * static_cast<size_t>(ppb) * C + ppb + 1) +
      static_cast<size_t>(threads) * (sr + sw);
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                          \
  ref, static_cast<const uint8_t*>(reads1),                                 \
      static_cast<const uint8_t*>(reads2), static_cast<const int*>(pos1),   \
      static_cast<const int*>(pos2), B, R, C, E, P, paper, sc, threshold,   \
      ppb, sr, sw, ref_len, win_hi, pad, static_cast<int*>(out),            \
      static_cast<int*>(cigar1), static_cast<int*>(cigar2),                 \
      static_cast<int*>(count)
  if (packed) {
    cudaFuncSetAttribute(candidate_align_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    candidate_align_kernel<true>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(REPRO_ARGS);
  } else {
    cudaFuncSetAttribute(candidate_align_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    candidate_align_kernel<false>
        <<<static_cast<unsigned>(blocks), threads, smem, s>>>(REPRO_ARGS);
  }
#undef REPRO_ARGS
  return repro::launch_status();
}
