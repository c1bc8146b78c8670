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
// `threads` (128) threads per `ppb` pairs, one launch per call, at most 64
// registers a thread so that an SM holds 8 blocks (32 warps).
//   1. With a prescreen (0 < P < C), the zero-shift Hamming distance of
//      both mates of each fully valid slot (others rank as MM_BIG), then a
//      stable rank per slot; the top P slots, in rank order, are the
//      aligned set (without a prescreen, all C slots in slot order).
//   2. The valid (pair, mate, rank) items of the aligned set go into a
//      work list in shared memory (a shared counter, compacted), so the
//      block aligns only live items; a pair without any valid item wins at
//      rank 0 (every key (2 NEG_BIG) C - j), so both mates of its rank-0
//      slot join the list too, for their edit fields.
//   3. Lane groups align the list (R <= 1,024: NW > 0).  An item goes to a
//      group of L lanes, L the power of two covering R in 32-position
//      lanes (8 at R 150 and 250), so a warp holds 32 / L groups and takes
//      the next 32 / L items of the list in each round.  The group stages
//      the item's read (aligned 32-bit words, copied as they lie, up to
//      STAGE loads a lane in flight) and its window (raw words the same
//      way, or the packed words unpacked four bases a word) into its own
//      rows of shared memory, and runs
//      light_align.cuh's `light_align_lanes<NW>` on them: bitmasks of
//      four-base compares, the walk a nibble at a time through the
//      256-entry table the block builds once, shuffle scans across the
//      group.  Only warp barriers separate the rounds.  Rows are an odd
//      number of 4-byte words, so a warp's groups fall in different banks.
//      Past 1,024 bases (NW = 0) one thread aligns an item with
//      `light_align_one` on rows of its own, staged one base at a time.
//   4. One thread per pair takes the first maximum of the keys; a winner
//      with an invalid mate that was not aligned (a pair whose only valid
//      mates lie in other slots) puts that mate in a second list, aligned
//      as in 3 ("invalid slots read the window at 0": its edit fields are
//      reported).
// Results equal the plain version's bit for bit: the same integer
// arithmetic, the same tie-breaks, and a list order that only decides
// which group computes an item, never its result.  The kernel also does
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
constexpr int TABLE = 256;            // the lanes' nibble table (int2)
// a block's threads at most (the wrapper's THREADS), and the blocks an SM
// holds at once, so at most 64 registers a thread (NW 8 takes 70 uncapped)
constexpr int MAX_THREADS = 128, MIN_BLOCKS = 8;

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

// The launch's arguments (candidate_align_launch documents them).
struct Params {
  const void* ref;
  const uint8_t* reads1;
  const uint8_t* reads2;
  const int* pos1;
  const int* pos2;
  int B, R, C, E, P, paper;
  Scoring sc;
  int threshold, lg_l, ppb, sr, sw, ref_len, win_hi, pad;
  int* out;
  int* cigar1;
  int* cigar2;
  int* count;
};

// Words a lane loads before it stores any, in the staging loops below.
constexpr int STAGE = 8;

// Copy the n bytes at `src` to the 4-byte-aligned dst as the aligned
// words that hold them, lane `li` of `L` taking every L-th word (an
// aligned word holding a byte of a tensor lies in its allocation).
// Returns the byte of dst where they start.
__device__ __forceinline__ int stage_words(uint32_t* dst, const uint8_t* src,
                                           int n, int li, int L) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const int head = static_cast<int>(a & 3);
  const int n_words = (head + n + 3) >> 2;
  for (int t = li; t < n_words; t += STAGE * L) {
    uint32_t v[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int q = t + u * L;
      v[u] = q < n_words ? __ldg(w + q) : 0u;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u)
      if (t + u * L < n_words) dst[t + u * L] = v[u];
  }
  return head;
}

// Unpack the n bases from base `off` of the packed words w to bytes of
// dst, four a word, lane `li` of `L` taking every L-th word (words past
// the last base's are never read).
__device__ __forceinline__ void stage_packed(uint32_t* dst, const uint32_t* w,
                                             int off, int n, int li, int L) {
  const int n_out = (n + 3) >> 2;
  for (int t = li; t < n_out; t += STAGE * L) {
    uint32_t lo[STAGE], hi[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int b = off + 4 * (t + u * L), wi = b >> 4;
      const bool in = t + u * L < n_out;
      lo[u] = in ? __ldg(w + wi) : 0u;
      hi[u] = in && (b & 15) > 12 && 16 * (wi + 1) < off + n
                  ? __ldg(w + wi + 1) : 0u;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int q = t + u * L;
      const uint32_t v =
          __funnelshift_r(lo[u], hi[u], 2 * ((off + 4 * q) & 15));
      if (q < n_out)
        dst[q] = (v & 3u) | (v >> 2 & 3u) << 8 | (v >> 4 & 3u) << 16 |
                 (v >> 6 & 3u) << 24;
    }
  }
}

// NW > 0: lane groups of 2^lg_l lanes, NW words a lane; NW = 0: one
// thread an item.
template <bool PACKED, int NW>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    candidate_align_kernel(Params p) {
  extern __shared__ int2 sh2[];
  const int R = p.R, C = p.C, E = p.E, ppb = p.ppb;
  const int PC = ppb * C;
  // the lanes' table first (8-byte aligned), then per item
  // k = (pair * 2 + mate) * C + rank: its score, and its edit
  // type | len << 2 | pos << 17 (len <= E and pos < R, both below 2^14)
  const int2* tab = sh2;
  int* score = reinterpret_cast<int*>(sh2 + (NW > 0 ? TABLE : 0));
  int* edit = score + 2 * PC;
  int* slot_of = edit + 2 * PC;   // [pair][rank] -> slot
  int* pmm = slot_of + PC;        // [pair][slot] -> prescreen distance
  int* work = pmm + PC;           // item list, up to 2 PC entries
  int* flag = work + 2 * PC;      // [pair]: has a valid item, then winner
  int* n_work = flag + ppb;
  uint8_t* rows = reinterpret_cast<uint8_t*>(n_work + 1);

  const long long b0 = static_cast<long long>(blockIdx.x) * ppb;
  const int np = static_cast<int>(min(static_cast<long long>(ppb), p.B - b0));
  const bool prescreen = p.P > 0 && p.P < C;
  const int n_align = prescreen ? p.P : C;
  const int W = R + 2 * E;

  auto pos_at = [&](int mate, int lp, int c) {
    return __ldg((mate ? p.pos2 : p.pos1) + (b0 + lp) * C + c);
  };
  auto valid_at = [&](int mate, int lp, int c) {
    return pos_at(mate, lp, c) != repro::INVALID_LOC;
  };
  auto read_of = [&](int mate, int lp) {
    return (mate ? p.reads2 : p.reads1) + (b0 + lp) * R;
  };
  // the window coordinates of kernels/_util.window_starts: an invalid
  // slot reads the window at 0; packed, start pos - E (wrapping as int32
  // does) clamped to [0, win_hi] and split into word and offset;
  // unpacked, pos clamped to [E - W, ref_len - 1 + E] in the reference
  // edge-padded by `pad` bases
  auto window = [&](int mate, int lp, int c) {
    const int q = valid_at(mate, lp, c) ? pos_at(mate, lp, c) : 0;
    if constexpr (PACKED) {
      int st = valid_at(mate, lp, c)
                   ? static_cast<int>(static_cast<unsigned>(q) -
                                      static_cast<unsigned>(E))
                   : 0;
      st = min(max(st, 0), p.win_hi);
      return repro::RefWindow<true>{p.ref, st >> 4, st & 15};
    } else {
      const int st = min(max(q, E - W), p.ref_len - 1 + E);
      return repro::RefWindow<false>{
          p.ref, static_cast<long long>(st) + (p.pad - E), 0};
    }
  };
  auto keep = [&](int k, int lp, int mate, int c, const repro::AlignOut& a) {
    score[k] = valid_at(mate, lp, c) ? a.score : NEG_BIG;
    edit[k] = a.type | a.len << 2 | a.pos << 17;
  };
  // align work[0, n)
  auto align_list = [&](int n) {
    if constexpr (NW > 0) {
      const int L = 1 << p.lg_l, groups = blockDim.x >> p.lg_l;
      const int gi = threadIdx.x >> p.lg_l;
      const repro::LaneGroup g{static_cast<int>(threadIdx.x) & (L - 1), L};
      uint32_t* rw = reinterpret_cast<uint32_t*>(rows + gi * p.sr);
      uint32_t* ww =
          reinterpret_cast<uint32_t*>(rows + groups * p.sr + gi * p.sw);
      // a warp's groups take consecutive items; the loop is the warp's
      // (its shuffles span the warp), so a group past the list runs on
      // stale rows and keeps nothing
      const int first = (threadIdx.x >> 5) * (32 >> p.lg_l);
      for (int i0 = first; i0 < n; i0 += groups) {
        const int i = i0 + gi - first;
        int k = 0, lp = 0, mate = 0, c = 0, r0 = 0, w0 = 0;
        if (i < n) {
          k = work[i];
          lp = k / (2 * C);
          mate = k / C % 2;
          c = slot_of[lp * C + k % C];
          r0 = stage_words(rw, read_of(mate, lp), R, g.li, L);
          const repro::RefWindow<PACKED> win = window(mate, lp, c);
          if constexpr (PACKED) {
            stage_packed(ww, static_cast<const uint32_t*>(p.ref) + win.start,
                         win.off, W, g.li, L);
          } else {
            w0 = stage_words(ww, static_cast<const uint8_t*>(p.ref) +
                                     win.start, W, g.li, L);
          }
        }
        __syncwarp();
        const repro::AlignOut a = repro::light_align_lanes<NW>(
            rw, r0, ww, w0, R, E, p.paper != 0, p.sc, tab, g);
        if (i < n && g.li == 0) keep(k, lp, mate, c, a);
        __syncwarp();
      }
    } else {
      uint8_t* my_read = rows + threadIdx.x * p.sr;
      uint8_t* my_win = rows + blockDim.x * p.sr + threadIdx.x * p.sw;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int k = work[i];
        const int lp = k / (2 * C), mate = k / C % 2;
        const int c = slot_of[lp * C + k % C];
        const uint8_t* rd = read_of(mate, lp);
        for (int q = 0; q < R; ++q) my_read[q] = rd[q];
        const repro::RefWindow<PACKED> win = window(mate, lp, c);
        for (int q = 0; q < W; ++q) my_win[q] = win(q);
        keep(k, lp, mate, c,
             repro::light_align_one(my_read, repro::RowWindow{my_win}, R, E,
                                    p.paper != 0, p.sc));
      }
    }
  };

  // 1. the aligned set, in rank order
  if (threadIdx.x == 0) *n_work = 0;
  if constexpr (NW > 0) {
    for (int i = threadIdx.x; i < TABLE; i += blockDim.x)
      sh2[i] = repro::nibble_entry(i);
  }
  for (int i = threadIdx.x; i < np; i += blockDim.x) flag[i] = 0;
  if (prescreen) {
    for (int i = threadIdx.x; i < np * C; i += blockDim.x) {
      const int lp = i / C, c = i % C;
      int mm = MM_BIG;
      if (valid_at(0, lp, c) && valid_at(1, lp, c)) {
        mm = 0;
        for (int mate = 0; mate < 2; ++mate) {
          const uint8_t* rd = read_of(mate, lp);
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
  align_list(n_aligned);
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
  if (n_late > 0) align_list(n_late);
  __syncthreads();
  if (p.count != nullptr && threadIdx.x == 0)
    atomicAdd(p.count, n_aligned + n_late);

  for (int lp = threadIdx.x; lp < np; lp += blockDim.x) {
    const int best = flag[lp];
    const int c = slot_of[lp * C + best];
    const int k1 = lp * 2 * C + best, k2 = k1 + C;
    const int fields[N_FIELDS] = {
        c,                best,
        score[k1],        score[k2],
        valid_at(0, lp, c) && score[k1] >= p.threshold,
        valid_at(1, lp, c) && score[k2] >= p.threshold,
        pos_at(0, lp, c), pos_at(1, lp, c)};
    for (int f = 0; f < N_FIELDS; ++f)
      p.out[f * static_cast<long long>(p.B) + b0 + lp] = fields[f];
    const int e1 = edit[k1], e2 = edit[k2];
    write_cigar(p.cigar1 + (b0 + lp) * 6, e1 & 3, e1 >> 2 & 0x7FFF, e1 >> 17,
                R);
    write_cigar(p.cigar2 + (b0 + lp) * 6, e2 & 3, e2 >> 2 & 0x7FFF, e2 >> 17,
                R);
  }
}

template <int NW>
void launch(bool packed, const Params& p, unsigned blocks, int threads,
            size_t smem, cudaStream_t s) {
  if (packed) {
    cudaFuncSetAttribute(candidate_align_kernel<true, NW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    candidate_align_kernel<true, NW><<<blocks, threads, smem, s>>>(p);
  } else {
    cudaFuncSetAttribute(candidate_align_kernel<false, NW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    candidate_align_kernel<false, NW><<<blocks, threads, smem, s>>>(p);
  }
}

}  // namespace

// ref: packed int32 words (back-padded) or uint8 bases (edge-padded by
// `pad` in front), of ref_len words or bases before the padding; reads1/2:
// (B, R) uint8; pos1/2: (B, C) int32 candidate starts, INVALID_LOC
// padded; win_hi: the packed window start's clamp; out: (8, B) int32 =
// slot, rank, score1, score2, ok1, ok2, pos1, pos2 of the winner;
// cigar1/2: (B, 3, 2) int32 runs; count: null, or one int32 that the
// launch adds its number of alignments to.  The wrapper's launch_shape
// gives threads per block, lanes an item (0: one thread an item; else a
// power of two, at most 32, and R <= 32 lanes of 8 words), ppb pairs per
// block and the staged row strides sr, sw:
// 4 (8 ppb C + ppb + 1) + rows (sr + sw) bytes of shared memory, rows =
// threads / lanes (threads with one thread an item), and 2,048 for the
// table with lanes; R < 2^14.
extern "C" int candidate_align_launch(
    const void* ref, int packed, const void* reads1, const void* reads2,
    const void* pos1, const void* pos2, int B, int R, int C, int E, int P,
    int paper, int match, int mismatch, int gap_open, int gap_extend,
    int threshold, int threads, int lanes, int ppb, int sr, int sw,
    int ref_len, int win_hi, int pad, void* out, void* cigar1, void* cigar2,
    void* count, void* stream) {
  if (B == 0) return 0;
  int lg_l = 0, nw = 0;
  if (lanes > 0) {
    while ((1 << lg_l) < lanes) ++lg_l;
    nw = (R + 4 * lanes - 1) / (4 * lanes);
    if ((1 << lg_l) != lanes || lanes > 32 || nw > 8)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (static_cast<long long>(B) + ppb - 1) / ppb;
  const size_t smem =
      (lanes > 0 ? sizeof(int2) * TABLE : 0) +
      4 * (8 * static_cast<size_t>(ppb) * C + ppb + 1) +
      static_cast<size_t>(lanes > 0 ? threads >> lg_l : threads) * (sr + sw);
  const Params p{ref,
                 static_cast<const uint8_t*>(reads1),
                 static_cast<const uint8_t*>(reads2),
                 static_cast<const int*>(pos1),
                 static_cast<const int*>(pos2),
                 B, R, C, E, P, paper,
                 Scoring{match, mismatch, gap_open, gap_extend},
                 threshold, lg_l, ppb, sr, sw, ref_len, win_hi, pad,
                 static_cast<int*>(out),
                 static_cast<int*>(cigar1),
                 static_cast<int*>(cigar2),
                 static_cast<int*>(count)};
  const auto n = static_cast<unsigned>(blocks);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 0: launch<0>(packed, p, n, threads, smem, s); break;
    case 1: launch<1>(packed, p, n, threads, smem, s); break;
    case 2: launch<2>(packed, p, n, threads, smem, s); break;
    case 3: launch<3>(packed, p, n, threads, smem, s); break;
    case 4: launch<4>(packed, p, n, threads, smem, s); break;
    case 5: launch<5>(packed, p, n, threads, smem, s); break;
    case 6: launch<6>(packed, p, n, threads, smem, s); break;
    case 7: launch<7>(packed, p, n, threads, smem, s); break;
    case 8: launch<8>(packed, p, n, threads, smem, s); break;
  }
  return repro::launch_status();
}
