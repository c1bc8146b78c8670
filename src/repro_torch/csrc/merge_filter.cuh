// The one merge + Paired-Adjacency filter of the front-end kernels (§4.4-
// 4.5), shared by pair_frontend.cu and merge_filter.cu as repro's
// pair_frontend/kernel.py :: merge_filter_block is shared by
// pair_frontend_pallas and merge_filter_pallas.
//
// One warp handles one read pair, with __syncwarp only.  It walks the
// 2S seed rows of the pair, 4 seeds of both mates at a time with all 8
// row loads in flight before the first is used; lane l reads slot l of a
// row (a row of K = 32 is one coalesced 128-byte load), turns it into a
// read start (loc - seed offset, wrapping as int32 does), and the warp
// counts the hits (popcount of a ballot) and compacts the h starts other
// than INVALID_LOC into its shared memory (prefix popcount + a running
// offset).  Only those h starts are sorted, by counting ranks over h:
// the reference's stable sort of all M = S*K slots is these h values
// followed by M - h INVALID_LOC (= INT_MAX, after every start; a valid
// location whose start wraps to INT_MAX falls among them, as in repro),
// and equal values cannot be told apart, so neither can the order the h
// starts were compacted in.  Only i < h1 is probed, since no later slot
// holds a start: lo = #{s2 < s1[i] - Δ} (binary search; no INVALID_LOC
// is below a target), occ = #{j < i : s1[j] == s1[i]}, and the partner
// is s2[min(lo + occ, M - 1)], INVALID_LOC past h2.  The within-Δ test,
// the (start1, start2) dedup against the previous slot and the front
// compaction of <= C candidates (ballot + popcount, a running offset past
// 32) follow.  Work is O(M/32 + h²/32) per lane.  Int32 differences are
// taken in uint32 so they wrap exactly like the reference's int32
// arithmetic.
//
// `Locs` is how a location is read: locs.key(q) is fetched once for seed
// row q = mate*S + s of the warp's pair (by lane q), and locs(key, mate,
// s, k) is slot k of that row (element s*K + k of mate 0 or 1).
#pragma once

#include "common.cuh"

namespace repro {

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// Shared memory of one warp (one pair) for M starts per mate: 4M ints.
inline size_t merge_filter_warp_smem(int M) {
  return 4 * static_cast<size_t>(M) * sizeof(int);
}

// Default warps (pairs) per block: 8, or fewer where 8 warps' shared
// memory would pass 48 KB.  The wrapper refuses M whose one warp does not
// fit, and any explicit count past 1,024 threads or 48 KB
// (kernels/pair_frontend/ops.py::frontend_warps).
inline int merge_filter_warps(int M) {
  const int w = static_cast<int>(48 * 1024 / merge_filter_warp_smem(M));
  return w > 8 ? 8 : (w < 1 ? 1 : w);
}

// #{j < n : x[j] < v} of an ascending x.
__device__ __forceinline__ int lower_bound(const int* x, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Pair b's outputs: pos1/pos2 (B, C), n_out/nh1/nh2 (B,).  sh: this warp's
// 4M ints of shared memory.
template <class Locs>
__device__ void merge_filter_block(const Locs& locs, int S, int K,
                                   const SeedOffsets& offs, int delta, int C,
                                   long long b, int* sh,
                                   int* __restrict__ pos1,
                                   int* __restrict__ pos2,
                                   int* __restrict__ n_out,
                                   int* __restrict__ nh1,
                                   int* __restrict__ nh2) {
  constexpr unsigned ALL = 0xffffffffu;
  const int M = S * K;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;   // lanes before this one
  int* raw = sh;          // each mate's valid starts, in element order
  int* s1 = sh + 2 * M;   // sorted valid starts of mate 1, then mate 2
  int* s2 = s1 + M;
  int* p2 = raw;          // partner of s1[i] (raw is dead by then)

  // 1. the 2S seed rows, 32 slots at a time (lane l reads slot kc + l):
  // read starts, hits, and each mate's valid starts compacted (their order
  // does not matter: only their sorted values are used).  Lane q < 2S
  // fetches the key of row q = mate*S + s first (a bucket id, say); the
  // rows of 4 seeds of both mates are loaded before any is used, and the
  // seed loop is unrolled, so each offset is a constant-bank load.
  const int my_key = lane < 2 * S ? locs.key(lane) : 0;
  int h[2] = {0, 0}, hits[2] = {0, 0};
  for (int kc = 0; kc < K; kc += 32) {
    const int k = kc + lane;
#pragma unroll
    for (int s0 = 0; s0 < MAX_SEEDS; s0 += 4) {
      if (s0 >= S) break;
      int loc[2][4];
#pragma unroll
      for (int mate = 0; mate < 2; ++mate) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = s0 + u;
          const int key = __shfl_sync(ALL, my_key, mate * S + s);
          loc[mate][u] =
              s < S && k < K ? locs(key, mate, s, k) : INVALID_LOC;
        }
      }
#pragma unroll
      for (int mate = 0; mate < 2; ++mate) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (s0 + u >= S) break;
          const bool hit = loc[mate][u] != INVALID_LOC;
          const int st =
              hit ? wrap_sub(loc[mate][u], offs.v[s0 + u]) : INVALID_LOC;
          const bool valid = st != INVALID_LOC;
          const unsigned vb = __ballot_sync(ALL, valid);
          if (valid) raw[mate * M + h[mate] + __popc(vb & below)] = st;
          h[mate] += __popc(vb);
          hits[mate] += __popc(__ballot_sync(ALL, hit));
        }
      }
    }
  }
  const int h1 = h[0], h2 = h[1];
  __syncwarp();

  // 3. counting-rank sort of the h1 + h2 valid starts, both mates at once
  for (int u = lane; u < h1 + h2; u += 32) {
    const int mate = u >= h1;
    const int i = u - mate * h1, n = mate ? h2 : h1;
    const int* x = raw + mate * M;
    const int v = x[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const int xj = x[j];
      r += (xj < v) | ((xj == v) & (j < i));
    }
    (mate ? s2 : s1)[r] = v;
  }
  __syncwarp();

  // 4. probe, within-Δ test, dedup and front compaction, i < h1 only
  int kept = 0;
  for (int base = 0; base < h1; base += 32) {
    const int i = base + lane;
    int v = INVALID_LOC, q = INVALID_LOC;
    if (i < h1) {
      v = s1[i];
      const int lo = lower_bound(s2, h2, wrap_sub(v, delta));
      const int occ = i - lower_bound(s1, i, v);
      const int idx = min(max(lo + occ, 0), M - 1);
      q = idx < h2 ? s2[idx] : INVALID_LOC;
      p2[i] = q;
    }
    __syncwarp();
    bool keep = false;
    if (i < h1 && q != INVALID_LOC) {
      const uint32_t ud = static_cast<uint32_t>(q) - static_cast<uint32_t>(v);
      const int d = static_cast<int>(ud);
      const bool within = static_cast<int>(d < 0 ? 0u - ud : ud) <= delta;
      const bool first = i == 0 || s1[i - 1] != v || p2[i - 1] != q;
      keep = within && first;
    }
    const unsigned kb = __ballot_sync(ALL, keep);
    const int slot = kept + __popc(kb & below);
    if (keep && slot < C) {
      pos1[b * C + slot] = v;
      pos2[b * C + slot] = q;
    }
    kept += __popc(kb);
  }
  for (int c = kept + lane; c < C; c += 32) {
    pos1[b * C + c] = INVALID_LOC;
    pos2[b * C + c] = INVALID_LOC;
  }
  if (lane == 0) {
    n_out[b] = min(kept, C);
    nh1[b] = hits[0];
    nh2[b] = hits[1];
  }
}

}  // namespace repro
