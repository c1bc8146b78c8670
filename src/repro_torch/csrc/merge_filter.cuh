// The one merge + Paired-Adjacency filter of the front-end kernels (§4.4-
// 4.5), shared by pair_frontend.cu and merge_filter.cu as repro's
// pair_frontend/kernel.py :: merge_filter_block is shared by
// pair_frontend_pallas and merge_filter_pallas.
//
// One thread block handles one read pair: it reads the M = S*K locations
// of each mate, turns them into read starts (loc - seed offset) and counts
// the hits, stable-sorts each mate's starts, runs the Δ filter
// (searchsorted, per-occurrence partner probing, (start1, start2) dedup)
// and front-compacts <= C candidates.  Every element gets its stable rank
// #{j : x_j < x_i or (x_j == x_i and j < i)} (the rank the TPU kernel
// computes) and every later step is one thread per element over shared
// memory: O(M^2) compares per mate, where the function needs an
// O(h log h) sort of the h valid starts.  Int32 differences are taken in
// uint32 so they wrap exactly like the reference's int32 arithmetic (an
// INVALID_LOC partner would overflow a signed subtraction).
//
// `Locs` is how a location is read: locs(mate, e) is element e = s*K + k
// (seed s, slot k) of mate 0 or 1 of the block's pair.
#pragma once

#include "common.cuh"

namespace repro {

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// Shared memory of one block for M starts per mate.
inline size_t merge_filter_smem(int M) {
  return (6 * static_cast<size_t>(M) + 3) * sizeof(int);
}

// Threads of one block: one per start of both mates, whole warps, <= 1024.
inline int merge_filter_threads(int M) {
  const int threads = ((2 * M + 31) / 32) * 32;
  return threads > 1024 ? 1024 : threads;
}

// Pair b's outputs: pos1/pos2 (B, C), n_out/nh1/nh2 (B,).
template <class Locs>
__device__ void merge_filter_block(const Locs& locs, int M, int K,
                                   const SeedOffsets& offs, int delta, int C,
                                   long long b, int* sh,
                                   int* __restrict__ pos1,
                                   int* __restrict__ pos2,
                                   int* __restrict__ n_out,
                                   int* __restrict__ nh1,
                                   int* __restrict__ nh2) {
  int* raw1 = sh;           // unsorted starts, mate 1
  int* raw2 = sh + M;       // unsorted starts, mate 2
  int* s1 = sh + 2 * M;     // sorted starts
  int* s2 = sh + 3 * M;
  int* p2 = sh + 4 * M;     // probed partner of s1[i]
  int* keep = sh + 5 * M;
  int* cnt = sh + 6 * M;    // hits mate 1, hits mate 2, kept candidates
  const int tid = threadIdx.x;
  if (tid < 3) cnt[tid] = 0;
  __syncthreads();

  // 1. locations -> read starts, count hits
  for (int i = tid; i < 2 * M; i += blockDim.x) {
    const int mate = i / M, e = i % M;
    const int loc = locs(mate, e);
    int st = INVALID_LOC;
    if (loc != INVALID_LOC) {
      st = wrap_sub(loc, offs.v[e / K]);
      atomicAdd(&cnt[mate], 1);
    }
    (mate ? raw2 : raw1)[e] = st;
  }
  __syncthreads();

  // 2. stable counting sort of each mate's starts
  for (int i = tid; i < 2 * M; i += blockDim.x) {
    const int mate = i / M, e = i % M;
    const int* x = mate ? raw2 : raw1;
    const int v = x[e];
    int r = 0;
    for (int j = 0; j < M; ++j) {
      const int xj = x[j];
      r += (xj < v) | ((xj == v) & (j < e));
    }
    (mate ? s2 : s1)[r] = v;
  }
  __syncthreads();

  // 3. partner probe: searchsorted(s2, s1 - delta) + occurrence index
  for (int i = tid; i < M; i += blockDim.x) {
    const int v = s1[i];
    const int target = wrap_sub(v, delta);
    int lo = 0, occ = 0;
    for (int j = 0; j < M; ++j) {
      lo += s2[j] < target;
      occ += (j < i) & (s1[j] == v);
    }
    const int idx = min(max(lo + occ, 0), M - 1);
    p2[i] = s2[idx];
  }
  __syncthreads();

  // 4. within-Δ test and adjacent-pair dedup
  for (int i = tid; i < M; i += blockDim.x) {
    const int v = s1[i], q = p2[i];
    bool within = false;
    if (q != INVALID_LOC && v != INVALID_LOC) {
      const uint32_t ud = static_cast<uint32_t>(q) - static_cast<uint32_t>(v);
      const int d = static_cast<int>(ud);
      within = static_cast<int>(d < 0 ? 0u - ud : ud) <= delta;
    }
    const bool first = i == 0 || s1[i - 1] != v || p2[i - 1] != q;
    keep[i] = within && first;
  }
  __syncthreads();

  // 5. front compaction: kept element i lands at slot #{j < i : keep_j}
  for (int i = tid; i < M; i += blockDim.x) {
    if (!keep[i]) continue;
    int slot = 0;
    for (int j = 0; j < i; ++j) slot += keep[j];
    if (slot < C) {
      pos1[b * C + slot] = s1[i];
      pos2[b * C + slot] = p2[i];
    }
    atomicAdd(&cnt[2], 1);
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    if (c >= cnt[2]) {
      pos1[b * C + c] = INVALID_LOC;
      pos2[b * C + c] = INVALID_LOC;
    }
  }
  if (tid == 0) {
    n_out[b] = min(cnt[2], C);
    nh1[b] = cnt[0];
    nh2[b] = cnt[1];
  }
}

}  // namespace repro
