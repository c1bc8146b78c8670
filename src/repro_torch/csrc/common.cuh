// Shared definitions of the repro_torch CUDA kernels (sm_90a).
//
// Every kernel is exported through a plain C launcher
//     extern "C" int <name>_launch(..., void* stream)
// that launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError() (0 on success).  Pointers come
// from torch tensors the Python wrapper has checked and allocated.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int INVALID_LOC = 0x7fffffff;   // sentinel: sorts after every start
constexpr int NEG = -(1 << 20);           // dead DP cell / masked score
constexpr int BIG = 1 << 20;              // "infinite" mismatch count
constexpr int MAX_SEEDS = 16;

struct SeedOffsets {
  int v[MAX_SEEDS];
};

struct Scoring {
  int match, mismatch, gap_open, gap_extend;
};

inline SeedOffsets seed_offsets(const int* host, int S) {
  SeedOffsets o{};
  for (int s = 0; s < S && s < MAX_SEEDS; ++s) o.v[s] = host[s];
  return o;
}

// Base i of a reference window.  PACKED: 2-bit words, base q of the
// reference at bits [2(q%16), 2(q%16)+2) of word q/16, the window starting
// at base `off` of word `start`.  Otherwise raw uint8 bases from `start`.
template <bool PACKED>
__device__ __forceinline__ int window_base(const void* ref, long long start,
                                           int off, int i) {
  if constexpr (PACKED) {
    const uint32_t* w = static_cast<const uint32_t*>(ref);
    const int q = off + i;
    return (w[start + (q >> 4)] >> (2 * (q & 15))) & 3;
  } else {
    return static_cast<const uint8_t*>(ref)[start + i];
  }
}

// Base j of a window in the padded reference (raw or packed), read as
// window_base does: the window kernels' `Window` for gotoh.cuh and
// light_align.cuh.
template <bool PACKED>
struct RefWindow {
  const void* ref;
  long long start;
  int off;
  __device__ __forceinline__ int operator()(int j) const {
    return window_base<PACKED>(ref, start, off, j);
  }
};

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace repro
