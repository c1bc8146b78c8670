// light_align: Light Alignment (§4.6) of (B, R) reads against their
// (B, R + 2E) reference windows, the standalone building block.
//
// Replaces the TPU kernel repro/kernels/light_align/kernel.py ::
// light_align_pallas (its unit align_block is light_align.cuh here).  Each
// row gives score, edit type, length and position, and the chosen
// hypothesis' mismatch count; `ok` is derived by the wrapper, as in
// repro's ops.py.
//
// Bound on the H100: the 2E+1 shifted compares of R bases per row and the
// walks of the 2E gap hypotheses over them, against R + (R+2E) + 20 bytes,
// so integer operations bound it.  Design: L lanes a row
// (`light_align_lanes`: each lane's positions as bitmasks, four bases a
// compare, each shift's mask built once, the walk a nibble at a time
// through a shared-memory table, shuffle scans across the row's lanes),
// L = the power of two covering R in 32-position lanes (8 at R 150, so a
// warp holds 4 rows), and 4 NW positions a lane.  A block of 8 warps
// stages its 256 / L rows of reads and of windows (each contiguous in
// device memory) with 16-byte loads and builds the 256-entry table once;
// after that one barrier every warp runs on its own.
#include "light_align.cuh"

namespace {

using repro::Scoring;

constexpr int THREADS = 256;

// Copy the n bytes at `first` to dst as 16-byte vectors (the start aligned
// down; the head and tail vectors take only those n bytes, one at a time,
// so no load leaves the tensor).  Returns the byte of dst where they
// start.
__device__ int stage(uint4* dst, const uint8_t* first, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(first);
  const uint4* g = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
  const int head = static_cast<int>(a & 15);
  const int end = head + n, n_vec = (end + 15) >> 4;
  for (int v = threadIdx.x; v < n_vec; v += THREADS) {
    if (16 * v >= head && 16 * v + 16 <= end) {
      dst[v] = g[v];
    } else {
      const uint8_t* gb = reinterpret_cast<const uint8_t*>(g);
      uint8_t* db = reinterpret_cast<uint8_t*>(dst + v);
      for (int j = 0; j < 16; ++j) {
        const int i = 16 * v + j;
        db[j] = i >= head && i < end ? gb[i] : uint8_t{0};
      }
    }
  }
  return head;
}

// 2^lg_l lanes a row, `rows` = 256 >> lg_l rows a block; the staged reads
// take `read_vecs` 16-byte vectors of shared memory, the windows follow.
template <int NW>
__global__ void __launch_bounds__(THREADS) light_align_kernel(
    const uint8_t* __restrict__ reads, const uint8_t* __restrict__ wins,
    int B, int R, int E, int lg_l, int rows, int read_vecs, int paper,
    Scoring sc, int* __restrict__ out) {
  __shared__ int2 tab[256];
  extern __shared__ uint4 sh[];
  for (int i = threadIdx.x; i < 256; i += THREADS)
    tab[i] = repro::nibble_entry(i);
  const int W = R + 2 * E;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int n_rows = static_cast<int>(min(static_cast<long long>(rows),
                                          B - row0));
  const int hr = stage(sh, reads + row0 * R, n_rows * R);
  const int hw = stage(sh + read_vecs, wins + row0 * W, n_rows * W);
  __syncthreads();
  // every lane runs the unit (its shuffles span the warp); rows past the
  // batch read staged bytes that are never written back
  const int lane = threadIdx.x & 31;
  const int r = ((threadIdx.x >> 5) << (5 - lg_l)) + (lane >> lg_l);
  const repro::LaneGroup g{lane & ((1 << lg_l) - 1), 1 << lg_l};
  const repro::AlignOut o = repro::light_align_lanes<NW>(
      reinterpret_cast<const uint32_t*>(sh), hr + r * R,
      reinterpret_cast<const uint32_t*>(sh + read_vecs), hw + r * W, R, E,
      paper != 0, sc, tab, g);
  if (g.li == 0 && r < n_rows) {
    const long long b = row0 + r;
    out[b] = o.score;
    out[B + b] = o.type;
    out[2LL * B + b] = o.len;
    out[3LL * B + b] = o.pos;
    out[4LL * B + b] = o.mm;
  }
}

template <int NW>
void launch(const uint8_t* reads, const uint8_t* wins, int B, int R, int E,
            int lg_l, int paper, const Scoring& sc, int* out,
            cudaStream_t s) {
  const int L = 1 << lg_l, rows = THREADS >> lg_l, W = R + 2 * E;
  // each region: the rows, a head of up to 15 bytes, and the bytes past
  // the last row a lane reads (light_align_lanes)
  const int span = 4 * NW * L + 32;
  const int read_vecs = (rows * R + span + E + 15) >> 4;
  const int win_vecs = (rows * W + span + 15) >> 4;
  const size_t smem = 16 * static_cast<size_t>(read_vecs + win_vecs);
  const unsigned blocks = static_cast<unsigned>((B + rows - 1) / rows);
  light_align_kernel<NW><<<blocks, THREADS, smem, s>>>(
      reads, wins, B, R, E, lg_l, rows, read_vecs, paper, sc, out);
}

}  // namespace

// reads: (B, R) uint8; wins: (B, R + 2E) uint8, E + 2 <= R <= 1,024; out:
// (5, B) int32 = score, edit type, edit length, edit position, mismatches.
extern "C" int light_align_launch(const void* reads, const void* wins, int B,
                                  int R, int E, int paper, int match,
                                  int mismatch, int gap_open, int gap_extend,
                                  void* out, void* stream) {
  if (B == 0) return 0;
  int lg_l = 0;                          // lanes: 32 positions each, at most
  while ((32 << lg_l) < R) ++lg_l;
  const int NW = (R + (4 << lg_l) - 1) / (4 << lg_l);
  const Scoring sc{match, mismatch, gap_open, gap_extend};
  auto r = static_cast<const uint8_t*>(reads);
  auto w = static_cast<const uint8_t*>(wins);
  auto o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (NW) {
    case 1: launch<1>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    case 2: launch<2>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    case 3: launch<3>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    case 4: launch<4>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    case 5: launch<5>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    case 6: launch<6>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    case 7: launch<7>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    case 8: launch<8>(r, w, B, R, E, lg_l, paper, sc, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return repro::launch_status();
}
