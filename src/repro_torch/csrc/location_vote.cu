// location_vote: the Location Voting reduction of the long-read lane (§4.7).
//
// Replaces the TPU kernel repro/kernels/location_vote/kernel.py ::
// location_vote_pallas.  Each long read's (M,) row of candidate read-start
// diagonals (INVALID_LOC padded) reduces to (win_bin, votes): the bins are
// floored diagonal / vote_bin, a slot's count is its bin's multiplicity
// among the valid slots, votes is the largest count and win_bin the
// smallest bin at that count (0 when votes == 0).  C++ `/` truncates
// toward zero, so the bins take a floored divide of their own: truncation
// would fold the near-origin bins -1 and 0 together.
//
// Bound on the H100: 4*M bytes in and 8 bytes out per read, and the
// O(M log M) sort the function needs; at M = 256 both are far below a
// microsecond for 2,048 reads, so launch latency bounds it.  Design: one
// warp per read, 8 reads a block by default (`warps`, a launch argument
// the tuner sets, up to 32; reads are independent, so the result does not
// depend on it).  A row is mostly INVALID_LOC (a
// long read from a unique locus leaves about one candidate per
// pseudo-pair), so the warp reads its row (16-byte loads where the rows
// are 16-byte aligned, else one int per lane; no load leaves the tensor),
// floors the valid diagonals in registers and compacts their h bins into
// its slice of shared memory (ballot + popcount ranks).  Each lane then
// counts its compacted slots against the h bins only (h^2 / 32 compares,
// four bins per shared-memory load, broadcast to the warp), and a 5-step
// shuffle keeps the larger count and, on a tie, the smaller bin.  Only
// __syncwarp orders the warp's slice: no block barrier.  The TPU kernel's
// `did` output and DMA row table served its ping-pong protocol and have no
// counterpart.
#include <algorithm>

#include "common.cuh"

namespace {

using repro::INVALID_LOC;

constexpr int DEFAULT_WARPS = 8;          // reads a block
constexpr int MAX_WARPS = 32;             // 1,024 threads
constexpr int MAX_SHARED = 48 * 1024;     // bytes of a block's slices
constexpr unsigned ALL = 0xffffffffu;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Keep (v, b) if it has more votes, or as many votes and a smaller bin.
__device__ __forceinline__ void take_better(int& votes, int& bin, int v,
                                            int b) {
  if (v > votes || (v == votes && b < bin)) {
    votes = v;
    bin = b;
  }
}

// One slot per lane: a valid diagonal's bin goes to the next free place
// of the warp's compacted bins (lanes in order), h counts them.
__device__ __forceinline__ void compact(int d, int vote_bin, int* bins,
                                        int& h, unsigned below) {
  const bool valid = d != INVALID_LOC;
  const unsigned vb = __ballot_sync(ALL, valid);
  if (valid) bins[h + __popc(vb & below)] = floor_div(d, vote_bin);
  h += __popc(vb);
}

// One warp per read.  VEC: M % 4 == 0 and the rows 16-byte aligned.
// `slice`: ints of shared memory a warp holds (M rounded up to 4).
template <bool VEC>
__global__ void __launch_bounds__(32 * MAX_WARPS) location_vote_kernel(
    const int* __restrict__ diag, int B, int M, int slice, int vote_bin,
    int* __restrict__ win_bin, int* __restrict__ votes_out) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long read =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (read >= B) return;                   // the whole warp leaves
  int* bins = reinterpret_cast<int*>(smem) + warp * slice;
  const int* row = diag + read * M;
  const unsigned below = (1u << lane) - 1u;

  int h = 0;
  if constexpr (VEC) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    const int n_vec = M >> 2;
    for (int v0 = 0; v0 < n_vec; v0 += 32) {
      const int v = v0 + lane;
      const int4 x = v < n_vec ? __ldg(row4 + v)
                               : make_int4(INVALID_LOC, INVALID_LOC,
                                           INVALID_LOC, INVALID_LOC);
      compact(x.x, vote_bin, bins, h, below);
      compact(x.y, vote_bin, bins, h, below);
      compact(x.z, vote_bin, bins, h, below);
      compact(x.w, vote_bin, bins, h, below);
    }
  } else {
    for (int s0 = 0; s0 < M; s0 += 32) {
      const int s = s0 + lane;
      compact(s < M ? __ldg(row + s) : INVALID_LOC, vote_bin, bins, h,
              below);
    }
  }
  // pad the bins to a multiple of 4 with INVALID_LOC, which no bin equals
  const int h4 = (h + 3) & ~3;
  if (h + lane < h4) bins[h + lane] = INVALID_LOC;
  __syncwarp();

  int votes = 0, bin = INVALID_LOC;
  const int4* bins4 = reinterpret_cast<const int4*>(bins);
  for (int s = lane; s < h; s += 32) {
    const int b = bins[s];
    int c = 0;
    for (int j = 0; j < h4 >> 2; ++j) {
      const int4 q = bins4[j];
      c += (q.x == b) + (q.y == b) + (q.z == b) + (q.w == b);
    }
    take_better(votes, bin, c, b);
  }
  for (int s = 16; s > 0; s >>= 1) {
    const int v = __shfl_down_sync(ALL, votes, s);
    const int b = __shfl_down_sync(ALL, bin, s);
    take_better(votes, bin, v, b);
  }
  if (lane == 0) {
    win_bin[read] = votes > 0 ? bin : 0;
    votes_out[read] = votes;
  }
}

}  // namespace

// diag: (B, M) int32, M <= 12,288; win_bin, votes: (B,) int32; warps:
// reads a block, checked by the wrapper (kernels/location_vote/ops.py::
// vote_warps) against 1,024 threads and 48 KB of slices of round_up(M, 4)
// ints; <= 0 for the default, 8 or fewer where their slices pass 48 KB
// (one read a block at M = 12,288).
extern "C" int location_vote_launch(const void* diag, int B, int M,
                                    int vote_bin, void* win_bin, void* votes,
                                    int warps, void* stream) {
  if (B == 0) return 0;
  const int slice = (M + 3) & ~3;
  if (warps <= 0)
    warps = std::max(1, std::min(DEFAULT_WARPS,
                                 MAX_SHARED / (4 * std::max(slice, 4))));
  const unsigned blocks = static_cast<unsigned>((B + warps - 1) / warps);
  const size_t smem = static_cast<size_t>(warps) * slice * sizeof(int);
  const bool vec =
      M % 4 == 0 && (reinterpret_cast<uintptr_t>(diag) & 15) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const int*>(diag);
  auto wb = static_cast<int*>(win_bin);
  auto vo = static_cast<int*>(votes);
  if (vec)
    location_vote_kernel<true><<<blocks, 32 * warps, smem, s>>>(
        d, B, M, slice, vote_bin, wb, vo);
  else
    location_vote_kernel<false><<<blocks, 32 * warps, smem, s>>>(
        d, B, M, slice, vote_bin, wb, vo);
  return repro::launch_status();
}
