// seed_gather: NMSL row gather of the SeedMap query (§5.2),
// out[i] = table[ids[i]] over a (T, cap) table of 4-byte elements.
//
// Replaces the TPU kernel repro/kernels/seed_gather/kernel.py ::
// seed_gather_pallas.  An id outside [0, T) is mapped as jnp's table[ids]
// maps it: a negative id is wrapped once (id + T), then every id is
// clamped to [0, T - 1] (in 64 bits, so no id overflows).
//
// Bound on the H100: no arithmetic to speak of; 4 bytes of id plus a
// cap*4-byte row read and written per id, so memory bytes bound it.
// Design: consecutive threads copy consecutive 16-byte vectors of a row
// (4-byte elements when cap*4 or an address is not a multiple of 16), so
// a warp covers one row of 32 vectors or several shorter rows, every load
// and store coalesced within a row; the elements are copied as raw 32-bit
// words whatever their type.
#include "common.cuh"

namespace {

template <class V>
__global__ void seed_gather_kernel(const V* __restrict__ table,
                                   const int* __restrict__ ids, long long n,
                                   long long T, int per_row,
                                   V* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= n * per_row) return;
  const long long i = t / per_row;
  const int v = static_cast<int>(t - i * per_row);
  long long id = ids[i];
  if (id < 0) id += T;
  id = id < 0 ? 0 : (id > T - 1 ? T - 1 : id);
  out[t] = table[id * per_row + v];
}

template <class V>
int launch(const void* table, const void* ids, long long n, long long T,
           int per_row, void* out, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n * per_row + threads - 1) / threads;
  seed_gather_kernel<V><<<static_cast<unsigned>(blocks), threads, 0,
                          stream>>>(
      static_cast<const V*>(table), static_cast<const int*>(ids), n, T,
      per_row, static_cast<V*>(out));
  return repro::launch_status();
}

}  // namespace

// table: (T, cap) 4-byte elements; ids: (n,) int32; out: (n, cap).
// vec: table and out are 16-byte aligned and cap % 4 == 0.
extern "C" int seed_gather_launch(const void* table, long long T, int cap,
                                  const void* ids, long long n, int vec,
                                  void* out, void* stream) {
  if (n == 0 || cap == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<uint4>(table, ids, n, T, cap / 4, out, s)
             : launch<uint32_t>(table, ids, n, T, cap, out, s);
}
