// seed_buckets: Partitioned Seeding (§4.3) of both mates of a batch.
//
// Replaces the TPU kernel repro/kernels/pair_frontend/kernel.py ::
// seed_buckets_pallas (its hashing unit is xxhash/kernel.py ::
// xxhash32_lanes, here xxhash.cuh, which xxhash.cu shares).  For each read
// and each of its S seeds it 2-bit packs seed_len <= 64 bases at a fixed
// offset into four 32-bit words (zero padded, words are sums of shifted
// codes as in pack_2bit), hashes them with xxHash32 and writes the SeedMap
// bucket id hash & (T-1).
//
// Bound on the H100: the reads' bytes (2*B*R) and the ids (2*B*S*4) at
// the HBM rate; the arithmetic (~2 ops per base plus ~40 for the hash) is
// well below it.  Design: a block owns a tile of up to TILE_ROWS
// consecutive rows of one mate, which are contiguous bytes; it stages
// them in shared memory with 16-byte loads, lanes on neighbouring
// addresses (the tile's start aligned down, the head skipped; the first
// and last vectors load only the tile's own bytes, one at a time).  Each
// (read, seed) of the tile then builds its words from aligned 32-bit
// shared-memory loads, four bases at a time (two loads funnel-shifted
// when the seed starts off a word boundary), and one __dp4a sums the four
// codes * 4^m; the hash runs in registers and the ids are written in
// order, so consecutive threads store neighbouring ints.  Rows longer
// than MAX_TILE bytes are not staged: each seed reads its words straight
// from device memory (same packing; a word holding bytes outside the tile
// is read a byte at a time, so no load leaves the tensor).
#include <algorithm>

#include "xxhash.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TILE_ROWS = 64;            // rows a block owns
constexpr int MAX_TILE = 32 * 1024;      // staged bytes of a tile, at most

// Word k of a staged tile in shared memory.
struct SharedWords {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t operator()(long long k) const {
    return w[k];
  }
};

// Word k of the 4-byte-aligned `w` in device memory, of which only bytes
// [lo, hi) are the tile's: a word reaching past them takes those bytes
// alone (the others read as 0; the packing masks them off).
struct GlobalWords {
  const uint32_t* w;
  long long lo, hi;
  __device__ __forceinline__ uint32_t operator()(long long k) const {
    if (4 * k >= lo && 4 * k + 4 <= hi) return __ldg(w + k);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(w);
    uint32_t x = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = 4 * k + j;
      if (i >= lo && i < hi) x |= static_cast<uint32_t>(b[i]) << (8 * j);
    }
    return x;
  }
};

// The four words of the seed_len <= 64 bases starting at byte p of the
// 4-byte-aligned `words` (SharedWords or GlobalWords): word q is the sum
// over its bases i (16q <= i < 16q + 16) of code << 2*(i & 15), mod 2^32,
// whatever the codes are (pack_2bit sums; a code > 3 carries into the
// next base's bits).  Only the words holding a byte of the seed are read,
// and their bytes outside the seed are shifted or masked off.
template <class Words>
__device__ __forceinline__ void pack_seed(const Words& words, long long p,
                                          int seed_len, uint32_t (&w)[4]) {
  const long long q = p >> 2;
  const int sh = 8 * static_cast<int>(p & 3);
  const int n_words = (static_cast<int>(p & 3) + seed_len + 3) >> 2;
  uint32_t lo = seed_len > 0 ? words(q) : 0u;
  w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
  for (int g = 0; g < 16; ++g) {           // bases 4g .. 4g+3
    if (4 * g < seed_len) {
      const uint32_t hi = g + 1 < n_words ? words(q + g + 1) : 0u;
      uint32_t x = __funnelshift_r(lo, hi, sh);
      lo = hi;
      const int left = seed_len - 4 * g;
      if (left < 4) x &= (1u << (8 * left)) - 1u;
      // code0 + 4 code1 + 16 code2 + 64 code3, at bits 8 (g & 3) of its word
      w[g >> 2] += __dp4a(x, 0x40100401u, 0u) << (8 * (g & 3));
    }
  }
}

// Grid (tiles of one mate, 2 mates); `rows` rows a block.  STAGED: the
// tile goes through shared memory (rows * R <= MAX_TILE).
template <bool STAGED>
__global__ void __launch_bounds__(THREADS) seed_buckets_kernel(
    const uint8_t* __restrict__ reads1, const uint8_t* __restrict__ reads2,
    int B, int R, int rows, repro::SeedOffsets offs, int S, int seed_len,
    uint32_t hash_seed, uint32_t mask, int* __restrict__ out) {
  extern __shared__ uint4 tile[];
  __shared__ int s_offs[repro::MAX_SEEDS];
  // one thread copies the offsets, each from its own parameter slot (an
  // index into `offs` that varies by thread copies it to the stack)
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < repro::MAX_SEEDS; ++k) s_offs[k] = offs.v[k];
  }
  const int mate = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int n_rows = static_cast<int>(min(static_cast<long long>(rows),
                                          B - row0));
  const uint8_t* first = (mate ? reads2 : reads1) + row0 * R;
  const uintptr_t a = reinterpret_cast<uintptr_t>(first);
  int head;                      // byte of the words where the tile starts
  if constexpr (STAGED) {
    const uint4* g = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
    head = static_cast<int>(a & 15);
    const int end = head + n_rows * R, n_vec = (end + 15) >> 4;
    for (int v = threadIdx.x; v < n_vec; v += THREADS) {
      if (16 * v >= head && 16 * v + 16 <= end) {
        tile[v] = g[v];
      } else {                      // the head or tail vector
        const uint8_t* gb = reinterpret_cast<const uint8_t*>(g);
        uint8_t* tb = reinterpret_cast<uint8_t*>(tile + v);
        for (int j = 0; j < 16; ++j) {
          const int i = 16 * v + j;
          tb[j] = i >= head && i < end ? gb[i] : uint8_t{0};
        }
      }
    }
  } else {
    head = static_cast<int>(a & 3);
  }
  __syncthreads();
  int* o = out + (mate * static_cast<long long>(B) + row0) * S;
  const int n = n_rows * S;
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const int r = t / S, s = t - r * S;
    const long long p = head + static_cast<long long>(r) * R + s_offs[s];
    uint32_t w[4];
    if constexpr (STAGED) {
      pack_seed(SharedWords{reinterpret_cast<const uint32_t*>(tile)}, p,
                seed_len, w);
    } else {
      pack_seed(GlobalWords{reinterpret_cast<const uint32_t*>(
                                a & ~uintptr_t{3}),
                            head, head + static_cast<long long>(n_rows) * R},
                p, seed_len, w);
    }
    o[t] = static_cast<int>(
        repro::xxhash32_16(w[0], w[1], w[2], w[3], hash_seed) & mask);
  }
}

}  // namespace

// reads1, reads2: (B, R) uint8; offs_host: S host ints; out: (2B, S) int32.
extern "C" int seed_buckets_launch(const void* reads1, const void* reads2,
                                   int B, int R, const void* offs_host, int S,
                                   int seed_len, unsigned hash_seed,
                                   unsigned mask, void* out, void* stream) {
  if (B == 0 || S == 0) return 0;
  const bool staged = R > 0 && R <= MAX_TILE;
  // a block's rows: TILE_ROWS, fewer where they pass MAX_TILE bytes
  const int rows = staged ? std::min(TILE_ROWS, MAX_TILE / R) : TILE_ROWS;
  // the staged vectors: a head of up to 15 bytes, then the rows' bytes
  const size_t smem =
      staged ? (static_cast<size_t>(rows) * R + 30) & ~size_t{15} : 0;
  const dim3 grid(static_cast<unsigned>((B + rows - 1) / rows), 2);
  const auto offs =
      repro::seed_offsets(static_cast<const int*>(offs_host), S);
  auto s = static_cast<cudaStream_t>(stream);
  auto r1 = static_cast<const uint8_t*>(reads1);
  auto r2 = static_cast<const uint8_t*>(reads2);
  if (staged)
    seed_buckets_kernel<true><<<grid, THREADS, smem, s>>>(
        r1, r2, B, R, rows, offs, S, seed_len, hash_seed, mask,
        static_cast<int*>(out));
  else
    seed_buckets_kernel<false><<<grid, THREADS, 0, s>>>(
        r1, r2, B, R, rows, offs, S, seed_len, hash_seed, mask,
        static_cast<int*>(out));
  return repro::launch_status();
}
