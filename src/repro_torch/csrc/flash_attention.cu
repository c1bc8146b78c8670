// flash_attention: softmax attention forward of the LM serving path's
// prefill, out[bh, i] = softmax_j(q[bh, i] . k[kv, j] * scale) v[kv, j]
// over keys j <= i (causal) or all keys, kv = bh / G (grouped-query
// attention: G query heads share one K/V head, as the JAX model's
// jnp.repeat(k, G, axis=2) makes them share).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py ::
// flash_attention_pallas.  Its sequential third grid axis (kv blocks, the
// online-softmax state carried in VMEM scratch) becomes a loop inside one
// block per (bh, 128-row query tile); the state (running max m, sum l and
// the output accumulator) stays in registers.  As the TPU kernel: scores
// in float32, the finite mask value -1e30, m starting at -1e30 and l at 0,
// l == 0 read as 1 on the output.  Key tiles above the diagonal are
// skipped: for a row that has seen key 0 they add exactly nothing
// (p = exp(-1e30 - m) = 0 and the rescale factor is 1).  Blocks run
// longest-first over the causal triangle (the query tile counts down).
//
// Bound on the H100 (yi-6b prefill: BH 256, S 2048, D 128, bf16, causal):
// 4 BH D S(S+1)/2 = 2.75e11 flops of matrix products, 0.28 ms at 989
// TFLOP/s, against ~0.09 ms for the bytes (q, o and the 8x smaller GQA
// k, v), so the tensor cores bound it.  Design:
//   - bf16 inputs, D 64 or 128 (the wrapper zero-pads D 80 to 128, which
//     adds exact zeros to each score): Hopper's warpgroup products.  A
//     block of 384 threads: two consumer warpgroups of 64 query rows each
//     and a producer warpgroup, which gives its registers up to them
//     (setmaxnreg 24 / 240).  One producer thread loads the Q tile once
//     and K/V tiles of 128 keys into a 2-stage ring in shared memory by
//     TMA (cp.async.bulk.tensor, 128-byte swizzle, 64-column boxes), each
//     stage with a "full" mbarrier (the copy's bytes) and an "empty" one
//     (the 256 consumer threads' release).  A consumer warpgroup computes
//     S = Q K^T by wgmma m64n128k16 with Q and K from shared memory
//     (K-major), the online softmax in registers (exp2 of log2-scaled
//     scores), and O += P V by wgmma m64nDk16 with P as the register A
//     operand (the S accumulator's layout is the A fragment's, so P needs
//     no shuffle) and V from shared memory through the descriptor's
//     transpose (MN-major).  P stays float32 in effect: each p is split
//     into a bf16 hi part and the bf16 rounding of p - hi, and P V takes
//     two products, so P loses ~2^-17 of its value rather than bf16's
//     2^-9 (a bf16 P alone, one product, ran 0.70 ms against 0.89 at the
//     prefill's shapes on an H100, but carried a 2-layer yi-6b prefill
//     1.0e-2 from the plain one, past that check's limit).  Q . K^T of
//     bf16 values is exact in float32 products.
//   - float32 inputs: CUDA-core FMAs (a tensor-core product would round
//     the inputs), a quad of threads per query row, each holding a
//     quarter of q and of the accumulator, over 32-key tiles in shared
//     memory.  Off the serving path; it holds the algorithm to float32.
// Not yet: a persistent grid, or a TMA store of O.  Ping-pong of the two
// consumer warpgroups, the next tile's Q K^T issued behind P V, and a
// third K/V stage were each tried on an H100 and were not faster.
#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---- bf16: wgmma + TMA ------------------------------------------------------
constexpr int TQ = 128;                  // query rows per block
constexpr int TK = 128;                  // keys per K/V tile
constexpr int STAGES = 2;                // K/V tiles in flight
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int WG_THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int SUB = 64;                  // columns of a 128-byte sub-tile
constexpr int ROW_BYTES = SUB * 2;

// bytes of a 128-row tile: D / 64 sub-tiles
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return D / SUB * 128 * ROW_BYTES;
}

// shared memory of a block: Q, the K/V ring, 5 barriers, alignment slack
template <int D>
__host__ __device__ constexpr int wgmma_smem() {
  return tile_bytes<D>() * (1 + 2 * STAGES) + 8 * (1 + 2 * STAGES) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-column x 128-row box of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle.  K-major (Q, K):
// SBO 1024 bytes between 8-row groups, LBO unused.  MN-major (V): LBO the
// bytes between 64-column sub-tiles, SBO 1024 between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous product writes (or reads) stay where they are
// across this point: nothing reads them before the wait, nothing reuses
// them before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S[64 x 128] (+)= A . B^T, A and B from shared memory, K-major (SW128)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 128] += A . B, A (bf16 pairs) from registers, B from shared
// memory MN-major (SW128, transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += A . B, A (bf16 pairs) from registers, B from shared
// memory MN-major (SW128, transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n64(o, a, db);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 hi parts and the bf16 rounding of what they miss
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int BH, int S, int G,
                   float scale_log2, int causal) {
  constexpr int TILE = tile_bytes<D>();
  constexpr int SUB_BYTES = 128 * ROW_BYTES;   // one 64-column sub-tile
  constexpr int KSTEPS = D / 16;               // k16 steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + TILE;               // stage s at + s * TILE
  const uint32_t sv = sk + STAGES * TILE;
  const uint32_t qbar = sv + STAGES * TILE;
  const uint32_t full = qbar + 8;              // stage s at + 8 s
  const uint32_t empty = full + 8 * STAGES;

  // blocks in order of falling row count: the longest causal tiles first
  const int qt = S / TQ - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int n_kv = causal ? qt + 1 : S / TK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // the producer; one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      const int kv_row = (bh / G) * S;
      mbar_expect_tx(qbar, TILE);
      for (int h = 0; h < D / SUB; ++h)
        tma_load(sq + h * SUB_BYTES, &tq, h * SUB, bh * S + qt * TQ, qbar);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)   // the consumers released this stage's last tile
          mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        for (int h = 0; h < D / SUB; ++h) {
          tma_load(sk + s * TILE + h * SUB_BYTES, &tk, h * SUB,
                   kv_row + kt * TK, full + 8 * s);
          tma_load(sv + s * TILE + h * SUB_BYTES, &tv, h * SUB,
                   kv_row + kt * TK, full + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of the block's tile: r0 and r0 + 8
  const int r0 = wg * 64 + (threadIdx.x & 127) / 32 * 16 + g;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};   // this thread's share of each row's sum
  float sc[64];
  uint32_t ph[TK / 16][4], pl[TK / 16][4];   // P's bf16 hi and lo parts

  mbar_wait(qbar, 0);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);

    // S = Q K^T: element sc[4j + e] is row r0 + 8 (e >> 1), key
    // 8j + 2t + (e & 1) of the tile
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = kk / 4 * SUB_BYTES + kk % 4 * 32;
      wgmma_ss_n128(sc, sw128_desc(sq + wg * 64 * ROW_BYTES + off, 16),
                    sw128_desc(sk + s * TILE + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    pin(sc);

    const bool diag = causal && kt == qt;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (diag && 8 * j + 2 * t + (e & 1) > r0 + (e >> 1) * 8) x = NEG_INF;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float alpha = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }
    // the A fragment of keys 16kk..16kk+15 is the accumulator fragments of
    // score tiles 2kk (keys 2t, 2t+1) and 2kk+1 (keys 2t+8, 2t+9)
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = exp2f(sc[8 * kk + e] - m[(e >> 1) & 1]);
        l[(e >> 1) & 1] += p[e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        split_bf16(p[2 * u], p[2 * u + 1], ph[kk][u], pl[kk][u]);
    }

    // O += P V, once for each part of P: keys 16kk.. of the V tile start
    // 16kk rows into each sub-tile; the next 64 columns lie one sub-tile
    // further
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint64_t dv =
          sw128_desc(sv + s * TILE + kk * 16 * ROW_BYTES, SUB_BYTES);
      wgmma_pv<D>(o, ph[kk], dv);
      wgmma_pv<D>(o, pl[kk], dv);
    }
    wgmma_commit();
    wgmma_wait();
    pin(o);
    pin(ph);
    pin(pl);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (l[h] == 0.f) l[h] = 1.f;
  }
  __nv_bfloat16* ob = out + (static_cast<long long>(bh) * S + qt * TQ + r0) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(ob + c) =
        __floats2bfloat162_rn(o[4 * j] / l[0], o[4 * j + 1] / l[0]);
    *reinterpret_cast<__nv_bfloat162*>(ob + 8 * D + c) =
        __floats2bfloat162_rn(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
  }
}

// ---- float32: CUDA cores ---------------------------------------------------
constexpr int FQ = 64;             // query rows per block, a quad each
constexpr int FK = 32;             // keys per tile
constexpr int FMA_THREADS = FQ * 4;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int BH,
                 int S, int G, float scale, int causal) {
  constexpr int V4 = D / 4;        // float4 vectors per row
  constexpr int VPT = D / 16;      // of them per thread: sub + 4 i
  __shared__ __align__(16) float4 Ks[FK * V4];
  __shared__ __align__(16) float4 Vs[FK * V4];

  const int n_q = S / FQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / BH);
  const long long bh = blockIdx.x % BH;
  const int row = qt * FQ + threadIdx.x / 4, sub = threadIdx.x & 3;
  const float4* q4 = reinterpret_cast<const float4*>(q + (bh * S + row) * D);
  const float4* k4 = reinterpret_cast<const float4*>(k + (bh / G) * S * D);
  const float4* v4 = reinterpret_cast<const float4*>(v + (bh / G) * S * D);

  float4 qv[VPT], acc[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    qv[i] = q4[sub + 4 * i];
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;
  const int n_kv = causal ? (qt * FQ + FQ - 1) / FK + 1 : S / FK;
  for (int kt = 0; kt < n_kv; ++kt) {
    __syncthreads();
    for (int i = threadIdx.x; i < FK * V4; i += FMA_THREADS) {
      Ks[i] = k4[static_cast<long long>(kt) * FK * V4 + i];
      Vs[i] = v4[static_cast<long long>(kt) * FK * V4 + i];
    }
    __syncthreads();
    float s[FK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VPT; ++i) d = dot4(qv[i], Ks[j * V4 + sub + 4 * i], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      float x = d * scale;
      if (causal && kt * FK + j > row) x = NEG_INF;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < FK; ++j) {
      const float p = expf(s[j] - m);
      l += p;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const float4 w = Vs[j * V4 + sub + 4 * i];
        acc[i].x = fmaf(p, w.x, acc[i].x);
        acc[i].y = fmaf(p, w.y, acc[i].y);
        acc[i].z = fmaf(p, w.z, acc[i].z);
        acc[i].w = fmaf(p, w.w, acc[i].w);
      }
    }
  }
  if (l == 0.f) l = 1.f;
  float4* o4 = reinterpret_cast<float4*>(out + (bh * S + row) * D);
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    o4[sub + 4 * i] = make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l,
                                  acc[i].w / l);
}

// ---- host side -------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, found through the runtime so that the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, D) row-major bf16 tensor read in 64-column x 128-row boxes, each
// landing in shared memory with the 128-byte swizzle.
bool tile_map(CUtensorMap* map, const void* ptr, long long rows, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {SUB, 128};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int BH, int G, int S, float scale, int causal,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const long long kv_rows = static_cast<long long>(BH / G) * S;
  if (!tile_map(&tq, q, static_cast<long long>(BH) * S, D) ||
      !tile_map(&tk, k, kv_rows, D) || !tile_map(&tv, v, kv_rows, D))
    return static_cast<int>(cudaErrorNotSupported);
  constexpr int smem = wgmma_smem<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(S / TQ) * BH;
  flash_wgmma_kernel<D><<<blocks, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), BH, S, G, scale * LOG2E,
      causal);
  return repro::launch_status();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, int BH,
               int G, int S, float scale, int causal, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(S / FQ) * BH;
  flash_fma_kernel<D><<<blocks, FMA_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), BH, S, G, scale,
      causal);
  return repro::launch_status();
}

}  // namespace

// q, out: (BH, S, D); k, v: (BH / G, S, D), all contiguous, of one dtype:
// bf16 (dtype 1; S a multiple of 128, D 64 or 128, 16-byte aligned) or
// float32 (dtype 0; S a multiple of 64, D 64, 80 or 128).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int G,
                                      int S, int D, float scale, int causal,
                                      int dtype, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (G < 1 || BH % G || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (S % TQ) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 64:
        return launch_wgmma<64>(q, k, v, out, BH, G, S, scale, causal, s);
      case 128:
        return launch_wgmma<128>(q, k, v, out, BH, G, S, scale, causal, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (S % FQ) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch_fma<64>(q, k, v, out, BH, G, S, scale, causal, s);
    case 80:
      return launch_fma<80>(q, k, v, out, BH, G, S, scale, causal, s);
    case 128:
      return launch_fma<128>(q, k, v, out, BH, G, S, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
