// flash_attention: softmax attention forward of the LM serving path's
// prefill, out[bh, i] = softmax_j(q[bh, i] . k[kv, j] * scale) v[kv, j]
// over keys j <= i (causal) or all keys, kv = bh / G (grouped-query
// attention: G query heads share one K/V head, as the JAX model's
// jnp.repeat(k, G, axis=2) makes them share).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py ::
// flash_attention_pallas.  Its sequential third grid axis (kv blocks, the
// online-softmax state carried in VMEM scratch) becomes a loop inside one
// block per (bh, 64-row query tile); the state (running max m, sum l and
// the output accumulator) stays in registers.  As the TPU kernel: scores
// in float32, the finite mask value -1e30, m starting at -1e30 and l at 0,
// l == 0 read as 1 on the output.  Key tiles above the diagonal are
// skipped: for a row that has seen key 0 they add exactly nothing
// (p = exp(-1e30 - m) = 0 and the rescale factor is 1).
//
// Bound on the H100 (yi-6b prefill: BH 256, S 2048, D 128, bf16, causal):
// 4 BH D S(S+1)/2 = 2.75e11 flops of matrix products, 0.28 ms at 989
// TFLOP/s, against ~0.09 ms for the bytes (q, o and the 8x smaller GQA
// k, v), so the tensor cores bound it.  Design:
//   - bf16 inputs: mma.sync m16n8k16 (bf16 in, float32 accumulate) on 4
//     warps of 16 query rows each.  Q . K^T of bf16 values is exact in
//     float32 products, so the scores are the float32 scores up to the
//     order of the sum.  P stays float32 in effect: each p is split into
//     bf16 hi + lo parts (p - hi rounded again) and P V takes two
//     products, so P loses ~2^-17 of its value rather than bf16's 2^-9.
//     The K tile and the V tile (64 keys) are copied to shared memory in
//     16-byte vectors, rows padded by 16 bytes so that the fragment loads
//     (32-bit for K, ldmatrix.trans for V) hit 32 distinct banks.
//   - float32 inputs: CUDA-core FMAs (a tensor-core product would round
//     the inputs), a quad of threads per query row, each holding a
//     quarter of q and of the accumulator, over 32-key tiles in shared
//     memory.  Off the serving path; it holds the algorithm to float32.
// Not yet: wgmma, TMA, a pipelined tile ring or warp specialisation.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---- bf16: tensor cores ----------------------------------------------------
constexpr int BQ = 64;            // query rows per block, 16 per warp
constexpr int BK = 64;            // keys per tile
constexpr int MMA_THREADS = BQ / 16 * 32;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 bf16 matrices: rows k0..k0+15 of a row-major tile,
// 8 columns from `p`'s column; lanes 0-15 name the rows.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int BH, int S, int G,
                 float scale, int causal) {
  constexpr int KC = D / 16;   // k16 chunks of a head
  constexpr int DT = D / 8;    // n8 tiles of a head
  constexpr int NT = BK / 8;   // n8 tiles of a key tile
  constexpr int RS = D + 8;    // padded shared row (bf16 elements)
  constexpr int VEC = D / 8;   // 16-byte vectors per row
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * RS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK * RS];

  // blocks in order of falling row count: the longest causal tiles first
  const int n_q = S / BQ;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / BH);
  const long long bh = blockIdx.x % BH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + bh * S * D;
  const __nv_bfloat16* kb = k + (bh / G) * S * D;
  const __nv_bfloat16* vb = v + (bh / G) * S * D;
  const int r0 = qt * BQ + warp * 16 + g;   // this lane's rows: r0, r0 + 8

  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = ld32(qb + static_cast<long long>(r0) * D + c);
    qf[kc][1] = ld32(qb + static_cast<long long>(r0 + 8) * D + c);
    qf[kc][2] = ld32(qb + static_cast<long long>(r0) * D + c + 8);
    qf[kc][3] = ld32(qb + static_cast<long long>(r0 + 8) * D + c + 8);
  }
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};   // this lane's share of each row's sum

  const int n_kv = causal ? qt + 1 : S / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    __syncthreads();   // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * VEC; i += MMA_THREADS) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const long long src = static_cast<long long>(kt * BK + r) * D + c;
      *reinterpret_cast<uint4*>(&Ks[r * RS + c]) =
          *reinterpret_cast<const uint4*>(kb + src);
      *reinterpret_cast<uint4*>(&Vs[r * RS + c]) =
          *reinterpret_cast<const uint4*>(vb + src);
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* kr = &Ks[(nt * 8 + g) * RS + kc * 16 + 2 * t];
        mma_bf16(s[nt], qf[kc], ld32(kr), ld32(kr + 8));
      }
    }
    const bool diag = causal && kt == qt;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (diag && kt * BK + nt * 8 + 2 * t + (e & 1) > r0 + (e >> 1) * 8)
          x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float alpha = expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * h] *= alpha;
        o[dt][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      // the A fragment of keys 16j..16j+15 is the C fragments of score
      // tiles 2j (columns 2t, 2t+1) and 2j+1 (columns 2t+8, 2t+9)
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[u][e] = expf(s[2 * j + u][e] - m[e >> 1]);
          l[e >> 1] += p[u][e];
        }
      }
      uint32_t ph[4], pl[4];
      split_bf16(p[0][0], p[0][1], ph[0], pl[0]);
      split_bf16(p[0][2], p[0][3], ph[1], pl[1]);
      split_bf16(p[1][0], p[1][1], ph[2], pl[2]);
      split_bf16(p[1][2], p[1][3], ph[3], pl[3]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &Vs[(j * 16 + (lane & 15)) * RS + dt * 8]);
        mma_bf16(o[dt], ph, b0, b1);
        mma_bf16(o[dt], pl, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (l[h] == 0.f) l[h] = 1.f;
  }
  __nv_bfloat16* ob = out + bh * S * D;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(r0) * D +
                                       c) =
        __floats2bfloat162_rn(o[dt][0] / l[0], o[dt][1] / l[0]);
    *reinterpret_cast<__nv_bfloat162*>(
        ob + static_cast<long long>(r0 + 8) * D + c) =
        __floats2bfloat162_rn(o[dt][2] / l[1], o[dt][3] / l[1]);
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int G, int S, float scale, int causal, int bf16,
           cudaStream_t stream) {
  if (bf16) {
    const unsigned blocks = static_cast<unsigned>(S / BQ) * BH;
    flash_mma_kernel<D><<<blocks, MMA_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), BH, S, G, scale, causal);
  } else {
    const unsigned blocks = static_cast<unsigned>(S / FQ) * BH;
    flash_fma_kernel<D><<<blocks, FMA_THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), BH, S, G,
        scale, causal);
  }
  return repro::launch_status();
}

}  // namespace

// q, out: (BH, S, D); k, v: (BH / G, S, D), all contiguous, of one dtype:
// bf16 (dtype 1) or float32 (dtype 0).  S a multiple of 64 (the wrapper
// pads to 128), D one of 64, 80, 128.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int G,
                                      int S, int D, float scale, int causal,
                                      int dtype, void* stream) {
  if (BH == 0 || S == 0) return 0;
  if (S % BQ || S % FQ || G < 1 || BH % G || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, BH, G, S, scale, causal, dtype, s);
    case 80:
      return launch<80>(q, k, v, out, BH, G, S, scale, causal, dtype, s);
    case 128:
      return launch<128>(q, k, v, out, BH, G, S, scale, causal, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
