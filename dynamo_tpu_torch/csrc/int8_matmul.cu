// Int8-weight x bf16-activation matmul (W8A16) for Hopper (sm_90a), plain C interface.
//
// Computes the weight-only int8 matmul of dynamo_tpu/models/llama.py (matw :255,
// the int8 branch of lm_head :456), which has no Pallas kernel: on the TPU, XLA
// fuses the int8 -> bf16 convert into the dot's operand load. This kernel is
// the port's counterpart of that fusion.
//
//   y[m, n]   = round_to_x_dtype(sum_k x[m, k] * q[n, k])   fp32 accumulation
//   out[m, n] = round_to_out_dtype(float(y[m, n]) * s[n])
//
// x is [M, K] (bf16 on the main path; fp32 for the tests), q is [N, K] int8
// with K contiguous, s is [N] fp32 and out is [M, N] in bf16 (matw) or fp32
// (lm_head). int8 -> bf16 is exact (|q| <= 127), so the only roundings are the
// two above, as in the JAX code.
//
// What bounds it on the card: bytes. At decode M is the number of lanes (8 in
// the slice, 1 for a lone user): 2·M operations per weight byte against the
// H100's ~295, so the least time is N·K weight bytes (plus x, s and out) over
// the HBM rate. The design keeps enough weight bytes in flight and does as
// little per byte as it can:
//
// - Tensor cores with A and B swapped. mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate) takes 16 weight rows as its M side and 8 lanes of x as its N
//   side, so at M = 8 nothing is padded. Larger M loops over lane tiles of 8
//   (MT tiles held at once, the grid's y covering the rest) and the weight
//   fragment is reused across them.
// - A k-permutation that lets every thread load 16 contiguous bytes. Within a
//   64-wide chunk of K, thread t of a quad owns bytes [16t, 16t+16) of its two
//   rows (g and g+8). In mma step j it feeds bytes 16t+4j..+3 into the k slots
//   {2t, 2t+1, 2t+8, 2t+9} that the fragment layout gives it, and reads x at
//   the same four k; a sum over k does not care about the order, and A and B
//   use the same map. One 16-byte load per row per chunk, no shared memory,
//   no shuffles.
// - The block is 8 warps over one 16-row tile: each warp takes an eighth of
//   the 64-wide chunks of K and the partial sums meet in shared memory (in a
//   fixed order). Each thread issues the loads of U chunks before it converts
//   and multiplies any of them, so 8·U·1 KB of weights are in flight per
//   block. Weights stream with ld.global.nc.L1::no_allocate (read once); x is
//   read through the read-only cache (every block reads it).
// - int8 -> bf16 without a conversion instruction: a biased byte u = q + 128
//   placed under the exponent of 2^23 (prmt) is the float 2^23 + u; one fp32
//   subtract gives q exactly, and the top halves of two such floats (prmt
//   again) are the packed bf16 pair.
// - fp32 x (the tests) has no exact tensor-core path (TF32 keeps ~3 digits),
//   so it runs a CUDA-core kernel: one warp per weight row, 16-byte loads.
//
// Unsupported shapes are refused: N must be a multiple of 16 and K of 64
// (every llama-family width in the presets is a multiple of 128), and the
// pointers 16-byte aligned; the wrapper checks and raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // warps per block, splitting K
constexpr int kRows = 16;    // weight rows per block: the mma's M side
constexpr int kChunk = 64;   // K per chunk: 16 bytes per thread per row
constexpr int kLanes = 8;    // x rows per lane tile: the mma's N side

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// four int8 (bytes 0..3 of w) -> bf16 pairs lo = (b0, b1), hi = (b2, b3),
// exactly: 2^23 + (b + 128) as a float, minus 2^23 + 128
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
  // small integers: the low 16 bits of each float are zero, its top half is its bf16
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// c += a · b over one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// U chunks of K starting at chunk c: loads of all U first, then the mma steps
template <int MT, int U>
__device__ __forceinline__ void w8a16_chunks(const int8_t* qa, const int8_t* qb,
                                             const __nv_bfloat16* (&xr)[MT], int c,
                                             float (&acc)[MT][4]) {
  uint4 wa[U], wb[U], xv[U][MT][2];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    wa[u] = ld_stream(qa + (c + u) * kChunk);
    wb[u] = ld_stream(qb + (c + u) * kChunk);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (xr[i] != nullptr) {
        const uint4* p = reinterpret_cast<const uint4*>(xr[i] + (c + u) * kChunk);
        xv[u][i][0] = __ldg(p);
        xv[u][i][1] = __ldg(p + 1);
      } else {
        xv[u][i][0] = make_uint4(0, 0, 0, 0);
        xv[u][i][1] = make_uint4(0, 0, 0, 0);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // A: rows g (a0, a2) and g + 8 (a1, a3), k slots {2t, 2t+1} and {2t+8, 2t+9}
      uint32_t a[4];
      i8x4_to_bf16x4(word(wa[u], j), a[0], a[2]);
      i8x4_to_bf16x4(word(wb[u], j), a[1], a[3]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // B: x at the same four k, two bf16 per 32-bit word
        const uint4& h = xv[u][i][j >> 1];
        const int w = (j & 1) * 2;
        mma_bf16(acc[i], a, word(h, w), word(h, w + 1));
      }
    }
  }
}

// grid (N / 16, ceil(M / (8·MT))), 8 warps
template <int MT, int U, typename TO>
__global__ void __launch_bounds__(kWarps * 32)
    w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, TO* __restrict__ out, int M, int N, int K) {
  __shared__ float red[kWarps][MT * kLanes][kRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kRows;
  const int m0 = blockIdx.y * (MT * kLanes);
  const int chunks = K / kChunk;
  const int c_begin = warp * chunks / kWarps, c_end = (warp + 1) * chunks / kWarps;
  const int8_t* qa = q + (size_t)(n0 + g) * K + 16 * t;
  const int8_t* qb = qa + (size_t)8 * K;
  const __nv_bfloat16* xr[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = m0 + i * kLanes + g;
    xr[i] = m < M ? x + (size_t)m * K + 16 * t : nullptr;
  }
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  int c = c_begin;
  for (; c + U <= c_end; c += U) w8a16_chunks<MT, U>(qa, qb, xr, c, acc);
  for (; c < c_end; ++c) w8a16_chunks<MT, 1>(qa, qb, xr, c, acc);
  // C fragment: rows (weight n) g and g + 8, columns (lane m) 2t and 2t + 1
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    red[warp][i * kLanes + 2 * t][g] = acc[i][0];
    red[warp][i * kLanes + 2 * t + 1][g] = acc[i][1];
    red[warp][i * kLanes + 2 * t][g + 8] = acc[i][2];
    red[warp][i * kLanes + 2 * t + 1][g + 8] = acc[i][3];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < MT * kLanes * kRows; e += kWarps * 32) {
    const int m = e / kRows, n = e % kRows;
    if (m0 + m >= M) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) y += red[w][m][n];
    y = __bfloat162float(__float2bfloat16_rn(y));  // round to x's dtype
    out[(size_t)(m0 + m) * N + n0 + n] = from_f<TO>(y * s[n0 + n]);
  }
}

// fp32 x: one warp per weight row, each lane 16 k at a time, 8 lanes of x per
// block row; grid (N / 8, ceil(M / 8))
template <typename TO>
__global__ void __launch_bounds__(kWarps * 32)
    w8f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, TO* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kLanes;
  const int8_t* qr = q + (size_t)n * K;
  float acc[kLanes];
#pragma unroll
  for (int m = 0; m < kLanes; ++m) acc[m] = 0.f;
  for (int k = lane * 16; k < K; k += 32 * 16) {
    const uint4 w = ld_stream(qr + k);
    float wf[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      wf[b] = (float)(int8_t)((word(w, b >> 2) >> (8 * (b & 3))) & 0xff);
    }
#pragma unroll
    for (int m = 0; m < kLanes; ++m) {
      if (m0 + m >= M) continue;
      const float4* xp = reinterpret_cast<const float4*>(x + (size_t)(m0 + m) * K + k);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 xv = __ldg(xp + v);
        acc[m] += xv.x * wf[4 * v] + xv.y * wf[4 * v + 1] + xv.z * wf[4 * v + 2] +
                  xv.w * wf[4 * v + 3];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kLanes; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
  }
  if (lane < kLanes && m0 + lane < M) {
    float y = 0.f;
#pragma unroll
    for (int m = 0; m < kLanes; ++m) y = m == lane ? acc[m] : y;
    out[(size_t)(m0 + lane) * N + n] = from_f<TO>(y * s[n]);
  }
}

template <int MT, typename TO>
cudaError_t launch_bf16(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                        int K, cudaStream_t stream) {
  constexpr int U = 4 / MT;  // U·MT = 4: x registers stay the same for every MT
  dim3 grid(N / kRows, (M + MT * kLanes - 1) / (MT * kLanes));
  w8a16_kernel<MT, U, TO><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), q, s, static_cast<TO*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_out(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                       int K, int x_dtype, cudaStream_t stream) {
  if (x_dtype == 0) {
    dim3 grid(N / kWarps, (M + kLanes - 1) / kLanes);
    w8f32_kernel<TO><<<grid, kWarps * 32, 0, stream>>>(static_cast<const float*>(x), q, s,
                                                       static_cast<TO*>(out), M, N, K);
    return cudaGetLastError();
  }
  if (x_dtype != 1) return cudaErrorInvalidValue;
  if (M <= kLanes) return launch_bf16<1, TO>(x, q, s, out, M, N, K, stream);
  if (M <= 2 * kLanes) return launch_bf16<2, TO>(x, q, s, out, M, N, K, stream);
  return launch_bf16<4, TO>(x, q, s, out, M, N, K, stream);
}

}  // namespace

// x_dtype and out_dtype: 0 = float32, 1 = bfloat16. Returns the launch's error
// (cudaGetLastError() after it), 0 when the kernel launched; M = 0 launches
// nothing and returns 0.
extern "C" int int8_weight_matmul_launch(const void* x, const void* q, const void* s, void* out,
                                         int M, int N, int K, int x_dtype, int out_dtype,
                                         void* stream) {
  if (M == 0) return 0;
  if (M < 0 || N <= 0 || K <= 0 || N % kRows != 0 || K % kChunk != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  cudaError_t err;
  if (out_dtype == 0) {
    err = launch_out<float>(x, qp, sp, out, M, N, K, x_dtype, st);
  } else if (out_dtype == 1) {
    err = launch_out<__nv_bfloat16>(x, qp, sp, out, M, N, K, x_dtype, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
