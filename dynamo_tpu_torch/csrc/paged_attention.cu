// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of dynamo_tpu/ops/pallas/paged_attention.py:
// paged_attention_decode_v4 (_decode_kernel_v4), paged_attention_decode_v2
// (_decode_kernel_v2) and paged_attention_decode (v1, _decode_kernel). The
// three compute one function and differ only in how they schedule DMA on a
// TPU, so this one kernel ports all of them.
//
// Function: one query token per lane s attends to the first lengths[s]
// tokens of that lane's paged context. Pages are [N, bs, KVH, D]; the lane's
// block-table row maps logical block j to a physical page. GQA: query head h
// reads kv head h / (H / KVH). q is cast to the cache dtype before QK, p is
// cast to the cache dtype before PV, and everything accumulates in fp32, as
// the TPU kernels do. Outputs: o [S, H, D] in the cache dtype, and the
// softmax stats m (row max, clamped to >= -1e30) and l (denominator), both
// [S, H] fp32. A lane with length 0 gets o = 0, m = -1e30, l = 0.
//
// What bounds it on the card: bytes. Each live K and V row is read once and
// the arithmetic is two small products per key, far below the H100's ~295
// operations per byte, so the least time is the live K+V bytes of all lanes
// over the HBM rate. The design does what it can about that simply: one
// block per (lane, kv head[, group of 8 query heads]) so the G query heads of
// a GQA group share every K/V row they read; the block reads its own table
// row and walks only the lane's live pages (table entries past
// ceil(len / bs) are never read, and no dead slot is ever loaded, so no
// 0 * NaN can reach the value sum); warps split the pages, each lane of a
// warp holds D/32 contiguous dims of a row so a warp reads a 2*D-byte row in
// one coalesced sweep, and four rows are loaded before they are used. The
// warps' partial softmax states merge in shared memory at the end. It has
// no cp.async/TMA pipeline and no split over the context: that is later
// work (see ROADMAP.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 8;   // query heads per block
constexpr int kRows = 4;       // K/V rows in flight per warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round through the cache dtype (the TPU kernels' cast of q and p)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int D>
__global__ void paged_decode_kernel(
    const T* __restrict__ q,            // [S, H, D]
    const T* __restrict__ k_cache,      // [N, bs, KVH, D]
    const T* __restrict__ v_cache,
    const int* __restrict__ tables,     // [S, MB]
    const int* __restrict__ lengths,    // [S]
    T* __restrict__ o,                  // [S, H, D]
    float* __restrict__ m_out,          // [S, H]
    float* __restrict__ l_out,          // [S, H]
    int H, int KVH, int bs, int MB, float scale) {
  constexpr int NW = D >= 256 ? 4 : 8;          // warps per block
  constexpr int DPL = D >= 32 ? D / 32 : 1;     // dims per lane
  const int s = blockIdx.x;
  const int n = blockIdx.y;
  const int G = H / KVH;
  const int g0 = blockIdx.z * kMaxGroup;
  const int gb = min(kMaxGroup, G - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = lengths[s];
  const int head0 = n * G + g0;

  __shared__ float sm_m[NW][kMaxGroup];
  __shared__ float sm_st[NW][kMaxGroup];
  __shared__ float sm_l[NW][kMaxGroup];
  __shared__ float sm_acc[NW][kMaxGroup][D];

  if (len <= 0) {
    for (int i = threadIdx.x; i < gb * D; i += blockDim.x) {
      o[((size_t)s * H + head0 + i / D) * D + i % D] = from_f<T>(0.f);
    }
    for (int g = threadIdx.x; g < gb; g += blockDim.x) {
      m_out[(size_t)s * H + head0 + g] = -1e30f;
      l_out[(size_t)s * H + head0 + g] = 0.f;
    }
    return;
  }

  const bool dim_ok = lane * DPL < D;
  const int d0 = lane * DPL;

  float qr[kMaxGroup][DPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[g][i] = (g < gb && dim_ok)
          ? to_f(q[((size_t)s * H + head0 + g) * D + d0 + i])
          : 0.f;
    }
  }

  // Online softmax in the log2 domain with an integer stabilizer st (the
  // running ceil(max score * log2 e)): every rescale is by an exact power of
  // two, so p rounded to the cache dtype equals p rounded against the final
  // stabilizer, as the plain version rounds it (a kernel and a plain version
  // that round p against different maxima disagree by an ulp of o here and
  // there, and a 32-layer model amplifies that). mx tracks the true max for
  // the m output; l is rescaled to it at the end.
  float mx[kMaxGroup], st[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    mx[g] = -1e30f;
    st[g] = -1e30f;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  const int n_pages = (len + bs - 1) / bs;
  const size_t row_stride = (size_t)KVH * D;  // one token of a page
  for (int p = warp; p < n_pages; p += NW) {
    const int pid = tables[(size_t)s * MB + p];
    const int base = p * bs;
    const int live = min(bs, len - base);
    const T* kp = k_cache + ((size_t)pid * bs * KVH + n) * D + d0;
    const T* vp = v_cache + ((size_t)pid * bs * KVH + n) * D + d0;
    for (int t0 = 0; t0 < live; t0 += kRows) {
      float kv[kRows][DPL];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kv[r][i] = (t0 + r < live && dim_ok) ? to_f(kp[(t0 + r) * row_stride + i]) : 0.f;
        }
      }
      float sc[kRows][kMaxGroup];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g >= gb) break;  // gb is warp-uniform: the shuffles stay converged
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part += qr[g][i] * kv[r][i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
          sc[r][g] = part * scale;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kv[r][i] = (t0 + r < live && dim_ok) ? to_f(vp[(t0 + r) * row_stride + i]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= gb) break;
        float top = -1e30f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (t0 + r < live) top = fmaxf(top, sc[r][g]);
        }
        mx[g] = fmaxf(mx[g], top);
        const float st_new = fmaxf(st[g], ceilf(top * kLog2e));
        const float alpha = exp2f(st[g] - st_new);  // a power of two (or 0)
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (t0 + r < live) {
            const float pr = exp2f(sc[r][g] * kLog2e - st_new);
            l[g] += pr;
            const float pc = round_to<T>(pr);
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[g][i] += pc * kv[r][i];
          }
        }
        st[g] = st_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = mx[g];
      sm_st[warp][g] = st[g];
      sm_l[warp][g] = l[g];
    }
    if (dim_ok) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < gb * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float mt = -1e30f, stt = -1e30f;
    for (int w = 0; w < NW; ++w) {
      mt = fmaxf(mt, sm_m[w][g]);
      stt = fmaxf(stt, sm_st[w][g]);
    }
    float lt = 0.f, num = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float a = exp2f(sm_st[w][g] - stt);
      lt += a * sm_l[w][g];
      num += a * sm_acc[w][g][d];
    }
    const size_t hrow = (size_t)s * H + head0 + g;
    o[hrow * D + d] = from_f<T>(lt > 0.f ? num / lt : 0.f);
    if (d == 0) {
      m_out[hrow] = mt;
      l_out[hrow] = lt > 0.f ? lt * exp2f(stt - mt * kLog2e) : 0.f;
    }
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* tables,
                     const int* lengths, void* o, float* m, float* l, int S, int H,
                     int KVH, int bs, int MB, float scale, cudaStream_t stream) {
  constexpr int NW = D >= 256 ? 4 : 8;
  const int G = H / KVH;
  dim3 grid(S, KVH, (G + kMaxGroup - 1) / kMaxGroup);
  paged_decode_kernel<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      tables, lengths, static_cast<T*>(o), m, l, H, KVH, bs, MB, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v, const int* tables,
                     const int* lengths, void* o, float* m, float* l, int S, int H,
                     int KVH, int bs, int MB, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, tables, lengths, o, m, l, S, H, KVH, bs, MB, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, tables, lengths, o, m, l, S, H, KVH, bs, MB, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, tables, lengths, o, m, l, S, H, KVH, bs, MB, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, tables, lengths, o, m, l, S, H, KVH, bs, MB, scale, stream);
    case 256: return launch_d<T, 256>(q, k, v, tables, lengths, o, m, l, S, H, KVH, bs, MB, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError().
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache, const void* tables,
    const void* lengths, void* o, void* m_out, void* l_out, int S, int H, int KVH,
    int D, int bs, int MB, float scale, int dtype, void* stream) {
  if (S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_t<float>(D, q, k_cache, v_cache, tb, ln, o, m, l, S, H, KVH, bs, MB, scale, st);
  } else if (dtype == 1) {
    err = launch_t<__nv_bfloat16>(D, q, k_cache, v_cache, tb, ln, o, m, l, S, H, KVH, bs, MB, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
