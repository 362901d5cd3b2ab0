// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of dynamo_tpu/ops/pallas/paged_attention.py:
// paged_attention_decode_v4 (_decode_kernel_v4), paged_attention_decode_v2
// (_decode_kernel_v2) and paged_attention_decode (v1, _decode_kernel). The
// three compute one function and differ only in how they schedule DMA on a
// TPU, so this one pair of kernels ports all of them.
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
// What bounds it on the card: bytes. Each live K and V row is read once, and
// decode does about G = H / KVH operations per K+V byte against the H100's
// ~295, so the least time is the live K+V bytes of all lanes over the HBM
// rate. The design is there to keep enough bytes in flight:
//
// - Split-KV. The grid is (lane, kv head x groups of 16 query heads, split).
//   The wrapper picks the split count on the host from shapes alone (never
//   from lengths, which live on the card), aiming at a few blocks per SM. On
//   the card each split takes an equal, tile-aligned run of its lane's live
//   tokens; a split whose run starts past the lane's length writes an empty
//   partial (l = 0, stabilizer -1e30) and exits. Each split writes its
//   unnormalised fp32 numerator and its stats (stabilizer, max, l) to
//   scratch the wrapper allocates, and paged_decode_merge_kernel, launched
//   after every split kernel, combines them into o, m, l.
// - A cp.async ring. Tiles of TK keys (64 for bf16, 32 for fp32; 4 or 2
//   pages at bs = 16) pass through two shared-memory buffers: tile i+1 is
//   in flight while tile i is computed. Every
//   thread issues 16-byte cp.async.cg copies, consecutive threads on
//   consecutive 16-byte chunks of one 2·D-byte K or V row, and computes the
//   page of each row from the block's own table entries. Rows past the
//   split's end are zero-filled through cp.async's src-size operand (0 bytes
//   read), so neither a table entry past the lane's live pages nor a dead
//   slot's data (NaN in the tests) is ever read; their scores are masked to
//   -inf. Rows are stored with their 16-byte chunks XOR-swizzled so that
//   ldmatrix reads 8 rows without bank conflicts.
// - mma.sync.m16n8k16 (bf16 in, fp32 accumulate) over the GQA group. The
//   (up to 16) query heads of a kv head are the M rows; each warp takes 16
//   keys of a tile. S = Q·Kᵀ takes Q and K through ldmatrix; the two n8
//   accumulator tiles of S, rounded to bf16, are exactly the A operand of
//   P·V (FlashAttention-2's register reuse), and V enters through
//   ldmatrix.trans. Row max and sum need two quad shuffles per row per tile.
//   wgmma is not used: it needs 64 rows of M and decode has at most 16.
// - fp32 caches keep a CUDA-core inner product (TF32 would keep only about
//   three digits), in the same thread layout, split and merge, so the fp32
//   checks also hold the split algebra on the card.
//
// Rounding contract (shared with the plain versions in
// ops/paged_attention.py): p = 2^(s·log2e − st) with an integer stabilizer
// st per row, the running ceil(max score · log2e). Every rescale, between
// tiles, between the warps of a block and between splits, is by an exact
// power of two, so p rounded to the cache dtype against a partial
// stabilizer and rescaled equals p rounded against the global one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;  // query heads per block: the M rows of the mma
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegBig = -1e30f;

template <typename T, int D>
struct Geo {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int TK = kBf16 ? 64 : 32;         // keys per tile
  static constexpr int NW = TK / 16;                 // warps: 16 keys each
  static constexpr int THREADS = NW * 32;
  static constexpr int STAGES = 2;  // load tile i+1 while tile i is computed
  static constexpr int EPC = 16 / (int)sizeof(T);    // elements per 16-byte chunk
  static constexpr int CH = D / EPC;                 // chunks per row (a power of 2)
  static constexpr int RPG = CH >= 8 ? 1 : 8 / CH;   // rows sharing one swizzle
  static constexpr int SWM = (CH >= 8 ? 8 : CH) - 1;
  static constexpr int Q_ELEMS = kGroup * D;
  static constexpr int TILE_ELEMS = TK * D;
  static constexpr size_t RING = (size_t)STAGES * 2 * TILE_ELEMS * sizeof(T);
  static constexpr size_t MERGE = (size_t)NW * kGroup * D * sizeof(float);
  static constexpr size_t SMEM = Q_ELEMS * sizeof(T) + (RING > MERGE ? RING : MERGE);

  // element offset of 16-byte chunk c of row r in a [rows, D] tile
  static __device__ __forceinline__ int off(int r, int c) {
    return r * D + ((c ^ ((r / RPG) & SWM)) * EPC);
  }
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; live == false reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layout shared by both dtypes (the mma's C layout): a thread
// holds rows g = lane/4 and g+8 (query heads), and in each of two n8 tiles
// the columns (lane%4)*2 and +1 (keys of the warp's 16). sc[j][e] is row g,
// sc[j][2+e] row g+8, key j*8 + (lane%4)*2 + e. acc[t][..] likewise holds
// dims t*8 + (lane%4)*2 + {0,1}.

// S = Q · Kᵀ for the warp's 16 keys starting at tile row key0 (unscaled)
template <int D>
__device__ __forceinline__ void qk(float (&sc)[2][4], const __nv_bfloat16* qs,
                                   const __nv_bfloat16* ks, int key0, int lane) {
  using Gm = Geo<__nv_bfloat16, D>;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
  const int qrow = (lane & 7) + ((lane >> 3) & 1) * 8;   // A: rows 0-7 / 8-15
  const int krow = key0 + (lane & 7) + (lane >> 4) * 8;  // B: keys 0-7 / 8-15
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, qs + Gm::off(qrow, 2 * kk + (lane >> 4)));
    ldsm_x4(b, ks + Gm::off(krow, 2 * kk + ((lane >> 3) & 1)));
    mma_bf16(sc[0], a, b[0], b[1]);
    mma_bf16(sc[1], a, b[2], b[3]);
  }
}

// acc += bf16(p) · V for the warp's 16 keys: p's C fragments are P's A operand
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4], const float (&p)[2][4],
                                   const __nv_bfloat16* vs, int key0, int lane) {
  using Gm = Geo<__nv_bfloat16, D>;
  const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  const int vrow = key0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int c = 0; c < D / 8; c += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, vs + Gm::off(vrow, c + (lane >> 4)));
    mma_bf16(acc[c], a, b[0], b[1]);
    mma_bf16(acc[c + 1], a, b[2], b[3]);
  }
}

// fp32: the same products on the CUDA cores, in the same fragment layout
template <int D>
__device__ __forceinline__ void qk(float (&sc)[2][4], const float* qs, const float* ks,
                                   int key0, int lane) {
  using Gm = Geo<float, D>;
  const int g = lane >> 2;
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + j * 8 + cq + e;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
      for (int c = 0; c < Gm::CH; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(ks + Gm::off(key, c));
        const float4 a4 = *reinterpret_cast<const float4*>(qs + Gm::off(g, c));
        const float4 b4 = *reinterpret_cast<const float4*>(qs + Gm::off(g + 8, c));
        s0 += a4.x * k4.x + a4.y * k4.y + a4.z * k4.z + a4.w * k4.w;
        s1 += b4.x * k4.x + b4.y * k4.y + b4.z * k4.z + b4.w * k4.w;
      }
      sc[j][e] = s0;
      sc[j][2 + e] = s1;
    }
  }
}

template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 8][4], const float (&p)[2][4],
                                   const float* vs, int key0, int lane) {
  using Gm = Geo<float, D>;
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int j = kk >> 3, e = kk & 1;
    const int src = (lane & ~3) | ((kk & 7) >> 1);  // the quad lane holding key kk
    const float p0 = __shfl_sync(0xffffffffu, p[j][e], src);
    const float p1 = __shfl_sync(0xffffffffu, p[j][2 + e], src);
    const int row = key0 + kk;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      const int d = t * 8 + cq;  // d and d+1 lie in one 4-float chunk
      const float2 v2 =
          *reinterpret_cast<const float2*>(vs + Gm::off(row, d / Gm::EPC) + d % Gm::EPC);
      acc[t][0] += p0 * v2.x;
      acc[t][1] += p0 * v2.y;
      acc[t][2] += p1 * v2.x;
      acc[t][3] += p1 * v2.y;
    }
  }
}

// One block: lane s (blockIdx.x), kv head n and group of <= 16 of its query
// heads (blockIdx.y), split sp of NS (blockIdx.z). part: numerators
// [S, H, NS, D], then stabilizer, max and l, [S, H, NS] each.
template <typename T, int D>
__global__ void __launch_bounds__(Geo<T, D>::THREADS)
paged_decode_split_kernel(
    const T* __restrict__ q,            // [S, H, D]
    const T* __restrict__ k_cache,      // [N, bs, KVH, D]
    const T* __restrict__ v_cache,
    const int* __restrict__ tables,     // [S, MB]
    const int* __restrict__ lengths,    // [S]
    float* __restrict__ part,
    int H, int KVH, int bs, int MB, int NS, float scale) {
  using Gm = Geo<T, D>;
  constexpr int TK = Gm::TK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ring = qs + Gm::Q_ELEMS;
  float* mbuf = reinterpret_cast<float*>(ring);  // reused once the ring is drained
  __shared__ float sm_mx[Gm::NW][kGroup], sm_st[Gm::NW][kGroup], sm_l[Gm::NW][kGroup];

  const int s = blockIdx.x;
  const int G = H / KVH;
  const int HG = (G + kGroup - 1) / kGroup;
  const int n = blockIdx.y / HG;
  const int g0 = (blockIdx.y % HG) * kGroup;
  const int gb = min(kGroup, G - g0);
  const int head0 = n * G + g0;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t rows = (size_t)gridDim.x * H;
  float* p_st = part + rows * NS * D;
  float* p_mx = p_st + rows * NS;
  float* p_l = p_mx + rows * NS;

  // this split's run of the lane's live tokens: an equal share of its tiles
  const int len = min(max(lengths[s], 0), MB * bs);
  const int tiles = (len + TK - 1) / TK;
  const int per_split = (tiles + NS - 1) / NS;
  const long long t0_ll = (long long)sp * per_split * TK;
  if (t0_ll >= len) {  // an empty split (or an empty lane)
    for (int i = tid; i < gb; i += Gm::THREADS) {
      const size_t hrow = (size_t)s * H + head0 + i;
      p_st[hrow * NS + sp] = kNegBig;
      p_mx[hrow * NS + sp] = kNegBig;
      p_l[hrow * NS + sp] = 0.f;
    }
    return;
  }
  const int t0 = (int)t0_ll;
  const int t1 = min(t0 + per_split * TK, len);
  const int nt = (t1 - t0 + TK - 1) / TK;
  const int* trow = tables + (size_t)s * MB;

  // Q rows of the group (zeros past gb), in the first cp.async group
  for (int i = tid; i < kGroup * Gm::CH; i += Gm::THREADS) {
    const int r = i / Gm::CH, c = i % Gm::CH;
    const bool live = r < gb;
    cp_async16(qs + Gm::off(r, c), q + ((size_t)s * H + head0 + (live ? r : 0)) * D + c * Gm::EPC,
               live);
  }
  auto load_tile = [&](int it, int buf) {
    T* ks = ring + (size_t)buf * 2 * Gm::TILE_ELEMS;
    T* vs = ks + Gm::TILE_ELEMS;
    const int tt = t0 + it * TK;
    for (int i = tid; i < TK * Gm::CH; i += Gm::THREADS) {
      const int r = i / Gm::CH, c = i % Gm::CH;
      const int tok = tt + r;
      const bool live = tok < t1;
      size_t g = 0;
      if (live) {
        const int pid = __ldg(trow + tok / bs);
        g = (((size_t)pid * bs + tok % bs) * KVH + n) * D + c * Gm::EPC;
      }
      cp_async16(ks + Gm::off(r, c), k_cache + g, live);
      cp_async16(vs + Gm::off(r, c), v_cache + g, live);
    }
  };
#pragma unroll
  for (int i = 0; i < Gm::STAGES - 1; ++i) {
    if (i < nt) load_tile(i, i);
    cp_async_commit();
  }

  const int g = lane >> 2;
  const int cq = (lane & 3) * 2;
  float mx[2] = {kNegBig, kNegBig}, st[2] = {kNegBig, kNegBig}, lsum[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<Gm::STAGES - 2>();  // this thread's copies of tile it have landed
    __syncthreads();                  // everyone's have; buffer (it-1) is free again
    if (it + Gm::STAGES - 1 < nt) load_tile(it + Gm::STAGES - 1, (it + Gm::STAGES - 1) % Gm::STAGES);
    cp_async_commit();
    const T* ks = ring + (size_t)(it % Gm::STAGES) * 2 * Gm::TILE_ELEMS;
    const T* vs = ks + Gm::TILE_ELEMS;
    const int kb = t0 + it * TK + warp * 16;  // the warp's first key
    if (kb >= t1) continue;                   // warp-uniform: all 16 keys dead

    float sc[2][4];
    qk<D>(sc, qs, ks, warp * 16, lane);
    float top[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kb + j * 8 + cq + e < t1;
        sc[j][e] = ok ? sc[j][e] * scale : -INFINITY;
        sc[j][2 + e] = ok ? sc[j][2 + e] * scale : -INFINITY;
        top[0] = fmaxf(top[0], sc[j][e]);
        top[1] = fmaxf(top[1], sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 1));
      top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 2));
      mx[r] = fmaxf(mx[r], top[r]);
      const float st_new = fmaxf(st[r], ceilf(top[r] * kLog2e));
      const float alpha = exp2f(st[r] - st_new);  // a power of two (or 0)
      lsum[r] *= alpha;
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        acc[t][2 * r] *= alpha;
        acc[t][2 * r + 1] *= alpha;
      }
      st[r] = st_new;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = exp2f(sc[j][e] * kLog2e - st[0]);
        sc[j][2 + e] = exp2f(sc[j][2 + e] * kLog2e - st[1]);
        lsum[0] += sc[j][e];
        lsum[1] += sc[j][2 + e];
      }
    }
    pv<D>(acc, sc, vs, warp * 16, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory becomes mbuf
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm_mx[warp][g + 8 * r] = mx[r];
      sm_st[warp][g + 8 * r] = st[r];
      sm_l[warp][g + 8 * r] = lsum[r];
    }
  }
  float* mw = mbuf + (size_t)warp * kGroup * D;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int d = t * 8 + cq;
    *reinterpret_cast<float2*>(mw + g * D + d) = make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(mw + (g + 8) * D + d) = make_float2(acc[t][2], acc[t][3]);
  }
  __syncthreads();

  for (int i = tid; i < gb * D; i += Gm::THREADS) {
    const int row = i / D, d = i % D;
    float mxb = kNegBig, stb = kNegBig;
#pragma unroll
    for (int w = 0; w < Gm::NW; ++w) {
      mxb = fmaxf(mxb, sm_mx[w][row]);
      stb = fmaxf(stb, sm_st[w][row]);
    }
    float lt = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < Gm::NW; ++w) {
      const float a = exp2f(sm_st[w][row] - stb);
      lt += a * sm_l[w][row];
      num += a * mbuf[((size_t)w * kGroup + row) * D + d];
    }
    const size_t hrow = (size_t)s * H + head0 + row;
    part[(hrow * NS + sp) * D + d] = num;
    if (d == 0) {
      p_st[hrow * NS + sp] = stb;
      p_mx[hrow * NS + sp] = mxb;
      p_l[hrow * NS + sp] = lt;
    }
  }
}

// One block per (lane, query head): the splits' partials rescaled by
// 2^(st_i − st_max), an exact power of two, and summed. A split with l = 0
// is empty and its numerator (never written) is not read.
template <typename T>
__global__ void paged_decode_merge_kernel(const float* __restrict__ part, T* __restrict__ o,
                                          float* __restrict__ m_out, float* __restrict__ l_out,
                                          int rows, int D, int NS) {
  const size_t row = blockIdx.x;
  const float* acc = part + row * NS * D;
  const float* st = part + (size_t)rows * NS * D + row * NS;
  const float* mx = st + (size_t)rows * NS;
  const float* l = mx + (size_t)rows * NS;
  float stb = kNegBig, mxb = kNegBig;
  for (int i = 0; i < NS; ++i) {
    stb = fmaxf(stb, st[i]);
    mxb = fmaxf(mxb, mx[i]);
  }
  float lt = 0.f;
  for (int i = 0; i < NS; ++i) {
    if (l[i] > 0.f) lt += exp2f(st[i] - stb) * l[i];
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int i = 0; i < NS; ++i) {
      if (l[i] > 0.f) num += exp2f(st[i] - stb) * acc[(size_t)i * D + d];
    }
    o[row * D + d] = from_f<T>(lt > 0.f ? num / lt : 0.f);
  }
  if (threadIdx.x == 0) {
    m_out[row] = mxb;
    l_out[row] = lt > 0.f ? lt * exp2f(stb - mxb * kLog2e) : 0.f;
  }
}

// launched[0] and [1] count the split and merge kernels launched, [2] is
// the split kernel's grid z (its split count)
template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* tables,
                     const int* lengths, void* o, float* m, float* l, float* part, int S,
                     int H, int KVH, int bs, int MB, int NS, float scale,
                     cudaStream_t stream, int* launched) {
  using Gm = Geo<T, D>;
  auto kern = paged_decode_split_kernel<T, D>;
  cudaError_t err;
  if (Gm::SMEM > 48 * 1024) {
    // once per device (and not again while a CUDA graph is being captured)
    static unsigned long long set_on = 0;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !((set_on >> dev) & 1ull)) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)Gm::SMEM);
      if (err != cudaSuccess) return err;
      if (dev < 64) set_on |= 1ull << dev;
    }
  }
  const int G = H / KVH;
  dim3 grid(S, KVH * ((G + kGroup - 1) / kGroup), NS);
  kern<<<grid, Gm::THREADS, Gm::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      lengths, part, H, KVH, bs, MB, NS, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  launched[0] += 1;
  launched[2] = (int)grid.z;
  const int threads = D < 32 ? 32 : (D > 128 ? 128 : D);
  paged_decode_merge_kernel<T><<<S * H, threads, 0, stream>>>(part, static_cast<T*>(o), m, l,
                                                              S * H, D, NS);
  err = cudaGetLastError();
  if (err == cudaSuccess) launched[1] += 1;
  return err;
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v, const int* tables,
                     const int* lengths, void* o, float* m, float* l, float* part, int S,
                     int H, int KVH, int bs, int MB, int NS, float scale,
                     cudaStream_t stream, int* launched) {
#define PDA_CASE(DD)                                                                     \
  case DD:                                                                               \
    return launch_d<T, DD>(q, k, v, tables, lengths, o, m, l, part, S, H, KVH, bs, MB, NS, \
                           scale, stream, launched);
  switch (D) {
    PDA_CASE(16)
    PDA_CASE(32)
    PDA_CASE(64)
    PDA_CASE(128)
    PDA_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef PDA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part: fp32 scratch of S·H·NS·(D + 3)
// floats. launched (3 ints, host memory): the split and merge kernels
// launched by this call are added to [0] and [1], and [2] is set to the
// split count the split kernel ran with. Returns the first launch error
// (cudaGetLastError() after each launch), 0 when both launched.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache, const void* tables,
    const void* lengths, void* o, void* m_out, void* l_out, void* part, int S, int H,
    int KVH, int D, int bs, int MB, int num_splits, float scale, int dtype, void* stream,
    int* launched) {
  if (S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || bs <= 0 || MB <= 0 || num_splits <= 0 || part == nullptr ||
      launched == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  float* pt = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_t<float>(D, q, k_cache, v_cache, tb, ln, o, m, l, pt, S, H, KVH, bs, MB,
                          num_splits, scale, st, launched);
  } else if (dtype == 1) {
    err = launch_t<__nv_bfloat16>(D, q, k_cache, v_cache, tb, ln, o, m, l, pt, S, H, KVH, bs,
                                  MB, num_splits, scale, st, launched);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
