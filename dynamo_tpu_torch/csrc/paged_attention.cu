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
// Int8 pages (paged_decode_int8_split_kernel): the same attention over
// pages stored as int8 with one fp32 scale per token slot ([N, bs], shared
// by the slot's KVH heads). It replaces no TPU kernel: the JAX package's
// Pallas kernel has no fused dequantization, so an int8 pool there runs
// XLA's gather_history + dequantize_kv dense tier
// (dynamo_tpu/models/llama.py:534, :246). What bounds it: bytes, the int8 K
// and V rows plus 8 bytes of scales per token, about half of the bf16
// pages' bytes. Its design keeps the per-value work off that path:
//
// - The scales are folded, not applied per value. A key's score is
//   (q · k8) · (k_scale · softmax scale): one fp32 multiply per score; each
//   p is multiplied by its v_scale before it is rounded to the compute dtype
//   for P·V, and l sums the unscaled p. An int8 value is exact in bf16, so
//   the only roundings are the fp32 sums and p · v_scale to bf16 (one
//   rounding per p where dequantize_kv followed by the bf16 kernel rounds
//   every k, every v and every p).
// - No dequantized tile. K and V cross shared memory as int8 rows and go
//   from there straight into mma.sync's B fragments: ldmatrix in its 16-bit
//   view gives a thread 4 int8 values per register, which become two bf16x2
//   registers in 3 integer/bf16 operations per pair (i8pair_to_bf16x2). For
//   K (non-transposed) a register holds d = 4c..4c+3 of one key, so the mma's
//   k index runs over d in the order 4c, 4c+2 | 4c+1, 4c+3; Q's A fragments
//   are built once per block in that same order (Q·Kᵀ sums over d, so the
//   permutation changes nothing). For V (ldmatrix.trans) a register holds
//   keys 2c, 2c+1 at d = 2j, 2j+1: its even and odd bytes are the B
//   fragments of two n8 tiles, the even and the odd d of a 16-d block, so
//   the accumulator's d order is permuted and write_partial undoes it.
// - Warp-local pipelines. Each of the 4 warps owns a ring of STAGES stages
//   holding its own 16 rows of K and V and their scales; it copies and
//   waits for only those (cp.async groups and __syncwarp), so no block-wide
//   barrier runs between tiles and STAGES - 1 tiles per warp are in flight
//   while one is attended. A page's 64-byte run of 16 slot scales is copied
//   in 16-byte pieces.
// - The fp32 compute path keeps a CUDA-core inner product over the same
//   ring, the values converted exactly by byte permutes.
// - The wrapper plans the split count from the blocks per SM that this
//   kernel's footprint allows (paged_decode_int8_blocks_per_sm).
//
// Rounding contract (shared with the plain versions in
// ops/paged_attention.py): p = 2^(s·log2e − st) with an integer stabilizer
// st per row, the running ceil(max score · log2e). Every rescale, between
// tiles, between the warps of a block and between splits, is by an exact
// power of two, so p rounded to the cache dtype against a partial
// stabilizer and rescaled equals p rounded against the global one (and so
// does p · v_scale on the int8 path).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest written as zeros
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
// 16 bytes global -> shared; live == false reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  cp_async16_n(dst, src, live ? 16 : 0);
}
// 4 bytes global -> shared (through L1); live == false reads nothing, writes 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(live ? 4 : 0) : "memory");
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
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)) : "memory");
}

// c += a · b over one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  mma_bf16(c, a.x, a.y, a.z, a.w, b0, b1);
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

// The split kernels' running state of one warp over its keys: the row max
// mx, the integer stabilizer st, the denominator lsum (rows g and g+8) and
// the numerator acc in the mma's C layout.
template <int D>
struct WarpAcc {
  float mx[2] = {kNegBig, kNegBig};
  float st[2] = {kNegBig, kNegBig};
  float lsum[2] = {0.f, 0.f};
  float acc[D / 8][4];
  __device__ __forceinline__ WarpAcc() {
#pragma unroll
    for (int t = 0; t < D / 8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  }
};

// The online softmax over one warp's 16 scores per row (sc, masked keys at
// -inf; top: each thread's row maxima of them): the row max, the integer
// stabilizer and the rescale of lsum and acc by a power of two, then sc
// becomes p and lsum takes its sum. kSkipUnit skips the rescale of acc when
// no row of the warp moved its stabilizer (acc · 1 is acc). hi == false
// (a group of at most 8 query heads, warp-uniform): rows 8-15 are padding,
// left at their initial state with p = 0.
template <int D, bool kSkipUnit = false>
__device__ __forceinline__ void online_softmax(WarpAcc<D>& w, float (&sc)[2][4],
                                               float (&top)[2], bool hi = true) {
  float alpha[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (r == 1 && !hi) break;
    top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 1));
    top[r] = fmaxf(top[r], __shfl_xor_sync(0xffffffffu, top[r], 2));
    w.mx[r] = fmaxf(w.mx[r], top[r]);
    const float st_new = fmaxf(w.st[r], ceilf(top[r] * kLog2e));
    alpha[r] = exp2f(w.st[r] - st_new);  // a power of two (or 0)
    w.lsum[r] *= alpha[r];
    w.st[r] = st_new;
  }
  if (!kSkipUnit || __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int t = 0; t < D / 8; ++t) {
        w.acc[t][2 * r] *= alpha[r];
        w.acc[t][2 * r + 1] *= alpha[r];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[j][e] = exp2f(sc[j][e] * kLog2e - w.st[0]);
      w.lsum[0] += sc[j][e];
      if (hi) {
        sc[j][2 + e] = exp2f(sc[j][2 + e] * kLog2e - w.st[1]);
        w.lsum[1] += sc[j][2 + e];
      } else {
        sc[j][2 + e] = 0.f;
      }
    }
  }
}

// One warp's 16 keys of a tile in shared memory (ks, vs: [TK, D], swizzled),
// the first of them the split's token kb: scores, online softmax, P·V.
// Keys at or past t1 are masked.
template <typename T, int D>
__device__ __forceinline__ void attend_tile(WarpAcc<D>& w, const T* qs, const T* ks,
                                            const T* vs, int key0, int kb, int t1,
                                            float scale, int lane) {
  const int cq = (lane & 3) * 2;
  float sc[2][4];
  qk<D>(sc, qs, ks, key0, lane);
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
  online_softmax<D>(w, sc, top);
  pv<D>(w.acc, sc, vs, key0, lane);
}

// Where a block writes its split's partial: numerators [S, H, NS, D], then
// stabilizer, max and l, [S, H, NS] each.
struct Partial {
  float* num;
  float* st;
  float* mx;
  float* l;
  __device__ __forceinline__ Partial(float* part, int S, int H, int NS, int D) {
    const size_t rows = (size_t)S * H;
    num = part;
    st = part + rows * NS * D;
    mx = st + rows * NS;
    l = mx + rows * NS;
  }
};

// An empty split (or lane): l = 0 and stabilizer -1e30 for its gb rows.
template <int THREADS>
__device__ __forceinline__ void write_empty(const Partial& p, size_t row0, int gb, int NS,
                                            int sp, int tid) {
  for (int i = tid; i < gb; i += THREADS) {
    const size_t hrow = row0 + i;
    p.st[hrow * NS + sp] = kNegBig;
    p.mx[hrow * NS + sp] = kNegBig;
    p.l[hrow * NS + sp] = 0.f;
  }
}

// The block's epilogue, once its cp.async groups are drained and no thread
// reads the tiles any more: the warps' partials are combined through mbuf
// (shared memory of NW·16·D floats) by exact powers of two and the split's
// partial is written for rows row0 .. row0 + gb - 1.
// kPermD: acc holds the int8 kernel's permuted d order (pv8): acc[2q] and
// acc[2q+1] are the even and odd d of block q, so a thread's columns are
// d = 16q + 4·(lane % 4) + {0, 1, 2, 3}.
template <int NW, int THREADS, int D, bool kPermD = false>
__device__ __forceinline__ void write_partial(const Partial& p, WarpAcc<D>& w, float* mbuf,
                                              float (*sm_mx)[kGroup], float (*sm_st)[kGroup],
                                              float (*sm_l)[kGroup], size_t row0, int gb,
                                              int NS, int sp, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2;
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    w.lsum[r] += __shfl_xor_sync(0xffffffffu, w.lsum[r], 1);
    w.lsum[r] += __shfl_xor_sync(0xffffffffu, w.lsum[r], 2);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm_mx[warp][g + 8 * r] = w.mx[r];
      sm_st[warp][g + 8 * r] = w.st[r];
      sm_l[warp][g + 8 * r] = w.lsum[r];
    }
  }
  float* mw = mbuf + (size_t)warp * kGroup * D;
  if constexpr (kPermD) {
#pragma unroll
    for (int b = 0; b < D / 16; ++b) {
      const int d = b * 16 + 2 * cq;
      const float(&ev)[4] = w.acc[2 * b];
      const float(&od)[4] = w.acc[2 * b + 1];
      *reinterpret_cast<float4*>(mw + g * D + d) = make_float4(ev[0], od[0], ev[1], od[1]);
      *reinterpret_cast<float4*>(mw + (g + 8) * D + d) = make_float4(ev[2], od[2], ev[3], od[3]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      const int d = t * 8 + cq;
      *reinterpret_cast<float2*>(mw + g * D + d) = make_float2(w.acc[t][0], w.acc[t][1]);
      *reinterpret_cast<float2*>(mw + (g + 8) * D + d) = make_float2(w.acc[t][2], w.acc[t][3]);
    }
  }
  __syncthreads();

  for (int i = tid; i < gb * D; i += THREADS) {
    const int row = i / D, d = i % D;
    float mxb = kNegBig, stb = kNegBig;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      mxb = fmaxf(mxb, sm_mx[v][row]);
      stb = fmaxf(stb, sm_st[v][row]);
    }
    float lt = 0.f, num = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const float a = exp2f(sm_st[v][row] - stb);
      lt += a * sm_l[v][row];
      num += a * mbuf[((size_t)v * kGroup + row) * D + d];
    }
    const size_t hrow = row0 + row;
    p.num[(hrow * NS + sp) * D + d] = num;
    if (d == 0) {
      p.st[hrow * NS + sp] = stb;
      p.mx[hrow * NS + sp] = mxb;
      p.l[hrow * NS + sp] = lt;
    }
  }
}

// The run of a lane's live tokens that split sp of NS takes: an equal share
// of its tiles of TK keys. Empty when t0 >= t1.
struct SplitRun {
  int t0, t1, nt;
  __device__ __forceinline__ SplitRun(int length, int MB, int bs, int TK, int NS, int sp) {
    const int len = min(max(length, 0), MB * bs);
    const int tiles = (len + TK - 1) / TK;
    const int per_split = (tiles + NS - 1) / NS;
    const long long t0_ll = (long long)sp * per_split * TK;
    t0 = t0_ll >= len ? len : (int)t0_ll;
    t1 = t0_ll >= len ? len : min(t0 + per_split * TK, len);
    nt = (t1 - t0 + TK - 1) / TK;
  }
  __device__ __forceinline__ bool empty() const { return t0 >= t1; }
};

// The group's Q rows (zeros past gb) into shared memory, in the caller's
// first cp.async group.
template <typename T, int D>
__device__ __forceinline__ void load_q(T* qs, const T* q, size_t row0, int gb, int tid) {
  using Gm = Geo<T, D>;
  for (int i = tid; i < kGroup * Gm::CH; i += Gm::THREADS) {
    const int r = i / Gm::CH, c = i % Gm::CH;
    const bool live = r < gb;
    cp_async16(qs + Gm::off(r, c), q + (row0 + (live ? r : 0)) * D + c * Gm::EPC, live);
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
  const size_t row0 = (size_t)s * H + n * G + g0;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Partial p(part, gridDim.x, H, NS, D);

  const SplitRun run(lengths[s], MB, bs, TK, NS, sp);
  if (run.empty()) {
    write_empty<Gm::THREADS>(p, row0, gb, NS, sp, tid);
    return;
  }
  const int t0 = run.t0, t1 = run.t1, nt = run.nt;
  const int* trow = tables + (size_t)s * MB;

  load_q<T, D>(qs, q, row0, gb, tid);
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

  WarpAcc<D> w;
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<Gm::STAGES - 2>();  // this thread's copies of tile it have landed
    __syncthreads();                  // everyone's have; buffer (it-1) is free again
    if (it + Gm::STAGES - 1 < nt) load_tile(it + Gm::STAGES - 1, (it + Gm::STAGES - 1) % Gm::STAGES);
    cp_async_commit();
    const T* ks = ring + (size_t)(it % Gm::STAGES) * 2 * Gm::TILE_ELEMS;
    const T* vs = ks + Gm::TILE_ELEMS;
    const int kb = t0 + it * TK + warp * 16;  // the warp's first key
    if (kb >= t1) continue;                   // warp-uniform: all 16 keys dead
    attend_tile<T, D>(w, qs, ks, vs, warp * 16, kb, t1, scale, lane);
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory becomes mbuf
  write_partial<Gm::NW, Gm::THREADS, D>(p, w, mbuf, sm_mx, sm_st, sm_l, row0, gb, NS, sp, tid);
}

// The int8 kernel's geometry: tiles of TK = 64 keys as the split kernel's,
// one warp per 16 of them, each warp with its own ring of STAGES stages. A
// stage holds the warp's 16 int8 K rows, its 16 V rows (each row's 16-byte
// chunks XOR-swizzled as Geo's, for ldmatrix) and their 16 + 16 scales.
// Shared memory: Q (bf16: the mma A fragments, [D/16][32 lanes] of 16
// bytes; fp32: Geo's swizzled [16, D] tile), then the rings, which the
// block's epilogue reuses as its merge buffer.
template <typename T, int D>
struct Geo8 {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int TK = 64;
  static constexpr int NW = TK / 16;
  static constexpr int THREADS = NW * 32;
  static constexpr int STAGES = 3;
  static constexpr int CH = D / 16;  // 16-byte chunks of an int8 row
  static constexpr int RPG = CH >= 8 ? 1 : 8 / CH;
  static constexpr int SWM = (CH >= 8 ? 8 : CH) - 1;
  static constexpr int ROWS = 16 * D;                  // bytes of 16 rows
  static constexpr int STAGE = 2 * ROWS + 2 * 16 * 4;  // K, V, k and v scales
  static constexpr size_t RING = (size_t)NW * STAGES * STAGE;
  static constexpr size_t QBYTES = kBf16 ? (size_t)D * 32 : (size_t)kGroup * D * 4;
  static constexpr size_t MERGE = (size_t)NW * kGroup * D * sizeof(float);
  static constexpr size_t SMEM = QBYTES + (RING > MERGE ? RING : MERGE);
  // at most 128 registers a thread up to D = 128, so that 4 blocks fit an SM
  static constexpr int MIN_BLOCKS = D <= 128 ? 4 : 1;

  // byte offset of 16-byte chunk c of row r in a [16, D] int8 tile
  static __device__ __forceinline__ int off(int r, int c) {
    return r * D + ((c ^ ((r / RPG) & SWM)) << 4);
  }
};

// float(b) of the four signed bytes of w, exactly, without the
// integer-to-float conversion (which runs at a quarter of the fp32 rate):
// each byte, offset by 128 into 0..255, becomes the low mantissa byte of
// 2^23 (one byte permute), and 2^23 + 128 is subtracted (an exact add).
__device__ __forceinline__ float4 i8x4_to_f32(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128 in each byte
  constexpr float kOff = 8388736.f;    // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - kOff,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - kOff,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - kOff,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - kOff);
}

// The signed bytes 0 and 2 of w as a bf16x2 (byte 0 in the low half),
// exactly: in each half, 0x4300 | (b & 0x7f) is 128 + (b & 127) and
// 0xc300 | (b & 0x80) is -128 or, with b's sign bit on the exponent's
// lowest bit, -256; their sum is b, which bf16 holds exactly. Bytes 1 and 3
// are the same of w >> 8.
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t w) {
  const uint32_t x = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t z = (w & 0x00800080u) | 0xc300c300u;
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(y) : "r"(x), "r"(0x3f803f80u), "r"(z));
  return y;
}
__device__ __forceinline__ uint32_t i8_even(uint32_t w) { return i8pair_to_bf16x2(w); }
__device__ __forceinline__ uint32_t i8_odd(uint32_t w) { return i8pair_to_bf16x2(w >> 8); }

// The block's Q rows as the A fragments of qk8's d order: for each block kk
// of 16 d and each lane (g = lane / 4, c = lane % 4), a0 = (d 4c, 4c+2) of
// row g, a1 the same of row g+8, a2 = (d 4c+1, 4c+3) of row g, a3 of row
// g+8, at qf[kk·32 + lane]; rows past gb are zeros.
template <int D, int THREADS>
__device__ __forceinline__ void load_q8(uint4* qf, const __nv_bfloat16* q, size_t row0, int gb,
                                        int tid) {
  for (int i = tid; i < D / 16 * 32; i += THREADS) {
    const int kk = i / 32, g = (i % 32) >> 2, c = i & 3;
    uint2 w[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      w[r] = row < gb ? *reinterpret_cast<const uint2*>(q + (row0 + row) * D + kk * 16 + 4 * c)
                      : make_uint2(0u, 0u);
    }
    qf[i] = make_uint4(__byte_perm(w[0].x, w[0].y, 0x5410), __byte_perm(w[1].x, w[1].y, 0x5410),
                       __byte_perm(w[0].x, w[0].y, 0x7632), __byte_perm(w[1].x, w[1].y, 0x7632));
  }
}

// fp32: the block's Q rows into Geo's swizzled [16, D] tile; rows past gb
// are zeros
template <int D, int THREADS>
__device__ __forceinline__ void load_q8(float* qs, const float* q, size_t row0, int gb,
                                        int tid) {
  using Gq = Geo<float, D>;
  for (int i = tid; i < kGroup * Gq::CH; i += THREADS) {
    const int r = i / Gq::CH, c = i % Gq::CH;
    *reinterpret_cast<float4*>(qs + Gq::off(r, c)) =
        r < gb ? *reinterpret_cast<const float4*>(q + (row0 + r) * D + c * Gq::EPC)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// S = Q · Kᵀ for a warp's 16 int8 keys (ks: [16, D] swizzled), unscaled, in
// the C layout of qk. An ldmatrix x4 brings keys 0-7 and 8-15 of two 16-d
// blocks; a register holds d 4c..4c+3 of key lane / 4, whose even and odd
// bytes are the B fragment's k = 2c, 2c+1 and 2c+8, 2c+9.
template <int D>
__device__ __forceinline__ void qk8(float (&sc)[2][4], const uint4* qf, const int8_t* ks,
                                    int lane) {
  using G8 = Geo8<__nv_bfloat16, D>;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
  const int krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  if constexpr (D == 16) {
    uint32_t r[2];
    ldsm_x2(r, ks + G8::off(krow, 0));
    const uint4 a = qf[lane];
    mma_bf16(sc[0], a, i8_even(r[0]), i8_odd(r[0]));
    mma_bf16(sc[1], a, i8_even(r[1]), i8_odd(r[1]));
  } else {
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) {
      uint32_t r[4];
      ldsm_x4(r, ks + G8::off(krow, 2 * cc + (lane >> 4)));
      const uint4 a = qf[2 * cc * 32 + lane], b = qf[(2 * cc + 1) * 32 + lane];
      mma_bf16(sc[0], a, i8_even(r[0]), i8_odd(r[0]));
      mma_bf16(sc[1], a, i8_even(r[1]), i8_odd(r[1]));
      mma_bf16(sc[0], b, i8_even(r[2]), i8_odd(r[2]));
      mma_bf16(sc[1], b, i8_even(r[3]), i8_odd(r[3]));
    }
  }
}

// acc += a · V for a warp's 16 int8 keys (vs: [16, D] swizzled; a: P's A
// fragments, already times v_scale and rounded). ldmatrix.trans gives a
// thread keys 2c, 2c+1 at d = 2j, 2j+1 (j = lane / 4) in one register: its
// even bytes are the B fragment of the n8 tile of even d, its odd bytes
// that of odd d, so acc[2b] and acc[2b+1] hold the even and odd d of block
// b (write_partial<.., true> puts them back in order).
template <int D>
__device__ __forceinline__ void pv8(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                    const int8_t* vs, int lane) {
  using G8 = Geo8<__nv_bfloat16, D>;
  const int vrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  if constexpr (D == 16) {
    uint32_t r[2];
    ldsm_x2_trans(r, vs + G8::off(vrow, 0));
    mma_bf16(acc[0], a, i8_even(r[0]), i8_even(r[1]));
    mma_bf16(acc[1], a, i8_odd(r[0]), i8_odd(r[1]));
  } else {
#pragma unroll
    for (int cc = 0; cc < D / 32; ++cc) {
      uint32_t r[4];
      ldsm_x4_trans(r, vs + G8::off(vrow, 2 * cc + (lane >> 4)));
      mma_bf16(acc[4 * cc], a, i8_even(r[0]), i8_even(r[1]));
      mma_bf16(acc[4 * cc + 1], a, i8_odd(r[0]), i8_odd(r[1]));
      mma_bf16(acc[4 * cc + 2], a, i8_even(r[2]), i8_even(r[3]));
      mma_bf16(acc[4 * cc + 3], a, i8_odd(r[2]), i8_odd(r[3]));
    }
  }
}

// fp32: the same products on the CUDA cores, in qk's and pv's layouts
template <int D>
__device__ __forceinline__ void qk8(float (&sc)[2][4], const float* qs, const int8_t* ks,
                                    int lane) {
  using Gq = Geo<float, D>;
  using G8 = Geo8<float, D>;
  const int g = lane >> 2;
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = j * 8 + cq + e;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
      for (int c = 0; c < G8::CH; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + G8::off(key, c));
        const uint32_t wv[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 k4 = i8x4_to_f32(wv[h]);
          const float4 a4 = *reinterpret_cast<const float4*>(qs + Gq::off(g, 4 * c + h));
          const float4 b4 = *reinterpret_cast<const float4*>(qs + Gq::off(g + 8, 4 * c + h));
          s0 += a4.x * k4.x + a4.y * k4.y + a4.z * k4.z + a4.w * k4.w;
          s1 += b4.x * k4.x + b4.y * k4.y + b4.z * k4.z + b4.w * k4.w;
        }
      }
      sc[j][e] = s0;
      sc[j][2 + e] = s1;
    }
  }
}

template <int D>
__device__ __forceinline__ void pv8(float (&acc)[D / 8][4], const float (&p)[2][4],
                                    const int8_t* vs, int lane) {
  using G8 = Geo8<float, D>;
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int j = kk >> 3, e = kk & 1;
    const int src = (lane & ~3) | ((kk & 7) >> 1);  // the quad lane holding key kk
    const float p0 = __shfl_sync(0xffffffffu, p[j][e], src);
    const float p1 = __shfl_sync(0xffffffffu, p[j][2 + e], src);
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      const int d = t * 8 + cq;  // d and d+1 lie in one 16-byte chunk
      const float4 v4 = i8x4_to_f32(
          *reinterpret_cast<const uint16_t*>(vs + G8::off(kk, d >> 4) + (d & 15)));
      acc[t][0] += p0 * v4.x;
      acc[t][1] += p0 * v4.y;
      acc[t][2] += p1 * v4.x;
      acc[t][3] += p1 * v4.y;
    }
  }
}

// A warp's 16 keys of one tile (stage: its 16 K rows, 16 V rows, 16 k and
// 16 v scales), the first of them the split's token kb; keys at or past t1
// are masked (their rows and scales were zero-filled, never read). Scores
// are (q · k8) · (k_scale · scale); p · v_scale is rounded to T for P·V,
// and lsum sums p.
template <typename T, int D>
__device__ __forceinline__ void attend8(WarpAcc<D>& w, const void* qsm,
                                        const unsigned char* stage, int kb, int t1,
                                        float scale, bool hi, int lane) {
  using G8 = Geo8<T, D>;
  const int8_t* ks = reinterpret_cast<const int8_t*>(stage);
  const int8_t* vs = ks + G8::ROWS;
  const float* ksc = reinterpret_cast<const float*>(stage + 2 * G8::ROWS);
  const float* vsc = ksc + 16;
  const int cq = (lane & 3) * 2;
  float sc[2][4];
  if constexpr (G8::kBf16) {
    qk8<D>(sc, static_cast<const uint4*>(qsm), ks, lane);
  } else {
    qk8<D>(sc, static_cast<const float*>(qsm), ks, lane);
  }
  float top[2] = {-INFINITY, -INFINITY};
  float vw[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 k2 = *reinterpret_cast<const float2*>(ksc + j * 8 + cq);
    const float2 v2 = *reinterpret_cast<const float2*>(vsc + j * 8 + cq);
    vw[j][0] = v2.x;
    vw[j][1] = v2.y;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = kb + j * 8 + cq + e < t1;
      const float f = (e ? k2.y : k2.x) * scale;
      sc[j][e] = ok ? sc[j][e] * f : -INFINITY;
      sc[j][2 + e] = ok ? sc[j][2 + e] * f : -INFINITY;
      top[0] = fmaxf(top[0], sc[j][e]);
      top[1] = fmaxf(top[1], sc[j][2 + e]);
    }
  }
  online_softmax<D, true>(w, sc, top, hi);
  if constexpr (G8::kBf16) {
    const uint32_t a[4] = {
        pack_bf16(sc[0][0] * vw[0][0], sc[0][1] * vw[0][1]),
        pack_bf16(sc[0][2] * vw[0][0], sc[0][3] * vw[0][1]),
        pack_bf16(sc[1][0] * vw[1][0], sc[1][1] * vw[1][1]),
        pack_bf16(sc[1][2] * vw[1][0], sc[1][3] * vw[1][1])};
    pv8<D>(w.acc, a, vs, lane);
  } else {
    float pw[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pw[j][e] = sc[j][e] * vw[j][e];
        pw[j][2 + e] = sc[j][2 + e] * vw[j][e];
      }
    }
    pv8<D>(w.acc, pw, vs, lane);
  }
}

// paged_decode_split_kernel's function over int8 pages: k_cache / v_cache
// [N, bs, KVH, D] int8 and their per-token scales [N, bs] fp32 (one per
// physical slot, shared by the slot's KVH heads). Grid, splits, partials and
// merge are the split kernel's; inside a block each warp streams its own 16
// keys of every tile through its own ring (see the note at the top).
// vec_scales: bs is a multiple of 4 and both scale tables are 16-byte
// aligned, so a warp copies its 16 + 16 scales as 16-byte pieces of its
// pages' scale runs; otherwise one 4-byte copy per scale.
template <typename T, int D>
__global__ void __launch_bounds__(Geo8<T, D>::THREADS, Geo8<T, D>::MIN_BLOCKS)
paged_decode_int8_split_kernel(
    const T* __restrict__ q,              // [S, H, D] compute dtype
    const int8_t* __restrict__ k_cache,   // [N, bs, KVH, D]
    const int8_t* __restrict__ v_cache,
    const float* __restrict__ k_scale,    // [N, bs]
    const float* __restrict__ v_scale,
    const int* __restrict__ tables,       // [S, MB]
    const int* __restrict__ lengths,      // [S]
    float* __restrict__ part,
    int H, int KVH, int bs, int MB, int NS, float scale, int vec_scales) {
  using G8 = Geo8<T, D>;
  const bool page16 = bs % 16 == 0;
  using QT = std::conditional_t<G8::kBf16, uint4, float>;
  constexpr int TK = G8::TK, STAGES = G8::STAGES, CH = G8::CH;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + G8::QBYTES;
  float* mbuf = reinterpret_cast<float*>(ring);  // reused once the rings are drained
  __shared__ float sm_mx[G8::NW][kGroup], sm_st[G8::NW][kGroup], sm_l[G8::NW][kGroup];

  const int s = blockIdx.x;
  const int G = H / KVH;
  const int HG = (G + kGroup - 1) / kGroup;
  const int n = blockIdx.y / HG;
  const int g0 = (blockIdx.y % HG) * kGroup;
  const int gb = min(kGroup, G - g0);
  const size_t row0 = (size_t)s * H + n * G + g0;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Partial p(part, gridDim.x, H, NS, D);

  const SplitRun run(lengths[s], MB, bs, TK, NS, sp);
  if (run.empty()) {
    write_empty<G8::THREADS>(p, row0, gb, NS, sp, tid);
    return;
  }
  const int t0 = run.t0, t1 = run.t1, nt = run.nt;
  const int* trow = tables + (size_t)s * MB;
  unsigned char* wring = ring + (size_t)warp * STAGES * G8::STAGE;

  // The warp's 16 rows of tile it (tokens kb0 .. kb0 + 15) into stage buf,
  // then their scales. A lane copies chunk c = lane % CH of RL rows of K
  // and of V (for D = 16, lanes 0-15 a K row and lanes 16-31 a V row): its
  // rows, chunk and shared-memory offsets are the same for every tile, so
  // only the rows' pages are looked up per tile, one lookup in all when bs
  // is a multiple of 16 (the 16 rows then lie in one page). Rows and scales
  // at or past t1 read nothing and are written as zeros; a warp whose rows
  // all lie past t1 copies nothing (it attends nothing either).
  constexpr int RL = CH >= 2 ? CH / 2 : 1;
  const int c = lane % CH;
  const int rowstride = KVH * D;  // bytes between two slots' rows of a kv head
  const int8_t* kcol = k_cache + (size_t)n * D + c * 16;
  const int8_t* vcol = v_cache + (size_t)n * D + c * 16;
  auto load = [&](int it, int buf) {
    const int kb0 = t0 + it * TK + warp * 16;
    if (kb0 >= t1) return;
    const int nlive = t1 - kb0;  // rows r < nlive are live
    unsigned char* st = wring + buf * G8::STAGE;
    const int pg = kb0 / bs, slot0 = kb0 - pg * bs;
    const size_t page0 = page16 ? (size_t)__ldg(trow + pg) * bs + slot0 : 0;
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      const int r = CH >= 2 ? (lane + 32 * j) / CH : lane & 15;
      const bool live = r < nlive;
      size_t slot = 0;  // the row's physical slot
      if (live) {
        if (page16) {
          slot = page0 + r;
        } else {
          const int tok = kb0 + r;
          slot = (size_t)__ldg(trow + tok / bs) * bs + tok % bs;
        }
      }
      const int dst = G8::off(r, c);
      if (CH >= 2 || lane < 16) cp_async16(st + dst, kcol + slot * rowstride, live);
      if (CH >= 2 || lane >= 16) cp_async16(st + G8::ROWS + dst, vcol + slot * rowstride, live);
    }
    float* scs = reinterpret_cast<float*>(st + 2 * G8::ROWS);
    if (vec_scales) {
      if (lane < 8) {  // 4 pieces of 4 scales each for K, then for V
        const int kv = lane >> 2, r = 4 * (lane & 3), tok = kb0 + r;
        const int live = min(max(nlive - r, 0), 4);
        size_t g = 0;
        if (live) g = page16 ? page0 + r : (size_t)__ldg(trow + tok / bs) * bs + tok % bs;
        cp_async16_n(scs + kv * 16 + r, (kv ? v_scale : k_scale) + g, 4 * live);
      }
    } else {
      const int kv = lane >> 4, r = lane & 15, tok = kb0 + r;
      const bool live = r < nlive;
      size_t g = 0;
      if (live) g = (size_t)__ldg(trow + tok / bs) * bs + tok % bs;
      cp_async4(scs + kv * 16 + r, (kv ? v_scale : k_scale) + g, live);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) load(i, i);
    cp_async_commit();
  }
  load_q8<D, G8::THREADS>(reinterpret_cast<QT*>(smem_raw), q, row0, gb, tid);
  __syncthreads();  // Q is whole; from here on no barrier until the epilogue

  WarpAcc<D> w;
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of tile it have landed
    __syncwarp();  // the warp's have; the stage of tile it-1 is attended and free
    if (it + STAGES - 1 < nt) load(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const int kb = t0 + it * TK + warp * 16;  // the warp's first key
    if (kb >= t1) break;                      // warp-uniform; later tiles too
    attend8<T, D>(w, smem_raw, wring + (it % STAGES) * G8::STAGE, kb, t1, scale, gb > 8,
                  lane);
  }

  cp_async_wait<0>();
  __syncthreads();  // no warp reads its ring any more: the rings become mbuf
  write_partial<G8::NW, G8::THREADS, D, G8::kBf16>(p, w, mbuf, sm_mx, sm_st, sm_l, row0, gb,
                                                    NS, sp, tid);
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

// Allow kernel Kern `smem` bytes of dynamic shared memory: once per device
// (and so not again while a CUDA graph is being captured).
template <auto Kern>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static unsigned long long set_on = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((set_on >> dev) & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < 64) set_on |= 1ull << dev;
  return err;
}

// After a split kernel's launch (err: its cudaGetLastError()): count it in
// launched[0], its split count in [2], then launch the merge and count it
// in [1].
template <typename T>
cudaError_t merge_after(cudaError_t err, const float* part, void* o, float* m, float* l,
                        int S, int H, int D, int NS, cudaStream_t stream, int* launched) {
  if (err != cudaSuccess) return err;
  launched[0] += 1;
  launched[2] = NS;
  const int threads = D < 32 ? 32 : (D > 128 ? 128 : D);
  paged_decode_merge_kernel<T><<<S * H, threads, 0, stream>>>(part, static_cast<T*>(o), m, l,
                                                              S * H, D, NS);
  err = cudaGetLastError();
  if (err == cudaSuccess) launched[1] += 1;
  return err;
}

// launched[0] and [1] count the split and merge kernels launched, [2] is
// the split kernel's grid z (its split count)
template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const int* tables,
                     const int* lengths, void* o, float* m, float* l, float* part, int S,
                     int H, int KVH, int bs, int MB, int NS, float scale,
                     cudaStream_t stream, int* launched) {
  using Gm = Geo<T, D>;
  cudaError_t err = allow_smem<paged_decode_split_kernel<T, D>>(Gm::SMEM);
  if (err != cudaSuccess) return err;
  const int G = H / KVH;
  dim3 grid(S, KVH * ((G + kGroup - 1) / kGroup), NS);
  paged_decode_split_kernel<T, D><<<grid, Gm::THREADS, Gm::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      lengths, part, H, KVH, bs, MB, NS, scale);
  return merge_after<T>(cudaGetLastError(), part, o, m, l, S, H, D, NS, stream, launched);
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

// The int8 kernel's launch: as launch_d, with int8 pages and their scales.
template <typename T, int D>
cudaError_t launch_d8(const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* tables, const int* lengths, void* o, float* m,
                      float* l, float* part, int S, int H, int KVH, int bs, int MB, int NS,
                      float scale, cudaStream_t stream, int* launched) {
  using G8 = Geo8<T, D>;
  cudaError_t err = allow_smem<paged_decode_int8_split_kernel<T, D>>(G8::SMEM);
  if (err != cudaSuccess) return err;
  const int G = H / KVH;
  dim3 grid(S, KVH * ((G + kGroup - 1) / kGroup), NS);
  const int vec_scales = bs % 4 == 0 && reinterpret_cast<uintptr_t>(ks) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(vs) % 16 == 0;
  paged_decode_int8_split_kernel<T, D><<<grid, G8::THREADS, G8::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      ks, vs, tables, lengths, part, H, KVH, bs, MB, NS, scale, vec_scales);
  return merge_after<T>(cudaGetLastError(), part, o, m, l, S, H, D, NS, stream, launched);
}

// The int8 split kernel's resident blocks per SM, as the runtime computes
// them from its registers, threads and shared memory
template <typename T, int D>
cudaError_t blocks_d8(int* blocks) {
  using G8 = Geo8<T, D>;
  cudaError_t err = allow_smem<paged_decode_int8_split_kernel<T, D>>(G8::SMEM);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, paged_decode_int8_split_kernel<T, D>, G8::THREADS, G8::SMEM);
}

template <typename T>
cudaError_t blocks_t8(int D, int* blocks) {
  switch (D) {
    case 16: return blocks_d8<T, 16>(blocks);
    case 32: return blocks_d8<T, 32>(blocks);
    case 64: return blocks_d8<T, 64>(blocks);
    case 128: return blocks_d8<T, 128>(blocks);
    case 256: return blocks_d8<T, 256>(blocks);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t8(int D, const void* q, const void* k, const void* v, const float* ks,
                      const float* vs, const int* tables, const int* lengths, void* o, float* m,
                      float* l, float* part, int S, int H, int KVH, int bs, int MB, int NS,
                      float scale, cudaStream_t stream, int* launched) {
#define PDA8_CASE(DD)                                                                     \
  case DD:                                                                                \
    return launch_d8<T, DD>(q, k, v, ks, vs, tables, lengths, o, m, l, part, S, H, KVH, bs, \
                            MB, NS, scale, stream, launched);
  switch (D) {
    PDA8_CASE(16)
    PDA8_CASE(32)
    PDA8_CASE(64)
    PDA8_CASE(128)
    PDA8_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef PDA8_CASE
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

// paged_decode_attention_launch over int8 pages: k_cache / v_cache [N, bs,
// KVH, D] int8, k_scale / v_scale [N, bs] fp32. dtype is the compute dtype
// (q's and o's: 0 = float32, 1 = bfloat16), in which p · v_scale is
// rounded for P·V. part, launched and the return value as
// paged_decode_attention_launch:
// launched[0] counts paged_decode_int8_split_kernel, [1] the merge kernel.
extern "C" int paged_decode_attention_int8_launch(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* tables, const void* lengths, void* o, void* m_out,
    void* l_out, void* part, int S, int H, int KVH, int D, int bs, int MB, int num_splits,
    float scale, int dtype, void* stream, int* launched) {
  if (S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || bs <= 0 || MB <= 0 || num_splits <= 0 || part == nullptr ||
      launched == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lengths);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  float* pt = static_cast<float*>(part);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_t8<float>(D, q, k_cache, v_cache, ks, vs, tb, ln, o, m, l, pt, S, H, KVH, bs,
                           MB, num_splits, scale, st, launched);
  } else if (dtype == 1) {
    err = launch_t8<__nv_bfloat16>(D, q, k_cache, v_cache, ks, vs, tb, ln, o, m, l, pt, S, H,
                                   KVH, bs, MB, num_splits, scale, st, launched);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The resident blocks per SM of paged_decode_attention_int8_launch's split
// kernel for head_dim D and compute dtype (0 = float32, 1 = bfloat16), on
// the current device, into *blocks; the wrapper plans its split count from
// it. Returns the runtime's error, 0 on success.
extern "C" int paged_decode_int8_blocks_per_sm(int D, int dtype, int* blocks) {
  if (blocks == nullptr) return (int)cudaErrorInvalidValue;
  *blocks = 0;
  if (dtype == 0) return (int)blocks_t8<float>(D, blocks);
  if (dtype == 1) return (int)blocks_t8<__nv_bfloat16>(D, blocks);
  return (int)cudaErrorInvalidValue;
}
