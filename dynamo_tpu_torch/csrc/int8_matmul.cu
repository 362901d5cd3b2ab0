// Int8-weight x bf16-activation matmul (W8A16) for Hopper (sm_90a), plain C interface.
//
// Computes the weight-only int8 matmul of dynamo_tpu/models/llama.py (matw :255,
// the int8 branch of lm_head :456), which has no Pallas kernel: on the TPU, XLA
// fuses the int8 -> bf16 convert into the dot's operand load. These kernels are
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
// Three designs behind one entry. The wrapper (ops/int8_matmul.py,
// plan_int8) chooses one, and its grid, from M, N, K and the expert count
// alone, never from data, so a CUDA graph can capture any call:
//
// A. w8a16_tile_kernel, for prefill chunks (M from a threshold set on the
//    card; an "int8-all" chunk is 8 lanes x 128 tokens = 1024 rows). What
//    bounds it: operations. 2·M operations per weight byte is far above the
//    H100's ~295 per byte of HBM, so the least time is 2·M·N·K over the bf16
//    tensor-core peak, which only wgmma reaches. A block owns an output tile
//    of 128 rows of x by BN = 256, 224 or 128 weight rows (the planner takes
//    the width whose last round of tiles leaves the fewest SMs idle), so each
//    weight byte is read once per 128 rows of x; the grid walks the rows of
//    x fastest, so the blocks that run together share their weight tiles in
//    L2 and HBM streams the weight about once.
//    - A 5-stage ring in shared memory, filled by TMA: the x tile [128 x 64]
//      bf16 with the 128-byte swizzle that wgmma reads, and the weight tile
//      [BN x 64] int8 as it is stored. One mbarrier per stage counts the
//      bytes in. Thread 0 refills a stage as soon as every thread is done
//      with it, three k-blocks ahead of the one being dequantized.
//    - The weight is the B operand, dequantized into shared memory: the 256
//      threads turn the int8 tile into a bf16 tile in the 128-byte-swizzled
//      K-major layout of wgmma's B. Two such tiles alternate: the threads
//      dequantize k-block i+1 while the tensor cores run k-block i, fence the
//      generic-proxy writes to the async proxy and meet at a barrier. Two
//      k-blocks are queued on the tensor cores at a time (wgmma.wait_group
//      1), so they keep running while the threads meet. Every thread
//      converts the same number of pieces (BN = 224 converts 256 rows, 32 of
//      them junk): a per-thread branch in that code makes ptxas serialize
//      the wgmma pipeline (warning C7515).
//    - Two warpgroups each issue wgmma.mma_async.m64nBNk16 over their 64
//      rows of x (A from shared memory) and all BN weight rows, four per
//      64-wide k-block, into BN / 2 fp32 registers per thread.
//    - Why the weight is B in shared memory and not the register-fed A: a
//      register-fed weight wants each thread's 16 bytes contiguous, which
//      needs the k-permutation of path B below, and x in shared memory would
//      then need the same permutation at 4-byte granularity, which TMA cannot
//      write. With the weight as B the tile is dequantized once per block and
//      read by both warpgroups. The price is shared-memory traffic: wgmma's
//      operand reads, the TMA writes and the bf16 round trip come to about
//      160 bytes per clock at the tensor cores' peak, against ~128.
//    - No producer warp: the consumers meet at a barrier every k-block anyway
//      (both read the dequantized tile), and that is where the refill is
//      issued. A producer warpgroup that dequantized on its own (4 warps
//      instead of 8) measured slower on the card.
//    - Epilogue from the registers: round to bf16, scale by s[n] in fp32,
//      round to the output dtype, masking rows of x past M (TMA zero-fills
//      them on the way in) and weight rows past N.
//
// B. w8a16_splitk_kernel, for decode (small M). What bounds it: bytes. At
//    decode 2·M operations per weight byte is far below ~295, so the least
//    time is N·K weight bytes over the HBM rate, and the design keeps the
//    memory system busy and does little per byte:
//    - A planned grid of tiles of weight rows, splits of K and tiles of
//      lanes. A block streams at about 11 GB/s on the card whatever its
//      ring's depth (a sweep of 4 to 16 stages), so the grid must have a
//      block on every SM: blocks of 64 weight rows (4 row groups of 16)
//      where N gives enough of them, else blocks of 16 rows or split-K,
//      whichever the planner finds cheaper, each split at least 4 chunks of
//      K long.
//    - A 4-stage cp.async ring: each block streams its weight slab [rows x
//      K/splits] and the matching columns of x through shared memory, a
//      stage (256 K-columns for 64-row blocks, 512 for 16-row ones) landing
//      while the eight warps run mma.sync on an earlier one; one barrier per
//      stage. x is read once per block, through L1, which the blocks of an
//      SM share (for 16-row blocks at M = 8 x is as many bytes as the
//      weights: from L1, 4096->4096 ran 18% faster on the card). Rows are
//      padded by 16 bytes so the fragment loads below hit every bank once.
//    - Tensor cores with A and B swapped. mma.sync.m16n8k16 (bf16 in, fp32
//      accumulate) takes 16 weight rows (a row group) as its M side and 8
//      lanes of x as its N side, so M = 8 pads nothing. The 8 / RG warps of
//      a row group each take their chunks of every stage; their sums meet
//      in shared memory in a fixed order.
//    - A k-permutation that gives every thread 16 contiguous bytes. Within a
//      64-wide chunk of K, thread t of a quad owns bytes [16t, 16t+16) of its
//      two rows (g and g+8). In mma step j it feeds bytes 16t+4j..+3 into the
//      k slots {2t, 2t+1, 2t+8, 2t+9} that the fragment layout gives it, and
//      reads x at the same four k; a sum over k does not care about the
//      order, and A and B use the same map.
//    - Each 64-wide chunk of K is summed by its four mma steps into a fresh
//      fp32 fragment, which an fp32 add on the CUDA cores then carries into
//      the running sum. The tensor core's fp32 accumulation truncates where
//      an fp32 add rounds, so hundreds of steps into one accumulator lose
//      toward zero: at llama3-70b's K = 28672 (M = 8) 0.42% of the outputs
//      differed from the fp64-summed product's rounding, biased toward zero
//      (fp32 plain: 0.03%); summed per chunk, 0.023%, unbiased, at no
//      measured cost (chip_ab.py, PERF.md).
//    - Deterministic split-K without a workspace: the splits of a tile run as
//      one thread block cluster. Each keeps its fp32 sums in its own shared
//      memory; after a cluster barrier, split 0 reads them all through
//      distributed shared memory in split order and applies the two
//      roundings. No float atomics: two calls give the same bits, and so
//      does a CUDA graph replay. One split writes out directly.
//
// C. w8a16_expert_tile_kernel, for an expert stack's prefill (rows per expert
//    C from a threshold set on the card; a 1024-row chunk gives each of
//    mixtral's 8 experts C = 512). What bounds it: operations, as path A.
//    Path A keeps the weight as wgmma's B and pays in shared-memory traffic
//    (its own note above); here the roles swap:
//    - The weight is wgmma's A, fed from registers; x is B, straight from
//      its TMA tile (the 128-byte-swizzled K-major tile of path A). A block
//      owns 128 weight rows by BT tokens; each of two consumer warpgroups
//      issues wgmma.mma_async.m64nBTk16 over its own 64 weight rows, so each
//      dequantizes only the rows it multiplies, once, in registers. A
//      64-wide k-block moves about 115 bytes of shared memory per clock at
//      the tensor cores' peak (x read by both warpgroups, the int8 tile read
//      once, the TMA writes) against ~160 for path A.
//    - The fragment bytes: TMA lands the int8 tile with the 64-byte swizzle,
//      so the 4-byte loads of a warp hit 16 banks once; thread (g, t) loads
//      the words holding k = 2t.. and 2t + 8.. of its rows' 16-byte chunk,
//      and one prmt packs the two byte pairs for the exact conversion
//      (below) into the fragment's k slots {2t, 2t+1, 2t+8, 2t+9}. No
//      permutation of x or of the stored weights is needed. What holds the
//      kernel on the card (its clock under load, read beside its times by
//      chip_smoke.py) is in PERF.md.
//    - Token tiles as narrow as the capacity: BT is 16, 32, 64, 136 or 256
//      (wgmma's N in steps of 8; a width that is not a power of two runs as
//      pieces of 128, 64, ..., 8 tokens, each piece with the fragment layout
//      of one wide instruction). The planner takes the narrowest that
//      covers C in the fewest tiles: C = 130 is one tile of 136, not
//      128 + 2.
//    - A producer warpgroup (one thread issues the TMA loads; setmaxnreg
//      gives its registers to the consumers) and a ring of full and empty
//      mbarriers. The ring holds no bf16 tiles, so it is 5 stages deep at
//      BT = 256 and up to 8 for narrow tiles. Each consumer keeps two
//      k-blocks of wgmma in flight with their A fragments in two register
//      sets, and frees a stage when the k-block that read it is done.
//    - Grid (token tiles, weight tiles, experts): the token tiles of a
//      weight tile are neighbours, so they run together and the second
//      reads the weight tile from L2.
//    - Epilogue: the tile comes out transposed ([weight rows x tokens]), so
//      it is staged through the idle ring as [tokens x weight rows] (round
//      to bf16, scale by s[n] in fp32, round to the output dtype) and
//      written in whole 16-byte pieces of output rows, masked at C and N.
//      No atomics: two calls and a graph replay give the same bits.
//
// int8 -> bf16 without a conversion instruction (all three designs): a byte's low
// 7 bits placed under the bf16 exponent of 128 (prmt) are the bf16 128 + low7;
// one bf16x2 subtract of 128, or of 256 where the byte's sign bit is set (the
// sign bits placed the same way), gives the byte's value exactly, two bytes
// per instruction.
//
// fp32 x (the tests) has no exact tensor-core path (TF32 keeps ~3 digits), so
// it runs a CUDA-core kernel, w8f32_kernel: one warp per weight row, 16-byte
// loads.
//
// Expert stacks (the MoE layer's w_gate, w_up and w_down, ops/moe.py): one
// launch computes E independent products x[e] @ q[e].T of one stack, with
// the expert axis in the grid: z of the tile kernels (A and C), folded into
// z (expert major, lane tile minor) of the split-K kernel, whose clusters
// span only the split axis y, and z of the CUDA-core kernel. It replaces XLA's fused
// int8 convert-einsum of dynamo_tpu/ops/moe.py:70 (_expert_mat), again no
// Pallas kernel. The tile kernels' tensor maps span all experts' rows; a
// tile of expert e starts at row e·M of x and e·N of q, and the rows it reads
// past M or N belong to expert e + 1 (or are TMA's zero fill past the last)
// and reach no store: every store is masked at M and N. The wrapper plans
// the launch from (E, M, N, K), so a stack of E experts at M = 4 takes one
// split where one product would take several.
//
// Unsupported shapes are refused: N must be a multiple of 16 and K of 64
// (every llama-family width in the presets is a multiple of 128), and the
// pointers 16-byte aligned; the wrapper checks and raises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;  // K per chunk: 16 bytes per thread per weight row
constexpr int kLanes = 8;   // x rows per lane tile: the mma's N side (path B)

// -- shared helpers ----------------------------------------------------------------

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

__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// four int8 (bytes 0..3 of w) -> bf16 pairs lo = (b0, b1), hi = (b2, b3),
// exactly: each byte's low 7 bits under the bf16 exponent of 128 (prmt) is
// 128 + low7; minus 128, or 256 where the byte's sign bit is set (prmt of
// the sign bits under the same exponent), it is the byte's value
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t low7 = w & 0x7F7F7F7Fu, sign = w & 0x80808080u;
  lo = sub_bf16x2(__byte_perm(low7, 0x43434343u, 0x5140), __byte_perm(sign, 0x43434343u, 0x5140));
  hi = sub_bf16x2(__byte_perm(low7, 0x43434343u, 0x7362), __byte_perm(sign, 0x43434343u, 0x7362));
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

__device__ __forceinline__ float round_bf16(float y) {
  return __bfloat162float(__float2bfloat16_rn(y));
}

// two neighbouring outputs (n, n + 1) of one row
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared: streamed past L1 (the weights, read once) or
// through it (x, which every block of an SM reads)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// -- path A: wgmma tiles for prefill chunks -----------------------------------------

constexpr int kBM = 128;                     // rows of x per block: 2 warpgroups x 64
constexpr int kBK = 64;                      // K per stage: one 128-byte swizzle row of bf16
constexpr int kStagesA = 5;
constexpr int kXTile = kBM * kBK * 2;        // 16 KB bf16
constexpr int kThreadsA = 256;

template <int BN>  // weight rows per block: wgmma's N (128, 224 or 256)
struct GeoA {
  // rows dequantized: BN up to a multiple of 64, so every thread converts
  // the same number of pieces (a branch there would serialize wgmma); the
  // rows past BN are junk that wgmma never reads
  static constexpr int DEQ_ROWS = (BN + 63) / 64 * 64;
  static constexpr int QTILE = BN * kBK;            // int8
  static constexpr int BTILE = DEQ_ROWS * kBK * 2;  // dequantized bf16
  static constexpr int QOFF = kStagesA * kXTile;
  static constexpr int BOFF = QOFF + kStagesA * QTILE;
  static constexpr int BAROFF = BOFF + 2 * BTILE;
  static constexpr int SMEM = BAROFF + 8 * kStagesA + 1024;  // + room to align the base to 1024
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart (SBO), the tile 1024-byte aligned; a
// 16-wide k step inside the row is a 32-byte move of the start address
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A(64 x 16, desc a) · B(16 x BN, desc b), both K-major in shared memory,
// d: BN / 2 fp32 per thread
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<224>(float (&d)[112], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %114, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111},"
      " %112, %113, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// the int8 weight tile of a stage [BN x 64] -> bf16 [BN x 64] in the
// swizzled K-major layout: thread i takes 16 bytes (row r, 16-byte column c)
// at a time; a warp reads 512 contiguous bytes and writes every bank once
template <int BN>
__device__ __forceinline__ void dequant_tile(const uint8_t* qs, uint8_t* bs, int tid) {
#pragma unroll
  for (int p = 0; p < GeoA<BN>::DEQ_ROWS * kBK / 16 / kThreadsA; ++p) {
    const int item = tid + kThreadsA * p, r = item >> 2, c = item & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(qs + r * kBK + c * 16);
    uint4 lo, hi;  // bf16 of bytes 0..7 and 8..15: 16-byte columns 2c and 2c + 1
    i8x4_to_bf16x4(v.x, lo.x, lo.y);
    i8x4_to_bf16x4(v.y, lo.z, lo.w);
    i8x4_to_bf16x4(v.z, hi.x, hi.y);
    i8x4_to_bf16x4(v.w, hi.z, hi.w);
    uint8_t* row = bs + r * (kBK * 2);
    *reinterpret_cast<uint4*>(row + (((2 * c) ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
  }
}

// k-block kb of x and of the weight into stage st (thread 0 only): the
// stage's mbarrier expects both tiles' bytes
template <int BN>
__device__ __forceinline__ void load_stage_a(uint32_t base, int st, int kb, const CUtensorMap* tmx,
                                             const CUtensorMap* tmq, int m0, int n0) {
  using G = GeoA<BN>;
  const uint32_t bar = base + G::BAROFF + 8 * st;
  mbar_expect_tx(bar, kXTile + G::QTILE);
  tma_load_2d(base + st * kXTile, tmx, kb * kBK, m0, bar);
  tma_load_2d(base + G::QOFF + st * G::QTILE, tmq, kb * kBK, n0, bar);
}

// grid (ceil(M / 128), ceil(N / BN), experts), 256 threads, GeoA<BN>::SMEM
// bytes. The tensor maps span the experts' rows ([experts·M, K] and
// [experts·N, K]); expert e's tiles start at row e·M of x and e·N of q, and
// the rows a tile reads past M or N (the next expert's) reach no store.
template <int BN, typename TO>
__global__ void __launch_bounds__(kThreadsA, 1)
    w8a16_tile_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmq, const float* __restrict__ s,
                      TO* __restrict__ out, int M, int N, int K) {
  using G = GeoA<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the 128-byte swizzle wants 1024-byte tiles
  uint8_t* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN, e = blockIdx.z;
  s += (size_t)e * N;
  out += (size_t)e * M * N;
  const int xrow = e * M + m0, qrow = e * N + n0;  // this tile's first rows in the maps
  const int nk = K / kBK;
  const uint32_t bars = base + G::BAROFF;  // one mbarrier per stage, 8 bytes each
  if (tid == 0) {
    for (int st = 0; st < kStagesA; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int st = 0; st < kStagesA && st < nk; ++st) {
      load_stage_a<BN>(base, st, st, &tmx, &tmq, xrow, qrow);
    }
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  mbar_wait(bars, 0);
  dequant_tile<BN>(sm + G::QOFF, sm + G::BOFF, tid);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int kb = 0; kb < nk; ++kb) {
    const int st = kb % kStagesA, buf = kb & 1;
    // k-block kb on the tensor cores, queued behind k-block kb - 1: this
    // warpgroup's 64 rows of x, all BN weight rows
    const uint32_t a = base + st * kXTile + wg * (64 * kBK * 2);
    const uint32_t b = base + G::BOFF + buf * G::BTILE;
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      wgmma_bf16<BN>(acc, desc_sw128(a + 32 * j), desc_sw128(b + 32 * j));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // k-block kb - 1 done
    fence_regs(acc);
    // both warpgroups are done with k-block kb - 1: its stage and its bf16 tile are free
    __syncthreads();
    if (tid == 0 && kb >= 1 && kb - 1 + kStagesA < nk) {
      load_stage_a<BN>(base, (kb - 1) % kStagesA, kb - 1 + kStagesA, &tmx, &tmq, xrow, qrow);
    }
    // while k-block kb runs: dequantize k-block kb + 1 into the other bf16 tile
    if (kb + 1 < nk) {
      const int st1 = (kb + 1) % kStagesA;
      mbar_wait(bars + 8 * st1, ((kb + 1) / kStagesA) & 1);
      dequant_tile<BN>(sm + G::QOFF + st1 * G::QTILE, sm + G::BOFF + (buf ^ 1) * G::BTILE, tid);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // k-block kb + 1's bf16 tile is visible to wgmma
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);

  // epilogue: acc[4j + 2h + e] is row 16·warp + g + 8h of this warpgroup's
  // 64, column (weight row) 8j + 2t + e
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int mr = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n < N) {
      const float2 sc = *reinterpret_cast<const float2*>(s + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mr + 8 * h;
        if (m < M) {
          store2(out + (size_t)m * N + n, round_bf16(acc[4 * j + 2 * h]) * sc.x,
                 round_bf16(acc[4 * j + 2 * h + 1]) * sc.y);
        }
      }
    }
  }
}

// -- path B: split-K over a shared-memory ring for decode -----------------------------

constexpr int kWarpsB = 8;
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kStagesB = 4;     // stages of the ring
constexpr int kMaxSplits = 16;  // a split-K cluster: above 8, a non-portable cluster size
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may have

// RG row groups of 16 weight rows (one mma's M side) per block, 4 or 1; the
// 8 warps are RG row groups x KW parts of every stage; MT lane tiles of 8
template <int RG, int MT>
struct GeoB {
  static constexpr int ROWS = 16 * RG;
  static constexpr int KW = kWarpsB / RG;
  static constexpr int CHUNKS = KW < 4 ? 4 : KW;      // 64-wide chunks of K per stage
  static constexpr int WPITCH = CHUNKS * kChunk + 16;      // bytes per weight row in a stage
  static constexpr int XPITCH = CHUNKS * kChunk * 2 + 16;  // bytes per x row in a stage
  static constexpr int WBYTES = ROWS * WPITCH;
  static constexpr int STAGE = WBYTES + MT * kLanes * XPITCH;  // bytes per ring stage
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the float at shared address `local` in the shared memory of cluster block `rank`
__device__ __forceinline__ float ld_cluster(uint32_t local, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// grid (ceil(N / (16·RG)), splits, experts · ceil(M / (8·MT))), 256
// threads, 4·GeoB<RG, MT>::STAGE bytes; a cluster of the `splits` blocks of
// a tile (the cluster spans y only: never two experts). z is the expert
// (major) and the lane tile (minor); expert e's x, q, s and out start
// e·M·K, e·N·K, e·N and e·M·N elements in. Split i takes 64-wide chunks
// [i·C/splits, (i+1)·C/splits) of K. Warp w computes row group w % RG over
// part w / RG of every stage's chunks.
template <int RG, int MT, typename TO>
__global__ void __launch_bounds__(kThreadsB)
    w8a16_splitk_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                        const float* __restrict__ s, TO* __restrict__ out, int M, int N, int K,
                        int splits) {  // x, q, s, out: the first expert's
  using G = GeoB<RG, MT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rg = warp % RG, part_k = warp / RG;
  const int mtiles = (M + MT * kLanes - 1) / (MT * kLanes);
  const int e = blockIdx.z / mtiles;
  const int n0 = blockIdx.x * G::ROWS, split = blockIdx.y;
  const int m0 = (blockIdx.z - e * mtiles) * (MT * kLanes);
  x += (size_t)e * M * K;
  q += (size_t)e * N * K;
  s += (size_t)e * N;
  out += (size_t)e * M * N;
  const int rows = min(G::ROWS, N - n0), lanes = min(MT * kLanes, M - m0);
  const int chunks = K / kChunk;
  const int c0 = (int)((long long)split * chunks / splits);
  const int c1 = (int)((long long)(split + 1) * chunks / splits);
  const int stages = (c1 - c0 + G::CHUNKS - 1) / G::CHUNKS;

  // stage st of the slab (weights, then x) into ring slot st % kStagesB,
  // 16 bytes per copy, consecutive threads on consecutive bytes of a row; a
  // stage past the slab commits an empty group, so wait_group counts hold
  auto issue = [&](int st) {
    if (st < stages) {
      uint8_t* buf = smem + (st % kStagesB) * G::STAGE;
      const int cb = c0 + st * G::CHUNKS, live16 = min(G::CHUNKS, c1 - cb) * (kChunk / 16);
      constexpr int WG = G::CHUNKS * kChunk / 16;      // 16-byte pieces per weight row
      constexpr int XG = G::CHUNKS * kChunk * 2 / 16;  // per x row
#pragma unroll
      for (int i = tid; i < G::ROWS * WG; i += kThreadsB) {
        const int r = i / WG, c = i % WG;
        if (r < rows && c < live16) {
          cp_async16(buf + r * G::WPITCH + c * 16, q + (size_t)(n0 + r) * K + cb * kChunk + c * 16);
        }
      }
      uint8_t* xb = buf + G::WBYTES;
#pragma unroll
      for (int i = tid; i < MT * kLanes * XG; i += kThreadsB) {
        const int r = i / XG, c = i % XG;
        if (r < lanes && c < 2 * live16) {
          cp_async16_l1(xb + r * G::XPITCH + c * 16,
                        x + (size_t)(m0 + r) * K + cb * kChunk + c * 8);
        }
      }
    }
    cp_async_commit();
  };

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const bool live = rg * 16 < rows;  // this warp's 16 weight rows exist
  for (int st = 0; st < kStagesB - 1; ++st) issue(st);
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kStagesB - 2>();  // this thread's copies of stage st have landed
    __syncthreads();                // everyone's have, and stage st - 1 is done with
    issue(st + kStagesB - 1);       // into the slot that stage st - 1 left
    const uint8_t* buf = smem + (st % kStagesB) * G::STAGE;
#pragma unroll
    for (int h = 0; h < G::CHUNKS / G::KW; ++h) {
      const int cc = part_k * (G::CHUNKS / G::KW) + h;  // this warp's chunks of the stage
      if (!live || c0 + st * G::CHUNKS + cc >= c1) continue;
      const uint8_t* wa = buf + (rg * 16 + g) * G::WPITCH + cc * kChunk + 16 * t;
      const uint4 va = *reinterpret_cast<const uint4*>(wa);
      const uint4 vb = *reinterpret_cast<const uint4*>(wa + 8 * G::WPITCH);
      const uint8_t* xr = buf + G::WBYTES + g * G::XPITCH + cc * kChunk * 2 + 32 * t;
      uint4 xv[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i * kLanes + g < lanes) {
          const uint4* p = reinterpret_cast<const uint4*>(xr + i * kLanes * G::XPITCH);
          xv[i][0] = p[0];
          xv[i][1] = p[1];
        } else {
          xv[i][0] = xv[i][1] = make_uint4(0, 0, 0, 0);
        }
      }
      // this chunk's 64 products per output on the tensor cores, from 0
      float chunk[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) chunk[i][0] = chunk[i][1] = chunk[i][2] = chunk[i][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // A: rows g (a0, a2) and g + 8 (a1, a3), k slots {2t, 2t+1} and {2t+8, 2t+9}
        uint32_t a[4];
        i8x4_to_bf16x4(word(va, j), a[0], a[2]);
        i8x4_to_bf16x4(word(vb, j), a[1], a[3]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // B: x at the same four k, two bf16 per 32-bit word
          const uint4& hx = xv[i][j >> 1];
          const int w = (j & 1) * 2;
          mma_bf16(chunk[i], a, word(hx, w), word(hx, w + 1));
        }
      }
      // ... carried into the running sum by fp32 adds (the note above)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += chunk[i][e];
      }
    }
  }

  // the KW parts of each row group meet in shared memory (the ring is
  // drained): parts 1.. store, part 0 adds them in order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  // then this split's sums, [8·MT lanes, ROWS]
  float* part = red + (G::KW - 1) * RG * MT * 4 * 32;
  if (part_k > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[((((part_k - 1) * RG + rg) * MT + i) * 4 + e) * 32 + lane] = acc[i][e];
      }
    }
  }
  __syncthreads();
  // C fragment of lane tile i: weight rows g, g + 8 of the row group; lanes 2t, 2t + 1
  if (part_k == 0 && live) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y = acc[i][e];
#pragma unroll
        for (int h = 1; h < G::KW; ++h) {
          y += red[((((h - 1) * RG + rg) * MT + i) * 4 + e) * 32 + lane];
        }
        const int m = i * kLanes + 2 * t + (e & 1), n = rg * 16 + g + 8 * (e >> 1);
        if (splits == 1) {
          if (m < lanes) {
            out[(size_t)(m0 + m) * N + n0 + n] = from_f<TO>(round_bf16(y) * s[n0 + n]);
          }
        } else {
          part[m * G::ROWS + n] = y;
        }
      }
    }
  }
  if (splits == 1) return;
  // split-K: the tile's splits are one thread block cluster; split 0 reads
  // every split's sums from its shared memory, in split order
  cluster_sync();
  if (cluster_rank() == 0) {
    for (int e = tid; e < lanes * rows; e += kThreadsB) {
      const int m = e / rows, n = e - m * rows;
      const uint32_t local = smem_u32(part + m * G::ROWS + n);
      float y = 0.f;
      for (int i = 0; i < splits; ++i) y += ld_cluster(local, i);
      out[(size_t)(m0 + m) * N + n0 + n] = from_f<TO>(round_bf16(y) * s[n0 + n]);
    }
  }
  cluster_sync();  // no block leaves while split 0 may still read its shared memory
}

// -- path C: expert tiles with the weight as wgmma's register-fed A ---------------------

constexpr int kWRows = 128;                 // weight rows per block: 2 consumer warpgroups x 64
constexpr int kThreadsC = 384;              // 2 consumer warpgroups, 1 producer warpgroup
constexpr int kQTileC = kWRows * kBK;       // the int8 weight tile of a stage, 8 KB
constexpr int kRingC = 200 * 1024;          // the ring's bytes, at most
constexpr int kMaxStagesC = 8;

// BT tokens per block (wgmma's N); the staging tile of the epilogue reuses
// the ring: [BT tokens x 128 weight rows] of TO, each row padded by 16 bytes
template <int BT, typename TO>
struct GeoC {
  static constexpr int XTILE = BT * kBK * 2;  // x: BT rows x 64 bf16, 128-byte swizzle
  static constexpr int STAGE = XTILE + kQTileC;
  static constexpr int STAGES = kRingC / STAGE < kMaxStagesC ? kRingC / STAGE : kMaxStagesC;
  static constexpr int QOFF = STAGES * XTILE;  // the q tiles after the x tiles
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PITCH = kWRows + 16 / (int)sizeof(TO);  // staging row, elements
  static constexpr int BAROFF = RING;  // full[STAGES], then empty[STAGES]
  static constexpr int SMEM = BAROFF + 16 * STAGES + 1024;  // + room to align the base to 1024
  static_assert(BT % 8 == 0 && BT >= 8 && BT <= 256, "wgmma's N");
  static_assert(BT * PITCH * (int)sizeof(TO) <= RING, "the staging tile fits the ring");
};

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"  // scale-d: d += a·b
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[BT / 2] += A(64 x 16, registers) · B(16 x BT), B K-major in shared memory
// at x with the 128-byte swizzle: pieces of 256, 128, ..., 8 tokens, each
// token piece a 1024-byte-aligned run of 8-row swizzle atoms. Every piece
// keeps the fragment layout of one m64nBTk16: d[4j + 2h + e] is weight row
// 16·warp + g + 8h, token 8j + 2t + e
template <int BT, int OFF = 0>
__device__ __forceinline__ void wgmma_tokens(float (&d)[BT / 2], const uint32_t (&a)[4],
                                             uint32_t x) {
  constexpr int REM = BT - OFF;
  if constexpr (REM > 0) {
    constexpr int P = REM >= 256 ? 256 : REM >= 128 ? 128 : REM >= 64 ? 64
                      : REM >= 32 ? 32 : REM >= 16 ? 16 : 8;
    wgmma_rs<P>(d + OFF / 2, a, desc_sw128(x + OFF * kBK * 2));
    wgmma_tokens<BT, OFF + P>(d, a, x);
  }
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i]) :: "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// one 64-wide k-block of a consumer warpgroup: wait for its stage, gather
// this thread's A fragments of its two weight rows from the int8 tile into
// `cur`, queue the four k16 steps behind the previous k-block's, then wait
// for the previous k-block (whose fragments are `prev`) and free its stage.
// The tile landed with TMA's 64-byte swizzle (16-byte chunk c of row r at
// c ^ ((r >> 1) & 3)): a warp's 4-byte loads of one k16 step hit 16 words in
// 16 banks. Thread (g, t) takes the words holding k = 16j + 2t.. and 16j +
// 2t + 8.. of its rows; one prmt packs their two bytes each, and the exact
// conversion turns them into the fragment's pairs {2t, 2t+1}, {2t+8, 2t+9}.
template <int BT, int STAGES>
__device__ __forceinline__ void expert_kblock(float (&acc)[BT / 2], uint32_t (&cur)[4][4],
                                              uint32_t (&prev)[4][4], int kb, uint32_t base,
                                              const uint8_t* qtiles, uint32_t full,
                                              uint32_t empty, int sw, uint32_t sel, int lane) {
  const int st = kb % STAGES;
  mbar_wait(full + 8 * st, (kb / STAGES) & 1);
  const uint8_t* qt = qtiles + st * kQTileC;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = (j ^ sw) << 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r0 (a0, a2) and r0 + 8 (a1, a3)
      const uint8_t* p = qt + h * 8 * kBK + c;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 8);
      i8x4_to_bf16x4(__byte_perm(w0, w1, sel), cur[j][h], cur[j][h + 2]);
    }
  }
  fence_a(cur);
  fence_regs(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint32_t x = base + st * (BT * kBK * 2);  // the stage's x tile
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) wgmma_tokens<BT>(acc, cur[j], x + 32 * j);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // k-block kb - 1 done
  fence_regs(acc);
  fence_a(prev);  // live until here: the k-block kb - 1 read them
  if (kb >= 1 && lane == 0) mbar_arrive(empty + 8 * ((kb - 1) % STAGES));
}

// grid (ceil(C / BT), ceil(N / 128), experts), 384 threads, GeoC::SMEM bytes.
// Warpgroups 0 and 1 consume, 64 weight rows each; warpgroup 2 produces
// (one thread issues the TMA loads). The token tiles of a weight tile are
// neighbours in x, so they run together and the second reads the weight
// tile from L2. The tensor maps span the experts' rows ([experts·C, K] and
// [experts·N, K]); expert e's tiles start at row e·C of x and e·N of q, and
// the rows a tile reads past C or N (the next expert's) reach no store.
template <int BT, typename TO>
__global__ void __launch_bounds__(kThreadsC, 1)
    w8a16_expert_tile_kernel(const __grid_constant__ CUtensorMap tmx,
                             const __grid_constant__ CUtensorMap tmq,
                             const float* __restrict__ s, TO* __restrict__ out, int C, int N,
                             int K) {
  using G = GeoC<BT, TO>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzles want 1024-byte tiles
  uint8_t* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int c0 = blockIdx.x * BT, n0 = blockIdx.y * kWRows, e = blockIdx.z;
  const int nk = K / kBK;
  const uint32_t full = base + G::BAROFF, empty = full + 8 * G::STAGES;
  if (tid == 0) {
    for (int st = 0; st < G::STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {  // producer: registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 2 * 128) {
      const int xrow = e * C + c0, qrow = e * N + n0;  // this tile's first rows in the maps
      for (int kb = 0; kb < nk; ++kb) {
        const int st = kb % G::STAGES;
        if (kb >= G::STAGES) mbar_wait(empty + 8 * st, ((kb / G::STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * st, G::STAGE);
        tma_load_2d(base + st * G::XTILE, &tmx, kb * kBK, xrow, full + 8 * st);
        tma_load_2d(base + G::QOFF + st * kQTileC, &tmq, kb * kBK, qrow, full + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's weight rows: r0 and r0 + 8
    const int sw = (g >> 1) & 3;              // both rows' swizzle: (r >> 1) & 3
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;  // the byte pair at k = 2t of a word
    const uint8_t* qtiles = sm + G::QOFF + r0 * kBK + 4 * (t >> 1);
    float acc[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    uint32_t fa[4][4], fb[4][4];  // A fragments of two k-blocks in flight
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[j][i] = fb[j][i] = 0u;
    }
    int kb = 0;
#pragma unroll 1
    for (; kb + 1 < nk; kb += 2) {
      expert_kblock<BT, G::STAGES>(acc, fa, fb, kb, base, qtiles, full, empty, sw, sel, lane);
      expert_kblock<BT, G::STAGES>(acc, fb, fa, kb + 1, base, qtiles, full, empty, sw, sel,
                                   lane);
    }
    if (kb < nk) {
      expert_kblock<BT, G::STAGES>(acc, fa, fb, kb, base, qtiles, full, empty, sw, sel, lane);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    fence_a(fa);
    fence_a(fb);

    // epilogue: both consumer warpgroups are done with the ring, which now
    // stages the tile as [tokens x weight rows]: round to bf16, scale by
    // s[n] in fp32, round to the output dtype; then whole 16-byte pieces of
    // a token's row go out, masked at C and N
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    TO* stage = reinterpret_cast<TO*>(sm);
    s += (size_t)e * N + n0;
    const float sc0 = n0 + r0 < N ? s[r0] : 0.f, sc1 = n0 + r0 + 8 < N ? s[r0 + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        TO* p = stage + (8 * j + 2 * t + i) * G::PITCH + r0;
        p[0] = from_f<TO>(round_bf16(acc[4 * j + i]) * sc0);
        p[8] = from_f<TO>(round_bf16(acc[4 * j + 2 + i]) * sc1);
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    constexpr int VEC = 16 / (int)sizeof(TO), PER_ROW = kWRows / VEC;
    out += ((size_t)e * C + c0) * N + n0;
#pragma unroll 4
    for (int i = tid; i < BT * PER_ROW; i += 256) {
      const int tok = i / PER_ROW, v = i - tok * PER_ROW;
      if (c0 + tok < C && n0 + v * VEC < N) {
        *reinterpret_cast<uint4*>(out + (size_t)tok * N + v * VEC) =
            *reinterpret_cast<const uint4*>(stage + tok * G::PITCH + v * VEC);
      }
    }
  }
}

// -- fp32 activations: CUDA cores ------------------------------------------------------

constexpr int kWarpsF = 8;

// one warp per weight row, each lane 16 k at a time, 8 lanes of x per block
// row; grid (N / 8, ceil(M / 8), experts)
template <typename TO>
__global__ void __launch_bounds__(kWarpsF * 32)
    w8f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ s, TO* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x += (size_t)blockIdx.z * M * K;
  q += (size_t)blockIdx.z * N * K;
  s += (size_t)blockIdx.z * N;
  out += (size_t)blockIdx.z * M * N;
  const int n = blockIdx.x * kWarpsF + warp;
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

// -- host side -----------------------------------------------------------------------

// a kernel attribute set once per device (`done`: a bit per device)
template <typename F>
cudaError_t allow_once(F* kernel, cudaFuncAttribute attr, int value, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev) & 1ull) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

// a kernel's dynamic shared memory above 48 KB must be allowed
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, unsigned long long& done) {
  return allow_once(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes, done);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the runtime
// (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a 2D tensor map of a row-major [rows, K] matrix, boxes of [box_rows, 64]
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                int rows, int K, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename TO>
cudaError_t launch_tile(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                        int K, int E, cudaStream_t stream, int* launched) {
  static unsigned long long smem_done = 0;
  cudaError_t err = allow_smem(w8a16_tile_kernel<BN, TO>, GeoA<BN>::SMEM, smem_done);
  if (err != cudaSuccess) return err;
  CUtensorMap tmx, tmq;
  if (!tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, E * M, K, kBM,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, E * N, K, BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN, E);
  w8a16_tile_kernel<BN, TO><<<grid, kThreadsA, GeoA<BN>::SMEM, stream>>>(
      tmx, tmq, s, static_cast<TO*>(out), M, N, K);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    launched[0] = 1;
    launched[1] = grid.x * grid.y * grid.z;
    launched[2] = 1;
  }
  return err;
}

template <int BT, typename TO>
cudaError_t launch_expert_tile(const void* x, const int8_t* q, const float* s, void* out, int C,
                               int N, int K, int E, cudaStream_t stream, int* launched) {
  using G = GeoC<BT, TO>;
  static unsigned long long smem_done = 0;
  cudaError_t err = allow_smem(w8a16_expert_tile_kernel<BT, TO>, G::SMEM, smem_done);
  if (err != cudaSuccess) return err;
  CUtensorMap tmx, tmq;
  if (!tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, E * C, K, BT,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, E * N, K, kWRows,
                  CU_TENSOR_MAP_SWIZZLE_64B)) {
    return cudaErrorInvalidValue;
  }
  dim3 grid((C + BT - 1) / BT, (N + kWRows - 1) / kWRows, E);
  w8a16_expert_tile_kernel<BT, TO><<<grid, kThreadsC, G::SMEM, stream>>>(
      tmx, tmq, s, static_cast<TO*>(out), C, N, K);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    launched[0] = 4;
    launched[1] = grid.x * grid.y * grid.z;
    launched[2] = 1;
  }
  return err;
}

template <int RG, int MT, typename TO>
cudaError_t launch_splitk(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                          int K, int E, int splits, cudaStream_t stream, int* launched) {
  using G = GeoB<RG, MT>;
  auto kernel = w8a16_splitk_kernel<RG, MT, TO>;
  const int smem = kStagesB * G::STAGE;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static unsigned long long smem_done = 0, cluster_done = 0;
  cudaError_t err = allow_smem(kernel, smem, smem_done);
  if (err == cudaSuccess && splits > 8) {
    err = allow_once(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1, cluster_done);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3((N + G::ROWS - 1) / G::ROWS, splits, E * ((M + MT * kLanes - 1) / (MT * kLanes)));
  cfg.blockDim = dim3(kThreadsB);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;  // the splits of a tile: one cluster
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x), q, s,
                           static_cast<TO*>(out), M, N, K, splits);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) {
    launched[0] = 2;
    launched[1] = cfg.gridDim.x * cfg.gridDim.y * cfg.gridDim.z;
    launched[2] = splits;
  }
  return err;
}

template <int RG, typename TO>
cudaError_t launch_splitk_m(const void* x, const int8_t* q, const float* s, void* out, int M,
                            int N, int K, int E, int splits, cudaStream_t stream, int* launched) {
  if (M <= kLanes) {
    return launch_splitk<RG, 1, TO>(x, q, s, out, M, N, K, E, splits, stream, launched);
  }
  if (M <= 2 * kLanes) {
    return launch_splitk<RG, 2, TO>(x, q, s, out, M, N, K, E, splits, stream, launched);
  }
  if (M <= 4 * kLanes) {
    return launch_splitk<RG, 4, TO>(x, q, s, out, M, N, K, E, splits, stream, launched);
  }
  if constexpr (RG == 1) {  // 16-row blocks with 8 lane tiles: a ring over 227 KB
    return cudaErrorInvalidValue;
  } else {
    return launch_splitk<RG, 8, TO>(x, q, s, out, M, N, K, E, splits, stream, launched);
  }
}

template <typename TO>
cudaError_t launch_out(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                       int K, int E, int x_dtype, int path, int splits, int rows,
                       cudaStream_t stream, int* launched) {
  if (x_dtype == 0) {
    dim3 grid(N / kWarpsF, (M + kLanes - 1) / kLanes, E);
    w8f32_kernel<TO><<<grid, kWarpsF * 32, 0, stream>>>(static_cast<const float*>(x), q, s,
                                                         static_cast<TO*>(out), M, N, K);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) {
      launched[0] = 3;
      launched[1] = grid.x * grid.y * grid.z;
      launched[2] = 1;
    }
    return err;
  }
  if (x_dtype != 1) return cudaErrorInvalidValue;
  if (path == 1) {  // rows: the tile's weight rows
    if (rows == 256) return launch_tile<256, TO>(x, q, s, out, M, N, K, E, stream, launched);
    if (rows == 224) return launch_tile<224, TO>(x, q, s, out, M, N, K, E, stream, launched);
    if (rows == 128) return launch_tile<128, TO>(x, q, s, out, M, N, K, E, stream, launched);
    return cudaErrorInvalidValue;
  }
  if (path == 3) {  // rows: the expert tile kernel's tokens per block (wgmma's N)
    switch (rows) {
      case 256: return launch_expert_tile<256, TO>(x, q, s, out, M, N, K, E, stream, launched);
      case 136: return launch_expert_tile<136, TO>(x, q, s, out, M, N, K, E, stream, launched);
      case 64: return launch_expert_tile<64, TO>(x, q, s, out, M, N, K, E, stream, launched);
      case 32: return launch_expert_tile<32, TO>(x, q, s, out, M, N, K, E, stream, launched);
      case 16: return launch_expert_tile<16, TO>(x, q, s, out, M, N, K, E, stream, launched);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path != 2 || splits < 1 || splits > K / kChunk || splits > kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  if (rows == 64) {
    return launch_splitk_m<4, TO>(x, q, s, out, M, N, K, E, splits, stream, launched);
  }
  if (rows == 16) {
    return launch_splitk_m<1, TO>(x, q, s, out, M, N, K, E, splits, stream, launched);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [E, M, K], q [E, N, K], s [E, N] and out [E, M, N], each contiguous:
// E (experts) independent products of one launch, with the expert axis in
// the grid (E = 1: one product). x_dtype and out_dtype: 0 = float32, 1 =
// bfloat16. path (bf16 x only; fp32 x always runs the CUDA-core kernel): 1 =
// the wgmma tile kernel with tiles of `rows` weight rows (128, 224 or 256), 2
// = the split-K kernel with blocks of `rows` weight rows (64 or 16) and
// `splits` splits of K (1 <= splits <= min(K / 64, 16)), 3 = the expert tile
// kernel with blocks of `rows` rows of x (16, 32, 64, 136 or 256)
// by 128 weight rows.
// launched (3 ints, host memory) reports the launch: [0] the kernel (1 tile,
// 2 split-K, 3 CUDA-core, 4 expert tile, 0 none), [1] its blocks, [2] its
// splits. Returns
// the launch's error (cudaGetLastError() after it), 0 when the kernel
// launched; M = 0 launches nothing and returns 0.
extern "C" int int8_weight_matmul_launch(const void* x, const void* q, const void* s, void* out,
                                         int M, int N, int K, int E, int x_dtype, int out_dtype,
                                         int path, int splits, int rows, void* stream,
                                         int* launched) {
  if (launched == nullptr) return (int)cudaErrorInvalidValue;
  launched[0] = launched[1] = launched[2] = 0;
  if (M == 0) return 0;
  // the grid's z (experts x lane tiles) and the tensor maps' rows (E·M, E·N)
  if (M < 0 || N <= 0 || K <= 0 || E <= 0 || N % 16 != 0 || K % kChunk != 0 ||
      (long long)E * ((M + 7) / 8) > 65535 || (long long)E * M > (1ll << 31) - 1 ||
      (long long)E * N > (1ll << 31) - 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  cudaError_t err;
  if (out_dtype == 0) {
    err = launch_out<float>(x, qp, sp, out, M, N, K, E, x_dtype, path, splits, rows, st,
                            launched);
  } else if (out_dtype == 1) {
    err = launch_out<__nv_bfloat16>(x, qp, sp, out, M, N, K, E, x_dtype, path, splits, rows, st,
                                    launched);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
