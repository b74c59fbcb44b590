// Hopper (sm_90a) building blocks shared by the tensor-core attention
// kernels (flash_attention.cu, flash_attention_bwd.cu): mbarriers, TMA
// loads of 4-d tensor maps, wgmma descriptors and instructions of shape
// m64n64k16 (bf16 in, f32 accumulators), and the host code that encodes
// the tensor maps; for the f32 routes, cp.async copies into padded
// shared tiles, mma.sync m16n8k8 on TF32 and the three-product split
// that keeps f32 accuracy on it.  Everything lives in an anonymous
// namespace: each source that includes it gets its own copy.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hopper {

constexpr int BOX = 64;        // bf16 columns per 128-byte swizzled box
constexpr int ROW_BYTES = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-d tensor map {d, head, seq, batch} into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in 16 B units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo) << 16) |
         (uint64_t(sbo) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_REGS(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define WG_LIST                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) · B (16 x 64): both from shared
// memory, K-major (A rows and B columns have their 16 k values contiguous)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_REGS(d)
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (64 x 64, f32) += A (64 x 16, registers) · B (16 x 64) with B from
// shared memory MN-major (its 64 columns contiguous: transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_REGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// 2^x on the special-function unit (results below 2^-126 flush to 0,
// which no softmax weight beside the row's max of 2^0 can notice)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function), found through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a (batch, seq, heads, D) bf16 tensor as a 4-d map {D, heads, seq, batch}
// read in boxes of 64 columns x `rows` rows of one head, swizzled 128 B;
// columns past D and rows past seq are filled with zeros
int make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
             int D, long long sb, long long ss, long long sh, int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return int(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(BOX), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + int(r);
}

// TMA steps in multiples of 16 bytes from a 16-byte aligned base; a
// dimension of extent 1 is never stepped and gets a stride that is
bool tma_strides(const void* ptr, int batch, int seq, int heads, int D,
                 long long* sb, long long* ss, long long* sh) {
  if (heads == 1) *sh = D;
  if (seq == 1) *ss = (long long)heads * *sh;
  if (batch == 1) *sb = (long long)seq * *ss;
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && *sb % 8 == 0 &&
         *ss % 8 == 0 && *sh % 8 == 0 && *sb > 0 && *ss > 0 && *sh > 0;
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: three TF32 products per product (3xTF32)
// ---------------------------------------------------------------------------
// The shared tiles of the f32 routes hold raw f32 rows, `tile_ld(w)`
// floats apart: w rounded up to 32, plus 4.  A row stride of 4 mod 32
// words makes both fragment reads conflict-free: the scalar ones, where
// thread (g, t) of a warp reads row g, column t (4g + t: 32 banks), and
// the 16-byte ones, where it reads rows 2t and 2t + 1, columns 4g..4g+3
// (8t + 4g: eight distinct 16-byte slots a quarter warp).
constexpr int BLOCK_SMEM = 227 * 1024;  // dynamic shared memory of a block

__host__ __device__ constexpr int tile_ld(int w) {
  return (w + 31) / 32 * 32 + 4;
}

// the 32-column groups of a row w wide, as a kernel is instantiated for
// them: 1-4, 6 or 8
__host__ __device__ constexpr int groups32(int w) {
  return (w + 31) / 32 <= 4 ? (w + 31) / 32 : (w + 31) / 32 <= 6 ? 6 : 8;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + n) of an f32 tensor whose row r starts at src + r·stride
// (w contiguous columns, w a multiple of 4) into the shared tile at dst
// (`ld` floats a row), by the block's threads, 16 bytes a copy (VEC) or 4;
// rows at or past `valid` are filled with zeros.  The columns past w are
// left as they are: no product reads them into a result that is stored.
template <bool VEC>
__device__ __forceinline__ void load_rows(uint32_t dst, int ld,
                                          const float* src, long long stride,
                                          int r0, int n, int valid, int w) {
  constexpr int E = VEC ? 4 : 1;
  const int per = w / E;
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int r = i / per, c = (i - r * per) * E;
    const bool in = r0 + r < valid;
    const float* s = in ? src + (long long)(r0 + r) * stride + c : src;
    const uint32_t d = dst + 4u * uint32_t(r * ld + c);
    if (VEC)
      cp_async16(d, s, in ? 16u : 0u);
    else
      cp_async4(d, s, in ? 4u : 0u);
  }
}

// x = big + small, both TF32 rounded to nearest with ties away (x - big
// is exact in f32): big·big + big·small + small·big leaves about
// 2^-21·|a·b| of a product a·b, where one TF32 rounding leaves 2^-11.
// The rounding is cvt.rna.tf32.f32's, written as half a unit of the 13
// dropped bits added to the magnitude and the bits masked: two integer
// instructions, where ptxas makes the cvt four or five (a guard for NaN
// and infinity, which the sum here turns into infinity: small = x - big
// is then NaN, and so is every product).  `tf32_rna` is the cvt itself;
// `flash_attention_tf32_mismatches` holds the two equal on every finite
// f32.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d (16 x 8, f32) += a (16 x 8) · b (8 x 8), TF32 in.  Fragments (g = lane
// / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0, d1 (g, 2t, 2t + 1), d2, d3
// (g + 8, the same columns)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a·b: mma_tf32 with a C of zeros (no register to clear first)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// The three TF32 products of a · b[j], for N n-tiles of 8: big·big into
// hi[j], big·small and small·big into lo[j] (set, not added to, where
// FIRST).  Two accumulators an n-tile, so half the products wait on no
// other; each kind over all N tiles in turn.
template <int N, bool FIRST = false>
__device__ __forceinline__ void mma3(float (&hi)[N][4], float (&lo)[N][4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[N][2],
                                     const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (FIRST)
      mma_tf32_zero(hi[j], ab, bb[j]);
    else
      mma_tf32(hi[j], ab, bb[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (FIRST)
      mma_tf32_zero(lo[j], ab, bs[j]);
    else
      mma_tf32(lo[j], ab, bs[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(lo[j], as, bb[j]);
}

// the A fragment of rows g and g + 8, columns k0 + t and k0 + t + 4 of a
// shared tile (`ld` floats a row from `x`, its first row), split
__device__ __forceinline__ void frag_a(const float* x, int ld, int k0,
                                       int g, int t, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float* r = x + g * ld + k0 + t;
  split_tf32(r[0], big[0], small[0]);
  split_tf32(r[8 * ld], big[1], small[1]);
  split_tf32(r[4], big[2], small[2]);
  split_tf32(r[8 * ld + 4], big[3], small[3]);
}

// The A fragment of a k step over the columns 8j .. 8j + 7 of an f32
// accumulator tile c[j] (C layout) that the step's product sums over:
// thread t's columns 2t and 2t + 1 serve as the step's k = t and t + 4,
// so no value moves between lanes; the B operand's k rows follow
// (`frag_b_cols`: rows 2t and 2t + 1)
__device__ __forceinline__ void frag_a_acc(const float (&c)[4],
                                           uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// B fragments of N n-tiles whose n runs along a raw tile's rows (n-tile
// j: rows 8j + g) and k along its columns (k0 + t, k0 + t + 4), split
template <int N>
__device__ __forceinline__ void frag_b_rows(const float* x, int ld, int k0,
                                            int g, int t,
                                            uint32_t (&big)[N][2],
                                            uint32_t (&small)[N][2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float* r = x + (8 * j + g) * ld + k0 + t;
    split_tf32(r[0], big[j][0], small[j][0]);
    split_tf32(r[4], big[j][1], small[j][1]);
  }
}

// B fragments of four n-tiles whose n runs along a 32-column group of a
// raw tile's columns and k along its rows, for the k step whose A came
// from `frag_a_acc`: rows 2t and 2t + 1 of `x` (the step's first row, the
// group's first column), columns 4g .. 4g + 3 of the group, one 16-byte
// read each.  n-tile i's n = g is column 4g + i, so its accumulator's
// columns 2t and 2t + 1 are the group's columns 8t + i and 8t + 4 + i
// (`store_group`)
__device__ __forceinline__ void frag_b_cols(const float* x, int ld, int g,
                                            int t, uint32_t (&big)[4][2],
                                            uint32_t (&small)[4][2]) {
  const float* r = x + 2 * t * ld + 4 * g;
  const float4 a = *reinterpret_cast<const float4*>(r);
  const float4 b = *reinterpret_cast<const float4*>(r + ld);
  const float xa[4] = {a.x, a.y, a.z, a.w}, xb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split_tf32(xa[i], big[i][0], small[i][0]);
    split_tf32(xb[i], big[i][1], small[i][1]);
  }
}

// d[j] += A · B[j]ᵀ over k < depth (a multiple of 8): A's rows g and g +
// 8 at `a`, B[j]'s rows 8j + g at `b`, k along the rows of both, each
// operand split by the warp that reads it.  The tensor cores add into an
// f32 accumulator without rounding to nearest, so a long sum drifts (dK
// by 4e-5 of itself over 768 products into one accumulator, on the card):
// each 128 columns of k are summed apart, in two fresh accumulators of at
// most 32 products, and added to d in f32.
template <int N>
__device__ __forceinline__ void product_rows(float (&d)[N][4], const float* a,
                                             int lda, const float* b, int ldb,
                                             int depth, int g, int t) {
  for (int k0 = 0; k0 < depth; k0 += 128) {
    float hi[N][4], lo[N][4];
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[j][e] = lo[j][e] = 0.f;
    const int k1 = min(k0 + 128, depth);
#pragma unroll 4
    for (int kk = k0; kk < k1; kk += 8) {
      uint32_t ab[4], as[4], bb[N][2], bs[N][2];
      frag_a(a, lda, kk, g, t, ab, as);
      frag_b_rows<N>(b, ldb, kk, g, t, bb, bs);
      mma3<N>(hi, lo, ab, as, bb, bs);
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] += lo[j][e] + hi[j][e];
  }
}

// d = d·f + A · B over the K k steps of one tile, for one 32-column group
// of B: A's fragments `ab`/`as` from an accumulator tile (`frag_a_acc`),
// B from a raw tile at `x` (the tile's first row, the group's first
// column; k step j at rows 8j + 2t, 8j + 2t + 1), d in `frag_b_cols`'
// column order.  Rows g take f0, rows g + 8 f1 (the forward's rescale; 1
// in the backward).  Summed apart, as in `product_rows`, and added in
// f32.
template <int K>
__device__ __forceinline__ void product_cols(float (&d)[4][4],
                                             const uint32_t (&ab)[K][4],
                                             const uint32_t (&as)[K][4],
                                             const float* x, int ld, int g,
                                             int t, float f0, float f1) {
  float hi[4][4], lo[4][4];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    uint32_t bb[4][2], bs[4][2];
    frag_b_cols(x + 8 * j * ld, ld, g, t, bb, bs);
    if (j == 0)
      mma3<4, true>(hi, lo, ab[j], as[j], bb, bs);
    else
      mma3<4>(hi, lo, ab[j], as[j], bb, bs);
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      d[n][e] = fmaf(d[n][e], e < 2 ? f0 : f1, lo[n][e] + hi[n][e]);
}

// rows g and g + 8 (those below `rows`; row r at out + r·stride) of one
// 32-column group's four accumulator n-tiles (`frag_b_cols`' order),
// times f0 and f1: columns 8t .. 8t + 7 of the group, where below `width`
__device__ __forceinline__ void store_group(const float (&acc)[4][4],
                                            float* out, long long stride,
                                            int g, int rows, int col,
                                            int width, float f0, float f1) {
  if (col >= width) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (g + 8 * half >= rows) continue;
    const float f = half ? f1 : f0;
    float* dst = out + (g + 8 * half) * stride + col;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0][2 * half] * f, acc[1][2 * half] * f,
                    acc[2][2 * half] * f, acc[3][2 * half] * f);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[0][2 * half + 1] * f, acc[1][2 * half + 1] * f,
                    acc[2][2 * half + 1] * f, acc[3][2 * half + 1] * f);
  }
}

}  // namespace hopper
}  // namespace
