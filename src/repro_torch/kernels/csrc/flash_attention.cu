// Flash attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py, pl.pallas_call in
// `flash_attention_fwd`, body `_flash_kernel`): grouped-query attention
// (q head h reads kv head h / (H / K)), an online softmax over kv tiles
// with an f32 running max, denominator and accumulator, a causal mask
// (q_pos >= k_pos), an optional sliding window (q_pos - k_pos < window)
// and a kv_len tail mask.  Query row i sits at q_pos = q_offset + i: 0
// for a prompt attending to itself (top-left aligned, as the TPU kernel),
// the cache length for a prompt that continues a cache (chunked prefill,
// which the reference runs through its plain chunked attention with
// q_offset; k and v are then the cache's first q_offset + Sq rows, read in
// place through their strides, so Sk > Sq).  A chunk of a captured
// prefill reads q_offset from the device (one graph serves every offset)
// and takes the cache's whole rows as k and v: the causal mask hides the
// rows past the chunk, and the key loop stops at the chunk's last
// position, so only the last key tile reads such rows (zeros after a
// reset, which the mask turns into 0 · 0).  Masked logits get an
// additive -1e30, as in the TPU kernel.  Output in the input type.  The
// value head dim Dv may differ from the q/k head dim D, as the TPU
// kernel's (MLA: D = 192, Dv = 128): S = Q·Kᵀ runs over D, and V, the
// accumulators and the output over Dv.
//
// What bounds it: causal attention does S²·(D + Dv)·H operations on
// 2·S·(2·D + 2·Dv)·H bf16 bytes (q, k, v read once, out written once),
// about S/4 operations per byte.  Below the card's ~295 operations per
// byte (bf16 tensor-core peak over HBM rate), that is up to S ≈ 1180, the
// bound is bytes; past it, arithmetic on the tensor cores.
//
// Two kernels, both on the tensor cores, chosen by dtype (not a
// fallback: a failed launch of either raises):
//
// * bf16 — tensor cores.  One block of three warpgroups per (128-row q
//   tile, q head, batch row).  Warpgroup 2 is the producer: one thread
//   loads the Q tile once and streams K and V tiles of 64 rows with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 2-4 stages,
//   each guarded by mbarriers (K full, V full, empty).  Warpgroups 0 and
//   1 each own 64 query rows: S = Q·Kᵀ with wgmma (bf16 in, f32
//   accumulators in registers, both operands read from the swizzled
//   tiles), the mask and online softmax in f32 registers, then O += P·V
//   with P from registers and V read from shared memory transposed.  P
//   is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and both go
//   through the tensor cores into the same accumulator: the residual is
//   at most 2^-18·P, so the result keeps the plain version's f32
//   products (the Pallas kernel multiplies P in f32) within 2e-5 where
//   one bf16 rounding of P would not.  D and Dv are padded in shared
//   memory to 64-column boxes that TMA zero-fills past them (D = 96 is
//   two boxes): NC boxes for Q and K, NCV for V.  The template is
//   instantiated for the (NC, NCV) pairs the served models use, (1, 1),
//   (2, 2), (4, 4) and MLA's (3, 2); any other pair is refused.  Dv = 256
//   holds 128 f32 accumulator registers per thread, which setmaxnreg (240
//   for the consumers, 24 for the producer) makes room for.  Shared
//   memory per block: 1 KB of barriers + the Q tile (16 KB per box) +
//   stages × (K (8 KB per box) + V (8 KB per box)), 198,656 bytes at
//   D = Dv = 256 (2 stages) and 215,040 at D = 192, Dv = 128 (4 stages)
//   with the 1 KB alignment slack.  kv tiles that no
//   row of the block can see are never loaded; a warpgroup skips the
//   arithmetic of a tile none of its rows can see.  The tensor maps are
//   built on the host from the wrapper's strides; cuTensorMapEncodeTiled
//   comes from cudaGetDriverEntryPoint, so nothing links libcuda.
// * float32 — tensor cores, three TF32 products per product (namespace
//   `tf32`).  Each f32 operand x is split into big = cvt.rna.tf32(x) and
//   small = cvt.rna.tf32(x - big) (x - big is exact in f32), and a·b is
//   taken as big·big + big·small + small·big on mma.sync m16n8k8: about
//   2^-21·|a·b| is left of each product, where one TF32 rounding leaves
//   2^-11, far outside the card's 2e-5 check.  Q·Kᵀ and P·V both, with P
//   split where the softmax forms it.  The rounding is written as two
//   integer instructions (`to_tf32`, equal to the cvt on every finite
//   f32: `flash_attention_tf32_mismatches`); ptxas made the cvt four or
//   five, and the kernels ran 15-18% slower with it.  The tensor cores add
//   into their f32 accumulator without rounding to nearest, and over
//   hundreds of products into one accumulator that drift reached 4e-5 of
//   a gradient (the first design, on the card): so big·big and the two
//   cross products sum into accumulators of their own, at most 128
//   columns of D (S) or one kv tile (O, whose rescale by the new max
//   rides on the same FMA), and are added in f32.
//
//   What bounds it: f32-accurate work runs at 495/3 = 165 TFLOP/s at best (the
//   TF32 peak over three products), about 49 operations a byte of HBM; causal
//   attention in f32 does S/8 operations a byte (q, k, v and out moved once),
//   so the products bound it from S ≈ 400 on.  On the card the split's ALU
//   work comes first: five instructions an element a warp reads.  Splitting
//   each K and V tile once per block into shared (big, small) pairs instead
//   was slower on the card (two more barriers a tile, and the warps idle while
//   the block splits: PERF.md §6), so each warp splits what it reads.  One
//   block of eight warps per (128-row q tile, q head, batch row), 16 rows a
//   warp, and kv tiles of 64 rows where they fit (D and Dv up to 128;
//   `shape_for` gives the rest: MLA eight warps and 32 rows, D = Dv = 256 four
//   and 32).  The block's threads copy the Q tile once and K and V tiles into
//   two stages with cp.async (16 bytes a copy where every row starts on 16
//   bytes, else 4: a template flag), the next tile in flight while the warps
//   use the last.  Shared memory holds the raw f32 rows, `tile_ld` floats
//   apart (4 mod 32: every fragment read is free of bank conflicts).  S = Q·Kᵀ
//   reads Q and K as scalar fragments; the mask and the online softmax run in
//   registers (row max and sum over a quad, exp2 with the scale folded into it
//   as in the bf16 kernel); P feeds P·V from the registers, its columns 2t and
//   2t + 1 taken as the k of the product (no shuffle), and V is read 16 bytes
//   at a time along its columns (rows 2t and 2t + 1); the output columns come
//   out permuted within each group of 32 and are stored as float4s where they
//   belong.  Instantiated for Dv in 1-4, 6 or 8 groups of 32 columns (64-row
//   kv tiles for 1-4); D and Dv any multiple of 8 up to 256.  Shared memory
//   (`smem_bytes`): 153,600 bytes at D = Dv = 96, 184,320 at D = 192, Dv =
//   128, 199,680 at D = Dv = 256.
//
// Layout: q (B, Sq, H, D), k (B, Sk, K, D), v (B, Sk, K, Dv) with the
// last dimension contiguous and the other strides given in elements (for
// bf16: multiples of 8, base pointers 16-byte aligned, as TMA needs); out
// is a contiguous (B, Sq, H, Dv).  D and Dv are multiples of 8, at most
// 256.  lse, when not null, is a contiguous f32 (B, H, Sq): each row's
// log-sum-exp in natural log over its scaled, masked scores, which the
// backward (flash_attention_bwd.cu) recomputes the probabilities from;
// serving passes null and nothing more is written.  The bf16 kernel is
// instantiated with and without that store (template flag LSE), so
// serving runs the code it ran before the output existed: with a runtime
// test in the epilogue its S = 512 times were 1.6-3.3% longer (H100
// 80GB HBM3 at 700 W, against the kernel without the output).
#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers, make_map

namespace {

constexpr int MAX_D = 256;
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (B, H, Sq) or null
  int H, K, Sq, Sk, D, Dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;  // window <= 0: none
  int q_offset;        // the position of query row 0 among the keys
  // or, where not null, that position read from the device (a chunk of a
  // captured prefill: one graph serves every offset); q_offset unused
  const long long* q_offset_dev;
  float scale;
};

// the key position of query row 0: from the device where the caller
// gave it there
__device__ __forceinline__ int query_offset(const Params& p) {
  return p.q_offset_dev ? int(*p.q_offset_dev) : p.q_offset;
}

// ---------------------------------------------------------------------------
// float32: tensor cores, three TF32 products per product (mma.sync)
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace hopper;

constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SM_SMEM = 228 * 1024;  // of an SM, 1 KB a block reserved

// a block's shared memory: the Q tile (16 rows a warp) and two stages of
// a K and a V tile of bk rows, each row `tile_ld` floats
size_t smem_bytes(int warps, int bk, int D, int Dv) {
  return sizeof(float) * (size_t(16 * warps) * tile_ld(D) +
                          2 * size_t(bk) * (tile_ld(D) + tile_ld(Dv)));
}

bool fits(int warps, int bk, int D, int Dv) {
  return smem_bytes(warps, bk, D, Dv) <= size_t(BLOCK_SMEM);
}

// (warps, kv tile rows): eight warps (128 query rows) and 64 rows where
// they fit (D and Dv up to 128); else four and 32 rows where two such blocks
// share an SM; else eight and 32 (MLA's D = 192, Dv = 128); else four and
// 32 (D = Dv = 256).  On the card eight warps and 64 rows took phi3's
// heads in 0.081 ms where four and 32 took 0.100 (fewer barriers and
// copies a row, and each A fragment serves eight n-tiles), but four and
// 64 took MLA's in 0.489 ms where eight and 32 took 0.397
// (launch/probe_flash_f32.py; H100 at 700 W).
void shape_for(int D, int Dv, int* warps, int* bk) {
  *warps = 8;
  *bk = 64;
  if (groups32(Dv) <= 4 && fits(8, 64, D, Dv)) return;
  *bk = 32;
  if (2 * (smem_bytes(4, 32, D, Dv) + 1024) > SM_SMEM && fits(8, 32, D, Dv))
    return;
  *warps = 4;
}

// NV: 32-column groups of Dv the accumulators hold (groups32).  VEC: every
// row of q, k and v starts on 16 bytes and is copied 16 bytes at a time;
// else 4.  BK: kv rows a tile.
template <int NV, bool VEC, int BK>
__global__ void __launch_bounds__(256) flash_f32_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32, BQ = 16 * warps;
  const int ldk = tile_ld(p.D), ldv = tile_ld(p.Dv);
  float* const sq = smem;                // BQ x ldk
  float* const sk = sq + BQ * ldk;       // [2] BK x ldk
  float* const sv = sk + 2 * BK * ldk;   // [2] BK x ldv

  const float scale_log2 = p.scale * LOG2E;
  constexpr float LN2 = 0.6931471805599453f;
  // the longest q tiles (most kv tiles under the causal mask) go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int qo = query_offset(p);
  // kv tiles some row of this q tile can see (positions, not rows)
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, qo + q_last + 1) : p.Sk;
  int k_begin = p.window > 0 ? max(0, qo + q0 - p.window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // the Q tile and the first K, V tile; each later tile is copied while
  // the one before it is used
  load_rows<VEC>(smem_u32(sq), ldk, q, p.q_ss, q0, BQ, p.Sq, p.D);
  if (n_tiles) {
    load_rows<VEC>(smem_u32(sk), ldk, k, p.k_ss, k_begin, BK, p.Sk, p.D);
    load_rows<VEC>(smem_u32(sv), ldv, v, p.v_ss, k_begin, BK, p.Sk, p.Dv);
  }
  cp_async_commit();

  // 16 query rows a warp: this thread holds rows r0 and r0 + 8, at key
  // positions qo + r0 and qo + r0 + 8
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qa = q0 + 16 * warp;           // this warp's first row
  const int qb = min(qa + 15, p.Sq - 1);   // and its last live one
  const bool live = qa < p.Sq;
  const int r0 = qa + g;
  const int pa = qo + qa, pb = qo + qb, p0 = qo + r0;  // their positions
  const float* qw = sq + 16 * warp * ldk;

  float o[NV][4][4];  // 32-column group c, n-tile i (frag_b_cols' order)
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][i][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + 1 < n_tiles) {
      const int s = (i + 1) & 1, kn = k_begin + (i + 1) * BK;
      load_rows<VEC>(smem_u32(sk + s * BK * ldk), ldk, k, p.k_ss, kn, BK,
                     p.Sk, p.D);
      load_rows<VEC>(smem_u32(sv + s * BK * ldv), ldv, v, p.v_ss, kn, BK,
                     p.Sk, p.Dv);
    }
    cp_async_commit();
    const int k0 = k_begin + i * BK;
    // a tile that none of this warp's rows can see: no arithmetic
    if (!live || (p.causal && k0 > pb) ||
        (p.window > 0 && pa - (k0 + BK - 1) >= p.window))
      continue;
    const float* kt = sk + (i & 1) * BK * ldk;
    const float* vt = sv + (i & 1) * BK * ldv;

    // S = Q Kᵀ: 16 x 32 a warp, over D
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    product_rows<BK / 8>(sc, qw, ldk, kt, ldk, p.D, g, t4);

    // sc[j][e] is (r0, col k0 + 8j + 2 t4 + e) and sc[j][2 + e] is (r0 + 8,
    // the same col).  As in the bf16 kernel, a tile on a mask edge is
    // scaled to log2 units and masked here; any other keeps its raw scores,
    // and the scale folds into the one FFMA before each exp2.
    const bool masked = (p.causal && k0 + BK - 1 > pa) || k0 + BK > p.Sk ||
                        (p.window > 0 && pb - k0 >= p.window);
    const bool scaled = masked || !(scale_log2 > 0.f);
    if (scaled) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + e;
          float x0 = sc[j][e] * scale_log2, x1 = sc[j][2 + e] * scale_log2;
          if (masked) {
            if (kp >= p.Sk) {
              x0 += NEG;
              x1 += NEG;
            }
            if (p.causal) {
              if (p0 < kp) x0 += NEG;
              if (p0 + 8 < kp) x1 += NEG;
            }
            if (p.window > 0) {
              if (p0 - kp >= p.window) x0 += NEG;
              if (p0 + 8 - kp >= p.window) x1 += NEG;
            }
          }
          sc[j][e] = x0;
          sc[j][2 + e] = x1;
        }
      }
    }
    const float cs = scaled ? 1.f : scale_log2;
    // online softmax: a row lives in the four lanes of one quad
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0 * cs), mn1 = fmaxf(m[1], mx1 * cs);
    const float al0 = ex2(m[0] - mn0), al1 = ex2(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float e0 = ex2(fmaf(sc[j][e], cs, -mn0));
        const float e1 = ex2(fmaf(sc[j][2 + e], cs, -mn1));
        sc[j][e] = e0;
        sc[j][2 + e] = e1;
        sum0 += e0;
        sum1 += e1;
      }
    }
    l[0] = l[0] * al0 + sum0;  // this thread's columns; quad-summed last
    l[1] = l[1] * al1 + sum1;

    // O = O·alpha + P V over the tile's kv rows, P straight from the
    // registers
    uint32_t pb_[BK / 8][4], ps[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) frag_a_acc(sc[j], pb_[j], ps[j]);
#pragma unroll
    for (int c = 0; c < NV; ++c)
      if (32 * c < p.Dv)
        product_cols<BK / 8>(o[c], pb_, ps, vt + 32 * c, ldv, g, t4, al0,
                             al1);
  }

  // normalise and store: rows r0 and r0 + 8
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  if (!live) return;
  if (p.lse && t4 == 0) {
    // m is in log2 units of the scaled scores: lse = (m + log2 l) · ln 2
    float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    if (r0 < p.Sq) lse[r0] = (m[0] + log2f(fmaxf(l[0], 1e-30f))) * LN2;
    if (r0 + 8 < p.Sq) lse[r0 + 8] = (m[1] + log2f(fmaxf(l[1], 1e-30f))) * LN2;
  }
  const long long stride = (long long)p.H * p.Dv;
  float* out = static_cast<float*>(p.out) +
               ((long long)b * p.Sq + qa) * stride + (long long)h * p.Dv;
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int c = 0; c < NV; ++c)
    store_group(o[c], out, stride, g, p.Sq - qa, 32 * c + 8 * t4, p.Dv, inv0,
                inv1);
}

template <int NV, bool VEC, int BK>
int launch(const Params& p, int B, int warps, cudaStream_t stream) {
  const size_t smem = smem_bytes(warps, BK, p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<NV, VEC, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((p.Sq + 16 * warps - 1) / (16 * warps), p.H, B);
  flash_f32_kernel<NV, VEC, BK><<<grid, 32 * warps, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// kv tiles of 64 rows fit beside eight warps' Q tiles only up to D = 128
// (and Dv 128): 1-4 groups
template <int NV, bool VEC>
int run_nv(const Params& p, int B, cudaStream_t stream) {
  int warps, bk;
  shape_for(p.D, p.Dv, &warps, &bk);
  if (!fits(warps, bk, p.D, p.Dv)) return -1;
  if (bk == 32) return launch<NV, VEC, 32>(p, B, warps, stream);
  if constexpr (NV <= 4) return launch<NV, VEC, 64>(p, B, warps, stream);
  return -1;
}

template <bool VEC>
int run_vec(const Params& p, int B, cudaStream_t stream) {
  switch (groups32(p.Dv)) {
    case 1: return run_nv<1, VEC>(p, B, stream);
    case 2: return run_nv<2, VEC>(p, B, stream);
    case 3: return run_nv<3, VEC>(p, B, stream);
    case 4: return run_nv<4, VEC>(p, B, stream);
    case 6: return run_nv<6, VEC>(p, B, stream);
    default: return run_nv<8, VEC>(p, B, stream);
  }
}

// a row of every (batch, head, position) starts on 16 bytes: the base is
// aligned and each stride that is ever stepped a multiple of 4 floats
bool rows16(const void* ptr, int batch, int seq, int heads, long long sb,
            long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (batch == 1 || sb % 4 == 0) && (seq == 1 || ss % 4 == 0) &&
         (heads == 1 || sh % 4 == 0);
}

int run(const Params& p, int B, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(p.out) % 16) return -1;
  const bool vec = rows16(p.q, B, p.Sq, p.H, p.q_sb, p.q_ss, p.q_sh) &&
                   rows16(p.k, B, p.Sk, p.K, p.k_sb, p.k_ss, p.k_sh) &&
                   rows16(p.v, B, p.Sk, p.K, p.v_sb, p.v_ss, p.v_sh);
  return vec ? run_vec<true>(p, B, stream) : run_vec<false>(p, B, stream);
}

// every f32 bit pattern from `first` on, a grid stride apart: counts the
// finite ones whose to_tf32 is not the cvt's
__global__ void tf32_check_kernel(unsigned long long* mismatches) {
  unsigned long long n = 0;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float(uint32_t(i));
    if (isfinite(x) && to_tf32(x) != tf32_rna(x)) ++n;
  }
  if (n) atomicAdd(mismatches, n);
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, mbarrier ring
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BQ = 128;       // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int CONSUMERS = 2;  // warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr float LOG2E = 1.4426950408889634f;

// NC boxes of 64 columns for Q and K, NCV for V: the Q tile, one K and
// one V tile, and the stages
template <int NC, int NCV>
struct Layout {
  static constexpr int Q_BYTES = NC * BQ * ROW_BYTES;
  static constexpr int K_BYTES = NC * BK * ROW_BYTES;
  static constexpr int V_BYTES = NCV * BK * ROW_BYTES;
  static constexpr int STAGES_FIT =
      (220 * 1024 - Q_BYTES) / (K_BYTES + V_BYTES);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  // alignment slack + barriers + Q + the K and V rings
  static constexpr int SMEM =
      1024 + 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  static_assert(STAGES >= 2, "the ring needs two stages");
};


// LSE: write the rows' log-sum-exp to p.lse (training); serving's
// instance has no trace of it, so its code is the one it was without
template <int NC, int NCV, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, Params p) {
  using L = Layout<NC, NCV>;
  constexpr int ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on a multiple
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base;
  const uint32_t k_full = base + 8;                // [ST]
  const uint32_t v_full = base + 8 * (1 + ST);     // [ST]
  const uint32_t empty = base + 8 * (1 + 2 * ST);  // [ST]
  const uint32_t sq = base + 1024;
  const uint32_t sk = sq + L::Q_BYTES;             // [ST] tiles
  const uint32_t sv = sk + ST * L::K_BYTES;        // [ST] tiles

  // softmax scale · log2(e): exp(x) = exp2(x · log2 e)
  const float scale_log2 = p.scale * LOG2E;
  __nv_bfloat16* const out_ = static_cast<__nv_bfloat16*>(p.out);
  constexpr float LN2 = 0.6931471805599453f;
  // the longest q tiles (most kv tiles under the causal mask) go first;
  // at a q offset every tile sees q_offset more keys, so the order holds
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int qo = query_offset(p);
  // kv tiles some row of this q tile can see (positions, not rows)
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, qo + q_last + 1) : p.Sk;
  int k_begin = p.window > 0 ? max(0, qo + q0 - p.window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load(sq + c * BQ * ROW_BYTES, &tq, q_full, c * BOX, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty + 8 * s, ((i / ST) - 1) & 1);
        const int k0 = k_begin + i * BK;
        const uint32_t ks = sk + s * L::K_BYTES, vs = sv + s * L::V_BYTES;
        mbar_expect_tx(k_full + 8 * s, L::K_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load(ks + c * BK * ROW_BYTES, &tk, k_full + 8 * s, c * BOX, kvh,
                   k0, b);
        mbar_expect_tx(v_full + 8 * s, L::V_BYTES);
        for (int c = 0; c < NCV; ++c)
          tma_load(vs + c * BK * ROW_BYTES, &tv, v_full + 8 * s, c * BOX, kvh,
                   k0, b);
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    // the accumulator rows this thread holds: r0 and r0 + 8, at key
    // positions qo + r0 and qo + r0 + 8
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int qa = q0 + wg * 64;           // this warpgroup's first row
    const int qb = min(qa + 63, p.Sq - 1);  // and its last live one
    const bool live = qa < p.Sq;
    const int pa = qo + qa, pb = qo + qb, p0 = qo + r0;  // their positions
    const uint32_t q_tile = sq + wg * 64 * ROW_BYTES;

    float o[NCV][32];
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      const uint32_t ph = (i / ST) & 1;
      const int k0 = k_begin + i * BK;
      const uint32_t ks = sk + s * L::K_BYTES, vs = sv + s * L::V_BYTES;
      // a tile that none of this warpgroup's rows can see: skip the
      // arithmetic, but wait for it so the empty arrival counts for it
      const bool skip = !live || (p.causal && k0 > pb) ||
                        (p.window > 0 && pa - (k0 + BK - 1) >= p.window);
      mbar_wait(k_full + 8 * s, ph);
      if (!skip) {
        // S = Q Kᵀ: 64 x 64, f32
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NC; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns of a box
          wgmma_ss(sc,
                   desc(q_tile + (kk / 4) * BQ * ROW_BYTES + off, 1, 64),
                   desc(ks + (kk / 4) * BK * ROW_BYTES + off, 1, 64), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // sc[4j + e] is (r0, col 8j + 2 t4 + e) and sc[4j + 2 + e] is
        // (r0 + 8, the same col).  The softmax's ALU work, not the tensor
        // cores, bounds a tile, so it is kept lean: a tile on a mask edge
        // is scaled to log2 units and masked here; any other keeps its raw
        // scores, and the scale folds into the one FFMA before each exp2
        // (a positive scale commutes with the max).
        const bool masked = (p.causal && k0 + BK - 1 > pa) || k0 + BK > p.Sk ||
                            (p.window > 0 && pb - k0 >= p.window);
        const bool scaled = masked || !(scale_log2 > 0.f);
        if (scaled) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kp = k0 + 8 * j + 2 * t4 + e;
              float x0 = sc[4 * j + e] * scale_log2;
              float x1 = sc[4 * j + 2 + e] * scale_log2;
              if (masked) {
                if (kp >= p.Sk) {
                  x0 += NEG;
                  x1 += NEG;
                }
                if (p.causal) {
                  if (p0 < kp) x0 += NEG;
                  if (p0 + 8 < kp) x1 += NEG;
                }
                if (p.window > 0) {
                  if (p0 - kp >= p.window) x0 += NEG;
                  if (p0 + 8 - kp >= p.window) x1 += NEG;
                }
              }
              sc[4 * j + e] = x0;
              sc[4 * j + 2 + e] = x1;
            }
          }
        }
        const float cs = scaled ? 1.f : scale_log2;
        // online softmax: a row lives in the four lanes of one quad
        float mx0 = NEG, mx1 = NEG;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m[0], mx0 * cs), mn1 = fmaxf(m[1], mx1 * cs);
        const float al0 = ex2(m[0] - mn0), al1 = ex2(m[1] - mn1);
        m[0] = mn0;
        m[1] = mn1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = ex2(fmaf(sc[4 * j + e], cs, -mn0));
            const float p1 = ex2(fmaf(sc[4 * j + 2 + e], cs, -mn1));
            sc[4 * j + e] = p0;
            sc[4 * j + 2 + e] = p1;
            sum0 += p0;
            sum1 += p1;
          }
        }
        l[0] = l[0] * al0 + sum0;  // this thread's columns; quad-summed last
        l[1] = l[1] * al1 + sum1;
        // O's rows times their rescale factors, unless no max moved
        if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
          for (int c = 0; c < NCV; ++c) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[c][4 * j] *= al0;
              o[c][4 * j + 1] *= al0;
              o[c][4 * j + 2] *= al1;
              o[c][4 * j + 3] *= al1;
            }
          }
        }
        // P as wgmma A fragments (k step kk: kv columns 16 kk .. 16 kk + 15)
        // in two bf16 parts, hi = bf16(P) and lo = bf16(P - hi)
        uint32_t phi[4][4], plo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = sc[8 * kk + 2 * r], y = sc[8 * kk + 2 * r + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
            phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
            plo[kk][r] = pack_bf16(x - __low2float(hi), y - __high2float(hi));
          }
        }

        // O += P V: V's tile is [kv row][d], read MN-major
        mbar_wait(v_full + 8 * s, ph);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NCV; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dv =
                desc(vs + c * BK * ROW_BYTES + kk * 16 * ROW_BYTES,
                     BK * ROW_BYTES / 16, 64);
            wgmma_rs(o[c], phi[kk], dv);
            wgmma_rs(o[c], plo[kk], dv);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NCV; ++c) fence_regs(o[c]);
      } else {
        mbar_wait(v_full + 8 * s, ph);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // normalise and store: row r0 and r0 + 8, columns 64 c + 8 j + 2 t4
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
    if (LSE && t4 == 0) {
      // m is in log2 units of the scaled scores: lse = (m + log2 l) · ln 2
      float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
      if (r0 < p.Sq) lse[r0] = (m[0] + log2f(fmaxf(l[0], 1e-30f))) * LN2;
      if (r0 + 8 < p.Sq)
        lse[r0 + 8] = (m[1] + log2f(fmaxf(l[1], 1e-30f))) * LN2;
    }
    const long long row_stride = (long long)p.H * p.Dv;
    __nv_bfloat16* out0 =
        out_ + ((long long)b * p.Sq + r0) * row_stride + (long long)h * p.Dv;
    __nv_bfloat16* out1 = out0 + 8 * row_stride;
#pragma unroll
    for (int c = 0; c < NCV; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * BOX + 8 * j + 2 * t4;
        if (col >= p.Dv) continue;
        if (r0 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(out0 + col) =
              __floats2bfloat162_rn(o[c][4 * j] * inv0,
                                    o[c][4 * j + 1] * inv0);
        if (r0 + 8 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(out1 + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2] * inv1,
                                    o[c][4 * j + 3] * inv1);
      }
    }
  }
}


template <int NC, int NCV, bool LSE>
int launch(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, B, p.Sq, p.H, p.D, p.q_sb, p.q_ss, p.q_sh, BQ);
  if (!err)
    err = make_map(&tk, p.k, B, p.Sk, p.K, p.D, p.k_sb, p.k_ss, p.k_sh, BK);
  if (!err)
    err = make_map(&tv, p.v, B, p.Sk, p.K, p.Dv, p.v_sb, p.v_ss, p.v_sh, BK);
  if (err) return err;
  const int smem = Layout<NC, NCV>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<NC, NCV, LSE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return int(e);
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_tc_kernel<NC, NCV, LSE><<<grid, THREADS, smem, stream>>>(tq, tk, tv,
                                                                  p);
  return int(cudaGetLastError());
}

template <int NC, int NCV>
int run_pair(const Params& p, int B, cudaStream_t stream) {
  return p.lse ? launch<NC, NCV, true>(p, B, stream)
               : launch<NC, NCV, false>(p, B, stream);
}

int run(Params p, int B, cudaStream_t stream) {
  if (!tma_strides(p.q, B, p.Sq, p.H, p.D, &p.q_sb, &p.q_ss, &p.q_sh) ||
      !tma_strides(p.k, B, p.Sk, p.K, p.D, &p.k_sb, &p.k_ss, &p.k_sh) ||
      !tma_strides(p.v, B, p.Sk, p.K, p.Dv, &p.v_sb, &p.v_ss, &p.v_sh) ||
      reinterpret_cast<uintptr_t>(p.out) % 16)
    return -1;
  // (Q/K boxes, V boxes): the pairs the served models use
  const int nc = (p.D + BOX - 1) / BOX, ncv = (p.Dv + BOX - 1) / BOX;
  if (nc == 1 && ncv == 1) return run_pair<1, 1>(p, B, stream);
  if (nc == 2 && ncv == 2) return run_pair<2, 2>(p, B, stream);
  if (nc == 3 && ncv == 2) return run_pair<3, 2>(p, B, stream);
  if (nc == 4 && ncv == 4) return run_pair<4, 4>(p, B, stream);
  return -1;
}

}  // namespace tc

}  // namespace

// The f32 route's rounding against cvt.rna.tf32.f32 over all 2^32 bit
// patterns: adds the finite inputs they round apart to *mismatches (a
// device counter the caller zeroed).  Returns 0 once launched, or a
// cudaError_t.
extern "C" int flash_attention_tf32_mismatches(unsigned long long* mismatches,
                                               void* stream) {
  tf32::tf32_check_kernel<<<1024, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(mismatches);
  return int(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 once launched, a
// cudaError_t, 1000 + a CUresult if a tensor map could not be built, or
// -1 for arguments the kernel does not take (for bf16, a (D, Dv) box pair
// it is not instantiated for).  lse: null, or the (B, H, Sq) f32 output.
// q_offset: the key position of query row 0 (>= 0), or, where
// q_offset_dev is not null, a device int64 holding it: the caller checks
// that the q rows' positions fall inside the keys (the kernel cannot read
// it here), and keys past the last row's position are masked causally.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype, int B,
    int H, int K, int Sq, int Sk, int D, int Dv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, int q_offset, const long long* q_offset_dev,
    float scale, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 || Dv <= 0 || Dv > MAX_D || Dv % 8 ||
      K <= 0 || H % K || B <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 ||
      H > 65535 || q_offset < 0)
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.H = H;
  p.K = K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.Dv = Dv;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.q_offset_dev = q_offset_dev;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tf32::run(p, B, s);
  if (dtype == 1) return tc::run(p, B, s);
  return -1;
}
