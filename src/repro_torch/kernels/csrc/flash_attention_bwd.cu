// Flash attention, backward, for NVIDIA Hopper (sm_90a).
//
// The JAX package has no Pallas kernel for this: its training attention
// is the `custom_vjp` in src/repro/models/layers.py (`_make_flash`, bwd),
// which recomputes the probabilities blockwise from the forward's
// log-sum-exp instead of keeping the S x S matrix, with
// D_i = rowsum(dO ⊙ O).  This is that algorithm as CUDA kernels, with the
// forward's masking: an additive -1e30 (here: P = 0) for keys past Sk,
// for q_pos < k_pos under the causal mask and for q_pos - k_pos >= window.
//
//   P  = exp(scale · Q Kᵀ + bias - lse)
//   dV = Pᵀ dO        dP = dO Vᵀ        dS = P ⊙ (dP - D) · scale
//   dQ = dS K         dK = dSᵀ Q
//
// What bounds it: the products.  Per visible (q, k) pair and head a flash
// backward does S, dP, dV, dK and dQ (2·(3·D + 2·Dv) operations) against
// far fewer bytes (q, k, v, o, dO and lse read once, dq, dk, dv written
// once): about 5·S/16 operations a byte under the causal mask at H = K,
// so on the bf16 tensor cores (989 TFLOP/s, ~295 operations a byte of
// HBM) the bound is arithmetic from S ≈ 950 on.
//
// Three passes, deterministic, no atomics:
//  1. D_i = rowsum(dO ⊙ O) into an f32 (B, H, Sq) scratch: `delta_kernel`,
//     one warp per (b, row, head), for f32; `delta_tc_kernel`, eight
//     threads a row with 16-byte loads, for bf16;
//  2. dK/dV: one block per (kv tile, unit, b) keeps its K and V tile and
//     loops over the q tiles that can see it, recomputing P and dS tile
//     by tile, with dK and dV accumulated in registers.  A unit is a kv
//     head when H = K: dK, dV are written in the inputs' type.  Under GQA
//     (G = H / K > 1) a unit is one q head, which writes its own partial
//     dK, dV in f32 to a (B, Sk, H, D) scratch, and `reduce_kernel` sums
//     the G heads of each group in head order (recurrentgemma's K = 1,
//     H = 10 would otherwise run one block per kv tile, 48 at S = 3072,
//     far fewer than the 132 SMs);
//  3. dQ: one block per (q tile, head, b) loops over the kv tiles it can
//     see and accumulates dQ.
//
// Two routes, both on the tensor cores, chosen by dtype (not a
// fallback: a failed launch of either raises):
//
// * bf16 — tensor cores (namespace `tc`), the forward's tools
//   (hopper.cuh): TMA loads with 128-byte swizzle into mbarrier rings, one
//   producer warp, wgmma with f32 accumulators in registers.
//   - dK/dV: three warpgroups per 64-row kv tile.  The producer loads K
//     and V once and streams the 64-row Q and dO tiles of the q tiles
//     that see it, with their rows' lse·log2 e (+inf past Sq, so P = 0
//     there) and D, into a ring of 2-4 stages.  Both consumers hold the
//     same 64 kv rows and split the work by role: warpgroup 0 computes
//     Sᵀ = K Qᵀ, Pᵀ (masked on the tiles on a mask's edge) and dV += Pᵀ dO;
//     warpgroup 1 computes dPᵀ = V dOᵀ, takes Pᵀ from warpgroup 0 through
//     16 KB of shared memory (named barriers: full, empty; each thread
//     reads back the values it would hold itself, so the hand-over has no
//     bank conflict), and forms dSᵀ and dK += dSᵀ Q.  At D = Dv the two
//     do the same number of products, and dV, dK take NCV·32, NC·32 f32
//     registers a thread (128 each at D 256), which one warpgroup alone
//     could not hold.  Pᵀ and dSᵀ go in registers as the A operand; dO and
//     Q are read from their swizzled tiles as the transposed B operand.
//   - dQ: the forward's shape, 64 q rows per consumer warpgroup: two
//     consumers (128 rows) where Q, dO and two stages of K, V fit in
//     shared memory, else one (D = Dv = 256).  The producer loads the Q
//     and dO tiles once and streams K and V; S = Q Kᵀ and dP = dO Vᵀ from
//     shared memory, dS in registers, dQ += dS K with K read transposed.
//   - Precision: P and dS are f32 values the kernel computes, so each
//     goes through the tensor cores as bf16 hi plus bf16 lo (hi = bf16(x),
//     lo = bf16(x - hi)) into one f32 accumulator, as the forward does for
//     P: the residual is at most 2^-16·|x|, and the result keeps the
//     plain version's f32 products (the reference multiplies in f32)
//     within 2e-5, where one bf16 rounding would not.  (hi by truncation
//     would save a conversion a pair but doubles the residual: on the CPU
//     emulation it used 91% of the f32 tolerance, against 47%.)  Q, K, V and dO are
//     bf16 values already, exact on the tensor cores.  So the kernels do
//     10 tile products per (q, kv) pair where the bound counts 5.
//   - Masks: P = 0 for k >= Sk, q < k (causal) and q - k >= window, on
//     the tiles that cross an edge; tiles no row of a block can see are
//     never loaded, and a dQ warpgroup skips the arithmetic of a tile
//     none of its rows can see.
//   - D and Dv are padded to 64-column boxes that TMA zero-fills (D = 96
//     is two).  Instantiated for the (D boxes, Dv boxes) pairs of the
//     forward: (1, 1), (2, 2), (4, 4) and MLA's (3, 2); any other pair is
//     refused.
// * float32 — tensor cores, three TF32 products per product (namespace
//   `tf32`, the forward's tools in hopper.cuh): every product — S, dP,
//   dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K — is big·big + big·small +
//   small·big on mma.sync m16n8k8, each f32 operand split into TF32 big =
//   rna(x) and small = rna(x - big) (`to_tf32`: cvt.rna.tf32.f32's
//   rounding in two integer instructions), P and dS where they are
//   formed: about 2^-21·|a·b| is left of each product, where one TF32
//   rounding leaves 2^-11.  big·big and the cross products go into
//   accumulators of their own, at most 128 columns of D or Dv or one q or
//   kv tile, added in f32: summed over a whole tile loop inside the
//   tensor cores' accumulator, which does not round to nearest, dK
//   drifted by 4e-5 of its value at MLA's S 2048 (the first design, on
//   the card).  Bound: the five products at 165 TFLOP/s (the TF32 peak
//   over three), about 49 operations a byte; the kernels do 7 (passes 2
//   and 3 each recompute S and dP), and on the card the split's ALU work
//   comes first.  No producer: the block's threads copy tiles with
//   cp.async (16 bytes; the wrapper hands over 16-byte aligned bases) into
//   two stages, the next in flight while the warps use the last; shared
//   tiles hold raw f32 rows `tile_ld` floats apart, split by the warp
//   that reads them (splitting each tile once per block into shared
//   (big, small) pairs instead was slower: the warps idle while the block
//   splits).
//   - dK/dV: 8 kv rows a warp, four warps (32 rows: 16 kv tiles × 8 q heads =
//     128 blocks at H 8, K 2, S 512, where the CUDA-core kernels' 64-row tiles
//     gave 64), or eight (64 rows) where two blocks of four do not share an SM
//     but one of eight fits (MLA: with four, its backward took 31.3 ms on the
//     card, with eight 19.9), streaming q tiles of 32 rows with their
//     (lse·log2 e, D) pairs.  The first half of the warps hold 16 kv rows each
//     and compute Sᵀ = K Qᵀ, Pᵀ (0 where masked; lse = +inf past Sq) and dV +=
//     Pᵀ dO; the second half the same rows' dPᵀ = V dOᵀ, then, once Pᵀ is
//     handed over in shared memory (each lane reads back the elements its twin
//     wrote), dSᵀ and dK += dSᵀ Q.  One accumulator array serves dV in the one
//     role and dK in the other.
//   - dQ: 16 q rows a warp, Q and dO copied once, kv tiles streamed: four
//     warps and 64 rows, else 32, where two such blocks share an SM, else
//     the first of (8, 32), (8, 24), (8, 16), (4, 32), (4, 16) warps and
//     rows that fits (minicpm: (4, 64); MLA: (8, 24); D = Dv = 256: (4,
//     16)).  S, dP, dS in registers, dQ += dS K.
//   A product whose k runs over a C tile's columns (Pᵀ dO, dSᵀ Q, dS K)
//   takes the tile's columns 2t and 2t + 1 as k = t and t + 4 and reads
//   its B operand 16 bytes at a time along the columns (`frag_b_cols`).
//   Instantiated for max(D, Dv) in 1-4, 6 or 8 groups of 32 columns; D and
//   Dv any multiple of 8 up to 256.  `bwd_launch_shape` (ops.py) mirrors
//   the tiles and shared memory; launch/probe_flash_f32.py times the
//   choices against their alternatives.
//
// Layout: q (B, Sq, H, D), k (B, Sk, K, D), v (B, Sk, K, Dv), o and dO
// (B, Sq, H, Dv), dq, dk, dv like q, k, v: all contiguous, of one type
// (float32 or bfloat16), q, k, v, o and dO 16-byte aligned;
// lse (B, H, Sq) f32.  D and Dv are multiples of 8, at most 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers, make_map

namespace {

constexpr int MAX_D = 256;
constexpr int THREADS = 256;  // of the D_i and GQA reduction kernels
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;       // (B, H, Sq)
  void *dq, *dk, *dv;
  float *dk_ws, *dv_ws;  // (B, Sk, H, D / Dv) partials under GQA, else null
  int B, H, K, Sq, Sk, D, Dv;
  int causal, window;  // window <= 0: none
  float scale;
};

// ---------------------------------------------------------------------------
// pass 1: D_i = rowsum(dO ⊙ O)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(Params p) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;  // (b, s, h) in memory order
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)p.B * p.Sq * p.H;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(p.o) + row * p.Dv;
  const T* d = static_cast<const T*>(p.dout) + row * p.Dv;
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32) acc += to_f32(o[c]) * to_f32(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = int(row % p.H);
    const long long bs = row / p.H;
    const int s = int(bs % p.Sq), b = int(bs / p.Sq);
    p.delta[((long long)b * p.H + h) * p.Sq + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// pass 2b (GQA): dK, dV = the sum of the group's G partials, in head order
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const float* ws, T* out, long long n, int K, int G,
                  int width) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;  // n = B·Sk·K·width outputs
  const int c = int(i % width);
  const long long bsk = i / width;  // (b·Sk + s)·K + kvh
  const int kvh = int(bsk % K);
  const long long bs = bsk / K;
  const float* src = ws + (bs * K * G + (long long)kvh * G) * width + c;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += src[(long long)g * width];
  out[i] = from_f32<T>(acc);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, mbarrier rings
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BT = 64;  // rows of a consumer warpgroup and of a streamed tile
constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory of a block
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 2;  // named barriers (0: sync)

// pass 2: the block's K and V tiles, a ring of (Q, dO, row stats) stages
// and the Pᵀ hand-over between the two consumer warpgroups
template <int NC, int NCV>
struct KvLayout {
  static constexpr int K_BYTES = NC * BT * ROW_BYTES;
  static constexpr int V_BYTES = NCV * BT * ROW_BYTES;
  static constexpr int Q_BYTES = NC * BT * ROW_BYTES;
  static constexpr int DO_BYTES = NCV * BT * ROW_BYTES;
  static constexpr int STAT_BYTES = BT * 8;  // (lse·log2 e, D) per q row
  static constexpr int P_BYTES = BT * BT * 4;
  // alignment slack + barriers + K + V + the hand-over
  static constexpr int FIXED = 1024 + 1024 + K_BYTES + V_BYTES + P_BYTES;
  static constexpr int STAGE = Q_BYTES + DO_BYTES + STAT_BYTES;
  static constexpr int STAGES_FIT = (SMEM_MAX - FIXED) / STAGE;
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

// pass 3: the block's Q and dO tiles (64 rows per consumer warpgroup) and
// a ring of (K, V) stages; two consumers where two stages fit beside
// their 128-row Q and dO tiles, else one
template <int NC, int NCV>
struct QLayout {
  static constexpr int CONS =
      2048 + 4 * (NC + NCV) * BT * ROW_BYTES <= SMEM_MAX ? 2 : 1;
  static constexpr int BQ = CONS * BT;
  static constexpr int THREADS = 128 * (CONS + 1);
  static constexpr int Q_BYTES = NC * BQ * ROW_BYTES;
  static constexpr int DO_BYTES = NCV * BQ * ROW_BYTES;
  static constexpr int K_BYTES = NC * BT * ROW_BYTES;
  static constexpr int V_BYTES = NCV * BT * ROW_BYTES;
  static constexpr int FIXED = 1024 + 1024 + Q_BYTES + DO_BYTES;
  static constexpr int STAGES_FIT = (SMEM_MAX - FIXED) / (K_BYTES + V_BYTES);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static constexpr int SMEM = FIXED + STAGES * (K_BYTES + V_BYTES);
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// pass 1, bf16: D_i = rowsum(dO ⊙ O), eight threads a row, each reading
// 16 bytes of O and of dO at a time (one warp a row, as `delta_kernel`,
// reads 2-16 bytes a lane and ran at ~1 TB/s)
__global__ void __launch_bounds__(256) delta_tc_kernel(Params p) {
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  float acc = 0.f;
  if (row < (long long)p.B * p.Sq * p.H) {
    const uint4* o = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.o) + row * p.Dv);
    const uint4* d = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.dout) + row * p.Dv);
    for (int c = part; c < p.Dv / 8; c += 8) {
      const uint4 a = o[c], b = d[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]);
        const float2 y = __bfloat1622float2(b2[i]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < (long long)p.B * p.Sq * p.H) {
    const int h = int(row % p.H);  // row = (b, s, h) in memory order
    const long long bs = row / p.H;
    const int s = int(bs % p.Sq), b = int(bs / p.Sq);
    p.delta[((long long)b * p.H + h) * p.Sq + s] = acc;
  }
}

// the forward's mask for (q position, k position)
__device__ __forceinline__ bool hidden(const Params& p, int q, int k) {
  return k >= p.Sk || (p.causal && q < k) ||
         (p.window > 0 && q - k >= p.window);
}

// a 64 x 64 f32 accumulator as wgmma A fragments (its columns are the k
// of the product, 16 a step) in two bf16 parts: hi = bf16(x) and
// lo = bf16(x - hi)
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
  }
}

// acc += (hi + lo) · B over 4 k steps of 16, for each of N 64-column
// boxes of B, read MN-major (transposed) from a swizzled tile of 64 rows
// a box at `tile`
template <int N>
__device__ __forceinline__ void product_rs(float (&acc)[N][32],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           uint32_t tile) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc(tile + c * BT * ROW_BYTES + kk * 16 * ROW_BYTES,
                              BT * ROW_BYTES / 16, 64);
      wgmma_rs(acc[c], hi[kk], d);
      wgmma_rs(acc[c], lo[kk], d);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < N; ++c) fence_regs(acc[c]);
}

// d = A · Bᵀ over N boxes of 64 columns, both read K-major from swizzled
// tiles: A's 64 rows at `a` with its boxes `a_box` bytes apart, B's 64
// rows at `b` in boxes of 64 rows.  Issued only: the caller fences,
// commits and waits.
template <int N>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a,
                                           int a_box, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4 * N; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns of a box
    wgmma_ss(d, desc(a + (kk / 4) * a_box + off, 1, 64),
             desc(b + (kk / 4) * BT * ROW_BYTES + off, 1, 64), kk > 0);
  }
}

// rows r0 and r0 + 8 (those below `rows`) of a 64-row accumulator tile of
// N boxes into `out` (row r at out + r·row_stride), the columns below
// `width`; f32 or bf16
template <int N, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[N][32], T* out,
                                           long long row_stride, int r0,
                                           int rows, int width, int t4) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * BOX + 8 * j + 2 * t4;
      if (col >= width) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r >= rows) continue;
        const float x = acc[c][4 * j + 2 * half];
        const float y = acc[c][4 * j + 2 * half + 1];
        T* dst = out + r * row_stride + col;
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x, y);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][32]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// ---------------------------------------------------------------------------
// pass 2: dK, dV per 64-row kv tile
// ---------------------------------------------------------------------------
template <int NC, int NCV>
__global__ void __launch_bounds__(384, 1)
    dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Params p) {
  using L = KvLayout<NC, NCV>;
  constexpr int ST = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on a multiple
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kv_full = base;
  const uint32_t full = base + 8;              // [ST]
  const uint32_t empty = base + 8 * (1 + ST);  // [ST]
  const uint32_t sk = base + 1024;
  const uint32_t sv = sk + L::K_BYTES;
  const uint32_t sq = sv + L::V_BYTES;         // [ST] tiles
  const uint32_t sdo = sq + ST * L::Q_BYTES;   // [ST] tiles
  const uint32_t sp = sdo + ST * L::DO_BYTES;  // the Pᵀ hand-over
  const uint32_t sst = sp + L::P_BYTES;        // [ST][BT] row stats
  float4* const p_x = reinterpret_cast<float4*>(smem_raw + (sp - raw));
  float2* const stats = reinterpret_cast<float2*>(smem_raw + (sst - raw));

  const bool gqa = p.dk_ws != nullptr;
  const int k0 = blockIdx.x * BT, unit = blockIdx.y, b = blockIdx.z;
  const int h = unit;  // the q head (G = 1 without the scratch)
  const int kvh = gqa ? unit / (p.H / p.K) : unit;
  // the q tiles whose rows can see a key of this tile
  const int k_last = min(k0 + BT, p.Sk) - 1;
  const int q_begin = p.causal ? k0 : 0;  // k0 is a multiple of BT
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BT - 1) / BT : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      // the TMA's expect_tx arrival and the producer warp's 32 (stats)
      mbar_init(full + 8 * s, 33);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one warp keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 2 * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, L::K_BYTES + L::V_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load(sk + c * BT * ROW_BYTES, &tk, kv_full, c * BOX, kvh, k0, b);
        for (int c = 0; c < NCV; ++c)
          tma_load(sv + c * BT * ROW_BYTES, &tv, kv_full, c * BOX, kvh, k0, b);
      }
      const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
      const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty + 8 * s, ((i / ST) - 1) & 1);
        const int q0 = q_begin + i * BT;
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, L::Q_BYTES + L::DO_BYTES);
          for (int c = 0; c < NC; ++c)
            tma_load(sq + s * L::Q_BYTES + c * BT * ROW_BYTES, &tq,
                     full + 8 * s, c * BOX, h, q0, b);
          for (int c = 0; c < NCV; ++c)
            tma_load(sdo + s * L::DO_BYTES + c * BT * ROW_BYTES, &tdo,
                     full + 8 * s, c * BOX, h, q0, b);
        }
        // rows past Sq: lse = +inf makes their P, and so dS, 0
        for (int r = lane; r < BT; r += 32) {
          const int q = q0 + r;
          stats[s * BT + r] = q < p.Sq
                                  ? make_float2(lse[q] * LOG2E, delta[q])
                                  : make_float2(inf(), 0.f);
        }
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // consumers: the same 64 kv rows, r0 and r0 + 8 in each thread
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int r0 = k0 + warp * 16 + lane / 4;
  const float scale_log2 = p.scale * LOG2E;
  // dK, dV rows: (b, s, kv head) of the outputs, or (b, s, q head) of the
  // f32 partials under GQA
  const long long heads = gqa ? p.H : p.K;
  const long long row0 = (long long)b * p.Sk * heads + (gqa ? h : kvh);
  mbar_wait(kv_full, 0);

  if (wg == 0) {
    // Sᵀ = K Qᵀ; Pᵀ = exp2(Sᵀ·scale·log2 e - lse·log2 e); dV += Pᵀ dO
    float dv[NCV][32];
    zero(dv);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      const int q0 = q_begin + i * BT;
      const uint32_t qs = sq + s * L::Q_BYTES, dos = sdo + s * L::DO_BYTES;
      mbar_wait(full + 8 * s, (i / ST) & 1);
      float x[32];
      wgmma_fence();
      product_ss<NC>(x, sk, BT * ROW_BYTES, qs);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);
      // x[4j + e] is (kv row r0, q col q0 + 8j + 2 t4 + e), x[4j + 2 + e]
      // (r0 + 8, the same col); the cols' stats are float2s in stats[s]
      const bool edge = k0 + BT > p.Sk || (p.causal && q0 < k0 + BT - 1) ||
                        (p.window > 0 && q0 + BT - 1 - k0 >= p.window);
      const float4* st = reinterpret_cast<const float4*>(stats + s * BT);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 cs = st[4 * j + t4];  // (lse2, D) of two cols
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = e ? cs.z : cs.x;
          float p0 = ex2(fmaf(x[4 * j + e], scale_log2, -l2));
          float p1 = ex2(fmaf(x[4 * j + 2 + e], scale_log2, -l2));
          if (edge) {
            const int qc = q0 + 8 * j + 2 * t4 + e;
            if (hidden(p, qc, r0)) p0 = 0.f;
            if (hidden(p, qc, r0 + 8)) p1 = 0.f;
          }
          x[4 * j + e] = p0;
          x[4 * j + 2 + e] = p1;
        }
      }
      // hand Pᵀ over once warpgroup 1 has read the previous one; thread
      // tid of warpgroup 1 holds the same (row, col) elements
      if (i > 0) bar_sync(BAR_P_EMPTY, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        p_x[j * 128 + tid] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      bar_arrive(BAR_P_FULL, 256);
      uint32_t hi[4][4], lo[4][4];
      split_frags(x, hi, lo);
      product_rs<NCV>(dv, hi, lo, dos);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (gqa)
      store_rows<NCV>(dv, p.dv_ws + row0 * p.Dv, heads * p.Dv, r0, p.Sk,
                      p.Dv, t4);
    else
      store_rows<NCV>(dv, static_cast<__nv_bfloat16*>(p.dv) + row0 * p.Dv,
                      heads * p.Dv, r0, p.Sk, p.Dv, t4);
  } else {
    // dPᵀ = V dOᵀ; dSᵀ = Pᵀ ⊙ (dPᵀ - D)·scale; dK += dSᵀ Q
    float dk[NC][32];
    zero(dk);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      const uint32_t qs = sq + s * L::Q_BYTES, dos = sdo + s * L::DO_BYTES;
      mbar_wait(full + 8 * s, (i / ST) & 1);
      float x[32];
      wgmma_fence();
      product_ss<NCV>(x, sv, BT * ROW_BYTES, dos);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);
      const float4* st = reinterpret_cast<const float4*>(stats + s * BT);
      bar_sync(BAR_P_FULL, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pt = p_x[j * 128 + tid];
        const float4 cs = st[4 * j + t4];  // (lse2, D) of two cols
        x[4 * j] = pt.x * (x[4 * j] - cs.y) * p.scale;
        x[4 * j + 1] = pt.y * (x[4 * j + 1] - cs.w) * p.scale;
        x[4 * j + 2] = pt.z * (x[4 * j + 2] - cs.y) * p.scale;
        x[4 * j + 3] = pt.w * (x[4 * j + 3] - cs.w) * p.scale;
      }
      if (i + 1 < n_tiles) bar_arrive(BAR_P_EMPTY, 256);
      uint32_t hi[4][4], lo[4][4];
      split_frags(x, hi, lo);
      product_rs<NC>(dk, hi, lo, qs);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    if (gqa)
      store_rows<NC>(dk, p.dk_ws + row0 * p.D, heads * p.D, r0, p.Sk, p.D,
                     t4);
    else
      store_rows<NC>(dk, static_cast<__nv_bfloat16*>(p.dk) + row0 * p.D,
                     heads * p.D, r0, p.Sk, p.D, t4);
  }
}

// ---------------------------------------------------------------------------
// pass 3: dQ per q tile, 64 rows per consumer warpgroup
// ---------------------------------------------------------------------------
template <int NC, int NCV>
__global__ void __launch_bounds__(QLayout<NC, NCV>::THREADS, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, Params p) {
  using L = QLayout<NC, NCV>;
  constexpr int ST = L::STAGES, CONS = L::CONS, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base;
  const uint32_t full = base + 8;              // [ST]
  const uint32_t empty = base + 8 * (1 + ST);  // [ST]
  const uint32_t sq = base + 1024;
  const uint32_t sdo = sq + L::Q_BYTES;
  const uint32_t sk = sdo + L::DO_BYTES;     // [ST] tiles
  const uint32_t sv = sk + ST * L::K_BYTES;  // [ST] tiles

  // the longest q tiles (most kv tiles under the causal mask) go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  // kv tiles some row of this q tile can see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % BT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BT - 1) / BT : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONS * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONS) {
    // producer: one thread keeps the ring full
    if constexpr (CONS > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONS * 128) {
      mbar_expect_tx(q_full, L::Q_BYTES + L::DO_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load(sq + c * BQ * ROW_BYTES, &tq, q_full, c * BOX, h, q0, b);
      for (int c = 0; c < NCV; ++c)
        tma_load(sdo + c * BQ * ROW_BYTES, &tdo, q_full, c * BOX, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty + 8 * s, ((i / ST) - 1) & 1);
        const int k0 = k_begin + i * BT;
        const uint32_t ks = sk + s * L::K_BYTES, vs = sv + s * L::V_BYTES;
        mbar_expect_tx(full + 8 * s, L::K_BYTES + L::V_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load(ks + c * BT * ROW_BYTES, &tk, full + 8 * s, c * BOX, kvh,
                   k0, b);
        for (int c = 0; c < NCV; ++c)
          tma_load(vs + c * BT * ROW_BYTES, &tv, full + 8 * s, c * BOX, kvh,
                   k0, b);
      }
    }
    return;
  }

  // consumers: 64 q rows per warpgroup, r0 and r0 + 8 in each thread
  if constexpr (CONS > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const int qa = q0 + wg * 64;            // this warpgroup's first row
  const int qb = min(qa + 63, p.Sq - 1);  // and its last live one
  const bool live = qa < p.Sq;
  const float scale_log2 = p.scale * LOG2E;
  // the rows' stats; rows past Sq: lse = +inf makes their P, and dS, 0
  float l2[2], dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const long long at = ((long long)b * p.H + h) * p.Sq + r;
    l2[half] = r < p.Sq ? p.lse[at] * LOG2E : inf();
    dd[half] = r < p.Sq ? p.delta[at] : 0.f;
  }
  const uint32_t q_tile = sq + wg * 64 * ROW_BYTES;
  const uint32_t do_tile = sdo + wg * 64 * ROW_BYTES;

  float dq[NC][32];
  zero(dq);
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const int k0 = k_begin + i * BT;
    const uint32_t ks = sk + s * L::K_BYTES, vs = sv + s * L::V_BYTES;
    // a tile that none of this warpgroup's rows can see: skip the
    // arithmetic, but wait for it so the empty arrival counts for it
    const bool skip = !live || (p.causal && k0 > qb) ||
                      (p.window > 0 && qa - (k0 + BT - 1) >= p.window);
    mbar_wait(full + 8 * s, (i / ST) & 1);
    if (!skip) {
      float x[32], dp[32];
      wgmma_fence();
      product_ss<NC>(x, q_tile, BQ * ROW_BYTES, ks);
      product_ss<NCV>(dp, do_tile, BQ * ROW_BYTES, vs);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);
      fence_regs(dp);
      // x[4j + e] is (row r0, kv col k0 + 8j + 2 t4 + e), x[4j + 2 + e]
      // (r0 + 8, the same col): dS = P ⊙ (dP - D)·scale, in place
      const bool edge = k0 + BT > p.Sk || (p.causal && k0 + BT - 1 > qa) ||
                        (p.window > 0 && qb - k0 >= p.window);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = k0 + 8 * j + 2 * t4 + e;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n = 4 * j + 2 * half + e;
            float pr = ex2(fmaf(x[n], scale_log2, -l2[half]));
            if (edge && hidden(p, r0 + 8 * half, kc)) pr = 0.f;
            x[n] = pr * (dp[n] - dd[half]) * p.scale;
          }
        }
      }
      uint32_t hi[4][4], lo[4][4];
      split_frags(x, hi, lo);
      product_rs<NC>(dq, hi, lo, ks);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  if (live)
    store_rows<NC>(dq,
                   static_cast<__nv_bfloat16*>(p.dq) +
                       ((long long)b * p.Sq * p.H + h) * p.D,
                   (long long)p.H * p.D, r0, p.Sq, p.D, t4);
}

template <int NC, int NCV>
int launch(const Params& p, cudaStream_t stream) {
  using KL = KvLayout<NC, NCV>;
  using QL = QLayout<NC, NCV>;
  // the wrapper passes contiguous tensors
  long long q_sb = (long long)p.Sq * p.H * p.D, q_ss = (long long)p.H * p.D,
            q_sh = p.D;
  long long o_sb = (long long)p.Sq * p.H * p.Dv,
            o_ss = (long long)p.H * p.Dv, o_sh = p.Dv;
  long long k_sb = (long long)p.Sk * p.K * p.D, k_ss = (long long)p.K * p.D,
            k_sh = p.D;
  long long v_sb = (long long)p.Sk * p.K * p.Dv,
            v_ss = (long long)p.K * p.Dv, v_sh = p.Dv;
  if (!tma_strides(p.q, p.B, p.Sq, p.H, p.D, &q_sb, &q_ss, &q_sh) ||
      !tma_strides(p.dout, p.B, p.Sq, p.H, p.Dv, &o_sb, &o_ss, &o_sh) ||
      !tma_strides(p.k, p.B, p.Sk, p.K, p.D, &k_sb, &k_ss, &k_sh) ||
      !tma_strides(p.v, p.B, p.Sk, p.K, p.Dv, &v_sb, &v_ss, &v_sh) ||
      reinterpret_cast<uintptr_t>(p.o) % 16)
    return -1;
  // Q and dO in 64-row boxes (pass 2) and in the dQ pass's BQ-row boxes
  CUtensorMap tq, tdo, tq_b, tdo_b, tk, tv;
  int err = make_map(&tq, p.q, p.B, p.Sq, p.H, p.D, q_sb, q_ss, q_sh, BT);
  if (!err)
    err = make_map(&tdo, p.dout, p.B, p.Sq, p.H, p.Dv, o_sb, o_ss, o_sh, BT);
  if (!err)
    err = make_map(&tq_b, p.q, p.B, p.Sq, p.H, p.D, q_sb, q_ss, q_sh, QL::BQ);
  if (!err)
    err = make_map(&tdo_b, p.dout, p.B, p.Sq, p.H, p.Dv, o_sb, o_ss, o_sh,
                   QL::BQ);
  if (!err)
    err = make_map(&tk, p.k, p.B, p.Sk, p.K, p.D, k_sb, k_ss, k_sh, BT);
  if (!err)
    err = make_map(&tv, p.v, p.B, p.Sk, p.K, p.Dv, v_sb, v_ss, v_sh, BT);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_tc_kernel<NC, NCV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KL::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_tc_kernel<NC, NCV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QL::SMEM);
  if (e != cudaSuccess) return int(e);

  const long long rows = (long long)p.B * p.Sq * p.H;
  delta_tc_kernel<<<unsigned((rows + 31) / 32), 256, 0, stream>>>(p);
  dim3 grid_kv((p.Sk + BT - 1) / BT, p.dk_ws ? p.H : p.K, p.B);
  dkdv_tc_kernel<NC, NCV><<<grid_kv, 384, KL::SMEM, stream>>>(tq, tdo, tk,
                                                               tv, p);
  if (p.dk_ws) {
    const int G = p.H / p.K;
    const long long nk = (long long)p.B * p.Sk * p.K * p.D;
    const long long nv = (long long)p.B * p.Sk * p.K * p.Dv;
    reduce_kernel<__nv_bfloat16>
        <<<unsigned((nk + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            p.dk_ws, static_cast<__nv_bfloat16*>(p.dk), nk, p.K, G, p.D);
    reduce_kernel<__nv_bfloat16>
        <<<unsigned((nv + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            p.dv_ws, static_cast<__nv_bfloat16*>(p.dv), nv, p.K, G, p.Dv);
  }
  dim3 grid_q((p.Sq + QL::BQ - 1) / QL::BQ, p.H, p.B);
  dq_tc_kernel<NC, NCV><<<grid_q, QL::THREADS, QL::SMEM, stream>>>(
      tq_b, tdo_b, tk, tv, p);
  return int(cudaGetLastError());
}

// (D boxes, Dv boxes): the forward's pairs
int run(const Params& p, cudaStream_t stream) {
  const int nc = (p.D + BOX - 1) / BOX, ncv = (p.Dv + BOX - 1) / BOX;
  if (nc == 1 && ncv == 1) return launch<1, 1>(p, stream);
  if (nc == 2 && ncv == 2) return launch<2, 2>(p, stream);
  if (nc == 3 && ncv == 2) return launch<3, 2>(p, stream);
  if (nc == 4 && ncv == 4) return launch<4, 4>(p, stream);
  return -1;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: tensor cores, three TF32 products per product (mma.sync)
// ---------------------------------------------------------------------------
namespace tf32 {

using namespace hopper;
using tc::hidden;
using tc::inf;

constexpr int BQ = 32;  // q rows of each tile a dK/dV block streams
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SM_SMEM = 228 * 1024;  // of an SM, 1 KB a block reserved

// whether two blocks of `bytes` share an SM
bool two_fit(size_t bytes) { return 2 * (bytes + 1024) <= SM_SMEM; }

// pass 2's shared memory at `warps` (8·warps kv rows): the block's K and V
// tiles, two stages of (Q, dO, the rows' (lse·log2 e, D)) and the Pᵀ
// hand-over
size_t kv_smem(int warps, int D, int Dv) {
  const size_t w = tile_ld(D) + tile_ld(Dv), kv = 8 * warps;
  return sizeof(float) * (kv * w + 2 * (BQ * w + 2 * BQ) + kv * BQ);
}

// pass 3's at `warps` (16·warps q rows): the block's Q and dO tiles and
// two stages of (K, V) tiles of `bk` rows
size_t dq_smem(int warps, int D, int Dv, int bk) {
  const size_t w = tile_ld(D) + tile_ld(Dv);
  return sizeof(float) * (16 * warps * w + 2 * bk * w);
}

// ---------------------------------------------------------------------------
// pass 2: dK, dV per kv tile of 8 rows a warp (32 or 64).  Warps 0 ..
// W/2 - 1 (16 rows each) compute Sᵀ = K Qᵀ, Pᵀ and dV += Pᵀ dO; warps W/2
// .. W - 1 the same rows' dPᵀ = V dOᵀ, dSᵀ = Pᵀ ⊙ (dPᵀ - D)·scale and dK
// += dSᵀ Q, with Pᵀ handed over in shared memory.  N: 32-column groups of
// max(D, Dv).
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(256) dkdv_f32_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = tile_ld(p.D), ldv = tile_ld(p.Dv);
  const int pairs = blockDim.x / 64, KV = 16 * pairs;
  float* const sk = smem;                   // KV x ldk
  float* const sv = sk + KV * ldk;          // KV x ldv
  float* const sq = sv + KV * ldv;          // [2] BQ x ldk
  float* const sdo = sq + 2 * BQ * ldk;     // [2] BQ x ldv
  float2* const stats = reinterpret_cast<float2*>(sdo + 2 * BQ * ldv);
  float4* const p_x = reinterpret_cast<float4*>(stats + 2 * BQ);

  const bool gqa = p.dk_ws != nullptr;
  const int k0 = blockIdx.x * KV, unit = blockIdx.y, b = blockIdx.z;
  const int h = unit;  // the q head (G = 1 without the scratch)
  const int kvh = gqa ? unit / (p.H / p.K) : unit;
  const float* q =
      static_cast<const float*>(p.q) + ((long long)b * p.Sq * p.H + h) * p.D;
  const float* dout = static_cast<const float*>(p.dout) +
                      ((long long)b * p.Sq * p.H + h) * p.Dv;
  const float* k =
      static_cast<const float*>(p.k) + ((long long)b * p.Sk * p.K + kvh) * p.D;
  const float* v = static_cast<const float*>(p.v) +
                   ((long long)b * p.Sk * p.K + kvh) * p.Dv;
  const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;
  // the q tiles whose rows can see a key of this tile
  const int k_last = min(k0 + KV, p.Sk) - 1;
  const int q_begin = p.causal ? k0 : 0;  // k0 is a multiple of BQ
  const int q_end = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;

  // stage s: the Q and dO rows of q tile i and their stats; rows past Sq
  // are zeros, and lse = +inf makes their P, and so dS, 0
  auto load_stage = [&](int i) {
    const int s = i & 1, q0 = q_begin + i * BQ;
    load_rows<true>(smem_u32(sq + s * BQ * ldk), ldk, q, (long long)p.H * p.D,
                    q0, BQ, p.Sq, p.D);
    load_rows<true>(smem_u32(sdo + s * BQ * ldv), ldv, dout,
                    (long long)p.H * p.Dv, q0, BQ, p.Sq, p.Dv);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      stats[s * BQ + threadIdx.x] = r < p.Sq
                                        ? make_float2(lse[r] * LOG2E, delta[r])
                                        : make_float2(inf(), 0.f);
    }
  };
  load_rows<true>(smem_u32(sk), ldk, k, (long long)p.K * p.D, k0, KV, p.Sk,
                  p.D);
  load_rows<true>(smem_u32(sv), ldv, v, (long long)p.K * p.Dv, k0, KV, p.Sk,
                  p.Dv);
  if (n_tiles) load_stage(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool role_p = warp < pairs;  // Sᵀ, Pᵀ, dV; else dPᵀ, dSᵀ, dK
  const int pair = warp % pairs;     // rows 16·pair .. of the kv tile
  const int r0 = k0 + 16 * pair + g;  // this thread's kv rows r0, r0 + 8
  const float scale_log2 = p.scale * LOG2E;
  const int width = role_p ? p.Dv : p.D;  // of the accumulator: dV or dK
  const float* ka = (role_p ? sk : sv) + 16 * pair * (role_p ? ldk : ldv);

  float acc[N][4][4];
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i is in; tile i - 1 and its Pᵀ are used up
    if (i + 1 < n_tiles) load_stage(i + 1);
    cp_async_commit();
    const int s = i & 1, q0 = q_begin + i * BQ;
    const float* qt = sq + s * BQ * ldk;
    const float* dot = sdo + s * BQ * ldv;
    const float4* st = reinterpret_cast<const float4*>(stats + s * BQ);
    // x[j][e] is (kv row r0, q col q0 + 8j + 2 t4 + e), x[j][2 + e] (r0 + 8,
    // the same col): Sᵀ, then Pᵀ (role P), or dPᵀ, then dSᵀ
    float x[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    // Sᵀ = K Qᵀ over D, or dPᵀ = V dOᵀ over Dv
    const int ldx = role_p ? ldk : ldv;
    product_rows<BQ / 8>(x, ka, ldx, role_p ? qt : dot, ldx,
                         role_p ? p.D : p.Dv, g, t4);
    const bool edge = k0 + KV > p.Sk || (p.causal && q0 < k0 + KV - 1) ||
                      (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
    if (role_p) {
      // Pᵀ = exp2(Sᵀ·scale·log2 e - lse·log2 e), 0 where the forward masked
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float4 cs = st[4 * j + t4];  // (lse2, D) of two cols
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = e ? cs.z : cs.x;
          float p0 = ex2(fmaf(x[j][e], scale_log2, -l2));
          float p1 = ex2(fmaf(x[j][2 + e], scale_log2, -l2));
          if (edge) {
            const int qc = q0 + 8 * j + 2 * t4 + e;
            if (hidden(p, qc, r0)) p0 = 0.f;
            if (hidden(p, qc, r0 + 8)) p1 = 0.f;
          }
          x[j][e] = p0;
          x[j][2 + e] = p1;
        }
        // to the warp of the other role on the same rows: its lane holds
        // the same elements
        p_x[(BQ / 8 * pair + j) * 32 + lane] =
            make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      }
    }
    __syncthreads();  // Pᵀ handed over
    if (!role_p) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float4 pt = p_x[(BQ / 8 * pair + j) * 32 + lane];
        const float4 cs = st[4 * j + t4];  // (lse2, D) of two cols
        x[j][0] = pt.x * (x[j][0] - cs.y) * p.scale;
        x[j][1] = pt.y * (x[j][1] - cs.w) * p.scale;
        x[j][2] = pt.z * (x[j][2] - cs.y) * p.scale;
        x[j][3] = pt.w * (x[j][3] - cs.w) * p.scale;
      }
    }
    // dV += Pᵀ dO, or dK += dSᵀ Q, over the tile's q rows
    const float* rt = role_p ? dot : qt;
    const int ldr = role_p ? ldv : ldk;
    uint32_t ab[BQ / 8][4], as[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) frag_a_acc(x[j], ab[j], as[j]);
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (32 * c < width)
        product_cols<BQ / 8>(acc[c], ab, as, rt + 32 * c, ldr, g, t4, 1.f,
                             1.f);
  }

  // dV (role P) or dK rows r0, r0 + 8: (b, s, kv head) of the outputs, or
  // (b, s, q head) of the f32 partials under GQA
  const long long heads = gqa ? p.H : p.K;
  float* out = role_p ? (gqa ? p.dv_ws : static_cast<float*>(p.dv))
                      : (gqa ? p.dk_ws : static_cast<float*>(p.dk));
  const int first = k0 + 16 * pair;
  out += ((long long)b * p.Sk * heads + (long long)first * heads +
          (gqa ? h : kvh)) * width;
#pragma unroll
  for (int c = 0; c < N; ++c)
    store_group(acc[c], out, heads * width, g, p.Sk - first, 32 * c + 8 * t4,
                width, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// pass 3: dQ per q tile, 16 rows a warp (64 or 128), over kv tiles of BK
// rows.  N: 32-column groups of max(D, Dv).
// ---------------------------------------------------------------------------
template <int N, int BK>
__global__ void __launch_bounds__(256) dq_f32_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = tile_ld(p.D), ldv = tile_ld(p.Dv);
  const int qrows = 16 * (blockDim.x / 32);
  float* const sq = smem;                    // qrows x ldk
  float* const sdo = sq + qrows * ldk;       // qrows x ldv
  float* const sk = sdo + qrows * ldv;       // [2] BK x ldk
  float* const sv = sk + 2 * BK * ldk;       // [2] BK x ldv

  // the longest q tiles (most kv tiles under the causal mask) go first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * qrows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const float* q =
      static_cast<const float*>(p.q) + ((long long)b * p.Sq * p.H + h) * p.D;
  const float* dout = static_cast<const float*>(p.dout) +
                      ((long long)b * p.Sq * p.H + h) * p.Dv;
  const float* k =
      static_cast<const float*>(p.k) + ((long long)b * p.Sk * p.K + kvh) * p.D;
  const float* v = static_cast<const float*>(p.v) +
                   ((long long)b * p.Sk * p.K + kvh) * p.Dv;
  // kv tiles some row of this q tile can see
  const int q_last = min(q0 + qrows, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const long long ks = (long long)p.K * p.D, vs = (long long)p.K * p.Dv;

  load_rows<true>(smem_u32(sq), ldk, q, (long long)p.H * p.D, q0, qrows,
                  p.Sq, p.D);
  load_rows<true>(smem_u32(sdo), ldv, dout, (long long)p.H * p.Dv, q0,
                  qrows, p.Sq, p.Dv);
  if (n_tiles) {
    load_rows<true>(smem_u32(sk), ldk, k, ks, k_begin, BK, p.Sk, p.D);
    load_rows<true>(smem_u32(sv), ldv, v, vs, k_begin, BK, p.Sk, p.Dv);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qa = q0 + 16 * warp;           // this warp's first row
  const int qb = min(qa + 15, p.Sq - 1);   // and its last live one
  const bool live = qa < p.Sq;
  const int r0 = qa + g;
  const float scale_log2 = p.scale * LOG2E;
  // the rows' stats; rows past Sq: lse = +inf makes their P, and dS, 0
  float l2[2], dd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const long long at = ((long long)b * p.H + h) * p.Sq + r;
    l2[half] = r < p.Sq ? p.lse[at] * LOG2E : inf();
    dd[half] = r < p.Sq ? p.delta[at] : 0.f;
  }
  const float* qw = sq + 16 * warp * ldk;
  const float* dow = sdo + 16 * warp * ldv;

  float dq[N][4][4];
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[c][n][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    if (i + 1 < n_tiles) {
      const int s = (i + 1) & 1, kn = k_begin + (i + 1) * BK;
      load_rows<true>(smem_u32(sk + s * BK * ldk), ldk, k, ks, kn, BK, p.Sk,
                      p.D);
      load_rows<true>(smem_u32(sv + s * BK * ldv), ldv, v, vs, kn, BK, p.Sk,
                      p.Dv);
    }
    cp_async_commit();
    const int k0 = k_begin + i * BK;
    // a tile that none of this warp's rows can see: no arithmetic
    if (!live || (p.causal && k0 > qb) ||
        (p.window > 0 && qa - (k0 + BK - 1) >= p.window))
      continue;
    const float* kt = sk + (i & 1) * BK * ldk;
    const float* vt = sv + (i & 1) * BK * ldv;
    float x[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = dp[j][e] = 0.f;
    // S = Q Kᵀ over D; dP = dO Vᵀ over Dv
    product_rows<BK / 8>(x, qw, ldk, kt, ldk, p.D, g, t4);
    product_rows<BK / 8>(dp, dow, ldv, vt, ldv, p.Dv, g, t4);
    // x[j][2 half + e] is (row r0 + 8 half, kv col k0 + 8j + 2 t4 + e): dS
    // = P ⊙ (dP - D)·scale, in place
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > qa) ||
                      (p.window > 0 && qb - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * half + e;
          float pr = ex2(fmaf(x[j][n], scale_log2, -l2[half]));
          if (edge && hidden(p, r0 + 8 * half, k0 + 8 * j + 2 * t4 + e))
            pr = 0.f;
          x[j][n] = pr * (dp[j][n] - dd[half]) * p.scale;
        }
      }
    }
    // dQ += dS K over the tile's kv rows
    uint32_t ab[BK / 8][4], as[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) frag_a_acc(x[j], ab[j], as[j]);
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (32 * c < p.D)
        product_cols<BK / 8>(dq[c], ab, as, kt + 32 * c, ldk, g, t4, 1.f,
                             1.f);
  }
  if (!live) return;
  const long long stride = (long long)p.H * p.D;
  float* out = static_cast<float*>(p.dq) +
               ((long long)b * p.Sq + qa) * stride + (long long)h * p.D;
#pragma unroll
  for (int c = 0; c < N; ++c)
    store_group(dq[c], out, stride, g, p.Sq - qa, 32 * c + 8 * t4, p.D, 1.f,
                1.f);
}

// four warps a dK/dV block (32 kv rows), two blocks an SM; eight (64
// rows) where two blocks of four do not fit beside each other but one of
// eight does (MLA)
int kv_warps(int D, int Dv) {
  return !two_fit(kv_smem(4, D, Dv)) &&
                 kv_smem(8, D, Dv) <= size_t(BLOCK_SMEM)
             ? 8
             : 4;
}

// a dQ block's warps (16 q rows each) and kv tile rows: four warps and 64
// rows, else 32, where two such blocks share an SM; else the first of (8,
// 32), (8, 24), (8, 16), (4, 32), (4, 16) whose tiles fit a block.  On the
// card 64 rows took minicpm-2b's backward from 2.124 ms to 2.018 and (8,
// 24) MLA's from 16.68 to 15.82, against (4, 32) and (8, 16)
// (launch/probe_flash_f32.py; H100 at 700 W).
void dq_shape(int D, int Dv, int* warps, int* bk) {
  const int two[2] = {64, 32};
  const int one[5][2] = {{8, 32}, {8, 24}, {8, 16}, {4, 32}, {4, 16}};
  *warps = 4;
  for (int k : two) {
    *bk = k;
    if (two_fit(dq_smem(4, D, Dv, k))) return;
  }
  for (const auto& wk : one)
    if (dq_smem(wk[0], D, Dv, wk[1]) <= size_t(BLOCK_SMEM)) {
      *warps = wk[0];
      *bk = wk[1];
      return;
    }
  *warps = *bk = 0;
}

template <int N, int BK>
int launch(const Params& p, int kvw, int dqw, cudaStream_t stream) {
  const size_t kv = kv_smem(kvw, p.D, p.Dv),
               dqs = dq_smem(dqw, p.D, p.Dv, BK);
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_f32_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(kv));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq_f32_kernel<N, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dqs));
  if (e != cudaSuccess) return int(e);

  const long long rows = (long long)p.B * p.Sq * p.H;
  delta_kernel<float><<<unsigned((rows + THREADS / 32 - 1) / (THREADS / 32)),
                        THREADS, 0, stream>>>(p);
  const int kv_rows = 8 * kvw;
  dim3 grid_kv((p.Sk + kv_rows - 1) / kv_rows, p.dk_ws ? p.H : p.K, p.B);
  dkdv_f32_kernel<N><<<grid_kv, 32 * kvw, kv, stream>>>(p);
  if (p.dk_ws) {
    const int G = p.H / p.K;
    const long long nk = (long long)p.B * p.Sk * p.K * p.D;
    const long long nv = (long long)p.B * p.Sk * p.K * p.Dv;
    reduce_kernel<float>
        <<<unsigned((nk + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            p.dk_ws, static_cast<float*>(p.dk), nk, p.K, G, p.D);
    reduce_kernel<float>
        <<<unsigned((nv + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
            p.dv_ws, static_cast<float*>(p.dv), nv, p.K, G, p.Dv);
  }
  const int q_rows = 16 * dqw;
  dim3 grid_q((p.Sq + q_rows - 1) / q_rows, p.H, p.B);
  dq_f32_kernel<N, BK><<<grid_q, 32 * dqw, dqs, stream>>>(p);
  return int(cudaGetLastError());
}

// kv tiles of 64 rows share an SM in pairs only where max(D, Dv) <= 96
// (1-3 groups), of 24 rows are taken only past 128 (6 or 8 groups)
template <int N>
int run_n(const Params& p, cudaStream_t stream) {
  int dqw, bk;
  dq_shape(p.D, p.Dv, &dqw, &bk);
  const int kvw = kv_warps(p.D, p.Dv);
  if (!dqw || kv_smem(kvw, p.D, p.Dv) > size_t(BLOCK_SMEM)) return -1;
  if (bk == 32) return launch<N, 32>(p, kvw, dqw, stream);
  if (bk == 16) return launch<N, 16>(p, kvw, dqw, stream);
  if constexpr (N <= 3)
    if (bk == 64) return launch<N, 64>(p, kvw, dqw, stream);
  if constexpr (N >= 6)
    if (bk == 24) return launch<N, 24>(p, kvw, dqw, stream);
  return -1;
}

int run(const Params& p, cudaStream_t stream) {
  // the wrapper passes contiguous tensors; rows start on 16 bytes where
  // every base does (D and Dv are multiples of 8)
  const void* const bases[] = {p.q, p.k, p.v, p.o, p.dout, p.dq, p.dk, p.dv};
  for (const void* t : bases)
    if (reinterpret_cast<uintptr_t>(t) % 16) return -1;
  switch (groups32(p.D > p.Dv ? p.D : p.Dv)) {
    case 1: return run_n<1>(p, stream);
    case 2: return run_n<2>(p, stream);
    case 3: return run_n<3>(p, stream);
    case 4: return run_n<4>(p, stream);
    case 6: return run_n<6>(p, stream);
    default: return run_n<8>(p, stream);
  }
}

}  // namespace tf32

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv).  delta:
// an f32 (B, H, Sq) scratch; dk_ws, dv_ws: f32 (B, Sk, H, D) and
// (B, Sk, H, Dv) scratches when H > K, else null.  Returns 0 once
// launched, a cudaError_t, 1000 + a CUresult if a tensor map could not be
// built, or -1 for arguments the kernels do not take (for bf16, a (D, Dv)
// box pair they are not instantiated for, or an unaligned q, k, v, dout).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* dk_ws, float* dv_ws, int dtype, int B, int H, int K,
    int Sq, int Sk, int D, int Dv, int causal, int window, float scale,
    void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 || Dv <= 0 || Dv > MAX_D || Dv % 8 ||
      K <= 0 || H % K || B <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 ||
      H > 65535 || ((H > K) != (dk_ws != nullptr)) ||
      ((H > K) != (dv_ws != nullptr)))
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.dk_ws = dk_ws;
  p.dv_ws = dv_ws;
  p.B = B;
  p.H = H;
  p.K = K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.Dv = Dv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return tf32::run(p, s);
  if (dtype == 1) return tc::run(p, s);
  return -1;
}
