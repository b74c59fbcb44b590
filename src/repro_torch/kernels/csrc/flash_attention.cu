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
// Two kernels, chosen by dtype (not a fallback: a failed bf16 launch
// raises):
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
// * float32 — the CUDA-core kernel of the first port (not redesigned):
//   f32 FMAs out of shared memory, one block of 256 threads per (64-row
//   q tile, q head, batch row).  It keeps the f32 path exact to ~1e-6,
//   which TF32 tensor cores would not.
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
// float32: CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid

size_t smem_bytes(int D, int Dv) {
  const int ld = D + 1;  // odd row stride: K-tile reads are conflict-free
  return sizeof(float) *
         (size_t(BQ) * ld + size_t(BK) * ld + size_t(BK) * Dv +
          size_t(BQ) * (BK + 1) + 3 * BQ);
}

// NJ: output columns tx + 16 j (of Dv), j < NJ, that each thread
// accumulates
template <int NJ>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ld = D + 1;
  float* Qs = smem;                   // BQ x ld
  float* Ks = Qs + BQ * ld;           // BK x ld
  float* Vs = Ks + BK * ld;           // BK x Dv
  float* Ps = Vs + BK * Dv;           // BQ x (BK + 1): scores, then probs
  float* row_m = Ps + BQ * (BK + 1);  // running max
  float* row_l = row_m + BQ;          // running denominator
  float* row_a = row_l + BQ;          // this tile's rescale factor

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D, s = q0 + r;
    Qs[r * ld + c] = s < p.Sq ? q[s * p.q_ss + c] : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG;
    row_l[tid] = 0.f;
  }

  // kv tiles some row of this q tile can see (positions, not rows)
  const int qo = query_offset(p);
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, qo + q_last + 1);
  int k_begin = p.window > 0 ? max(0, qo + q0 - p.window + 1) : 0;
  k_begin -= k_begin % BK;

  const int nd = (Dv + 15) / 16;  // output columns per thread, <= NJ
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed; Q tile and stats set
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D, s = k0 + r;
      Ks[r * ld + c] = s < p.Sk ? k[s * p.k_ss + c] : 0.f;
    }
    for (int i = tid; i < BK * Dv; i += THREADS) {
      const int r = i / Dv, c = i - r * Dv, s = k0 + r;
      Vs[r * Dv + c] = s < p.Sk ? v[s * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = qo + q0 + r, kpos = k0 + c;
        float bias = 0.f;
        if (kpos >= p.Sk) bias += NEG;
        if (p.causal && qpos < kpos) bias += NEG;
        if (p.window > 0 && qpos - kpos >= p.window) bias += NEG;
        Ps[r * (BK + 1) + c] = sc[i][j] * p.scale + bias;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row
    {
      const int r = tid >> 2, part = tid & 3;
      float* prow = Ps + r * (BK + 1);
      const float m_prev = row_m[r];
      float mx = NEG;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float e = expf(prow[c] - m_new);
        prow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int dc = tx + 16 * j;
        if (j < nd && dc < Dv) {
          const float vv = Vs[c * Dv + dc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= p.Sq) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    if (p.lse && tx == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + s] =
          row_m[r] + logf(fmaxf(row_l[r], 1e-30f));
    float* orow =
        out + ((long long)(b) * p.Sq + s) * p.H * Dv + (long long)h * Dv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int dc = tx + 16 * j;
      if (j < nd && dc < Dv) orow[dc] = acc[i][j] * inv;
    }
  }
}

template <int NJ>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd_kernel<NJ><<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

int run(const Params& p, int B, cudaStream_t stream) {
  if (p.Dv <= 128) return launch<8>(p, B, stream);
  return launch<16>(p, B, stream);
}

}  // namespace simt

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
  if (dtype == 0) return simt::run(p, B, s);
  if (dtype == 1) return tc::run(p, B, s);
  return -1;
}
