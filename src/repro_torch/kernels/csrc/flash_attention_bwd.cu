// Flash attention, backward, for NVIDIA Hopper (sm_90a).
//
// The JAX package has no Pallas kernel for this: its training attention
// is the `custom_vjp` in src/repro/models/layers.py (`_make_flash`, bwd),
// which recomputes the probabilities blockwise from the forward's
// log-sum-exp instead of keeping the S x S matrix, with
// D_i = rowsum(dO ⊙ O).  This is that algorithm as CUDA kernels, in f32
// on the CUDA cores (inputs of f32 or bf16 are widened as they are
// loaded; outputs in the inputs' type), with the forward's masking: an
// additive -1e30 for keys past Sk, for q_pos < k_pos under the causal
// mask and for q_pos - k_pos >= window.
//
//   P  = exp(scale · Q Kᵀ + bias - lse)
//   dV = Pᵀ dO        dP = dO Vᵀ        dS = P ⊙ (dP - D) · scale
//   dQ = dS K         dK = dSᵀ Q
//
// Three passes, deterministic, no atomics:
//  1. `delta_kernel`: D_i = rowsum(dO ⊙ O), one warp per (b, row, head),
//     into an f32 (B, H, Sq) scratch;
//  2. `dkdv_kernel`: one block per (kv tile, unit, b) keeps its K and V
//     tile in shared memory and loops over the q tiles that can see it,
//     recomputing P and dS tile by tile, with dK and dV accumulated in
//     registers.  A unit is a kv head when H = K: dK, dV are written in
//     the inputs' type.  Under GQA (G = H / K > 1) a unit is one q head,
//     which writes its own partial dK, dV in f32 to a (B, Sk, H, D)
//     scratch, and `reduce_kernel` sums the G heads of each group in head
//     order: G times the blocks of one kv head (recurrentgemma's K = 1,
//     H = 10 would otherwise run one block per kv tile, 96 at S = 3072,
//     fewer than the SMs);
//  3. `dq_kernel`: one block per (q tile, head, b) loops over the kv tiles
//     it can see and accumulates dQ.
// Passes 2 and 3 each recompute S and dP: 7 tile products per (q, kv)
// tile pair against the forward's 2.
//
// What bounds it: the products.  Per visible (q, k) pair and head, pass 2
// does S, dP, dV and dK (4·D + 4·Dv operations) and pass 3 S, dP and dQ
// (4·D + 2·Dv): 2·(4·D + 3·Dv) in all, on CUDA cores in f32 (67 TFLOP/s
// peak), against far fewer bytes (q, k, v, o, dO and lse read once, dq,
// dk, dv written once).  Each thread computes a block of BQ/16 x BK/16
// of a tile product out of shared memory with odd row strides, so reads
// are free of bank conflicts.  The tile sizes are picked for the widest
// head dim so that K, V, Q and dO tiles fit: (BQ, BK) = (64, 64) up to
// 64, (32, 64) up to 128 and (64, 32) up to 256 (215 KB of shared memory
// at D = Dv = 256; at recurrentgemma's train shape 22% faster than the
// (32, 32) tiles of 140 KB, H100 80GB HBM3 at 700 W).  Tensor cores
// (mma/wgmma) and TMA are a later redesign.
//
// Layout: q (B, Sq, H, D), k (B, Sk, K, D), v (B, Sk, K, Dv), o and dO
// (B, Sq, H, Dv), dq, dk, dv like q, k, v: all contiguous, of one type
// (float32 or bfloat16); lse (B, H, Sq) f32.  D and Dv are multiples of 8,
// at most 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 256;
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
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
// shared pieces of passes 2 and 3
// ---------------------------------------------------------------------------
// rows [r0, r0 + n) of a (.., S, heads, width) tensor at head `head` into
// a shared tile of n x (width + 1) f32; rows past S are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, int S, int heads, int head,
                                          int width) {
  const int ld = width + 1;
  for (int i = threadIdx.x; i < n * width; i += THREADS) {
    const int r = i / width, c = i - r * width, s = r0 + r;
    dst[r * ld + c] =
        s < S ? to_f32(src[((long long)s * heads + head) * width + c]) : 0.f;
  }
}

// The additive mask of the forward for (q position, k position)
__device__ __forceinline__ float mask_bias(const Params& p, int qpos,
                                           int kpos) {
  float bias = 0.f;
  if (kpos >= p.Sk) bias += NEG;
  if (p.causal && qpos < kpos) bias += NEG;
  if (p.window > 0 && qpos - kpos >= p.window) bias += NEG;
  return bias;
}

// P and dS of a BQ x BK tile pair from the tiles in shared memory: each
// thread its rows ty + 16 i, columns tx + 16 j.  Ps, dSs: BQ x (BK + 1).
// Rows past Sq get P = dS = 0.
template <int BQ, int BK>
__device__ __forceinline__ void probs_tile(const Params& p, const float* Qs,
                                           const float* dOs, const float* Ks,
                                           const float* Vs,
                                           const float* lse_s,
                                           const float* del_s, float* Ps,
                                           float* dSs, int q0, int k0) {
  constexpr int RI = BQ / 16, RJ = BK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ld = p.D + 1, ldv = p.Dv + 1;
  float sc[RI][RJ], dp[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) sc[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < p.D; ++d) {
    float qa[RI], kb[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) qa[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < RJ; ++j) kb[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
  }
  for (int d = 0; d < p.Dv; ++d) {
    float oa[RI], vb[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) oa[i] = dOs[(ty + 16 * i) * ldv + d];
#pragma unroll
    for (int j = 0; j < RJ; ++j) vb[j] = Vs[(tx + 16 * j) * ldv + d];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = tx + 16 * j;
      float pr = 0.f;
      if (qpos < p.Sq)
        pr = expf(sc[i][j] * p.scale + mask_bias(p, qpos, k0 + c) - lse_s[r]);
      Ps[r * (BK + 1) + c] = pr;
      dSs[r * (BK + 1) + c] = pr * (dp[i][j] - del_s[r]) * p.scale;
    }
  }
}

template <int BQ, int BK>
constexpr size_t smem_floats(int D, int Dv) {
  return size_t(BK) * (D + 1) + size_t(BK) * (Dv + 1) + size_t(BQ) * (D + 1) +
         size_t(BQ) * (Dv + 1) + 2 * size_t(BQ) * (BK + 1) + 2 * BQ;
}

// ---------------------------------------------------------------------------
// pass 2: dK, dV per kv tile
// ---------------------------------------------------------------------------
// NJ: columns tx + 16 j (j < NJ) of D and of Dv each thread accumulates
template <typename T, int BQ, int BK, int NJ>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv, ld = D + 1, ldv = Dv + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ldv;
  float* dOs = Qs + BQ * ld;
  float* Ps = dOs + BQ * ldv;
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* del_s = lse_s + BQ;

  const int G = p.H / p.K;
  const bool gqa = p.dk_ws != nullptr;
  const int k0 = blockIdx.x * BK, unit = blockIdx.y, b = blockIdx.z;
  const int kvh = gqa ? unit / G : unit;
  const int h = unit;  // without the scratch G = 1: the kv head's own
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int RK = BK / 16;

  const T* q = static_cast<const T*>(p.q) + (long long)b * p.Sq * p.H * D;
  const T* k = static_cast<const T*>(p.k) + (long long)b * p.Sk * p.K * D;
  const T* v = static_cast<const T*>(p.v) + (long long)b * p.Sk * p.K * Dv;
  const T* dout =
      static_cast<const T*>(p.dout) + (long long)b * p.Sq * p.H * Dv;
  const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;

  load_tile<T>(Ks, k, k0, BK, p.Sk, p.K, kvh, D);
  load_tile<T>(Vs, v, k0, BK, p.Sk, p.K, kvh, Dv);

  float adk[RK][NJ], adv[RK][NJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // the q rows that can see a key of this tile
  const int k_last = min(k0 + BK, p.Sk) - 1;
  int q_begin = p.causal ? k0 : 0;
  q_begin -= q_begin % BQ;
  const int q_end =
      p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;  // exclusive
  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous q tile fully used
    load_tile<T>(Qs, q, q0, BQ, p.Sq, p.H, h, D);
    load_tile<T>(dOs, dout, q0, BQ, p.Sq, p.H, h, Dv);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool in = q0 + r < p.Sq;
      lse_s[r] = in ? lse[q0 + r] : 0.f;
      del_s[r] = in ? delta[q0 + r] : 0.f;
    }
    __syncthreads();
    probs_tile<BQ, BK>(p, Qs, dOs, Ks, Vs, lse_s, del_s, Ps, dSs, q0, k0);
    __syncthreads();
    // dV[k][c] += P[q][k] dO[q][c]; dK[k][c] += dS[q][k] Q[q][c]
    for (int r = 0; r < BQ; ++r) {
      float pr[RK], ds[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pr[i] = Ps[r * (BK + 1) + ty + 16 * i];
        ds[i] = dSs[r * (BK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < Dv) {
          const float o = dOs[r * ldv + c];
#pragma unroll
          for (int i = 0; i < RK; ++i) adv[i][j] = fmaf(pr[i], o, adv[i][j]);
        }
        if (c < D) {
          const float qq = Qs[r * ld + c];
#pragma unroll
          for (int i = 0; i < RK; ++i) adk[i][j] = fmaf(ds[i], qq, adk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (gqa) {
        const long long row = ((long long)b * p.Sk + s) * p.H + h;
        if (c < D) p.dk_ws[row * D + c] = adk[i][j];
        if (c < Dv) p.dv_ws[row * Dv + c] = adv[i][j];
      } else {
        const long long row = ((long long)b * p.Sk + s) * p.K + kvh;
        if (c < D) static_cast<T*>(p.dk)[row * D + c] = from_f32<T>(adk[i][j]);
        if (c < Dv)
          static_cast<T*>(p.dv)[row * Dv + c] = from_f32<T>(adv[i][j]);
      }
    }
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
// pass 3: dQ per q tile
// ---------------------------------------------------------------------------
template <typename T, int BQ, int BK, int NJ>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv, ld = D + 1, ldv = Dv + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ldv;
  float* dOs = Qs + BQ * ld;
  float* Ps = dOs + BQ * ldv;
  float* dSs = Ps + BQ * (BK + 1);
  float* lse_s = dSs + BQ * (BK + 1);
  float* del_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int RQ = BQ / 16;

  const T* q = static_cast<const T*>(p.q) + (long long)b * p.Sq * p.H * D;
  const T* k = static_cast<const T*>(p.k) + (long long)b * p.Sk * p.K * D;
  const T* v = static_cast<const T*>(p.v) + (long long)b * p.Sk * p.K * Dv;
  const T* dout =
      static_cast<const T*>(p.dout) + (long long)b * p.Sq * p.H * Dv;
  const float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* delta = p.delta + ((long long)b * p.H + h) * p.Sq;

  load_tile<T>(Qs, q, q0, BQ, p.Sq, p.H, h, D);
  load_tile<T>(dOs, dout, q0, BQ, p.Sq, p.H, h, Dv);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < p.Sq;
    lse_s[r] = in ? lse[q0 + r] : 0.f;
    del_s[r] = in ? delta[q0 + r] : 0.f;
  }

  float adq[RQ][NJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adq[i][j] = 0.f;

  // the kv tiles some row of this q tile can see (as the forward's)
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Sk, q_last + 1) : p.Sk;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % BK;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous kv tile fully used; Q, dO, stats set
    load_tile<T>(Ks, k, k0, BK, p.Sk, p.K, kvh, D);
    load_tile<T>(Vs, v, k0, BK, p.Sk, p.K, kvh, Dv);
    __syncthreads();
    probs_tile<BQ, BK>(p, Qs, dOs, Ks, Vs, lse_s, del_s, Ps, dSs, q0, k0);
    __syncthreads();
    // dQ[q][c] += dS[q][k] K[k][c]
    for (int c2 = 0; c2 < BK; ++c2) {
      float ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = dSs[(ty + 16 * i) * (BK + 1) + c2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          const float kk = Ks[c2 * ld + c];
#pragma unroll
          for (int i = 0; i < RQ; ++i) adq[i][j] = fmaf(ds[i], kk, adq[i][j]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= p.Sq) continue;
    const long long row = ((long long)b * p.Sq + s) * p.H + h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dq[row * D + c] = from_f32<T>(adq[i][j]);
    }
  }
}

template <typename T, int BQ, int BK, int NJ>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats<BQ, BK>(p.D, p.Dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, BQ, BK, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T, BQ, BK, NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err != cudaSuccess) return int(err);

  const long long rows = (long long)p.B * p.Sq * p.H;
  delta_kernel<T><<<unsigned((rows + THREADS / 32 - 1) / (THREADS / 32)),
                    THREADS, 0, stream>>>(p);
  const int units = p.dk_ws ? p.H : p.K;
  dim3 grid_kv((p.Sk + BK - 1) / BK, units, p.B);
  dkdv_kernel<T, BQ, BK, NJ><<<grid_kv, THREADS, smem, stream>>>(p);
  if (p.dk_ws) {
    const int G = p.H / p.K;
    const long long nk = (long long)p.B * p.Sk * p.K * p.D;
    const long long nv = (long long)p.B * p.Sk * p.K * p.Dv;
    reduce_kernel<T><<<unsigned((nk + THREADS - 1) / THREADS), THREADS, 0,
                       stream>>>(p.dk_ws, static_cast<T*>(p.dk), nk, p.K, G,
                                 p.D);
    reduce_kernel<T><<<unsigned((nv + THREADS - 1) / THREADS), THREADS, 0,
                       stream>>>(p.dv_ws, static_cast<T*>(p.dv), nv, p.K, G,
                                 p.Dv);
  }
  dim3 grid_q((p.Sq + BQ - 1) / BQ, p.H, p.B);
  dq_kernel<T, BQ, BK, NJ><<<grid_q, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// tiles by the widest head dim (module comment)
template <typename T>
int run(const Params& p, cudaStream_t stream) {
  const int w = p.D > p.Dv ? p.D : p.Dv;
  if (w <= 64) return launch<T, 64, 64, 4>(p, stream);
  if (w <= 128) return launch<T, 32, 64, 8>(p, stream);
  return launch<T, 64, 32, 16>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv).  delta:
// an f32 (B, H, Sq) scratch; dk_ws, dv_ws: f32 (B, Sk, H, D) and
// (B, Sk, H, Dv) scratches when H > K, else null.  Returns 0 once
// launched, a cudaError_t, or -1 for arguments the kernel does not take.
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
  if (dtype == 0) return run<float>(p, s);
  if (dtype == 1) return run<__nv_bfloat16>(p, s);
  return -1;
}
