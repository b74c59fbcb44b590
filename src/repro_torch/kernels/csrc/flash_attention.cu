// Flash attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/kernel.py, pl.pallas_call in
// `flash_attention_fwd`, body `_flash_kernel`): grouped-query attention
// (q head h reads kv head h / (H / K)), an online softmax over kv tiles
// with an f32 running max, denominator and accumulator, a top-left
// aligned causal mask (q_pos >= k_pos), an optional sliding window
// (q_pos - k_pos < window) and a kv_len tail mask.  Masked logits get an
// additive -1e30, as in the TPU kernel.  Output in the input type.
//
// What bounds it: causal attention does 2·S²·D·H operations on
// 2·4·S·D·H bf16 bytes (q, k, v read once, out written once), S/4
// operations per byte.  Below the card's ~295 operations per byte (bf16
// tensor-core peak over HBM rate), that is up to S ≈ 1180, the bound is
// bytes; past it, arithmetic.  Either bound is far below this first
// version's time: it does the arithmetic as f32 FMAs on the CUDA cores
// out of shared memory (no tensor cores, no TMA), so the kernel is
// limited by its own FMA and shared-memory rate, not by either bound.
// One block of 256 threads per (batch, q head, 64-row q tile); the
// S×S score matrix never leaves shared memory, and kv tiles that the
// causal or window mask hides from every row of the tile are skipped.
// wgmma and TMA are later work.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, K, D) with the last dimension
// contiguous and the other strides given in elements; out is a
// contiguous (B, Sq, H, D).  D is a multiple of 8, at most 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int H, K, Sq, Sk, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;  // window <= 0: none
  float scale;
};

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

size_t smem_bytes(int D) {
  const int ld = D + 1;  // odd row stride: K-tile reads are conflict-free
  return sizeof(float) *
         (size_t(BQ) * ld + size_t(BK) * ld + size_t(BK) * D +
          size_t(BQ) * (BK + 1) + 3 * BQ);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* Qs = smem;                   // BQ x ld
  float* Ks = Qs + BQ * ld;           // BK x ld
  float* Vs = Ks + BK * ld;           // BK x D
  float* Ps = Vs + BK * D;            // BQ x (BK + 1): scores, then probs
  float* row_m = Ps + BQ * (BK + 1);  // running max
  float* row_l = row_m + BQ;          // running denominator
  float* row_a = row_l + BQ;          // this tile's rescale factor

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.K);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D, s = q0 + r;
    Qs[r * ld + c] = s < p.Sq ? to_f32(q[s * p.q_ss + c]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG;
    row_l[tid] = 0.f;
  }

  // kv tiles some row of this q tile can see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % BK;

  const int nd = (D + 15) / 16;  // output columns per thread, <= 8
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed; Q tile and stats set
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D, s = k0 + r;
      const bool ok = s < p.Sk;
      Ks[r * ld + c] = ok ? to_f32(k[s * p.k_ss + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f32(v[s * p.v_ss + c]) : 0.f;
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
        const int qpos = q0 + r, kpos = k0 + c;
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
      for (int j = 0; j < 8; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int dc = tx + 16 * j;
        if (j < nd && dc < D) {
          const float vv = Vs[c * D + dc];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= p.Sq) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    T* orow = out + ((long long)(b) * p.Sq + s) * p.H * D + (long long)h * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int dc = tx + 16 * j;
      if (j < nd && dc < D) orow[dc] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int K, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 || K <= 0 || H % K || B <= 0 || Sq <= 0 ||
      Sk <= 0)
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.H = H;
  p.K = K;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
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
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return -1;
}
