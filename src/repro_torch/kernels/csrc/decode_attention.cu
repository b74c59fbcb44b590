// Decode attention for NVIDIA Hopper (sm_90a): one query token per batch
// row against its KV cache.
//
// Replaces the Pallas TPU kernel `decode_attention_fwd`
// (src/repro/kernels/decode_attention/kernel.py, pl.pallas_call in
// `decode_attention_fwd`, body `_decode_kernel`): grouped-query heads
// (q head h reads kv head h / (H / K)), a per-row `valid_len` mask and an
// online softmax with f32 statistics.  Rows at or past `valid_len` are
// never read.  A row with `valid_len == 0` gets the mean of V over all S
// cache rows, which is what the TPU kernel's additive -1e30 mask gives.
//
// What bounds it: every cache byte below valid_len is read once for about
// 4·G operations per bf16 pair, far below the card's ~295 operations per
// byte, so the bound is memory: 2·valid_len·K·D·bytes per row.  The
// design streams the cache with 16-byte loads: one block of 256 threads
// per (kv head, batch row, group of up to 8 of the kv head's G query
// heads); a row group of lanes takes one cache row at a time (16 lanes x
// 8 elements cover D <= 128, a whole warp D <= 256), keeps its query
// heads in registers, and runs its own online softmax; the row groups
// merge through shared memory at the end.  G > 8 (recurrentgemma's 10)
// splits into ceil(G / 8) blocks of equal head counts, each reading the
// kv head's rows again (from L2 at batch 1).  With one block per kv head
// and head group the grid is small at batch 1; splitting the rows of a
// long cache over several blocks is later work.
//
// Layout: q (B, H, D) and out (B, H, D) contiguous; k/v (B, S, K, D) with
// the last dimension contiguous, the other strides given in elements and
// all multiples of 8, base pointers 16-byte aligned.  D is a multiple of
// 8, at most 256; any G = H / K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int MAX_GB = 8;  // query heads per block
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  void* out;
  int H, K, S, D;
  int GB;  // query heads per block: blockIdx.z takes heads [z·GB, z·GB + GB)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
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

// eight consecutive elements, 16-byte aligned, as f32
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// MAXG: registers for query heads (>= GB); ROWL: lanes per cache row
template <typename T, int MAXG, int ROWL>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  // rows each row group has in flight: more for few heads, fewer where
  // the query heads' registers are the scarcer resource
  constexpr int U = MAXG <= 2 ? 4 : (MAXG == 4 ? 2 : 1);
  constexpr int ROWS = THREADS / ROWL;  // row groups: one cache row each
  extern __shared__ float smem[];
  const int D = p.D;
  float* part_acc = smem;                         // [WARPS][MAXG][D]
  float* part_m = part_acc + WARPS * MAXG * D;    // [WARPS][MAXG]
  float* part_l = part_m + WARPS * MAXG;          // [WARPS][MAXG]

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.K;
  const int g0 = blockIdx.z * p.GB;           // this block's first head
  const int Gb = min(p.GB, G - g0);           // and its head count
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = threadIdx.x / ROWL;         // this row group's id
  const int c0 = (lane % ROWL) * 8;           // this lane's 8 elements
  const bool active = c0 < D;

  const int vl = p.valid_len[b];
  const bool uniform = vl <= 0;  // nothing valid: mean of V, as on the TPU
  const int n = uniform ? p.S : min(vl, p.S);

  const long long head0 = (long long)b * p.H + kh * G + g0;
  const T* q = static_cast<const T*>(p.q) + head0 * D;
  float qr[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = (g < Gb && active) ? to_f32(q[g * D + c0 + e]) : 0.f;

  float m[MAXG], l[MAXG], acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh + c0;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh + c0;
  // the loop bound is uniform over the block: every lane reaches every
  // shuffle; rows past n are loaded as zeros and skipped in the update
  for (int base = 0; base < n; base += ROWS * U) {
    float kr[U][8], vr[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * ROWS + grp;
      if (row < n && active) {
        load8(kbase + row * p.k_ss, kr[u]);
        load8(vbase + row * p.v_ss, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool valid = base + u * ROWS + grp < n;
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) t = fmaf(qr[g][e], kr[u][e], t);
#pragma unroll
        for (int off = ROWL / 2; off > 0; off >>= 1)
          t += __shfl_xor_sync(0xffffffffu, t, off);
        s[g] = t;
      }
      if (!valid) continue;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float sc = uniform ? 0.f : s[g] * p.scale;
        const float mn = fmaxf(m[g], sc);
        const float a = expf(m[g] - mn), pr = expf(sc - mn);
        l[g] = l[g] * a + pr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vr[u][e], acc[g][e] * a);
        m[g] = mn;
      }
    }
  }

  if constexpr (ROWL == 16) {
    // merge the two half-warps of each warp
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], 16);
      const float mt = fmaxf(m[g], mo);
      const float a = expf(m[g] - mt), ao = expf(mo - mt);
      l[g] = l[g] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xo = __shfl_xor_sync(0xffffffffu, acc[g][e], 16);
        acc[g][e] = acc[g][e] * a + xo * ao;
      }
      m[g] = mt;
    }
  }
  // then the warps, through shared memory
  if (lane < ROWL) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (active)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part_acc[(warp * MAXG + g) * D + c0 + e] = acc[g][e];
      if (lane == 0) {
        part_m[warp * MAXG + g] = m[g];
        part_l[warp * MAXG + g] = l[g];
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out) + head0 * D;
  for (int t = threadIdx.x; t < Gb * D; t += THREADS) {
    const int g = t / D, d = t - g * D;
    float mt = NEG;
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, part_m[w * MAXG + g]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(part_m[w * MAXG + g] - mt);
      lt += part_l[w * MAXG + g] * a;
      at += part_acc[(w * MAXG + g) * D + d] * a;
    }
    out[t] = from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int MAXG, int ROWL>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * WARPS * MAXG * (size_t(p.D) + 2);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, MAXG, ROWL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int G = p.H / p.K;
  dim3 grid(p.K, B, (G + p.GB - 1) / p.GB);
  decode_kernel<T, MAXG, ROWL><<<grid, THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, int ROWL>
int dispatch_heads(const Params& p, int B, cudaStream_t stream) {
  if (p.GB <= 1) return launch<T, 1, ROWL>(p, B, stream);
  if (p.GB <= 2) return launch<T, 2, ROWL>(p, B, stream);
  if (p.GB <= 4) return launch<T, 4, ROWL>(p, B, stream);
  return launch<T, 8, ROWL>(p, B, stream);
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t stream) {
  if (p.D <= 128) return dispatch_heads<T, 16>(p, B, stream);
  return dispatch_heads<T, 32>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* valid_len,
    void* out, int dtype, int B, int H, int K, int S, int D, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 || K <= 0 || H % K || B <= 0 ||
      S <= 0 || B > 65535)
    return -1;
  const int G = H / K;
  const int n_groups = (G + MAX_GB - 1) / MAX_GB;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid_len = valid_len;
  p.out = out;
  p.H = H;
  p.K = K;
  p.S = S;
  p.D = D;
  p.GB = (G + n_groups - 1) / n_groups;  // equal head counts per block
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, s);
  return -1;
}
