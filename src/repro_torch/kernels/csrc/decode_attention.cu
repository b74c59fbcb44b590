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
// per (kv head, batch row); each half-warp takes one cache row at a time
// (16 lanes x 8 elements cover D <= 128), keeps the G query heads of the
// kv head in registers, and runs its own online softmax; the 16
// half-warps merge through shared memory at the end.  With one block per
// kv head the grid is small at batch 1; splitting the rows of a long
// cache over several blocks is later work.
//
// Layout: q (B, H, D) and out (B, H, D) contiguous; k/v (B, S, K, D) with
// the last dimension contiguous, the other strides given in elements and
// all multiples of 8, base pointers 16-byte aligned.  D is a multiple of
// 8, at most 128; G = H / K at most 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HALVES = THREADS / 16;  // half-warps: one cache row each
constexpr int MAX_D = 128;
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  void* out;
  int H, K, S, D;
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

template <typename T, int MAXG>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  // rows each half-warp has in flight: more for few heads, fewer where
  // the G query heads' registers are the scarcer resource
  constexpr int U = MAXG <= 2 ? 4 : (MAXG == 4 ? 2 : 1);
  __shared__ float part_acc[WARPS][MAXG][MAX_D];
  __shared__ float part_m[WARPS][MAXG];
  __shared__ float part_l[WARPS][MAXG];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.K, D = p.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp * 2 + lane / 16;  // this half-warp's id
  const int c0 = (lane % 16) * 8;         // this lane's 8 elements
  const bool active = c0 < D;

  const int vl = p.valid_len[b];
  const bool uniform = vl <= 0;  // nothing valid: mean of V, as on the TPU
  const int n = uniform ? p.S : min(vl, p.S);

  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.H + kh * G) * D;
  float qr[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[g][e] = (g < G && active) ? to_f32(q[g * D + c0 + e]) : 0.f;

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
  for (int base = 0; base < n; base += HALVES * U) {
    float kr[U][8], vr[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * HALVES + half;
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
      const bool valid = base + u * HALVES + half < n;
      float s[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) t = fmaf(qr[g][e], kr[u][e], t);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
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

  // merge the two half-warps of each warp, then the warps
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
  if (lane < 16) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (active)
#pragma unroll
        for (int e = 0; e < 8; ++e) part_acc[warp][g][c0 + e] = acc[g][e];
      if (lane == 0) {
        part_m[warp][g] = m[g];
        part_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out) + ((long long)b * p.H + kh * G) * D;
  for (int t = threadIdx.x; t < G * D; t += THREADS) {
    const int g = t / D, d = t - g * D;
    float mt = NEG;
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, part_m[w][g]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(part_m[w][g] - mt);
      lt += part_l[w][g] * a;
      at += part_acc[w][g][d] * a;
    }
    out[t] = from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int MAXG>
int launch(const Params& p, int B, cudaStream_t stream) {
  decode_kernel<T, MAXG><<<dim3(p.K, B), THREADS, 0, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t stream) {
  const int G = p.H / p.K;
  if (G <= 1) return launch<T, 1>(p, B, stream);
  if (G <= 2) return launch<T, 2>(p, B, stream);
  if (G <= 4) return launch<T, 4>(p, B, stream);
  return launch<T, 8>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* valid_len,
    void* out, int dtype, int B, int H, int K, int S, int D, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 || K <= 0 || H % K || H / K > 8 ||
      B <= 0 || S <= 0)
    return -1;
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
