// AdamW's update of one leaf for NVIDIA Hopper (sm_90a): the clip, both
// moments, the bias-corrected step and the decoupled weight decay in one
// pass, in place on the parameter, m and v.
//
// Replaces no Pallas kernel: the reference's update is one XLA fusion of
// `repro.training.optimizer.adamw_update`; the port's plain version runs
// it as thirteen elementwise passes a leaf, each reading and writing the
// whole leaf (~124 bytes a parameter).  Per element, in f32:
//
//   g' = g·scale
//   m  = b1·m + (1 − b1)·g'
//   v  = b2·v + (1 − b2)·g'²
//   δ  = (m / bc1) / (√(v / bc2) + eps)   (+ wd·p where `decay`)
//   p  = p − lr·δ
//
// each step rounded as the plain version's CUDA passes round it (a product
// of a sum with a scalar `alpha` is one fused multiply-add, as PyTorch's
// add and addcmul kernels compile; divisions and the square root are IEEE
// round-to-nearest).  scale, lr, bc1 and bc2 are device scalars read
// through pointers, so nothing is read on the host and the launch can be
// captured in a CUDA graph.  The gradient is read, never written.
//
// What bounds it: ~16 operations against 28 bytes a parameter (g, p, m, v
// read once; p, m, v written once), far below the card's operations per
// byte, so the bound is memory: 28·n bytes, 14.9 GB and 4.44 ms for
// minicpm-2b's largest leaf (5.3e8 parameters) at 3.35 TB/s.  So the
// design only keeps the memory system busy:
//
// - Each thread moves 16-byte vectors with streaming loads and stores
//   (the leaf is touched once; it should not displace L2), UNROLL vectors
//   of each of the four arrays issued before any is used: 8 loads of 16
//   bytes in flight a thread.
// - A grid-stride loop over a fixed grid (the wrapper launches 8 blocks
//   of 256 threads an SM, all the card holds at once), with 64-bit
//   offsets: a stacked leaf of minicpm-2b holds 5.3e8 elements, 2.1 GB.
// - The last n mod 4 elements are a masked tail run by the first block's
//   first threads.
//
// Layout: g, p, m, v contiguous float32 of n elements, each on 16 bytes
// (the wrapper refuses others); scale, lr, bc1, bc2 float32 scalars on
// the device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
  int decay;
};

struct Scalars {
  float scale, lr, bc1, bc2;
};

__device__ __forceinline__ void update(float g, float& p, float& m, float& v,
                                       const Scalars& s, const Hyper& h) {
  const float gs = __fmul_rn(g, s.scale);
  m = __fmaf_rn(h.omb1, gs, __fmul_rn(m, h.b1));
  v = __fmaf_rn(h.omb2, __fmul_rn(gs, gs), __fmul_rn(v, h.b2));
  const float denom =
      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps);
  float delta = __fdiv_rn(__fdiv_rn(m, s.bc1), denom);
  if (h.decay) delta = __fmaf_rn(h.wd, p, delta);
  p = __fsub_rn(p, __fmul_rn(delta, s.lr));
}

__device__ __forceinline__ void update4(const float4& g, float4& p, float4& m,
                                        float4& v, const Scalars& s,
                                        const Hyper& h) {
  update(g.x, p.x, m.x, v.x, s, h);
  update(g.y, p.y, m.y, v.y, s, h);
  update(g.z, p.z, m.z, v.z, s, h);
  update(g.w, p.w, m.w, v.w, s, h);
}

__global__ void __launch_bounds__(THREADS)
    adamw_kernel(const float* __restrict__ g, float* __restrict__ p,
                 float* __restrict__ m, float* __restrict__ v, int64_t n,
                 const float* __restrict__ scale, const float* __restrict__ lr,
                 const float* __restrict__ bc1, const float* __restrict__ bc2,
                 Hyper h) {
  const Scalars s{*scale, *lr, *bc1, *bc2};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t n4 = n >> 2;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (; i + (UNROLL - 1) * stride < n4; i += UNROLL * stride) {
    float4 G[UNROLL], P[UNROLL], M[UNROLL], V[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t j = i + u * stride;
      G[u] = __ldcs(g4 + j);
      P[u] = __ldcs(p4 + j);
      M[u] = __ldcs(m4 + j);
      V[u] = __ldcs(v4 + j);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t j = i + u * stride;
      update4(G[u], P[u], M[u], V[u], s, h);
      __stcs(p4 + j, P[u]);
      __stcs(m4 + j, M[u]);
      __stcs(v4 + j, V[u]);
    }
  }
  for (; i < n4; i += stride) {
    const float4 G = __ldcs(g4 + i);
    float4 P = __ldcs(p4 + i), M = __ldcs(m4 + i), V = __ldcs(v4 + i);
    update4(G, P, M, V, s, h);
    __stcs(p4 + i, P);
    __stcs(m4 + i, M);
    __stcs(v4 + i, V);
  }
  // the ragged tail: the last n mod 4 elements
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const int64_t t = (n4 << 2) + threadIdx.x;
    float pt = p[t], mt = m[t], vt = v[t];
    update(g[t], pt, mt, vt, s, h);
    p[t] = pt;
    m[t] = mt;
    v[t] = vt;
  }
}

}  // namespace

// One leaf's update on `stream` over `blocks` blocks of THREADS threads.
// Returns a CUDA error code (0 on success).
extern "C" int adamw_update(const float* g, float* p, float* m, float* v,
                            long long n, const float* scale, const float* lr,
                            const float* bc1, const float* bc2, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, int decay, int blocks,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  const Hyper h{b1, omb1, b2, omb2, eps, wd, decay};
  adamw_kernel<<<blocks, THREADS, 0, stream>>>(g, p, m, v, n, scale, lr, bc1,
                                               bc2, h);
  return static_cast<int>(cudaGetLastError());
}
