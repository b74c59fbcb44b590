// RG-LRU scan for NVIDIA Hopper (sm_90a): the gated linear recurrence
// h_t = a_t · h_{t-1} + x_t over time, with an f32 carry seeded by h0.
//
// Replaces the Pallas TPU kernel `rglru_scan_fwd`
// (src/repro/kernels/rglru_scan/kernel.py, pl.pallas_call in
// `rglru_scan_fwd`, body `_rglru_kernel`).  The TPU kernel walks time as
// the innermost, sequential grid axis with the carry in VMEM scratch and
// pads time with a = 1 rows for its tiling; here each thread owns one
// (batch row, channel), keeps the carry in a register and loops over time
// itself, so no padding exists.  Each step is a · h + x rounded twice
// (__fmul_rn, __fadd_rn: no fused multiply-add), the arithmetic of the
// plain PyTorch version, so f32 results match it bit for bit.
//
// What bounds it: 2 operations per element against x, a and out moved
// once each (3·B·S·dr elements), far below the card's operations per
// byte, so the bound is memory: 3·B·S·dr·4 bytes in f32 (92 MB at S =
// 3000, dr = 2560: 27 us at 3.35 TB/s).  The design: neighbouring threads
// take neighbouring channels, so every load and store of a step is
// coalesced; blocks of 64 threads spread B·dr/64 blocks over the SMs; each
// thread loads UNROLL steps of x and a before it runs their chain, so
// 2·UNROLL loads are in flight per thread.  With only B·dr threads (2560
// at batch 1) the loads in flight, not the bandwidth, set the time:
// splitting time into chunks scanned in parallel is later work.
//
// Layout: x, a and out (B, S, dr) contiguous, of one type (float32 or
// bfloat16); h0 (B, dr) contiguous float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const float* __restrict__ h0, T* __restrict__ out, int S,
                 int dr) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= dr) return;
  const long long base = (long long)b * S * dr + c;
  const T* xp = x + base;
  const T* ap = a + base;
  T* op = out + base;
  float h = h0[(long long)b * dr + c];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float xv[UNROLL], av[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      xv[u] = to_f32(xp[(long long)(t + u) * dr]);
      av[u] = to_f32(ap[(long long)(t + u) * dr]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      op[(long long)(t + u) * dr] = from_f32<T>(h);
    }
  }
  for (; t < S; ++t) {
    const long long off = (long long)t * dr;
    h = __fadd_rn(__fmul_rn(to_f32(ap[off]), h), to_f32(xp[off]));
    op[off] = from_f32<T>(h);
  }
}

template <typename T>
int launch(const void* x, const void* a, const float* h0, void* out, int B,
           int S, int dr, cudaStream_t stream) {
  dim3 grid((dr + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), h0,
      static_cast<T*>(out), S, dr);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a and out).  Returns a cudaError_t
// (0 = launched), or -1 for arguments the kernel does not take.
extern "C" int rglru_scan_fwd(const void* x, const void* a, const float* h0,
                              void* out, int dtype, int B, int S, int dr,
                              void* stream) {
  if (B <= 0 || S <= 0 || dr <= 0 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, h0, out, B, S, dr, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, a, h0, out, B, S, dr, s);
  return -1;
}
