// RG-LRU scan, backward, for NVIDIA Hopper (sm_90a): the gradient of
// h_t = a_t · h_{t-1} + x_t (rglru_scan.cu) given dy = dL/dh_t, the
// forward's h and its seed h0, as the reverse-time chain
//
//   dh_t = dy_t + a_{t+1} · dh_{t+1}      (t = S-1 down to 0; none past S-1)
//   dx_t = dh_t,  da_t = dh_t · h_{t-1}  (h_{-1} = h0),  dh0 = a_0 · dh_0.
//
// The JAX package differentiates its associative scan
// (src/repro/models/recurrent.py, `rglru_scan`) with JAX's own autodiff,
// h0 folded in as a virtual first step; it has no Pallas kernel for it.
// Each step rounds apart (__fadd_rn, __fmul_rn), the arithmetic of the
// plain PyTorch version's reverse loop, so f32 results match it bit for
// bit and a bf16 output is one rounding of the same f32 value.
//
// What bounds it: like the forward, bytes — dy, a and h read once, dx
// and da written once (5·B·S·dr elements) against 3 operations each —
// and, at batch 1, the chain: S dependent steps per channel.
//
// The design is the forward's (namespace `tma`), run backwards in time:
// a block owns cb channels of one batch row; one producer thread streams
// tiles of `rows` steps × cb channels of dy, a and h into a ring of
// `stages` slots with TMA (3-d tensor maps {dr, S, B}), the LAST tile
// first.  The h tile of time tile [t0, t0 + rows) is read one step
// earlier, [t0 - 1, t0 + rows - 1), so row r holds h_{t0+r-1}: TMA fills
// the row before t = 0 with zeros and the chain takes h0 there.  The
// consumer warp's lane c runs channel c's chain from the tile's last row
// to its first into two out tiles (dx, da), which TMA stores write back
// (dropping rows past S and channels past dr).  A row stride that is not
// a multiple of 16 bytes, or an unaligned base, goes to the thread-per-
// channel kernel (namespace `simt`, cb = 0).
//
// Layout: dy, a, h, dx, da (B, S, dr) contiguous, of one type (float32 or
// bfloat16); h0 and dh0 (B, dr) contiguous float32.
#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// one step of the reverse chain: g carries a_{t+1} · dh_{t+1} in, and
// a_t · dh_t out
__device__ __forceinline__ void step(float dy, float a, float h_prev,
                                     float& g, float& dx, float& da) {
  const float dh = __fadd_rn(dy, g);
  dx = dh;
  da = __fmul_rn(dh, h_prev);
  g = __fmul_rn(a, dh);
}

// ---------------------------------------------------------------------------
// a thread per (batch row, channel), loads straight from global memory
// ---------------------------------------------------------------------------
namespace simt {

constexpr int THREADS = 64;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_kernel(const T* __restrict__ dy, const T* __restrict__ a,
               const T* __restrict__ h, const float* __restrict__ h0,
               T* __restrict__ dx, T* __restrict__ da, float* __restrict__ dh0,
               int S, int dr) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= dr) return;
  const long long base = (long long)b * S * dr + c;
  const float first = h0[(long long)b * dr + c];
  float g = 0.f;
  for (int t = S - 1; t >= 0; --t) {
    const long long off = base + (long long)t * dr;
    const float hp = t > 0 ? to_f32(h[off - dr]) : first;
    float dxv, dav;
    step(to_f32(dy[off]), to_f32(a[off]), hp, g, dxv, dav);
    dx[off] = from_f32<T>(dxv);
    da[off] = from_f32<T>(dav);
  }
  dh0[(long long)b * dr + c] = g;
}

template <typename T>
int launch(const void* dy, const void* a, const void* h, const float* h0,
           void* dx, void* da, float* dh0, int B, int S, int dr,
           cudaStream_t stream) {
  dim3 grid((dr + THREADS - 1) / THREADS, B);
  bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(a),
      static_cast<const T*>(h), h0, static_cast<T*>(dx), static_cast<T*>(da),
      dh0, S, dr);
  return int(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// time tiles streamed into shared memory by TMA, last tile first
// ---------------------------------------------------------------------------
namespace tma {

constexpr int THREADS = 64;  // warp 0: the chains; warp 1, lane 0: TMA
constexpr int MAX_ROWS = 256;
constexpr int MAX_STAGES = 8;
constexpr int INS = 3;        // dy, a, h tiles per stage
constexpr int OUTS = 2;       // dx, da tiles per out slot
constexpr int OUT_SLOTS = 2;  // out slots: one filling, one being stored
constexpr int SLOT_ALIGN = 128;
constexpr int HEADER = 256;
constexpr int MAX_SMEM = 227 * 1024;

struct Params {
  const float* h0;
  float* dh0;
  int S, dr, rows, stages;
  int slot;  // bytes between tiles: a box, rounded up to 128
};

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

// one box of a 3-d tensor map {channel, time, batch} into shared memory;
// coordinates outside the tensor (t = -1) are filled with zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(t), "r"(b)
      : "memory");
}

// CB: channels a block owns.  Grid: (dr / CB rounded up, B); block:
// THREADS.  Shared memory: the barriers, then `stages` slots of three
// tiles (dy, a, h shifted one step back), then OUT_SLOTS pairs of out
// tiles (dx, da), each rows × CB elements.
template <typename T, int CB>
__global__ void __launch_bounds__(THREADS)
    bwd_kernel(const __grid_constant__ CUtensorMap tdy,
               const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap th,
               const __grid_constant__ CUtensorMap tdx,
               const __grid_constant__ CUtensorMap tda, Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((SLOT_ALIGN - (smem_u32(smem_raw) % SLOT_ALIGN)) %
                  SLOT_ALIGN);
  const uint32_t full = smem_u32(smem);          // [stages]
  const uint32_t empty = full + 8 * MAX_STAGES;  // [stages]
  uint8_t* const tiles = smem + HEADER;
  uint8_t* const outs = tiles + size_t(INS * p.stages) * p.slot;
  const int ST = p.stages;
  const int c0 = blockIdx.x * CB, b = blockIdx.y;
  const int n_tiles = (p.S + p.rows - 1) / p.rows;
  const uint32_t box = uint32_t(p.rows) * CB * sizeof(T);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 1) {
    // producer: the last time tile first
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty + 8 * s, ((i / ST) - 1) & 1);
        const int t0 = (n_tiles - 1 - i) * p.rows;
        const uint32_t dst = smem_u32(tiles + size_t(INS * s) * p.slot);
        mbar_expect_tx(full + 8 * s, INS * box);
        tma_load(dst, &tdy, full + 8 * s, c0, t0, b);
        tma_load(dst + p.slot, &ta, full + 8 * s, c0, t0, b);
        tma_load(dst + 2 * p.slot, &th, full + 8 * s, c0, t0 - 1, b);
      }
    }
    return;
  }

  // consumer: lane c runs channel c0 + c (lanes past CB repeat channel
  // c0 + CB - 1 and write the same values to the same place)
  const int col = min(lane, CB - 1);
  const float first = p.h0[(long long)b * p.dr + min(c0 + col, p.dr - 1)];
  float g = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const int os_slot = i % OUT_SLOTS;
    const int t0 = (n_tiles - 1 - i) * p.rows;
    uint8_t* const out_pair = outs + size_t(OUTS * os_slot) * p.slot;
    T* const dxs = reinterpret_cast<T*>(out_pair) + col;
    T* const das = reinterpret_cast<T*>(out_pair + p.slot) + col;
    // this out pair's last stores have read it
    if (lane == 0 && i >= OUT_SLOTS)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(OUT_SLOTS - 1)
                   : "memory");
    __syncwarp();
    mbar_wait(full + 8 * s, (i / ST) & 1);
    const uint8_t* const in = tiles + size_t(INS * s) * p.slot;
    const T* dys = reinterpret_cast<const T*>(in) + col;
    const T* as = reinterpret_cast<const T*>(in + p.slot) + col;
    const T* hs = reinterpret_cast<const T*>(in + 2 * p.slot) + col;
    const int n = min(p.rows, p.S - t0);  // rows of this tile < S
#pragma unroll 8
    for (int r = n - 1; r >= 0; --r) {
      const float hp = (t0 + r == 0) ? first : to_f32(hs[r * CB]);
      float dxv, dav;
      step(to_f32(dys[r * CB]), to_f32(as[r * CB]), hp, g, dxv, dav);
      dxs[r * CB] = from_f32<T>(dxv);
      das[r * CB] = from_f32<T>(dav);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty + 8 * s);
      tma_store(&tdx, smem_u32(out_pair), c0, t0, b);
      tma_store(&tda, smem_u32(out_pair + p.slot), c0, t0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (lane < CB && c0 + lane < p.dr) p.dh0[(long long)b * p.dr + c0 + lane] = g;
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

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

// a (B, S, dr) tensor as a 3-d map {dr, S, B} in boxes of cb channels ×
// rows steps of one batch row, unswizzled, zero-filled past its edges
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int dr,
             int cb, int rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return int(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(dr), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(dr) * sizeof(T),
                                 cuuint64_t(S) * dr * sizeof(T)};
  const cuuint32_t boxd[3] = {cuuint32_t(cb), cuuint32_t(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 4
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(
      map, dt, 3, const_cast<void*>(ptr), dims, strides, boxd, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + int(r);
}

template <typename T, int CB>
int launch(const void* dy, const void* a, const void* h, const float* h0,
           void* dx, void* da, float* dh0, int B, int S, int dr, int rows,
           int stages, cudaStream_t stream) {
  const void* ptrs[5] = {dy, a, h, dx, da};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return -1;
  if ((CB * sizeof(T)) % 16 || rows < 1 || rows > MAX_ROWS || stages < 1 ||
      stages > MAX_STAGES || (size_t(dr) * sizeof(T)) % 16)
    return -1;
  Params p;
  p.h0 = h0;
  p.dh0 = dh0;
  p.S = S;
  p.dr = dr;
  p.rows = rows;
  p.stages = stages;
  const int box = rows * CB * int(sizeof(T));
  p.slot = (box + SLOT_ALIGN - 1) / SLOT_ALIGN * SLOT_ALIGN;
  const size_t smem = SLOT_ALIGN + HEADER +
                      size_t(INS * stages + OUTS * OUT_SLOTS) * p.slot;
  if (smem > size_t(MAX_SMEM)) return -1;
  CUtensorMap m[5];
  int err = 0;
  for (int i = 0; i < 5 && !err; ++i)
    err = make_map<T>(&m[i], ptrs[i], B, S, dr, CB, rows);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_kernel<T, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  dim3 grid((dr + CB - 1) / CB, B);
  bwd_kernel<T, CB><<<grid, THREADS, smem, stream>>>(m[0], m[1], m[2], m[3],
                                                     m[4], p);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* dy, const void* a, const void* h, const float* h0,
        void* dx, void* da, float* dh0, int B, int S, int dr, int cb,
        int rows, int stages, cudaStream_t stream) {
  switch (cb) {
    case 8:
      return launch<T, 8>(dy, a, h, h0, dx, da, dh0, B, S, dr, rows, stages,
                          stream);
    case 16:
      return launch<T, 16>(dy, a, h, h0, dx, da, dh0, B, S, dr, rows, stages,
                           stream);
    case 32:
      return launch<T, 32>(dy, a, h, h0, dx, da, dh0, B, S, dr, rows, stages,
                           stream);
    default: return -1;
  }
}

}  // namespace tma

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, a, h, dx, da).  cb, rows, stages:
// the launch shape the wrapper picked (cb = 0: the thread-per-channel
// kernel).  Returns 0 once launched, a cudaError_t, 1000 + a CUresult if a
// tensor map could not be built, or -1 for arguments the kernel does not
// take.
extern "C" int rglru_scan_bwd(const void* dy, const void* a, const void* h,
                              const float* h0, void* dx, void* da, float* dh0,
                              int dtype, int B, int S, int dr, int cb,
                              int rows, int stages, void* stream) {
  if (B <= 0 || S <= 0 || dr <= 0 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cb == 0) {
    if (dtype == 0)
      return simt::launch<float>(dy, a, h, h0, dx, da, dh0, B, S, dr, s);
    if (dtype == 1)
      return simt::launch<__nv_bfloat16>(dy, a, h, h0, dx, da, dh0, B, S, dr,
                                         s);
    return -1;
  }
  if (dtype == 0)
    return tma::run<float>(dy, a, h, h0, dx, da, dh0, B, S, dr, cb, rows,
                           stages, s);
  if (dtype == 1)
    return tma::run<__nv_bfloat16>(dy, a, h, h0, dx, da, dh0, B, S, dr, cb,
                                   rows, stages, s);
  return -1;
}
