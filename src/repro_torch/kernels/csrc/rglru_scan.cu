// RG-LRU scan for NVIDIA Hopper (sm_90a): the gated linear recurrence
// h_t = a_t · h_{t-1} + x_t over time, with an f32 carry seeded by h0.
//
// Replaces the Pallas TPU kernel `rglru_scan_fwd`
// (src/repro/kernels/rglru_scan/kernel.py, pl.pallas_call in
// `rglru_scan_fwd`, body `_rglru_kernel`).  The TPU kernel walks time as
// the innermost, sequential grid axis with the carry in VMEM scratch and
// pads time with a = 1 rows for its tiling; here one thread owns one
// (batch row, channel), keeps the carry in a register and runs the whole
// chain in time order, so no padding exists.  Each step is a · h + x
// rounded twice (__fmul_rn, __fadd_rn: no fused multiply-add), the
// arithmetic of the plain PyTorch version, so f32 results match it bit
// for bit and a bf16 output is one rounding of the same f32 value.
//
// What bounds it: 2 operations per element against x, a and out moved
// once each (3·B·S·dr elements), far below the card's operations per
// byte, so the bound is memory: 3·B·S·dr·4 bytes in f32 (92 MB at S =
// 3000, dr = 2560: 27 us at 3.35 TB/s).  The chain itself is S dependent
// multiply-adds, ~9 cycles a step with its operands in registers; so one
// sequential chain per channel can come near the bound if its loads
// arrive fast enough, which takes ~3 MB of loads in flight across the
// card.  Fed from shared memory the chain runs at ~22 cycles a step on the
// H100 (ptxas issues each step's shared loads just ahead of it): ~33 us at
// S = 3000, so at batch 1 the chain, not the bytes, sets the time.
//
// The design (namespace `tma`): a block owns cb channels (32; 16 or 8
// where 32 would leave more than half the SMs idle) of one batch row.
// One producer thread streams tiles of `rows` time steps × cb channels of
// x and of a into a ring of `stages` slots in shared memory with TMA (3-d
// tensor maps {dr, S, B}, so a tile never crosses a batch row; rows past
// S are zero-filled and never read), each slot guarded by a full and an
// empty mbarrier.  The consumer warp's lane c runs channel c's chain out
// of shared memory into an out tile, which a TMA store writes back (it
// drops rows past S and channels past dr); the consumer releases a slot
// once its rows are consumed.
//
// TMA steps in multiples of 16 bytes: a row stride dr·itemsize that is
// not one, or an x or a not 16-byte aligned, goes to the thread-per-
// channel kernel (namespace `simt`, chosen by the wrapper: cb = 0), which
// loads straight from global memory with 16 steps of loads in flight.
//
// Layout: x, a and out (B, S, dr) contiguous, of one type (float32 or
// bfloat16); h0 (B, dr) contiguous float32.
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

// ---------------------------------------------------------------------------
// a thread per (batch row, channel), loads straight from global memory:
// for shapes TMA cannot read
// ---------------------------------------------------------------------------
namespace simt {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

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

}  // namespace simt

// ---------------------------------------------------------------------------
// time tiles streamed into shared memory by TMA, one chain per channel
// ---------------------------------------------------------------------------
namespace tma {

constexpr int THREADS = 64;     // warp 0: the chains; warp 1, lane 0: TMA
constexpr int MAX_ROWS = 256;   // time steps a tile holds (TMA's box limit)
constexpr int MAX_STAGES = 8;
constexpr int UNROLL = 32;      // steps of the chain in one unrolled run
constexpr int OUT_SLOTS = 2;    // out tiles: one filling, one being stored
constexpr int SLOT_ALIGN = 128;  // a TMA destination's alignment
constexpr int HEADER = 256;      // the barriers, before the first slot
constexpr int MAX_SMEM = 227 * 1024;

struct Params {
  const float* h0;
  int S, dr, rows, stages;
  int slot;  // bytes between tiles in the ring: a box, rounded up to 128
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

// returns once the phase of parity `parity` has completed
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

// one box of a 3-d tensor map {channel, time, batch} into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(t), "r"(b)
      : "memory");
}

// a tile of shared memory into one box of a 3-d tensor map; the box's
// parts past the tensor's edges are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(t), "r"(b)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// UNROLL steps of the chain out of the x and a tiles into the out tile,
// all three of CB channels a row, from row r0: every shared access is an
// immediate offset from one base, so nothing but the chain is serial
template <typename T, int CB>
__device__ __forceinline__ void run_group(const T* xs, const T* as, T* os,
                                          int r0, float& h) {
  float xv[UNROLL], av[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    xv[u] = to_f32(xs[(r0 + u) * CB]);
    av[u] = to_f32(as[(r0 + u) * CB]);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
    os[(r0 + u) * CB] = from_f32<T>(h);
  }
}

// CB: channels a block owns (a compile-time stride keeps every shared
// access an immediate offset).  Grid: (dr / CB rounded up, B); block:
// THREADS.  Shared memory: the full and empty barriers of each stage,
// then the stages, each an x tile and an a tile of rows × CB elements,
// then OUT_SLOTS out tiles.
template <typename T, int CB>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap to, Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((SLOT_ALIGN - (smem_u32(smem_raw) % SLOT_ALIGN)) %
                  SLOT_ALIGN);
  const uint32_t full = smem_u32(smem);               // [stages]
  const uint32_t empty = full + 8 * MAX_STAGES;       // [stages]
  uint8_t* const tiles = smem + HEADER;
  uint8_t* const outs = tiles + size_t(2 * p.stages) * p.slot;
  const int ST = p.stages;
  const int c0 = blockIdx.x * CB, b = blockIdx.y;
  const int n_tiles = (p.S + p.rows - 1) / p.rows;
  const uint32_t box = uint32_t(p.rows) * CB * sizeof(T);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);  // the consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 1) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty + 8 * s, ((i / ST) - 1) & 1);
        const uint32_t xs = smem_u32(tiles + size_t(2 * s) * p.slot);
        mbar_expect_tx(full + 8 * s, 2 * box);
        tma_load(xs, &tx, full + 8 * s, c0, i * p.rows, b);
        tma_load(xs + p.slot, &ta, full + 8 * s, c0, i * p.rows, b);
      }
    }
    return;
  }

  // consumer: lane c runs channel c0 + c.  Lanes past CB run channel c0 +
  // CB - 1 again and write the same values to the same place; channels
  // past dr run on zeros and TMA drops them, as it drops rows past S.
  const int col = min(lane, CB - 1);
  float h = p.h0[(long long)b * p.dr + min(c0 + col, p.dr - 1)];
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST;
    const int os_slot = i % OUT_SLOTS;
    T* const os = reinterpret_cast<T*>(outs + size_t(os_slot) * p.slot) + col;
    // the out tile's last store has read it (at most OUT_SLOTS - 1 pending)
    if (lane == 0 && i >= OUT_SLOTS)
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(OUT_SLOTS - 1)
                   : "memory");
    __syncwarp();
    mbar_wait(full + 8 * s, (i / ST) & 1);
    const T* xs =
        reinterpret_cast<const T*>(tiles + size_t(2 * s) * p.slot) + col;
    const T* as = reinterpret_cast<const T*>(tiles + size_t(2 * s + 1) *
                                                         p.slot) + col;
    const int n = min(p.rows, p.S - i * p.rows);  // rows of this tile < S
    int r = 0;
    for (; r + UNROLL <= n; r += UNROLL) run_group<T, CB>(xs, as, os, r, h);
    for (; r < n; ++r) {
      h = __fadd_rn(__fmul_rn(to_f32(as[r * CB]), h), to_f32(xs[r * CB]));
      os[r * CB] = from_f32<T>(h);
    }
    // the out tile's writes seen by TMA; the x and a slot free again
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty + 8 * s);
      tma_store(&to, smem_u32(outs + size_t(os_slot) * p.slot), c0,
                i * p.rows, b);
    }
  }
  // every store has written its tile before the block ends
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function), found through the runtime
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

// a (B, S, dr) tensor as a 3-d map {dr, S, B} read in boxes of cb
// channels × rows time steps of one batch row, unswizzled; channels past
// dr and steps past S are filled with zeros
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
int launch(const void* x, const void* a, const float* h0, void* out, int B,
           int S, int dr, int rows, int stages, cudaStream_t stream) {
  if ((CB * sizeof(T)) % 16 || rows < 1 || rows > MAX_ROWS || stages < 1 ||
      stages > MAX_STAGES ||
      (size_t(dr) * sizeof(T)) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return -1;
  Params p;
  p.h0 = h0;
  p.S = S;
  p.dr = dr;
  p.rows = rows;
  p.stages = stages;
  const int box = rows * CB * int(sizeof(T));
  p.slot = (box + SLOT_ALIGN - 1) / SLOT_ALIGN * SLOT_ALIGN;
  const size_t smem =
      SLOT_ALIGN + HEADER + size_t(2 * stages + OUT_SLOTS) * p.slot;
  if (smem > size_t(MAX_SMEM)) return -1;
  CUtensorMap tx, ta, to;
  int err = make_map<T>(&tx, x, B, S, dr, CB, rows);
  if (!err) err = make_map<T>(&ta, a, B, S, dr, CB, rows);
  if (!err) err = make_map<T>(&to, out, B, S, dr, CB, rows);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<T, CB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  dim3 grid((dr + CB - 1) / CB, B);
  scan_kernel<T, CB><<<grid, THREADS, smem, stream>>>(tx, ta, to, p);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* a, const float* h0, void* out, int B,
        int S, int dr, int cb, int rows, int stages, cudaStream_t stream) {
  switch (cb) {
    case 8: return launch<T, 8>(x, a, h0, out, B, S, dr, rows, stages, stream);
    case 16:
      return launch<T, 16>(x, a, h0, out, B, S, dr, rows, stages, stream);
    case 32:
      return launch<T, 32>(x, a, h0, out, B, S, dr, rows, stages, stream);
    default: return -1;
  }
}

}  // namespace tma

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, a and out).  cb, rows, stages:
// the launch shape the wrapper picked (channels a block owns: 8, 16 or
// 32; time steps a tile holds; tiles in the ring); cb = 0 takes the
// thread-per-channel kernel.
// Returns 0 once launched, a cudaError_t, 1000 + a CUresult if a tensor
// map could not be built, or -1 for arguments the kernel does not take.
extern "C" int rglru_scan_fwd(const void* x, const void* a, const float* h0,
                              void* out, int dtype, int B, int S, int dr,
                              int cb, int rows, int stages, void* stream) {
  if (B <= 0 || S <= 0 || dr <= 0 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cb == 0) {
    if (dtype == 0) return simt::launch<float>(x, a, h0, out, B, S, dr, s);
    if (dtype == 1)
      return simt::launch<__nv_bfloat16>(x, a, h0, out, B, S, dr, s);
    return -1;
  }
  if (dtype == 0)
    return tma::run<float>(x, a, h0, out, B, S, dr, cb, rows, stages, s);
  if (dtype == 1)
    return tma::run<__nv_bfloat16>(x, a, h0, out, B, S, dr, cb, rows, stages,
                                   s);
  return -1;
}
