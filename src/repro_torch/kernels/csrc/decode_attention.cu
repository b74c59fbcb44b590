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
// The value head dim Dv may differ from the q/k head dim D, as the TPU
// kernel's (MLA: D = 192, Dv = 128): the q·k dot runs over D, and the
// accumulators, the merges and the output over Dv.
//
// What bounds it: every cache byte below valid_len is read once for about
// 4·G operations per bf16 pair, far below the card's ~295 operations per
// byte, so the bound is memory: valid_len·K·(D + Dv)·bytes per row.
// Reading those bytes fast takes many loads in flight on many SMs, and batch-1
// decode has few (batch row, kv head) pairs: recurrentgemma's MQA has
// one.  So the cache rows of each (batch row, kv head, group of query
// heads) are split over a thread-block cluster of up to 8 blocks
// (flash-decoding): the launch picks the split count from the cache
// length S (at least 32 rows a split) and the heads per block from B·K
// and the SM count, so that the grid fills the card; each block splits
// its row's min(valid_len, S) rows evenly by blockIdx.x.  In a block of
// 256 threads a row group of lanes takes one cache row at a time with
// 16-byte loads (16 lanes x 8 elements cover max(D, Dv) <= 128, a whole
// warp up to 256: MLA's D = 192 takes the whole warp, of which 16 lanes
// hold V's 128 columns), keeps its query heads in registers and runs its
// own online softmax.  Every load of a pass issues before any is used (a
// slot past the split's end reloads its last row), and the head groups of
// one kv head walk their rows from different offsets, so that they do not
// all ask for one line at once: on the card, branchy loads and that
// crowding each took a large share of the loop's time (PERF.md).  The row
// groups merge through shared memory into the block's partial (m, l,
// acc[G, Dv]) in f32.  Then the cluster merges its blocks'
// partials through distributed shared memory, each block a slice of the
// outputs, in split order 0, 1, ...: one launch per call, no scratch in
// device memory, and the same bits from run to run.  A split past a
// row's valid_len holds (m = -1e30, l = 0, acc = 0) and merges with
// weight 0.  Fewer heads per block means more blocks, each reading the
// kv head's rows again (from L2).
//
// Layout: q (B, H, D) and out (B, H, Dv) contiguous; k (B, S, K, D) and
// v (B, S, K, Dv) with the last dimension contiguous, the other strides
// given in elements and all multiples of 8, base pointers 16-byte
// aligned.  D and Dv are multiples of 8, at most 256; any G = H / K.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 256;
constexpr int MAX_SPLITS = 8;     // blocks per cluster (the portable most)
constexpr int MIN_SPLIT_ROWS = 32;
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* valid_len;
  void* out;
  int H, K, S, D, Dv;
  int GB;  // query heads per block: group z takes heads [z·GB, z·GB + GB)
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

size_t smem_bytes(int maxg, int Dv) {
  // per-warp partials, then the block's partial that the cluster reads
  return sizeof(float) * (size_t(WARPS) + 1) * maxg * (size_t(Dv) + 2);
}

// MAXG: registers for query heads (>= GB); ROWL: lanes per cache row.
// Grid: (splits, K · groups, B), clusters of (splits, 1, 1).
template <typename T, int MAXG, int ROWL>
__global__ void __launch_bounds__(THREADS) decode_kernel(Params p) {
  // rows each row group has in flight: more for few heads, fewer where
  // the query heads' registers are the scarcer resource
  constexpr int U = MAXG <= 2 ? 4 : (MAXG == 4 ? 2 : 1);
  constexpr int ROWS = THREADS / ROWL;  // row groups: one cache row each
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  float* part_acc = smem;                         // [WARPS][MAXG][Dv]
  float* part_m = part_acc + WARPS * MAXG * Dv;   // [WARPS][MAXG]
  float* part_l = part_m + WARPS * MAXG;          // [WARPS][MAXG]
  float* blk_acc = part_l + WARPS * MAXG;         // [MAXG][Dv]
  float* blk_m = blk_acc + MAXG * Dv;             // [MAXG]
  float* blk_l = blk_m + MAXG;                    // [MAXG]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_splits = gridDim.x;
  const int kh = blockIdx.y % p.K, b = blockIdx.z;
  const int G = p.H / p.K;
  const int g0 = (blockIdx.y / p.K) * p.GB;   // this block's first head
  const int Gb = min(p.GB, G - g0);           // and its head count
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = threadIdx.x / ROWL;         // this row group's id
  const int c0 = (lane % ROWL) * 8;           // this lane's 8 elements
  const bool active = c0 < D;                 // of q and k
  const bool active_v = c0 < Dv;              // of v and the output

  const int vl = p.valid_len[b];
  const bool uniform = vl <= 0;  // nothing valid: mean of V, as on the TPU
  const int n = uniform ? p.S : min(vl, p.S);
  // this split's rows [r_begin, r_end) of the n valid ones
  const int chunk = (n + n_splits - 1) / n_splits;
  const int r_begin = min(n, split * chunk);
  const int r_end = min(n, r_begin + chunk);

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

  // the head groups of one kv head read the same rows: each starts at
  // its own offset into the split, so they do not ask for one line at once
  const int n_rows = r_end - r_begin;
  const int n_groups = gridDim.y / p.K;
  const int rot =
      (int)((long long)(blockIdx.y / p.K) * n_rows / n_groups);
  // a lane past D reads k's last 8 columns (its q is 0), and a lane past
  // Dv v's last 8 (its accumulator is never stored)
  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh +
                   min(c0, D - 8);
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh +
                   min(c0, Dv - 8);
  // the loop bound is uniform over the block: every lane reaches every
  // shuffle; a slot past r_end reloads the split's last row (every load
  // issues, none waits on a branch) and is skipped in the update
  for (int base = r_begin; base < r_end; base += ROWS * U) {
    float kr[U][8], vr[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int row = base + u * ROWS + grp;
      if (row < r_end) {
        row += rot;
        if (row >= r_end) row -= n_rows;
      }
      row = min(row, r_end - 1);
      load8(kbase + row * p.k_ss, kr[u]);
      load8(vbase + row * p.v_ss, vr[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool valid = base + u * ROWS + grp < r_end;
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
  // then the warps, through shared memory, into the block's partial
  if (lane < ROWL) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (active_v)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part_acc[(warp * MAXG + g) * Dv + c0 + e] = acc[g][e];
      if (lane == 0) {
        part_m[warp * MAXG + g] = m[g];
        part_l[warp * MAXG + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < Gb * Dv; t += THREADS) {
    const int g = t / Dv, d = t - g * Dv;
    float mt = NEG;
    for (int w = 0; w < WARPS; ++w) mt = fmaxf(mt, part_m[w * MAXG + g]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float a = expf(part_m[w * MAXG + g] - mt);
      lt += part_l[w * MAXG + g] * a;
      at += part_acc[(w * MAXG + g) * Dv + d] * a;
    }
    blk_acc[t] = at;
    if (d == 0) {
      blk_m[g] = mt;
      blk_l[g] = lt;
    }
  }

  // the cluster's splits, in order 0, 1, ...: this block takes every
  // n_splits-th block of THREADS outputs
  cluster.sync();
  T* out = static_cast<T*>(p.out) + head0 * Dv;
  for (int t = split * THREADS + threadIdx.x; t < Gb * Dv;
       t += n_splits * THREADS) {
    const int g = t / Dv;
    float mt = NEG;
    for (int r = 0; r < n_splits; ++r)
      mt = fmaxf(mt, *cluster.map_shared_rank(blk_m + g, r));
    float lt = 0.f, at = 0.f;
    for (int r = 0; r < n_splits; ++r) {
      const float a = expf(*cluster.map_shared_rank(blk_m + g, r) - mt);
      lt += *cluster.map_shared_rank(blk_l + g, r) * a;
      at += *cluster.map_shared_rank(blk_acc + t, r) * a;
    }
    out[t] = from_f32<T>(at / fmaxf(lt, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its partial
}

int sm_count() {
  static const int n = []() {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      v = 132;
    return v;
  }();
  return n;
}

template <typename T, int MAXG, int ROWL>
int launch(const Params& p, int B, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(MAXG, p.Dv);
  auto kernel = decode_kernel<T, MAXG, ROWL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int G = p.H / p.K;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.K * ((G + p.GB - 1) / p.GB), B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T, int ROWL>
int dispatch_heads(const Params& p, int B, int splits, cudaStream_t stream) {
  if (p.GB <= 1) return launch<T, 1, ROWL>(p, B, splits, stream);
  if (p.GB <= 2) return launch<T, 2, ROWL>(p, B, splits, stream);
  if (p.GB <= 4) return launch<T, 4, ROWL>(p, B, splits, stream);
  return launch<T, 8, ROWL>(p, B, splits, stream);
}

template <typename T>
int dispatch(const Params& p, int B, int splits, cudaStream_t stream) {
  if (p.D <= 128 && p.Dv <= 128)
    return dispatch_heads<T, 16>(p, B, splits, stream);
  return dispatch_heads<T, 32>(p, B, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched),
// or -1 for arguments the kernel does not take.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* valid_len,
    void* out, int dtype, int B, int H, int K, int S, int D, int Dv,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, void* stream) {
  if (D <= 0 || D > MAX_D || D % 8 || Dv <= 0 || Dv > MAX_D || Dv % 8 ||
      K <= 0 || H % K || B <= 0 || S <= 0 || B > 65535 || H > 65535)
    return -1;
  const int G = H / K;
  // splits of the cache rows: at least MIN_SPLIT_ROWS each, at most a
  // cluster; then the most heads per block (8, 4, 2 or 1, in equal
  // groups) whose grid still fills the card, else one head per block
  const int splits =
      std::min(MAX_SPLITS, std::max(1, (S + MIN_SPLIT_ROWS - 1) /
                                           MIN_SPLIT_ROWS));
  int GB = 1;
  for (int cand : {8, 4, 2}) {
    const int n_groups = (G + cand - 1) / cand;
    if ((long long)B * K * n_groups * splits >= sm_count()) {
      GB = (G + n_groups - 1) / n_groups;  // equal head counts per block
      break;
    }
  }
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
  p.Dv = Dv;
  p.GB = GB;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, splits, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, splits, s);
  return -1;
}
