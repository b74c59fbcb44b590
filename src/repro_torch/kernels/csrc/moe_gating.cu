// Fused MoE gating for NVIDIA Hopper (sm_90a): router softmax, top-k,
// renormalised gates and first-come-first-served capacity slots; or, in
// its dropless mode, the published DeepSeek-V2 routing and every entry's
// row in expert-sorted order.
//
// Replaces the Pallas TPU kernel `moe_gating_fwd`
// (src/repro/kernels/moe_gating/kernel.py, pl.pallas_call in
// `moe_gating_fwd`, body `_gating_kernel`).  Per token: probs =
// softmax(logits) in f32; the top k of probs, the lower expert index first
// on ties (lax.top_k's order); gates = the top probs / max(their sum,
// 1e-9).  Per entry of the flattened (token, k) order: its position among
// the earlier entries of the same expert, slot = expert·C + position,
// keep = position < C; a dropped entry gets slot expert·C.
//
// The positions must come out first come, first served: an atomicAdd per
// entry would give each entry a place that depends on the order threads
// happen to run, not on the entry's place in the token order.  The TPU
// kernel runs its token blocks in order and carries E counters in VMEM.
//
// What bounds it: the logits are read once (T·E·4 bytes, 256 KB at T =
// 512 and E = 128) and each entry written once, well under a microsecond
// of memory time; the launch and the chain of dependent steps (load a
// row, reduce, rank) take longer.  So the design shortens that chain:
//
// - One thread-block cluster of nb blocks (up to 16 where the card can
//   place a non-portable cluster of 16 blocks of 1024 threads, else 8),
//   launched with cudaLaunchKernelEx; at T <= 32 a single block of 32·T
//   threads and no cluster (a decode step).  The wrapper picks nb and the
//   threads (`moe_gating_max_blocks` says how many blocks it may take).
// - Pass 1: block r owns tokens [r·Tb, (r+1)·Tb); a warp takes a token at
//   a time (softmax, k arg-max passes, gates), but first issues the loads
//   of up to G of its tokens, so their round trips to memory overlap.
//   Expert e sits at lane e % 32, slot e / 32: each load of a warp reads
//   32 neighbouring floats.  Each block counts its entries per expert in
//   shared memory (integer adds: exact in any order).
// - Offsets: after a cluster barrier each block reads the histograms of
//   the lower-ranked blocks through distributed shared memory and adds
//   them in rank order: exact integers, no atomics across blocks, no
//   scratch in device memory.
// - Pass 2: each block walks its own entries in order, in tiles of its
//   thread count, with E running counters started from those offsets.
//   Inside a tile an entry's rank is the number of earlier lanes of its
//   warp with the same expert (__match_any_sync) plus the counts of the
//   earlier warps, so nothing depends on scheduling and the result is the
//   same every run.  A last cluster barrier keeps each block's histogram
//   alive until every block has read it.
//
// Routing options (both modes).  Group-limited routing (n_groups > 1,
// DeepSeek-V2's `group_limited_greedy`): the experts fall into n_groups
// groups of E / n_groups in index order, a group's score is the largest
// prob of its experts, the topk_groups best groups are kept (the lower
// group first on ties) and the top k are taken among their experts alone.
// Without renorm the gate is the prob times `scale` (the routed scaling
// factor), not renormalised.  n_groups = 1 with renorm is the mode above,
// bit for bit.
//
// Dropless mode (C = 0): no entry is dropped.  After pass 1 every block
// reads every block's histogram, so each knows all the experts' totals;
// warp 0 scans them into each expert's first row, and pass 2 hands out
// rows from there, first come, first served as above: slot = the entry's
// row in expert-sorted order (experts ascending, (token, k) order within
// one), keep = expert < held (the experts this device holds are 0..held-1,
// so their rows come first), and block 0 writes ends[e], the end of expert
// e's rows (the inclusive prefix of the totals): what a grouped product
// over the held experts takes as its offsets.
//
// Layout: logits (T, E) contiguous float32; eids, slots (T, k) int32,
// gates (T, k) float32, keep (T, k) bytes 0/1, all contiguous; ends (E,)
// int32 (dropless mode only).  E <= 256, 1 <= k <= min(E, 8); n_groups <=
// 32 divides E, 1 <= topk_groups <= n_groups, k <= topk_groups · E /
// n_groups.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_E = 256;
constexpr int MAX_K = 8;
constexpr int PORTABLE_BLOCKS = 8;  // a cluster every sm_90 card takes
constexpr int MAX_BLOCKS = 16;      // a non-portable cluster, where it fits

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One token's routing by one warp: p holds the logits of experts lane +
// 32·i (-inf past E).  Lanes < k return their entry's expert and gate.
template <int PL>
__device__ __forceinline__ void route(float (&p)[PL], int lane, int E, int k,
                                      int n_groups, int topk_groups,
                                      bool renorm, float scale, int& my_eid,
                                      float& my_gate) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PL; ++i) mx = fmaxf(mx, p[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    if (lane + 32 * i < E) {
      p[i] = expf(p[i] - mx);
      sum += p[i];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
  for (int i = 0; i < PL; ++i)
    p[i] = lane + 32 * i < E ? p[i] / sum : -1.f;  // -1: never chosen

  if (n_groups > 1) {
    // lane g holds group g's score (the max of its probs, exact in any
    // order); the best topk_groups groups are kept, the lower on ties
    const int gs = E / n_groups;
    float my_score = -2.f;  // lanes past the groups: never kept
    for (int g = 0; g < n_groups; ++g) {
      float m = -2.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int e = lane + 32 * i;
        if (e >= g * gs && e < (g + 1) * gs) m = fmaxf(m, p[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == g) my_score = m;
    }
    unsigned kept = 0u;
    for (int j = 0; j < topk_groups; ++j) {
      float bv = my_score;
      int bi = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      kept |= 1u << bi;
      if (lane == bi) my_score = -3.f;  // taken
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int e = lane + 32 * i;
      if (e < E && !((kept >> (e / gs)) & 1u)) p[i] = -1.f;
    }
  }

  float top_sum = 0.f, my_prob = 0.f;
  my_eid = 0;
  for (int j = 0; j < k; ++j) {
    // this lane's best; its experts rise with i, so '>' keeps the lower
    float bv = -2.f;
    int bi = MAX_E;
#pragma unroll
    for (int i = 0; i < PL; ++i)
      if (p[i] > bv) {
        bv = p[i];
        bi = lane + 32 * i;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == j) {
      my_eid = bi;
      my_prob = bv;
    }
    top_sum += bv;
#pragma unroll
    for (int i = 0; i < PL; ++i)
      if (lane + 32 * i == bi) p[i] = -1.f;
  }
  my_gate = renorm ? my_prob / fmaxf(top_sum, 1e-9f) : my_prob * scale;
}

// PL: experts per lane (E <= 32·PL).  Grid: nb blocks, one cluster.
template <int PL>
__global__ void __launch_bounds__(MAX_THREADS)
    gating_kernel(const float* __restrict__ logits, int T, int E, int k,
                  int C, int n_groups, int topk_groups, bool renorm,
                  float scale, int held, int* eids, float* gates, int* slots,
                  unsigned char* keep, int* ends) {
  // tokens whose loads a warp issues before it routes the first of them
  // (16 registers of logits a lane: 1024 threads leave 64 each)
  constexpr int G = 16 / PL < 8 ? 16 / PL : 8;
  __shared__ int warp_count[MAX_WARPS][MAX_E];  // this tile's entries
  __shared__ int hist[MAX_E];     // this block's entries per expert
  __shared__ int running[MAX_E];  // entries before this tile
  __shared__ int first[MAX_E];    // dropless: each expert's first row
  const int nb = gridDim.x, rank = blockIdx.x;
  const int threads = blockDim.x, W = threads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Tb = (T + nb - 1) / nb;
  const int t_begin = min(T, rank * Tb), t_end = min(T, t_begin + Tb);
  for (int i = threadIdx.x; i < W * MAX_E; i += threads)
    (&warp_count[0][0])[i] = 0;
  for (int e = threadIdx.x; e < E; e += threads) hist[e] = 0;
  __syncthreads();

  // pass 1: warp w routes tokens t_begin + w, + W, ...; G at a time
  for (int t0 = t_begin + warp; t0 < t_end; t0 += G * W) {
    float p[G][PL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = t0 + g * W;
      const float* row = logits + (long long)t * E;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int e = lane + 32 * i;
        p[g][i] = t < t_end && e < E ? row[e] : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int t = t0 + g * W;
      if (t >= t_end) break;  // uniform over the warp
      int my_eid;
      float my_gate;
      route<PL>(p[g], lane, E, k, n_groups, topk_groups, renorm, scale,
                my_eid, my_gate);
      if (lane < k) {
        eids[(long long)t * k + lane] = my_eid;
        gates[(long long)t * k + lane] = my_gate;
        atomicAdd(&hist[my_eid], 1);
      }
    }
  }
  __syncthreads();  // hist complete; pass 1's eids seen by the block

  // offsets: the entries of the lower-ranked blocks, added in rank order
  // (dropless: every block's, for the totals)
  cg::cluster_group cluster = cg::this_cluster();
  if (nb > 1) {
    cluster_arrive();
    cluster_wait();  // every block's hist is complete
  }
  const bool dropless = C == 0;
  for (int e = threadIdx.x; e < E; e += threads) {
    int off = 0, total = 0;
    for (int r = 0; r < (dropless ? nb : rank); ++r) {
      const int n =
          r == rank ? hist[e] : *cluster.map_shared_rank(hist + e, r);
      if (r < rank) off += n;
      total += n;
    }
    running[e] = off;
    first[e] = total;
  }
  if (nb > 1) cluster_arrive();  // this block is done with the others' hist
  __syncthreads();
  if (dropless) {
    // warp 0 turns the totals into each expert's first row: 8 experts a
    // lane, then a scan across the lanes
    if (warp == 0) {
      int n[MAX_E / 32], sum = 0;
#pragma unroll
      for (int j = 0; j < MAX_E / 32; ++j) {
        const int e = (MAX_E / 32) * lane + j;
        n[j] = e < E ? first[e] : 0;
        sum += n[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      int row = incl - sum;
#pragma unroll
      for (int j = 0; j < MAX_E / 32; ++j) {
        const int e = (MAX_E / 32) * lane + j;
        if (e < E) {
          first[e] = row;
          row += n[j];
          if (rank == 0) ends[e] = row;
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += threads) running[e] += first[e];
    __syncthreads();
  }

  // pass 2: first-come-first-served positions over this block's entries
  const long long n_begin = (long long)t_begin * k;
  const long long n_end = (long long)t_end * k;
  const unsigned earlier_lanes = (1u << lane) - 1u;
  for (long long n0 = n_begin; n0 < n_end; n0 += threads) {
    const long long n = n0 + threadIdx.x;
    const int e = n < n_end ? eids[n] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && lane == __ffs(peers) - 1)
      warp_count[warp][e] = __popc(peers);
    __syncthreads();
    if (e >= 0) {
      int pos = running[e] + __popc(peers & earlier_lanes);
      for (int w = 0; w < warp; ++w) pos += warp_count[w][e];
      if (dropless) {
        slots[n] = pos;
        keep[n] = e < held ? 1 : 0;
      } else {
        const bool kept = pos < C;
        slots[n] = e * C + (kept ? pos : 0);
        keep[n] = kept ? 1 : 0;
      }
    }
    if (n0 + threads >= n_end) break;  // the last tile: nothing to carry
    __syncthreads();
    for (int x = threadIdx.x; x < E; x += threads) {
      int total = 0;
      for (int w = 0; w < W; ++w) {
        total += warp_count[w][x];
        warp_count[w][x] = 0;
      }
      running[x] += total;
    }
    __syncthreads();
  }
  // no block leaves (and frees its hist) while another may still read it
  if (nb > 1) cluster_wait();
}

template <int PL>
int launch(const float* logits, int* eids, float* gates, int* slots,
           unsigned char* keep, int* ends, int T, int E, int k, int C,
           int n_groups, int topk_groups, bool renorm, float scale,
           int held, int nb, int threads, cudaStream_t stream) {
  auto kernel = gating_kernel<PL>;
  if (nb > PORTABLE_BLOCKS) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return int(err);
  }
  if (nb == 1) {
    kernel<<<1, threads, 0, stream>>>(logits, T, E, k, C, n_groups,
                                      topk_groups, renorm, scale, held, eids,
                                      gates, slots, keep, ends);
    return int(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, logits, T, E, k, C, n_groups,
                         topk_groups, renorm, scale, held, eids, gates, slots,
                         keep, ends);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// the most blocks a cluster of gating_kernel may have on this card: 16
// if a cluster of 16 blocks of 1024 threads can be placed, else 8
int max_blocks() {
  static const int n = []() {
    auto kernel = gating_kernel<8>;  // the most registers of the four
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess) {
      cudaGetLastError();
      return PORTABLE_BLOCKS;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(MAX_BLOCKS);
    cfg.blockDim = dim3(MAX_THREADS);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = MAX_BLOCKS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
            cudaSuccess ||
        clusters < 1) {
      cudaGetLastError();
      return PORTABLE_BLOCKS;
    }
    return MAX_BLOCKS;
  }();
  return n;
}

}  // namespace

// nb, threads: the launch shape the wrapper picked (blocks in the one
// cluster, threads per block).  C = 0: the dropless mode (ends written).
// Returns a cudaError_t (0 = launched), or -1 for arguments the kernel
// does not take.
extern "C" int moe_gating_fwd(const float* logits, int* eids, float* gates,
                              int* slots, unsigned char* keep, int* ends,
                              int T, int E, int k, int C, int n_groups,
                              int topk_groups, int renorm, float scale,
                              int held, int nb, int threads, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_E || k <= 0 || k > MAX_K || k > E ||
      C < 0 || (C == 0 && (ends == nullptr || held < 0 || held > E)) ||
      n_groups < 1 || n_groups > 32 || E % n_groups || topk_groups < 1 ||
      topk_groups > n_groups || k > topk_groups * (E / n_groups) || nb < 1 ||
      nb > max_blocks() || threads < 32 || threads > MAX_THREADS ||
      threads % 32)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rn = renorm != 0;
#define GATING_LAUNCH(PL)                                                   \
  launch<PL>(logits, eids, gates, slots, keep, ends, T, E, k, C, n_groups, \
             topk_groups, rn, scale, held, nb, threads, s)
  if (E <= 32) return GATING_LAUNCH(1);
  if (E <= 64) return GATING_LAUNCH(2);
  if (E <= 128) return GATING_LAUNCH(4);
  return GATING_LAUNCH(8);
#undef GATING_LAUNCH
}

// The most blocks the wrapper may give one cluster on the current card.
extern "C" int moe_gating_max_blocks() { return max_blocks(); }
