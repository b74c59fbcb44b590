// Fused MoE gating for NVIDIA Hopper (sm_90a): router softmax, top-k,
// renormalised gates and first-come-first-served capacity slots.
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
// Here one block does the same walk: a first pass gives each warp one
// token at a time (softmax, k arg-max passes, gates); a second pass walks
// the entries in tiles of 1024, in order, with E running counters in
// shared memory.  Inside a tile an entry's rank is the number of earlier
// lanes of its warp with the same expert (__match_any_sync) plus the
// counts of the earlier warps, so nothing depends on scheduling and the
// result is deterministic.
//
// What bounds it: the logits are read once (T·E·4 bytes, 64 KB at T = 128
// and E = 128) and each entry written once; a few hundred KB at most, a
// microsecond of memory time.  The launch and the block's serial walk
// take longer, so the kernel is bound by launch latency, and one block is
// enough at the serving path's token counts.
//
// Layout: logits (T, E) contiguous float32; eids, slots (T, k) int32,
// gates (T, k) float32, keep (T, k) bytes 0/1, all contiguous.  E <= 256,
// 1 <= k <= min(E, 8).
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_E = 256;
constexpr int PER_LANE = MAX_E / 32;  // expert e sits at lane e % 32, slot e / 32
constexpr int MAX_K = 8;

__global__ void __launch_bounds__(THREADS)
    gating_kernel(const float* __restrict__ logits, int T, int E, int k,
                  int C, int* eids, float* gates, int* slots,
                  unsigned char* keep) {
  __shared__ int warp_count[WARPS][MAX_E];  // this tile's entries per expert
  __shared__ int running[MAX_E];            // entries of earlier tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < WARPS * MAX_E; i += THREADS)
    (&warp_count[0][0])[i] = 0;
  if (threadIdx.x < MAX_E) running[threadIdx.x] = 0;

  // pass 1: one warp per token
  for (int t = warp; t < T; t += WARPS) {
    const float* row = logits + (long long)t * E;
    float p[PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = lane + 32 * i;
      p[i] = e < E ? row[e] : -INFINITY;
      mx = fmaxf(mx, p[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      if (lane + 32 * i < E) {
        p[i] = expf(p[i] - mx);
        sum += p[i];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      p[i] = lane + 32 * i < E ? p[i] / sum : -1.f;  // -1: never chosen

    float top_sum = 0.f, my_prob = 0.f;
    int my_eid = 0;
    for (int j = 0; j < k; ++j) {
      // this lane's best; its experts rise with i, so '>' keeps the lower
      float bv = -2.f;
      int bi = MAX_E;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
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
      for (int i = 0; i < PER_LANE; ++i)
        if (lane + 32 * i == bi) p[i] = -1.f;
    }
    if (lane < k) {
      eids[(long long)t * k + lane] = my_eid;
      gates[(long long)t * k + lane] = my_prob / fmaxf(top_sum, 1e-9f);
    }
  }
  __syncthreads();  // pass 1's eids, in global memory, seen by every thread

  // pass 2: first-come-first-served positions, 1024 entries per tile
  const long long n_entries = (long long)T * k;
  const unsigned earlier_lanes = (1u << lane) - 1u;
  for (long long n0 = 0; n0 < n_entries; n0 += THREADS) {
    const long long n = n0 + threadIdx.x;
    const int e = n < n_entries ? eids[n] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && lane == __ffs(peers) - 1)
      warp_count[warp][e] = __popc(peers);
    __syncthreads();
    if (e >= 0) {
      int pos = running[e] + __popc(peers & earlier_lanes);
      for (int w = 0; w < warp; ++w) pos += warp_count[w][e];
      const bool kept = pos < C;
      slots[n] = e * C + (kept ? pos : 0);
      keep[n] = kept ? 1 : 0;
    }
    __syncthreads();
    if (threadIdx.x < E) {
      int total = 0;
      for (int w = 0; w < WARPS; ++w) {
        total += warp_count[w][threadIdx.x];
        warp_count[w][threadIdx.x] = 0;
      }
      running[threadIdx.x] += total;
    }
    __syncthreads();
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched), or -1 for arguments the kernel
// does not take.
extern "C" int moe_gating_fwd(const float* logits, int* eids, float* gates,
                              int* slots, unsigned char* keep, int T, int E,
                              int k, int C, void* stream) {
  if (T <= 0 || E <= 0 || E > MAX_E || k <= 0 || k > MAX_K || k > E ||
      C <= 0)
    return -1;
  gating_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, T, E, k, C, eids, gates, slots, keep);
  return int(cudaGetLastError());
}
