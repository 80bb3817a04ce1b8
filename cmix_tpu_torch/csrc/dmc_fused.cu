// DMC apply-pending-updates + byte-tree walk, one warp per block (Hopper).
//
// Replaces the TPU kernel cmix_tpu/models/dmc.py:_make_fused_kernel
// (launched through _fused_pallas, pallas_call at dmc.py:244) and computes
// exactly what _apply_xla + _walk_xla compute (dmc.py:377-411), bit for bit:
//
//   1. apply <= 40 pending edge-update words -- 24 count words (uX/uXC)
//      into cnt, then 8 clone-pointer words (uU/uUW) and then 8
//      path-pointer words (uS/uSW) into nxt; index -1 is a no-op,
//      duplicate indices inside a group carry identical words, and a path
//      word wins over a clone word on the same node;
//   2. walk the byte tree from cur down `levels` levels (dmc_walk.cuh) on
//      the updated tables.  Outputs are the count words of the 2^L
//      visited states (cw), the states themselves (vis) and the 2^(L-1)
//      pointer words fetched on the way (wn), with cw[0] = cnt[0],
//      vis[0] = 0, wn[0] = 0.
//
// Bound.  The bytes are nothing (~1.2 MB at B=256, L=8: 0.35 us at the
// 3.35 TB/s data-sheet rate of an NVIDIA H100 80GB HBM3 at 700.00 W); the
// time is a chain of dependent round trips to the L2 or device memory: cur
// and the descriptors, then L-1 pointer levels, then the last level's
// counts -- L+1 in all.
//
// Design.  The writes are not applied before the walk; they are forwarded.
// One warp (one CTA) serves one block, with no __syncthreads().  It loads
// cur and all 40 descriptors at once (one round trip) into shared memory
// and, for pools of up to kMaxTabled states (the CLI's 16384 among them),
// enters each into one of two byte tables indexed by state id (32 KiB for
// both): the count table maps s to a uX entry naming s, the pointer table
// to a uU entry, then (after a __syncwarp) to a uS entry, so a path word
// wins over a clone word.  The tables are never cleared: a read of state s
// takes entry j = table[s] and uses the descriptor's word only if j is in
// its group's range and descriptor j names s, which a stale entry cannot
// pass, since then s is named in this launch and its entry was written.  A
// read thus costs two dependent shared loads, made while its table load is
// in flight, and the walk starts at once: no table load waits for a
// descriptor store.  A larger pool launches the kernel's other form, whose
// reads compare s with every descriptor of their group instead (no
// tables, so no shared memory that grows with the pool).  The stores are
// issued after the walk, with the outputs, each lane storing the final
// word of its node (a clone lane whose node a path word supersedes stores
// the path word), so the tables end up exactly as the apply leaves them
// and the walk's plain, L1-cached loads never race with a store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmc_walk.cuh"

namespace {

constexpr int kNX = 24;                 // count-word descriptors per block
constexpr int kNP = 8;                  // pointer-word descriptors per group
constexpr int kND = kNX + 2 * kNP;      // [0,24) uX, [24,32) uU, [32,40) uS
constexpr int kMaxTabled = 16384;       // states of the largest tabled pool

// The tables as the walk reads them (dmc_walk.cuh's Tables): plain loads,
// and the pending words forwarded over them through the state tables.
struct Tabled {
  const int32_t* nb;          // this block's rows of nxt and cnt
  const int32_t* cb;
  const int32_t* idx;         // shared: the 40 descriptor indices
  const int32_t* word;        // shared: their words
  const uint8_t* tx;          // shared: state -> uX entry (or stale)
  const uint8_t* tp;          // shared: state -> uU/uS entry (or stale)

  __device__ __forceinline__ int32_t load_ptr(int32_t s) const {
    return nb[s];
  }
  __device__ __forceinline__ int32_t load_cnt(int32_t s) const {
    return cb[s];
  }
  struct Fwd {
    bool hit;
    int32_t word;
  };
  __device__ __forceinline__ Fwd fwd_ptr(int32_t s) const {
    const int j = tp[s];
    const int e = j >= kNX && j < kND ? j : kNX;   // in the array
    return {e == j && idx[e] == s, word[e]};
  }
  __device__ __forceinline__ Fwd fwd_cnt(int32_t s) const {
    const int j = tx[s];
    const int e = j < kNX ? j : 0;
    return {e == j && idx[e] == s, word[e]};
  }
  __device__ __forceinline__ int32_t pick(Fwd f, int32_t v) const {
    return f.hit ? f.word : v;
  }
};

// The same forwarding, by comparing s with every descriptor of its groups
// (pools of more than kMaxTabled states).
struct Compared {
  const int32_t* nb;
  const int32_t* cb;
  const int32_t* idx;
  const int32_t* word;

  __device__ __forceinline__ int32_t load_ptr(int32_t s) const {
    return nb[s];
  }
  __device__ __forceinline__ int32_t load_cnt(int32_t s) const {
    return cb[s];
  }
  struct Fwd {                // the state, and whose word it is
    int32_t s;
    bool ptr;
  };
  __device__ __forceinline__ Fwd fwd_ptr(int32_t s) const {
    return {s, true};
  }
  __device__ __forceinline__ Fwd fwd_cnt(int32_t s) const {
    return {s, false};
  }
  __device__ __forceinline__ int32_t pick(Fwd f, int32_t v) const {
    if (f.ptr) {
#pragma unroll
      for (int j = kNX; j < kND; ++j)   // uU, then uS: a path word wins
        v = idx[j] == f.s ? word[j] : v;
    } else {
#pragma unroll
      for (int j = 0; j < kNX; ++j) v = idx[j] == f.s ? word[j] : v;
    }
    return v;
  }
};

// The walk, then the outputs and the apply, after every table load of the
// walk: each lane stores the final word of its descriptor's node.
template <class Tables>
__device__ __forceinline__ void walk_and_apply(
    const Tables& tb, int32_t* nb, int32_t* cb, int32_t* svis, int lane,
    int b, int32_t c, int levels, bool is_x, int32_t gi, int32_t gw,
    int32_t pi, int32_t pw, int32_t* __restrict__ cw,
    int32_t* __restrict__ vis, int32_t* __restrict__ wn) {
  const int width = 1 << levels;
  dmc::walk(tb, svis, lane, c, levels, cw + (size_t)b * width,
            wn + (size_t)b * (width >> 1));
  for (int j = lane; j < width; j += dmc::kLanes)
    vis[(size_t)b * width + j] = svis[j];
  if (gi >= 0) {
    if (is_x)
      cb[gi] = gw;
    else
      nb[gi] = tb.pick(tb.fwd_ptr(gi), gw);
  }
  if (pi >= 0) nb[pi] = pw;
}

template <bool kTabled>
__global__ void __launch_bounds__(dmc::kLanes)
dmc_fused_kernel(int32_t* nxt, int32_t* cnt,
                 const int32_t* __restrict__ cur,
                 const int32_t* __restrict__ uX,
                 const int32_t* __restrict__ uXC,
                 const int32_t* __restrict__ uS,
                 const int32_t* __restrict__ uSW,
                 const int32_t* __restrict__ uU,
                 const int32_t* __restrict__ uUW,
                 int32_t* __restrict__ cw, int32_t* __restrict__ vis,
                 int32_t* __restrict__ wn, int n_nodes, int levels) {
  __shared__ int32_t svis[dmc::kMaxNodes];
  __shared__ int32_t sidx[kND], sword[kND];
  __shared__ uint8_t tabs[kTabled ? 2 * kMaxTabled : 1];
  uint8_t* tx = tabs;
  uint8_t* tp = tabs + kMaxTabled;
  const int lane = threadIdx.x % dmc::kLanes;   // < 32: see dmc::walk
  const int b = blockIdx.x;
  int32_t* nb = nxt + (size_t)b * n_nodes;
  int32_t* cb = cnt + (size_t)b * n_nodes;

  // ---- one round trip: cur and the 40 descriptors, loaded together;
  // lane i < 24 holds uX[i], lane i >= 24 uU[i-24] (entry i of both
  // groups), lane i < 8 also uS[i] (entry 32 + i)
  const int32_t c = cur[b];
  const bool is_x = lane < kNX;
  const int g = is_x ? lane : lane - kNX;
  const int32_t gi = (is_x ? uX + b * kNX : uU + b * kNP)[g];
  const int32_t gw = (is_x ? uXC + b * kNX : uUW + b * kNP)[g];
  int32_t pi = -1, pw = 0;
  if (lane < kNP) {
    pi = uS[b * kNP + lane];
    pw = uSW[b * kNP + lane];
  }
  sidx[lane] = gi;
  sword[lane] = gw;
  if (lane < kNP) {
    sidx[kNX + kNP + lane] = pi;
    sword[kNX + kNP + lane] = pw;
  }
  if constexpr (kTabled) {
    if (gi >= 0) (is_x ? tx : tp)[gi] = (uint8_t)lane;
    __syncwarp();
    if (pi >= 0) tp[pi] = (uint8_t)(kNX + kNP + lane);   // over clone words
  }
  __syncwarp();

  // ---- the walk, through the forwarded words, then the stores
  if constexpr (kTabled)
    walk_and_apply(Tabled{nb, cb, sidx, sword, tx, tp}, nb, cb, svis, lane,
                   b, c, levels, is_x, gi, gw, pi, pw, cw, vis, wn);
  else
    walk_and_apply(Compared{nb, cb, sidx, sword}, nb, cb, svis, lane, b, c,
                   levels, is_x, gi, gw, pi, pw, cw, vis, wn);
}

}  // namespace

extern "C" int dmc_fused(void* nxt, void* cnt, const void* cur,
                         const void* uX, const void* uXC, const void* uS,
                         const void* uSW, const void* uU, const void* uUW,
                         void* cw, void* vis, void* wn, int batch,
                         int n_nodes, int levels, void* stream) {
  auto* kernel = n_nodes <= kMaxTabled ? dmc_fused_kernel<true>
                                    : dmc_fused_kernel<false>;
  kernel<<<batch, dmc::kLanes, 0, (cudaStream_t)stream>>>(
      (int32_t*)nxt, (int32_t*)cnt, (const int32_t*)cur,
      (const int32_t*)uX, (const int32_t*)uXC, (const int32_t*)uS,
      (const int32_t*)uSW, (const int32_t*)uU, (const int32_t*)uUW,
      (int32_t*)cw, (int32_t*)vis, (int32_t*)wn, n_nodes, levels);
  return (int)cudaGetLastError();
}
