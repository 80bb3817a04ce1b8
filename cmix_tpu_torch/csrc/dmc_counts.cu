// DMC prediction-only byte-tree walk, one warp per block (Hopper).
//
// Replaces the TPU kernel cmix_tpu/models/dmc.py:_make_walk_kernel
// (launched through _counts_pallas, pallas_call at dmc.py:348) and computes
// what it computes, bit for bit: with no pending updates to apply, walk the
// byte tree from cur down `levels` (1..8) levels -- each nxt word packs the
// two u16 child ids of a machine state -- and return the packed count words
// of the 2^L visited states in byte-tree node order, zero-padded to 256
// (out[j] = cnt[vis[j]] for j < 2^L, vis[0] = 0 and vis[1] = cur).  The
// tables are only read.
//
// Bound.  The bytes are nothing (~0.65 MB at B=256, L=8: 0.2 us at the
// 3.35 TB/s data-sheet rate of an NVIDIA H100 80GB HBM3 at 700.00 W); the
// time is a chain of dependent round trips: cur, then L-1 pointer levels,
// then the last level's counts -- L+1 in all.
//
// Design.  The walk of dmc_walk.cuh, read-only: one warp (one CTA) per
// block, no __syncthreads(), the tables read through the read-only data
// path.  The zero tail of the output is stored first, by all lanes, off
// the chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmc_walk.cuh"

namespace {

constexpr int kOut = 256;   // output words per block, zero past 2^L

struct ReadOnly {
  const int32_t* nb;          // this block's rows of nxt and cnt
  const int32_t* cb;

  __device__ __forceinline__ int32_t load_ptr(int32_t s) const {
    return __ldg(nb + s);
  }
  __device__ __forceinline__ int32_t load_cnt(int32_t s) const {
    return __ldg(cb + s);
  }
  struct Fwd {};               // nothing is forwarded
  __device__ __forceinline__ Fwd fwd_ptr(int32_t) const { return {}; }
  __device__ __forceinline__ Fwd fwd_cnt(int32_t) const { return {}; }
  __device__ __forceinline__ int32_t pick(Fwd, int32_t v) const { return v; }
};

__global__ void __launch_bounds__(dmc::kLanes)
dmc_counts_kernel(const int32_t* __restrict__ nxt,
                  const int32_t* __restrict__ cnt,
                  const int32_t* __restrict__ cur, int32_t* __restrict__ out,
                  int n_nodes, int levels) {
  __shared__ int32_t svis[dmc::kMaxNodes];
  const int lane = threadIdx.x % dmc::kLanes;   // < 32: see dmc::walk
  const int b = blockIdx.x;
  int32_t* ob = out + (size_t)b * kOut;
  const int32_t c = __ldg(cur + b);
  for (int j = (1 << levels) + lane; j < kOut; j += dmc::kLanes) ob[j] = 0;
  const ReadOnly tb{nxt + (size_t)b * n_nodes, cnt + (size_t)b * n_nodes};
  dmc::walk(tb, svis, lane, c, levels, ob, nullptr);
}

}  // namespace

extern "C" int dmc_counts(const void* nxt, const void* cnt, const void* cur,
                          void* out, int batch, int n_nodes, int levels,
                          void* stream) {
  dmc_counts_kernel<<<batch, dmc::kLanes, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nxt, (const int32_t*)cnt, (const int32_t*)cur,
      (int32_t*)out, n_nodes, levels);
  return (int)cudaGetLastError();
}
