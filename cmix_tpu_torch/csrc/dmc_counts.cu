// DMC prediction-only byte-tree walk, one CTA per block (Hopper).
//
// Replaces the TPU kernel cmix_tpu/models/dmc.py:_make_walk_kernel
// (launched through _counts_pallas, pallas_call at dmc.py:348) and computes
// what it computes, bit for bit: with no pending updates to apply, walk the
// byte tree from cur down `levels` (1..8) levels -- each nxt word packs the
// two u16 child ids of a machine state -- and return the packed count words
// of the 2^L visited states in byte-tree node order, zero-padded to 256
// (out[j] = cnt[vis[j]] for j < 2^L, vis[0] = 0 and vis[1] = cur).  The
// tables are only read: unlike dmc_fused.cu, this kernel writes nothing but
// its output.
//
// Design.  One CTA of 256 threads serves one block (the Pallas kernel's
// one-block-per-grid-step shape; its VMEM staging and one-hot fetches
// existed only because Mosaic has no dynamic lane addressing).  The walk
// runs level by level through shared memory: at level l the 2^l threads
// n in [2^l, 2^(l+1)) load nxt[vis[n]] and write vis[2n], vis[2n+1]; then
// every thread j < 256 writes cnt[vis[j]] or 0.
//
// Bound.  The kernel must read ~(2^(L-1) - 1 + 2^L + 1) x 4 B and write
// 256 x 4 B per block (2.5 KB at L=8, 0.65 MB at B=256: ~0.2 us at
// 3.35 TB/s).  Its real bound is latency: a chain of L dependent global
// loads per block, 256 CTAs over 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 256;   // output words per block, zero past 2^L

__global__ void __launch_bounds__(kThreads)
dmc_counts_kernel(const int32_t* __restrict__ nxt,
                  const int32_t* __restrict__ cnt,
                  const int32_t* __restrict__ cur, int32_t* __restrict__ out,
                  int n_nodes, int levels) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* nb = nxt + (size_t)b * n_nodes;
  const int32_t* cb = cnt + (size_t)b * n_nodes;
  __shared__ int32_t svis[kThreads];

  if (t == 0) {
    svis[0] = 0;
    svis[1] = cur[b];
  }
  __syncthreads();
  for (int l = 0; l + 1 < levels; ++l) {
    if (t >= (1 << l) && t < (2 << l)) {
      const int32_t w = nb[svis[t]];
      svis[2 * t] = w & 0xFFFF;
      svis[2 * t + 1] = (w >> 16) & 0xFFFF;
    }
    __syncthreads();
  }
  out[b * kOut + t] = t < (1 << levels) ? cb[svis[t]] : 0;
}

}  // namespace

extern "C" int dmc_counts(const void* nxt, const void* cnt, const void* cur,
                          void* out, int batch, int n_nodes, int levels,
                          void* stream) {
  dmc_counts_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)nxt, (const int32_t*)cnt, (const int32_t*)cur,
      (int32_t*)out, n_nodes, levels);
  return (int)cudaGetLastError();
}
