// One DMC block's byte-tree walk by one warp (Hopper), shared by
// dmc_fused.cu and dmc_counts.cu.
//
// The walk starts at cur and runs `levels` (1..8) levels down the byte
// tree.  Node n of the tree (1 <= n < 2^L) holds machine state vis[n]
// (vis[0] = 0 is a pad, vis[1] = cur); each pointer word packs the two
// u16 child ids of a state, so at pointer level l (0 <= l <= L-2) the
// nodes n in [2^l, 2^(l+1)) read their pointer words w[n] and set
// vis[2n] = lo16(w[n]), vis[2n+1] = hi16(w[n]).  The count words cw[n] of
// all 2^L nodes are the walk's result.
//
// Bound.  Each level depends on the one before: L-1 pointer levels and one
// count gather, each a round trip to the L2 or device memory, while the
// bytes moved (a few KB per block) are nothing.  So one warp serves one
// block (one warp per CTA) and synchronises only by __syncwarp(): lane i
// handles nodes 2^l + i + 32k, and the visited states live in 1 KiB of
// shared memory.  The count words of a level are loaded in the same round
// trip as its pointer words but used (stored) only after the next level's
// loads are issued, so the chain waits on pointer words alone and only the
// last level's counts add a round trip: L round trips in all.  The level
// loop is unrolled, so every level's loaded words have registers of their
// own.
//
// The table reads go through `Tables`, which the kernel supplies:
//   load_ptr(s), load_cnt(s)  issue the loads of state s's words;
//   fwd_ptr(s), fwd_cnt(s)    start the lookup of a word forwarded over
//                             them (a Tables::Fwd);
//   pick(f, v)                the word the walk uses: the forwarded one,
//                             if any, else the loaded v (dmc_fused forwards
//                             its pending writes, dmc_counts nothing).
// A level's lookups are started for all its nodes together, after its
// loads are issued and before their words are used, so they overlap the
// loads' round trip instead of following it node by node.

#pragma once

#include <stdint.h>

namespace dmc {

constexpr int kLanes = 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxNodes = 1 << kMaxLevels;           // 2^L at L = 8
constexpr int kPerLane = kMaxNodes / 2 / kLanes;     // nodes a lane loads

// One warp walks one block.  svis: kMaxNodes ints of shared memory; cw:
// the block's count-word row (2^L entries written); wn: the block's
// pointer-word row (2^(L-1) entries written) or nullptr.  All 32 lanes
// must call it; it ends with a __syncwarp(), so svis holds vis.  Pass lane
// as threadIdx.x % kLanes, so that the compiler sees lane < 32 and folds
// the unrolled loops' bounds checks: with a bare threadIdx.x, dmc_fused
// took 84 registers instead of 48 and ran 1.6 us slower (NVIDIA H100 80GB
// HBM3, 700.00 W).
template <class Tables>
__device__ __forceinline__ void walk(const Tables& tb, int32_t* svis,
                                     int lane, int32_t cur, int levels,
                                     int32_t* __restrict__ cw,
                                     int32_t* __restrict__ wn) {
  // node 0's count word: loaded now, stored last
  const bool root = lane == kLanes - 1;
  const int32_t c_root = root ? tb.load_cnt(0) : 0;
  if (lane == 0) {
    svis[0] = 0;
    svis[1] = cur;
  }
  __syncwarp();
  int32_t s[kMaxLevels][kPerLane], c[kMaxLevels][kPerLane];
  typename Tables::Fwd fc[kMaxLevels][kPerLane];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < levels) {
      const int lo = 1 << l;
      const bool chase = l + 1 < levels;
      int32_t w[kPerLane];
      typename Tables::Fwd fp[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int n = lo + lane + kLanes * k;
        if (n < 2 * lo) {
          s[l][k] = svis[n];
          if (chase) w[k] = tb.load_ptr(s[l][k]);
          c[l][k] = tb.load_cnt(s[l][k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {    // while the loads fly
        const int n = lo + lane + kLanes * k;
        if (n < 2 * lo) {
          if (chase) fp[k] = tb.fwd_ptr(s[l][k]);
          fc[l][k] = tb.fwd_cnt(s[l][k]);
        }
      }
      if (l > 0) {            // the level before's counts, a round trip old
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int n = (lo >> 1) + lane + kLanes * k;
          if (n < lo) cw[n] = tb.pick(fc[l - 1][k], c[l - 1][k]);
        }
      }
      if (chase) {
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int n = lo + lane + kLanes * k;
          if (n < 2 * lo) {
            const int32_t p = tb.pick(fp[k], w[k]);
            svis[2 * n] = p & 0xFFFF;
            svis[2 * n + 1] = (int32_t)((uint32_t)p >> 16);
            if (wn != nullptr) wn[n] = p;
          }
        }
        __syncwarp();
      } else {                // the last level's counts
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int n = lo + lane + kLanes * k;
          if (n < 2 * lo) cw[n] = tb.pick(fc[l][k], c[l][k]);
        }
      }
    }
  }
  if (root) {
    cw[0] = tb.pick(tb.fwd_cnt(0), c_root);
    if (wn != nullptr) wn[0] = 0;
  }
  __syncwarp();
}

}  // namespace dmc
