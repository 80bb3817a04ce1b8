// The portable profile's integer LSTM update (Hopper), three launches.
//
// Replaces no TPU kernel: the JAX package's integer LSTM
// (cmix_tpu/mixer/ilstm.py) is plain jnp, and so is the port's plain
// version, mixer/ilstm.py:_update_plain.  On the card that plain version is
// ~2,000 small dependent PyTorch operations a byte step (the largest part
// of the PORT=1 step), for work of ~730 M int32 multiply-adds at B=64,
// H=256, W=8.  This file computes exactly what it computes, bit for bit:
// every value is int32 add, multiply, arithmetic shift, clamp or floor
// division, and every contraction an exact sum wrapped to 32 bits, which
// no summation order changes (sums mod 2^32 are associative).
//
//   1. ilstm_bptt: per lane group, the W forward cells over the ring (with
//      the output head's dlog at each step) and the W backward steps, in
//      one block with no grid-wide barrier: the shared weights do not
//      change until the optimizer, and a lane's chain reads only its own
//      state.  h and the vector being contracted stay in shared memory, c,
//      dh and dc in the registers of the thread that owns the unit.  The
//      terms the gradients need go to a scratch stash of W x B rows: h>>4
//      (W+1 rows), dlog, dpre, and the gates the backward step rereads
//      (the thread that wrote them reads them back).
//   2. ilstm_grads: gwh and gwo as integer GEMMs over all W*B stash rows
//      (64 x 64 tiles), gwx as a sum by byte and gb beside it (32-column
//      tiles), gbo; each tile's epilogue applies SGD or the integer Adam
//      and writes the new weights.
//   3. ilstm_advance: per lane group, with the new weights, the slide cell
//      over ring[:, 0] and the advance cell over the new byte (as one
//      contraction of 2 x lanes rows), the output head on the new h, p16,
//      the qcum prefix sum and the ring shift.
//
// Semantics kept from the plain version: arithmetic >> of negative values;
// floor division for SGD's grad // (B*W) (C's / truncates, corrected);
// every contraction summed in uint32 (wraps as an int32 sum) before its
// shift; (vi << 15) // total and (vi << 16) // total in 64 bits; every clamp
// bound; squash12 read from the table intmath._lut builds (the wrapper
// passes its pointer).  Bytes are read modulo 256 (the plain version's
// inputs are bytes), so no value indexes out of bounds.
//
// Bound.  The multiply-adds: each weight is read once per contraction and
// split into hi (w >> 8) and lo (w & 255) in registers, two IMADs a weight
// and row; a lane-step of kernel 1 is 3H*H (forward) + 2*256*H (head and
// its backward) + 3H*H (backward) weights, 2 x 524,288 IMADs at H=256, so
// 537 M for B=64, W=8, plus 133 M in kernel 2's GEMMs and 58 M in kernel 3:
// ~730 M, 44 us at the H100's 64 int32 IMADs a clock and SM (132 SMs,
// 1.98 GHz).  The weights (wx, wh, wo: 1.8 MB as int32) stay in the 50 MB
// L2, but every block of kernel 1 rereads wh and wo twice a step: 2.1 MB a
// step a block, 16.8 MB a block at W=8, whatever the lanes it serves.  So
// the lane group is chosen against both: one lane a block while the lanes
// fit on the SMs (B <= 132: 64 blocks at B=64, each bound by its own L2
// reads, ~130-200 us at 64-100 B a clock an SM), two above (B=256: 128
// blocks, each with 2 x the IMADs on half the L2 traffic a lane).  Kernel 1
// is the one that can not fill the card: its lanes are its parallelism.
//
// Design.  Each contraction splits its reduction over the block's 768
// threads: the forward ones (out[n] = sum_m a[m] w[m][n], w row-major) give
// each thread 4 adjacent columns (one 16-byte load a row, V=4 when H % 4 ==
// 0 and the weights are 16-byte aligned, else 1) and a slice of the rows,
// and add the slices' partial sums into shared memory by atomics (integer:
// any order gives the same bits); the backward ones (out[n] = sum_m a[m]
// w[n][m]) give each warp whole rows of w and reduce across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 768;              // threads of the lane kernels
constexpr int kGradT = 256;          // threads of the gradient kernel
constexpr int kMaxLanes = 2;         // lanes a block of the lane kernels
constexpr int kPreClip = 32760;      // Q12 pre-activation bound
constexpr int kGClip = 1 << 14;      // per-step gradient bound
constexpr int kLogitClip = 3072 << 4;
constexpr int kLutLo = 1024;         // squash12's table covers st13 in
constexpr int kLutHi = 7168;         // [kLutLo, kLutHi]
constexpr int kTile = 64;            // gradient GEMM tile (rows and cols)
constexpr int kTileR = 32;           // stash rows a GEMM step
constexpr int kXTile = 32;           // columns of a gwx tile

}  // namespace

// The call's operands (filled by mixer/ilstm.py, a ctypes Structure of the
// same layout).  Tensors are int32 and contiguous; the five weights in the
// order wx, wh, wo, b, bo.
struct IlstmArgs {
  const int32_t* w[5];
  const int32_t* m[5];               // Adam moments, null without Adam
  const int32_t* v[5];
  int32_t* nw[5];                    // the new weights and moments
  int32_t* nm[5];
  int32_t* nv[5];
  const int32_t* lut;                // squash12 on st13 in [1024, 7168]
  const int32_t* ring;               // (B, W)
  const void* bytes;                 // (B,) int32 or int64
  const int32_t* h;                  // (B, H) each
  const int32_t* c;
  const int32_t* h0;
  const int32_t* c0;
  int32_t* oh;                       // the new per-lane state
  int32_t* oc;
  int32_t* oh0;
  int32_t* oc0;
  int32_t* oring;                    // (B, W)
  int32_t* oqcum;                    // (B, 257)
  int32_t* scratch;                  // ilstm_scratch_ints(B, H, W) ints
  int batch, hidden, horizon;
  int lanes;                         // lanes a block: 1 or 2
  int bytes64;                       // bytes are int64
  int adam;
  int vec;                           // 4: 16-byte weight loads, else 1
  int lr[5], alr[5], clip[5];
};

namespace {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// int32 product that wraps, as an int32 tensor's
__device__ __forceinline__ int32_t mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// (sum a*w_hi) >> 8 + (sum a*w_lo) >> 16, the sums wrapped to int32
__device__ __forceinline__ int32_t dot16(uint32_t hi, uint32_t lo) {
  return ((int32_t)hi >> 8) + ((int32_t)lo >> 16);
}

__device__ __forceinline__ int32_t squash(const int32_t* lut, int st13) {
  return __ldg(lut + clampi(st13, kLutLo, kLutHi) - kLutLo);
}

__device__ __forceinline__ int32_t sig12(const int32_t* lut, int32_t pre) {
  return squash(lut, 4096 + (clampi(pre, -kPreClip, kPreClip) >> 4));
}

__device__ __forceinline__ int32_t tanh12(const int32_t* lut, int32_t x) {
  return 2 * squash(lut, 4096 + (clampi(x, -kPreClip, kPreClip) >> 3)) -
         4096;
}

__device__ __forceinline__ int byte_at(const void* p, int is64, int i) {
  return is64 ? (int32_t)((const long long*)p)[i] : ((const int32_t*)p)[i];
}

template <int V>
__device__ __forceinline__ void ldg(const int32_t* p, int32_t (&x)[V]) {
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void lds(const int32_t* p, int32_t (&x)[V]) {
  if constexpr (V == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = *p;
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int32_t warp_max(int32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = max(x, (int32_t)__shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// acc[r*lda + n] += sum_m a[r*lda_a + m] * w[m*N + n] for rows r < R, as
// the (hi, lo) pair of wrapped sums.  Thread t takes the V columns of group
// t % (N/V) over the rows of slice t / (N/V); acc is zero on entry.
// No barrier inside: the caller syncs before and after.
template <int V, int RM>
__device__ __forceinline__ void contract_cols(
    const int32_t* __restrict__ w, int M, int N, const int32_t* a, int lda_a,
    int R, uint32_t* acc_hi, uint32_t* acc_lo, int lda) {
  const int ng = N / V;
  const int S = max(1, (int)blockDim.x / ng);
  const int s = threadIdx.x / ng, g = threadIdx.x % ng;
  if (s >= S) return;
  const int m0 = s * M / S, m1 = (s + 1) * M / S;
  uint32_t hi[RM][V], lo[RM][V];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) hi[r][v] = lo[r][v] = 0;
  const int32_t* wp = w + g * V;
#pragma unroll 4
  for (int m = m0; m < m1; ++m) {
    int32_t x[V];
    ldg<V>(wp + (size_t)m * N, x);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < R) {
        const uint32_t av = (uint32_t)a[r * lda_a + m];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          hi[r][v] += av * (uint32_t)(x[v] >> 8);
          lo[r][v] += av * (uint32_t)(x[v] & 255);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (r < R) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        atomicAdd(acc_hi + r * lda + g * V + v, hi[r][v]);
        atomicAdd(acc_lo + r * lda + g * V + v, lo[r][v]);
      }
    }
  }
}

// out[r*lda + n] = sum_m a[r*lda_a + m] * w[n*M + m] for n < NR, rows r <
// R, as (hi, lo) pairs: one warp a row n of w.  No barrier inside.
template <int V, int RM>
__device__ __forceinline__ void contract_rows(
    const int32_t* __restrict__ w, int NR, int M, const int32_t* a,
    int lda_a, int R, uint32_t* out_hi, uint32_t* out_lo, int lda) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int mg = M / V;
  for (int n = threadIdx.x >> 5; n < NR; n += nw) {
    uint32_t hi[RM], lo[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) hi[r] = lo[r] = 0;
    const int32_t* wp = w + (size_t)n * M;
    for (int g = lane; g < mg; g += 32) {
      int32_t x[V];
      ldg<V>(wp + g * V, x);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r < R) {
          int32_t av[V];
          lds<V>(a + r * lda_a + g * V, av);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            hi[r] += (uint32_t)av[v] * (uint32_t)(x[v] >> 8);
            lo[r] += (uint32_t)av[v] * (uint32_t)(x[v] & 255);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      hi[r] = warp_sum(hi[r]);
      lo[r] = warp_sum(lo[r]);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (r < R) {
          out_hi[r * lda + n] = hi[r];
          out_lo[r * lda + n] = lo[r];
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(uint32_t* p, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) p[e] = 0;
}

// One cell's pointwise part for unit i: pre-activations from the
// contraction (acc) and the gathered wx row, then the gates and the new
// (c, h).  Returns h2; c is updated; f, g, o, tc for the backward step.
struct Gates {
  int32_t f, g, o, tc;
};

__device__ __forceinline__ int32_t cell(
    const int32_t* __restrict__ wx, const int32_t* __restrict__ b,
    const int32_t* lut, int H, int byte, const uint32_t* ahi,
    const uint32_t* alo, int i, int32_t& c, Gates& q) {
  const int G = 3 * H;
  const int32_t* wxr = wx + (byte & 255) * G;
  int32_t pre[3];
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int k = u * H + i;
    pre[u] = clampi(__ldg(wxr + k) + dot16(ahi[k], alo[k]) + __ldg(b + k),
                    -kPreClip, kPreClip);
  }
  q.f = sig12(lut, pre[0]);
  q.g = tanh12(lut, pre[1]);
  q.o = sig12(lut, pre[2]);
  c = (mul(q.f, c) + mul(4096 - q.f, q.g)) >> 12;
  q.tc = tanh12(lut, c);
  return mul(q.o, q.tc) >> 12;
}

// The output head's integer softmax numerators of rows r < R from their
// contraction with wo (acc, row stride lda): vi into val[r*lda + k], each
// row's total into tot[r].  Leaves with a barrier.
__device__ void head_vi(const int32_t* __restrict__ bo, const uint32_t* ahi,
                        const uint32_t* alo, int lda, int R, int32_t* val,
                        int32_t* mx, int32_t* tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int e = t; e < R * 256; e += blockDim.x) {
    const int r = e >> 8, k = e & 255;
    val[r * lda + k] = clampi(
        __ldg(bo + k) + dot16(ahi[r * lda + k], alo[r * lda + k]),
        -kLogitClip, kLogitClip);
  }
  __syncthreads();
  if (warp < R) {
    int32_t m = val[warp * lda + lane];
    for (int k = lane + 32; k < 256; k += 32)
      m = max(m, val[warp * lda + k]);
    m = warp_max(m);
    if (lane == 0) mx[warp] = m;
  }
  __syncthreads();
  for (int e = t; e < R * 256; e += blockDim.x) {
    const int r = e >> 8, k = e & 255;
    // _exp2_parts of st13x = max((logit - max) >> 4, -3072)
    const int32_t st = max((val[r * lda + k] - mx[r]) >> 4, -3072);
    const int32_t y = (st * 2955) >> 4;
    const int32_t kk = y >> 15;
    const int32_t g = y - mul(kk, 1 << 15);
    int32_t hh = (2593 * g) >> 15;
    hh = ((hh + 7371) * g) >> 15;
    hh = ((hh + 22804) * g) >> 15;
    const int32_t z = (1 << 15) + hh;
    const int s = clampi(-kk, 0, 31);
    val[r * lda + k] = min((z >> s) + 1, 65535);
  }
  __syncthreads();
  if (warp < R) {
    uint32_t sum = 0;
    for (int k = lane; k < 256; k += 32) sum += (uint32_t)val[warp * lda + k];
    sum = warp_sum(sum);
    if (lane == 0) tot[warp] = (int32_t)sum;
  }
  __syncthreads();
}

// The scratch stash of kernel 1, in ints: gates (W, B, 5, H), hs4 (W+1, B,
// H), dlog (W, B, 256), dpre (W, B, 3H).
struct Stash {
  int32_t* gates;
  int32_t* hs4;
  int32_t* dlog;
  int32_t* dpre;
};

__device__ __forceinline__ Stash stash_of(int32_t* s, int B, int H, int W) {
  Stash st;
  st.gates = s;
  st.hs4 = st.gates + (size_t)W * B * 5 * H;
  st.dlog = st.hs4 + (size_t)(W + 1) * B * H;
  st.dpre = st.dlog + (size_t)W * B * 256;
  return st;
}

// Shared memory of a lane kernel with RM rows: h rows (RM, Hp), the
// contracted vector (RM, Np), the two accumulators (RM, Np), 3 x RM ints.
inline int lane_smem_ints(int RM, int H) {
  const int Hp = (H + 3) & ~3;
  const int N = 3 * H > 256 ? 3 * H : 256;
  const int Np = (N + 3) & ~3;
  return RM * Hp + 3 * RM * Np + 4 * RM;
}

// ---- kernel 1: forward replay and backward pass, a lane group a block
template <int V, int RM>
__global__ void __launch_bounds__(kT, 1) ilstm_bptt(IlstmArgs p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int B = p.batch, H = p.hidden, W = p.horizon, G = 3 * H;
  const int Hp = pad4(H), Np = pad4(max(G, 256));
  int32_t* hsm = smem;                                  // (RM, Hp)
  int32_t* vec = hsm + RM * Hp;                         // (RM, Np)
  uint32_t* ahi = (uint32_t*)(vec + RM * Np);           // (RM, Np)
  uint32_t* alo = ahi + RM * Np;                        // (RM, Np)
  int32_t* mx = (int32_t*)(alo + RM * Np);              // (RM,)
  int32_t* tot = mx + RM;                               // (RM,)
  const Stash st = stash_of(p.scratch, B, H, W);
  const int32_t *wx = p.w[0], *wh = p.w[1], *wo = p.w[2], *bias = p.w[3];
  const int lane0 = blockIdx.x * p.lanes;
  const int R = min(p.lanes, B - lane0);
  const int t = threadIdx.x;
  // the thread that owns unit i of row r (kT >= RM * H: one unit at most)
  const bool own = t < R * H;
  const int r = own ? t / H : 0, i = own ? t % H : 0, ln = lane0 + r;
  int32_t c = 0, dh = 0, dc = 0;
  if (own) {
    const int32_t h = p.h0[ln * H + i];
    hsm[r * Hp + i] = h;
    c = p.c0[ln * H + i];
    st.hs4[ln * H + i] = h >> 4;
  }
  zero(ahi, RM * Np);
  zero(alo, RM * Np);
  __syncthreads();

  // ---- forward: W cells over the ring, the head's dlog after each
  for (int j = 0; j < W; ++j) {
    contract_cols<V, RM>(wh, H, G, hsm, Hp, R, ahi, alo, Np);
    __syncthreads();
    if (own) {
      Gates q;
      const int32_t cp = c;
      const int32_t h2 = cell(wx, bias, p.lut, H, p.ring[ln * W + j],
                              ahi + r * Np, alo + r * Np, i, c, q);
      int32_t* gs = st.gates + ((size_t)(j * B + ln) * 5) * H + i;
      gs[0] = cp;
      gs[H] = q.f;
      gs[2 * H] = q.g;
      gs[3 * H] = q.o;
      gs[4 * H] = q.tc;
      hsm[r * Hp + i] = h2;
      st.hs4[((size_t)(j + 1) * B + ln) * H + i] = h2 >> 4;
    }
    __syncthreads();
    zero(ahi, RM * Np);
    zero(alo, RM * Np);
    __syncthreads();
    contract_cols<V, RM>(wo, H, 256, hsm, Hp, R, ahi, alo, Np);
    __syncthreads();
    head_vi(p.w[4], ahi, alo, Np, R, vec, mx, tot);
    for (int e = t; e < R * 256; e += kT) {
      const int rr = e >> 8, k = e & 255, l2 = lane0 + rr;
      const int32_t p15 = (int32_t)(((long long)vec[rr * Np + k] << 15) /
                                    tot[rr]);
      const int tgt = (j + 1 < W ? p.ring[l2 * W + j + 1]
                                 : byte_at(p.bytes, p.bytes64, l2)) & 255;
      st.dlog[((size_t)j * B + l2) * 256 + k] =
          (p15 - (k == tgt ? 1 << 15 : 0)) >> 3;
    }
    zero(ahi, RM * Np);
    zero(alo, RM * Np);
    __syncthreads();
  }

  // ---- backward through time
  for (int j = W - 1; j >= 0; --j) {
    for (int e = t; e < R * 256; e += kT) {
      const int rr = e >> 8, k = e & 255;
      vec[rr * Np + k] = st.dlog[((size_t)j * B + lane0 + rr) * 256 + k];
    }
    __syncthreads();
    contract_rows<V, RM>(wo, H, 256, vec, Np, R, ahi, alo, Np);
    __syncthreads();
    if (own) {
      dh = clampi(dh + dot16(ahi[r * Np + i], alo[r * Np + i]), -(1 << 15),
                  1 << 15);
      const int32_t* gs = st.gates + ((size_t)(j * B + ln) * 5) * H + i;
      const int32_t cp = gs[0], f = gs[H], g = gs[2 * H], o = gs[3 * H],
                    tc = gs[4 * H];
      const int32_t d_o = mul(dh, tc) >> 12;
      const int32_t dtc = mul(dh, o) >> 12;
      dc = clampi(dc + (mul(dtc, (4096 * 4096 - mul(tc, tc)) >> 12) >> 12),
                  -(1 << 15), 1 << 15);
      const int32_t df = mul(dc, cp - g) >> 12;
      const int32_t dg = mul(dc, 4096 - f) >> 12;
      int32_t dp[3];
      dp[0] = mul(df, mul(f, 4096 - f) >> 12) >> 12;
      dp[1] = mul(dg, (4096 * 4096 - mul(g, g)) >> 12) >> 12;
      dp[2] = mul(d_o, mul(o, 4096 - o) >> 12) >> 12;
      int32_t* out = st.dpre + ((size_t)j * B + ln) * G;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int32_t d = clampi(dp[u], -kGClip, kGClip);
        out[u * H + i] = d;
        vec[r * Np + u * H + i] = clampi(d, -2047, 2047);
      }
      dc = mul(dc, f) >> 12;
    }
    __syncthreads();
    if (j > 0) {
      contract_rows<V, RM>(wh, H, G, vec, Np, R, ahi, alo, Np);
      __syncthreads();
      if (own) dh = dot16(ahi[r * Np + i], alo[r * Np + i]);
    }
  }
}

// ---- kernel 2: gradients over the whole stash, then the optimizer

struct GradArgs {
  IlstmArgs p;
  int tiles_wh, tiles_wo, tiles_wx;
  int cols_wh;                       // column tiles of a gwh row of tiles
  int pre_sh;                        // Adam's static pre-shift
};

__device__ __forceinline__ int bits(int32_t v) {
  return v <= 0 ? 0 : 32 - __clz(v);
}

// weight idx of tensor q from its summed gradient
__device__ __forceinline__ void optimize(const GradArgs& a, int q, int idx,
                                         int32_t grad) {
  const IlstmArgs& p = a.p;
  const int32_t w = p.w[q][idx], clip = p.clip[q];
  if (p.adam) {
    const int32_t m0 = p.m[q][idx], v0 = p.v[q][idx];
    const int32_t gq = clampi(grad >> a.pre_sh, -(1 << 15), 1 << 15);
    const int32_t m = m0 + ((gq - m0 + 4) >> 3);
    const int32_t v = v0 + ((mul(gq, gq) - v0 + 32) >> 6);
    const int s = (bits(v) + 1) >> 1;
    const int32_t ratio = clampi(mul(m, 1 << 12) >> s, -8192, 8192);
    p.nw[q][idx] = clampi(w - (mul(p.alr[q], ratio) >> 12), -clip, clip);
    p.nm[q][idx] = m;
    p.nv[q][idx] = v;
  } else {
    const int32_t bw = p.batch * p.horizon;
    int32_t d = grad / bw;
    if (grad % bw != 0 && grad < 0) --d;        // floor, as torch's //
    const int32_t gq = clampi(d, -kGClip, kGClip);
    p.nw[q][idx] = clampi(w - (mul(p.lr[q], gq) >> 12), -clip, clip);
  }
}

// out[h][k] = sum_r A[r][h] * (Bm[r][k] >> 4) over the Rt stash rows, on
// one 64 x 64 tile, then the optimizer of tensor q on it.
__device__ void grad_gemm(const GradArgs& a, int q, const int32_t* A,
                          const int32_t* Bm, int H, int N, int Rt, int th,
                          int tk, int32_t* sbuf) {
  int32_t(*As)[kTile] = reinterpret_cast<int32_t(*)[kTile]>(sbuf);
  int32_t(*Bs)[kTile] = As + kTileR;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int h0 = th * kTile, k0 = tk * kTile;
  uint32_t acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0;
  for (int r0 = 0; r0 < Rt; r0 += kTileR) {
    for (int e = t; e < kTileR * kTile; e += kGradT) {
      const int rr = e / kTile, cc = e % kTile, r = r0 + rr;
      As[rr][cc] = r < Rt && h0 + cc < H ? A[(size_t)r * H + h0 + cc] : 0;
      Bs[rr][cc] = r < Rt && k0 + cc < N ? Bm[(size_t)r * N + k0 + cc] >> 4
                                         : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTileR; ++rr) {
      int32_t av[4], bv[4];
      lds<4>(&As[rr][ty * 4], av);
      lds<4>(&Bs[rr][tx * 4], bv);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          acc[x][y] += (uint32_t)av[x] * (uint32_t)bv[y];
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int h = h0 + ty * 4 + x, k = k0 + tx * 4 + y;
      if (h < H && k < N) optimize(a, q, h * N + k, (int32_t)acc[x][y]);
    }
  }
}

// gwx (by byte) and gb on the 32 columns of tile tk, then their optimizer
__device__ void grad_wx(const GradArgs& a, const Stash& st, int tk,
                        int32_t* sbuf) {
  uint32_t(*gx)[kXTile] = reinterpret_cast<uint32_t(*)[kXTile]>(sbuf);
  uint32_t* gb = reinterpret_cast<uint32_t*>(sbuf) + 256 * kXTile;
  const IlstmArgs& p = a.p;
  const int B = p.batch, W = p.horizon, G = 3 * p.hidden, Rt = B * W;
  const int t = threadIdx.x, col = t % kXTile, k = tk * kXTile + col;
  for (int e = t; e < 256 * kXTile; e += kGradT) (&gx[0][0])[e] = 0;
  if (t < kXTile) gb[t] = 0;
  __syncthreads();
  uint32_t sum = 0;
  if (k < G) {
    for (int r = t / kXTile; r < Rt; r += kGradT / kXTile) {
      const int j = r / B, b = r % B;
      const uint32_t d = (uint32_t)st.dpre[(size_t)r * G + k];
      atomicAdd(&gx[p.ring[b * W + j] & 255][col], d);
      sum += d;
    }
    atomicAdd(&gb[col], sum);
  }
  __syncthreads();
  for (int e = t; e < 256 * kXTile; e += kGradT) {
    const int v = e / kXTile, cc = e % kXTile, kk = tk * kXTile + cc;
    if (kk < G) optimize(a, 0, v * G + kk, (int32_t)gx[v][cc]);
  }
  if (t < kXTile && k < G) optimize(a, 3, k, (int32_t)gb[t]);
}

// the two kinds of tile share one buffer: a GEMM step's A and B rows, or a
// gwx tile's sums by byte and gb's
constexpr int kGradSmem = 2 * kTileR * kTile > 256 * kXTile + kXTile
                              ? 2 * kTileR * kTile
                              : 256 * kXTile + kXTile;

__global__ void __launch_bounds__(kGradT) ilstm_grads(GradArgs a) {
  __shared__ __align__(16) int32_t sbuf[kGradSmem];
  const IlstmArgs& p = a.p;
  const int B = p.batch, H = p.hidden, W = p.horizon, Rt = B * W;
  const Stash st = stash_of(p.scratch, B, H, W);
  int blk = blockIdx.x;
  if (blk < a.tiles_wh) {             // gwh: h_prev>>4 x dpre>>4
    grad_gemm(a, 1, st.hs4, st.dpre, H, 3 * H, Rt, blk / a.cols_wh,
              blk % a.cols_wh, sbuf);
    return;
  }
  blk -= a.tiles_wh;
  if (blk < a.tiles_wo) {             // gwo: h_j>>4 x dlog>>4
    grad_gemm(a, 2, st.hs4 + (size_t)B * H, st.dlog, H, 256, Rt, blk / 4,
              blk % 4, sbuf);
    return;
  }
  blk -= a.tiles_wo;
  if (blk < a.tiles_wx) {
    grad_wx(a, st, blk, sbuf);
    return;
  }
  uint32_t sum = 0;                   // gbo, one column a thread
  for (int r = 0; r < Rt; ++r)
    sum += (uint32_t)st.dlog[(size_t)r * 256 + threadIdx.x];
  optimize(a, 4, threadIdx.x, (int32_t)sum);
}

// ---- kernel 3: slide, advance and the next byte's distribution
template <int V, int RM>
__global__ void __launch_bounds__(kT, 1) ilstm_advance(IlstmArgs p) {
  extern __shared__ __align__(16) int32_t smem[];
  const int B = p.batch, H = p.hidden, W = p.horizon, G = 3 * H;
  const int Hp = pad4(H), Np = pad4(max(G, 256));
  int32_t* hsm = smem;
  int32_t* vec = hsm + RM * Hp;
  uint32_t* ahi = (uint32_t*)(vec + RM * Np);
  uint32_t* alo = ahi + RM * Np;
  int32_t* mx = (int32_t*)(alo + RM * Np);
  int32_t* tot = mx + RM;
  const int32_t* lut = p.lut;
  const int lane0 = blockIdx.x * p.lanes;
  const int L = min(p.lanes, B - lane0), R = 2 * L;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // rows [0, L): the slide cells (h0, c0, ring[:, 0]); rows [L, 2L): the
  // advance cells (h, c, the new byte)
  for (int e = t; e < R * H; e += kT) {
    const int r = e / H, i = e % H, ln = lane0 + r % L;
    hsm[r * Hp + i] = (r < L ? p.h0 : p.h)[ln * H + i];
  }
  zero(ahi, RM * Np);
  zero(alo, RM * Np);
  __syncthreads();
  contract_cols<V, RM>(p.nw[1], H, G, hsm, Hp, R, ahi, alo, Np);
  __syncthreads();
  for (int e = t; e < R * H; e += kT) {
    const int r = e / H, i = e % H, ln = lane0 + r % L;
    const bool adv = r >= L;
    const int byte = adv ? byte_at(p.bytes, p.bytes64, ln) : p.ring[ln * W];
    int32_t c = (adv ? p.c : p.c0)[ln * H + i];
    Gates q;
    const int32_t h2 = cell(p.nw[0], p.nw[3], lut, H, byte, ahi + r * Np,
                            alo + r * Np, i, c, q);
    (adv ? p.oh : p.oh0)[ln * H + i] = h2;
    (adv ? p.oc : p.oc0)[ln * H + i] = c;
    hsm[r * Hp + i] = h2;
  }
  for (int e = t; e < L * W; e += kT) {
    const int ln = lane0 + e / W, x = e % W;
    p.oring[ln * W + x] = x + 1 < W ? p.ring[ln * W + x + 1]
                                    : byte_at(p.bytes, p.bytes64, ln);
  }
  __syncthreads();
  zero(ahi, RM * Np);
  zero(alo, RM * Np);
  __syncthreads();
  contract_cols<V, RM>(p.nw[2], H, 256, hsm + L * Hp, Hp, L, ahi, alo, Np);
  __syncthreads();
  head_vi(p.nw[4], ahi, alo, Np, L, vec, mx, tot);
  // p16 = (vi << 16) // total, then qcum = [0, cumsum(p16)]: a warp a row,
  // 8 columns a lane
  if (warp < L) {
    const int ln = lane0 + warp;
    int32_t run[8], s = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int k = lane * 8 + x;
      s += (int32_t)(((long long)vec[warp * Np + k] << 16) / tot[warp]);
      run[x] = s;
    }
    int32_t before = s;                // inclusive scan of the lane sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before += y;
    }
    before -= s;
    int32_t* q = p.oqcum + (size_t)ln * 257;
    if (lane == 0) q[0] = 0;
#pragma unroll
    for (int x = 0; x < 8; ++x) q[lane * 8 + x + 1] = before + run[x];
  }
}

using LaneKernel = void (*)(IlstmArgs);

// kernel 1 (bptt) or 3 for the weights' load width and the lanes a block;
// its rows of shared memory in *rows
LaneKernel lane_kernel(bool bptt, int vec, int lanes, int* rows) {
  *rows = bptt ? lanes : 2 * lanes;
  constexpr int L = kMaxLanes;
  if (bptt)
    return vec == 4 ? (lanes == 1 ? ilstm_bptt<4, 1> : ilstm_bptt<4, L>)
                    : (lanes == 1 ? ilstm_bptt<1, 1> : ilstm_bptt<1, L>);
  return vec == 4
             ? (lanes == 1 ? ilstm_advance<4, 2> : ilstm_advance<4, 2 * L>)
             : (lanes == 1 ? ilstm_advance<1, 2> : ilstm_advance<1, 2 * L>);
}

int launch_lanes(const IlstmArgs& a, cudaStream_t st, bool bptt) {
  int rows;
  const LaneKernel kernel = lane_kernel(bptt, a.vec, a.lanes, &rows);
  const int grid = (a.batch + a.lanes - 1) / a.lanes;
  const size_t smem = 4 * (size_t)lane_smem_ints(rows, a.hidden);
  kernel<<<grid, kT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ints of the scratch stash (the wrapper allocates them)
extern "C" long long ilstm_scratch_ints(int batch, int hidden, int horizon) {
  const long long B = batch, H = hidden, W = horizon;
  return W * B * 5 * H + (W + 1) * B * H + W * B * 256 + W * B * 3 * H;
}

// The three launches on the stream; 0, or the first CUDA error (a launch
// refused for its shape or resources runs nothing after it).
extern "C" int ilstm_update(const IlstmArgs* args, void* stream) {
  const IlstmArgs& a = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  if (a.lanes < 1 || a.lanes > kMaxLanes || (a.vec != 1 && a.vec != 4) ||
      a.hidden < 1 || a.hidden > 256 || a.horizon < 1 || a.batch < 1)
    return (int)cudaErrorInvalidValue;
  int rc = launch_lanes(a, st, true);
  if (rc != 0) return rc;
  GradArgs g;
  g.p = a;
  const int th = (a.hidden + kTile - 1) / kTile;
  g.cols_wh = (3 * a.hidden + kTile - 1) / kTile;
  g.tiles_wh = th * g.cols_wh;
  g.tiles_wo = th * (256 / kTile);
  g.tiles_wx = (3 * a.hidden + kXTile - 1) / kXTile;
  int bw = a.batch * a.horizon, nb = 0;
  while (bw) {
    ++nb;
    bw >>= 1;
  }
  g.pre_sh = nb - 5 > 0 ? nb - 5 : 0;
  ilstm_grads<<<g.tiles_wh + g.tiles_wo + g.tiles_wx + 1, kGradT, 0, st>>>(
      g);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_lanes(a, st, false);
}
