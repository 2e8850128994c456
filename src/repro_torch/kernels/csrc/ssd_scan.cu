// Mamba2 SSD chunked scan for Hopper (sm_90a): forward and backward.
//
// Replaces: src/repro/kernels/ssd_scan.py:75 `ssd_scan_kernel_call` (the
// Pallas TPU kernel; body `_kernel` at :34), reached through
// `repro.kernels.ops.ssd_scan` (ops.py:139) from every Mamba2 layer of the
// training forward when ssm_impl="kernel" (repro/models/layers.py:391-396).
// The JAX package's backward is the VJP of the sequential oracle
// (ops.py:127-134); here it is a kernel too, so the plain version stays off
// the card's main path.
//
// Semantics, per (batch b, head h) with group g = h / (H / G):
//   h_t = exp(a_t) h_{t-1} + B_t (x) x_t,   y_t = C_t . h_t,   h_{-1} = 0,
// computed chunk by chunk in the dual form: with A the inclusive cumsum of
// a inside the chunk and h the state at the chunk's start,
//   y_t = exp(A_t) C_t.h + sum_{s<=t} (C_t.B_s) exp(A_t - A_s) x_s
//   h'  = exp(A_L) h + sum_s exp(A_L - A_s) B_s (x) x_s
// (the mask is applied before the exp, so the upper triangle never
// overflows). Layouts are the JAX package's: x, y (B, S, H, P); a (B, S, H)
// f32; b, c (B, S, G, N); final state (B, H, N, P) f32; all contiguous.
// The dual form is exact for any chunk length; a partial chunk (S % L, or
// L below the 128-row tile) is masked in the kernels, so any S runs.
//
// What bounds it: at the training path's shape (B 2, S 4096, H 64, P 64,
// G 1, N 128, 128-row chunks, bf16) a forward moves 140 MB (x, y, a, b,
// c, the final state) and does ~30 GFLOP (0.042 ms of bytes at 3.35 TB/s
// against 0.03 ms of bf16 tensor-core products): bytes-bound once the
// products run on tensor cores. With a gradient wanted it also writes the
// state at every chunk's start, 134 MB of f32; the backward writes and
// reads as much again as `dstates`. What holds the kernels back on the
// card is the traffic from L2 into the SMs: B, C and C B^T are read again
// by every head, and each kernel streams about 2.6 TB/s of it (PERF.md).
//
// Two routes, chosen by the wrapper:
//
//  * The tensor-core route (namespace tc): bf16 with N and P multiples of
//    16 (N <= 128, P <= 64), chunks of up to 128 rows. Operands live in
//    shared memory as bf16 in 128-byte-swizzled 64-column panels
//    (wgmma_bf16.cuh), loaded by TMA from 3-D maps over the tensors as
//    stored, (P, H, B*S) and (N, G, B*S): one box is the 128 rows of one
//    chunk of one head or group. Rows past the chunk (a chunk shorter than
//    128 rows, or the end of S) get a = 0, exp(A) = w = 0 and a masked
//    decay, and are never stored. Every product is an m64nNk16 wgmma with
//    f32 accumulators in registers; two warpgroups share each 128-row
//    tile, one m64 half each. x, B, C and dy are exact in bf16; the f32
//    factors (the decayed scores C B^T * D, the state, w x, exp(A) dy, the
//    head sum of G) are rounded to bf16 operands once, as flash attention
//    rounds P. The f32 state itself is carried in f32 registers.
//    - The decay D of the L x L scores: the upper 64 x 64 block is zero,
//      so its elements and its products are skipped; the lower block
//      takes exp(A_t - A_63) exp(A_63 - A_s), two factors <= 1, in place
//      of an exp per element; the diagonal blocks mask before the exp.
//    - C B^T is shared by the heads of a group: a first launch writes it
//      for every (batch, chunk, group) to `cb` (4.2 MB at the training
//      shape, held by the L2); every head reads its rows from there and
//      applies its own decay. The other choice, a block owning several
//      heads, would cut the 128 (head, batch) walks that already give one
//      block per SM. (Measured: recomputing C B^T in every head would be
//      faster still, since the read, not the products, is the cost.)
//    - The f32 workspaces shared between kernels (`cb`, the states and
//      their gradients) are kept in the accumulators' fragment order, so
//      each thread moves whole float4s and a warp 512 contiguous bytes.
//    - Forward: one block per (head, batch) walks the chunks in order with
//      the N x P state in registers (each warpgroup 64 rows of N). Per
//      chunk: y = exp(A) (C h) + (C B^T * D) x, the scores going from
//      registers straight into the A fragments of the product with x, and
//      h <- exp(A_L) h + B^T (w x). Thread 0 keeps the next chunk's x, B
//      and C in flight by TMA into a two-stage ring, so loads overlap the
//      current chunk's products; a comes by plain loads one chunk ahead.
//      y leaves through a swizzled staging tile in 16-byte stores.
//    - Backward, three launches:
//      1. the carried state gradient, one block per (head, batch) walking
//         the chunks in reverse: dh <- exp(A_L) dh + C^T (exp(A) dy),
//         writing the gradient of each chunk's end state to `dstates`;
//      2. dx and da, one block per (chunk, head, batch), in parallel:
//         dP = dy x^T, S^ = C B^T * D, G = dP * D; dx = w (B dh') + S^T dy;
//         dA from the row and column sums of C B^T * G, t1 = exp(A) dy .
//         (C h) and q = x . w (B dh'), then its reverse cumsum;
//      3. dC and dB, one block per (chunk, group, batch) for each: the
//         sum over the group's heads goes into the products, so the
//         intra-chunk term is one product (sum_h G_h) B (and (sum_h
//         G_h)^T C) a chunk, the head sum kept in f32 registers in head
//         order, and the inter-chunk terms [exp(A) dy] h^T and [w x]
//         dh'^T accumulate over the heads in one accumulator, a product of
//         depth H x P. No atomics anywhere: two runs give the same bits.
//
//  * The FMA route (the first design, kept for f32 and other widths; f32
//    serves only the reduced checks): CUDA-core f32 FMAs on tiles staged
//    as float (bf16 widened on load, outputs rounded once), in chunks of
//    min(L, 64) rows (the f32 working set of a 128-row chunk would exceed
//    the 227 KB a block may have). Forward: one block of 8 warps per
//    (head, batch) walks the chunks with the state in registers. Backward:
//    the same reverse walk for dstates, then one block per (chunk, group,
//    batch) that computes C B^T once and loops over the group's heads,
//    summing dB and dC in registers in head order. Shared-memory rows have
//    odd strides in floats, so column reads across a warp hit 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "sm90_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int LT = 64;                     // chunk rows (tile)
constexpr int NP = 128;                    // state width N, padded
constexpr int PP = 64;                     // head dim P, padded
constexpr int LDL = LT + 1, LDN = NP + 1, LDP = PP + 1;
constexpr int RI = LT / kWarps;            // 8 rows of 64 per thread
constexpr int NI = NP / kWarps;            // 16 rows of 128 per thread
constexpr int PJ = PP / 32;                // 2 columns of 64 per thread
constexpr int NJ = NP / 32;                // 4 columns of 128 per thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Shape {
  int B, S, H, G, N, P, L, nc;
};

// Rows [0, LT) x columns [0, WP) of a tile from rows of `g` (row stride
// `stride` elements), as f32; rows >= nrows and columns >= width read 0.
template <typename T, int WP>
__device__ __forceinline__ void load_rows(float* s, int ld, const T* g,
                                          long stride, int nrows,
                                          int width) {
  for (int i = threadIdx.x; i < LT * WP; i += kThreads) {
    const int r = i / WP, c = i % WP;
    s[r * ld + c] = (r < nrows && c < width)
                        ? to_f32(g[r * stride + c]) : 0.f;
  }
}

// An (N, P) f32 state from global memory into an NP x PP tile, zero padded.
__device__ __forceinline__ void load_state(float* s, const float* g, int N,
                                           int P) {
  for (int i = threadIdx.x; i < NP * PP; i += kThreads) {
    const int n = i / PP, c = i % PP;
    s[n * LDP + c] = (n < N && c < P) ? g[n * P + c] : 0.f;
  }
}

// Warp 0: acum = inclusive cumsum of the chunk's a (rows >= nrows are 0),
// eA = exp(acum), w = exp(acum[LT-1] - acum). The caller synchronises.
__device__ __forceinline__ void chunk_cumsum(float* acum, float* eA,
                                             float* w, const float* a,
                                             long stride, int nrows) {
  if (threadIdx.x >= 32) return;
  const int l = threadIdx.x;
  const float v0 = 2 * l < nrows ? a[(2 * l) * stride] : 0.f;
  const float v1 = v0 + (2 * l + 1 < nrows ? a[(2 * l + 1) * stride] : 0.f);
  float s = v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(kFull, s, o);
    if (l >= o) s += t;
  }
  const float total = __shfl_sync(kFull, s, 31);
  const float c0 = s - v1 + v0, c1 = s;
  acum[2 * l] = c0;
  acum[2 * l + 1] = c1;
  eA[2 * l] = expf(c0);
  eA[2 * l + 1] = expf(c1);
  w[2 * l] = expf(total - c0);
  w[2 * l + 1] = expf(total - c1);
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ b, const T* __restrict__ c,
               T* __restrict__ y, float* __restrict__ hT,
               float* __restrict__ states, Shape p) {
  extern __shared__ __align__(16) float sm[];
  float* Xs = sm;                          // LT x LDP
  float* Bs = Xs + LT * LDP;               // LT x LDN
  float* Cs = Bs + LT * LDN;               // LT x LDN
  float* Ss = Cs + LT * LDN;               // LT x LDL
  float* Hs = Ss + LT * LDL;               // NP x LDP
  float* acum = Hs + NP * LDP;             // LT
  float* eA = acum + LT;                   // LT
  float* w = eA + LT;                      // LT

  const int h = blockIdx.x, bb = blockIdx.y, g = h / (p.H / p.G);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long xs = static_cast<long>(p.H) * p.P;   // row strides
  const long bs = static_cast<long>(p.G) * p.N;
  const T* xb = x + (static_cast<long>(bb) * p.S * p.H + h) * p.P;
  T* yb = y + (static_cast<long>(bb) * p.S * p.H + h) * p.P;
  const float* ab = a + static_cast<long>(bb) * p.S * p.H + h;
  const T* bb_ = b + (static_cast<long>(bb) * p.S * p.G + g) * p.N;
  const T* cb_ = c + (static_cast<long>(bb) * p.S * p.G + g) * p.N;
  const long head = static_cast<long>(bb) * p.H + h;

  // the state: h[n][q] with n = ty + 8 i, q = tx + 32 j
  float hr[NI][PJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      hr[i][j] = 0.f;
      Hs[(ty + kWarps * i) * LDP + tx + 32 * j] = 0.f;
    }

  for (int ci = 0; ci < p.nc; ++ci) {
    const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
    if (states != nullptr) {
      float* st = states + (head * p.nc + ci) * p.N * p.P;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int n = ty + kWarps * i, q = tx + 32 * j;
          if (n < p.N && q < p.P) st[n * p.P + q] = hr[i][j];
        }
    }
    load_rows<T, PP>(Xs, LDP, xb + r0 * xs, xs, nrows, p.P);
    load_rows<T, NP>(Bs, LDN, bb_ + r0 * bs, bs, nrows, p.N);
    load_rows<T, NP>(Cs, LDN, cb_ + r0 * bs, bs, nrows, p.N);
    chunk_cumsum(acum, eA, w, ab + static_cast<long>(r0) * p.H, p.H, nrows);
    __syncthreads();

    // S[t][s] = (C_t . B_s) exp(A_t - A_s) for s <= t, else 0
    {
      float acc[RI][2] = {};
      for (int n = 0; n < NP; ++n) {
        float cv[RI], bv[2];
#pragma unroll
        for (int i = 0; i < RI; ++i) cv[i] = Cs[(ty + kWarps * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[j] = Bs[(tx + 32 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = ty + kWarps * i, s = tx + 32 * j;
          Ss[t * LDL + s] =
              s <= t ? acc[i][j] * expf(acum[t] - acum[s]) : 0.f;
        }
    }
    __syncthreads();

    // y[t][q] = exp(A_t) (C_t . h)[q] + sum_s S[t][s] x[s][q]
    {
      float acc[RI][PJ] = {};
      for (int n = 0; n < NP; ++n) {
        float cv[RI], hv[PJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) cv[i] = Cs[(ty + kWarps * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = Hs[n * LDP + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float e = eA[ty + kWarps * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
      }
      for (int s = 0; s < LT; ++s) {
        float sv[RI], xv[PJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) sv[i] = Ss[(ty + kWarps * i) * LDL + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * LDP + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int t = ty + kWarps * i, q = tx + 32 * j;
          if (t < nrows && q < p.P)
            yb[(r0 + t) * xs + q] = from_f32<T>(acc[i][j]);
        }
    }
    __syncthreads();                       // C.h has read the old state

    // h <- exp(A_L) h + sum_s w_s B_s (x) x_s
    {
      const float decay = eA[LT - 1];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) hr[i][j] *= decay;
      for (int s = 0; s < LT; ++s) {
        float bv[NI], xv[PJ];
        const float ws = w[s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * LDP + tx + 32 * j] * ws;
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = Bs[s * LDN + ty + kWarps * i];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) hr[i][j] = fmaf(bv[i], xv[j], hr[i][j]);
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          Hs[(ty + kWarps * i) * LDP + tx + 32 * j] = hr[i][j];
    }
    __syncthreads();
  }

  float* out = hT + head * p.N * p.P;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int n = ty + kWarps * i, q = tx + 32 * j;
      if (n < p.N && q < p.P) out[n * p.P + q] = hr[i][j];
    }
}

// ---------------------------------------------------------------------
// backward 1: the carried state gradient, chunks in reverse
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_state_kernel(const float* __restrict__ a, const T* __restrict__ c,
                     const T* __restrict__ dy, const float* __restrict__ dhT,
                     float* __restrict__ dstates, Shape p) {
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm;                          // LT x LDN
  float* Ys = Cs + LT * LDN;               // LT x LDP
  float* acum = Ys + LT * LDP;
  float* eA = acum + LT;
  float* w = eA + LT;

  const int h = blockIdx.x, bb = blockIdx.y, g = h / (p.H / p.G);
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long xs = static_cast<long>(p.H) * p.P;
  const long bs = static_cast<long>(p.G) * p.N;
  const T* yb = dy + (static_cast<long>(bb) * p.S * p.H + h) * p.P;
  const float* ab = a + static_cast<long>(bb) * p.S * p.H + h;
  const T* cb_ = c + (static_cast<long>(bb) * p.S * p.G + g) * p.N;
  const long head = static_cast<long>(bb) * p.H + h;

  float dh[NI][PJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) {
      const int n = ty + kWarps * i, q = tx + 32 * j;
      dh[i][j] = (dhT != nullptr && n < p.N && q < p.P)
                     ? dhT[head * p.N * p.P + n * p.P + q] : 0.f;
    }

  for (int ci = p.nc - 1; ci >= 0; --ci) {
    const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
    float* st = dstates + (head * p.nc + ci) * p.N * p.P;
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const int n = ty + kWarps * i, q = tx + 32 * j;
        if (n < p.N && q < p.P) st[n * p.P + q] = dh[i][j];
      }
    load_rows<T, NP>(Cs, LDN, cb_ + r0 * bs, bs, nrows, p.N);
    load_rows<T, PP>(Ys, LDP, yb + r0 * xs, xs, nrows, p.P);
    chunk_cumsum(acum, eA, w, ab + static_cast<long>(r0) * p.H, p.H, nrows);
    __syncthreads();
    const float decay = eA[LT - 1];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) dh[i][j] *= decay;
    for (int t = 0; t < LT; ++t) {
      float cv[NI], yv[PJ];
      const float e = eA[t];
#pragma unroll
      for (int j = 0; j < PJ; ++j) yv[j] = Ys[t * LDP + tx + 32 * j] * e;
#pragma unroll
      for (int i = 0; i < NI; ++i) cv[i] = Cs[t * LDN + ty + kWarps * i];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) dh[i][j] = fmaf(cv[i], yv[j], dh[i][j]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// backward 2: every chunk on its own, the heads of a group in one block
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const T* __restrict__ b, const T* __restrict__ c,
                     const T* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ dstates, T* __restrict__ dx,
                     float* __restrict__ da, T* __restrict__ db,
                     T* __restrict__ dc, Shape p) {
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                          // LT x LDN
  float* Cs = Bs + LT * LDN;               // LT x LDN
  float* CBs = Cs + LT * LDN;              // LT x LDL: C B^T
  float* SGs = CBs + LT * LDL;             // LT x LDL: S^, then G
  float* Xs = SGs + LT * LDL;              // LT x LDP
  float* Ys = Xs + LT * LDP;               // LT x LDP: dy
  float* H0s = Ys + LT * LDP;              // NP x LDP: state at the start
  float* DHs = H0s + NP * LDP;             // NP x LDP: grad of the end state
  float* acum = DHs + NP * LDP;
  float* eA = acum + LT;
  float* w = eA + LT;
  float* rowM = w + LT;                    // row sums of M
  float* qs = rowM + LT;                   // Q_s = w_s x_s . (B dh')_s
  float* t1 = qs + LT;                     // exp(A_t) C_t . (dy h^T)_t
  float* colp = t1 + LT;                   // kWarps x LT column partials
  float* red = colp + kWarps * LT;         // kWarps

  const int ci = blockIdx.x, g = blockIdx.y, bb = blockIdx.z;
  const int rep = p.H / p.G;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
  const long xs = static_cast<long>(p.H) * p.P;
  const long bs = static_cast<long>(p.G) * p.N;
  const long goff = (static_cast<long>(bb) * p.S * p.G + g) * p.N +
                    static_cast<long>(r0) * bs;

  load_rows<T, NP>(Bs, LDN, b + goff, bs, nrows, p.N);
  load_rows<T, NP>(Cs, LDN, c + goff, bs, nrows, p.N);
  __syncthreads();
  {                                        // C B^T, rows t, columns s
    float acc[RI][2] = {};
    for (int n = 0; n < NP; ++n) {
      float cv[RI], bv[2];
#pragma unroll
      for (int i = 0; i < RI; ++i) cv[i] = Cs[(ty + kWarps * i) * LDN + n];
#pragma unroll
      for (int j = 0; j < 2; ++j) bv[j] = Bs[(tx + 32 * j) * LDN + n];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        CBs[(ty + kWarps * i) * LDL + tx + 32 * j] = acc[i][j];
  }

  // dB (rows s) and dC (rows t) of the group, summed over its heads
  float dB[RI][NJ] = {}, dC[RI][NJ] = {};

  for (int h = g * rep; h < (g + 1) * rep; ++h) {
    const long hoff = (static_cast<long>(bb) * p.S * p.H + h) * p.P +
                      static_cast<long>(r0) * xs;
    const long head = static_cast<long>(bb) * p.H + h;
    load_rows<T, PP>(Xs, LDP, x + hoff, xs, nrows, p.P);
    load_rows<T, PP>(Ys, LDP, dy + hoff, xs, nrows, p.P);
    load_state(H0s, states + (head * p.nc + ci) * p.N * p.P, p.N, p.P);
    load_state(DHs, dstates + (head * p.nc + ci) * p.N * p.P, p.N, p.P);
    chunk_cumsum(acum, eA, w,
                 a + static_cast<long>(bb) * p.S * p.H + h +
                     static_cast<long>(r0) * p.H,
                 p.H, nrows);
    __syncthreads();

    // dP = dy x^T (rows t, columns s), then S^ and G with the decay mask
    float gm[RI][2] = {};
    for (int q = 0; q < PP; ++q) {
      float yv[RI], xv[2];
#pragma unroll
      for (int i = 0; i < RI; ++i) yv[i] = Ys[(ty + kWarps * i) * LDP + q];
#pragma unroll
      for (int j = 0; j < 2; ++j) xv[j] = Xs[(tx + 32 * j) * LDP + q];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) gm[i][j] = fmaf(yv[i], xv[j], gm[i][j]);
    }
    {
      float colpart[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + kWarps * i;
        float rowpart = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = tx + 32 * j;
          float sh = 0.f, gv = 0.f;
          if (s <= t) {
            const float d = expf(acum[t] - acum[s]);
            const float cbv = CBs[t * LDL + s];
            sh = cbv * d;
            gv = gm[i][j] * d;
            const float m = cbv * gv;
            rowpart += m;
            colpart[j] += m;
          }
          SGs[t * LDL + s] = sh;
          gm[i][j] = gv;
        }
        rowpart = warp_sum(rowpart);
        if (tx == 0) rowM[t] = rowpart;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) colp[ty * LT + tx + 32 * j] = colpart[j];
    }
    __syncthreads();

    // dx[s] = w_s (B dh')_s + sum_t S^[t][s] dy_t (rows s, columns q)
    {
      float acc[RI][PJ] = {};
      for (int n = 0; n < NP; ++n) {
        float bv[RI], dv[PJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) bv[i] = Bs[(ty + kWarps * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) dv[j] = DHs[n * LDP + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(bv[i], dv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int s = ty + kWarps * i;
        float qv = 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          acc[i][j] *= w[s];
          qv = fmaf(Xs[s * LDP + tx + 32 * j], acc[i][j], qv);
        }
        qv = warp_sum(qv);
        if (tx == 0) qs[s] = qv;
      }
      for (int t = 0; t < LT; ++t) {
        float sv[RI], yv[PJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) sv[i] = SGs[t * LDL + ty + kWarps * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) yv[j] = Ys[t * LDP + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv[i], yv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int s = ty + kWarps * i, q = tx + 32 * j;
          if (s < nrows && q < p.P)
            dx[hoff + s * xs + q] = from_f32<T>(acc[i][j]);
        }
    }
    __syncthreads();                       // S^ is read: G takes its place
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        SGs[(ty + kWarps * i) * LDL + tx + 32 * j] = gm[i][j];
    __syncthreads();

    // dC[t] += exp(A_t) (dy h^T)_t + sum_s G[t][s] B_s (rows t, columns n)
    {
      float acc[RI][NJ] = {};
      for (int q = 0; q < PP; ++q) {
        float yv[RI], hv[NJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) yv[i] = Ys[(ty + kWarps * i) * LDP + q];
#pragma unroll
        for (int j = 0; j < NJ; ++j) hv[j] = H0s[(tx + 32 * j) * LDP + q];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(yv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + kWarps * i;
        const float e = eA[t];
        float tv = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][j] *= e;
          tv = fmaf(Cs[t * LDN + tx + 32 * j], acc[i][j], tv);
          dC[i][j] += acc[i][j];
        }
        tv = warp_sum(tv);
        if (tx == 0) t1[t] = tv;
      }
    }
    for (int s = 0; s < LT; ++s) {
      float gv[RI], bv[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) gv[i] = SGs[(ty + kWarps * i) * LDL + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = Bs[s * LDN + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dC[i][j] = fmaf(gv[i], bv[j], dC[i][j]);
    }

    // dB[s] += w_s (x dh'^T)_s + sum_t G[t][s] C_t (rows s, columns n)
    {
      float acc[RI][NJ] = {};
      for (int q = 0; q < PP; ++q) {
        float xv[RI], dv[NJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) xv[i] = Xs[(ty + kWarps * i) * LDP + q];
#pragma unroll
        for (int j = 0; j < NJ; ++j) dv[j] = DHs[(tx + 32 * j) * LDP + q];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xv[i], dv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ws = w[ty + kWarps * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) dB[i][j] = fmaf(ws, acc[i][j], dB[i][j]);
      }
    }
    for (int t = 0; t < LT; ++t) {
      float gv[RI], cv[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) gv[i] = SGs[t * LDL + ty + kWarps * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) cv[j] = Cs[t * LDN + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dB[i][j] = fmaf(gv[i], cv[j], dB[i][j]);
    }

    // <dh', h> for the exp(A_L) h term of the state update
    {
      float v = 0.f;
      for (int i = threadIdx.x; i < NP * PP; i += kThreads) {
        const int n = i / PP, q = i % PP;
        v = fmaf(DHs[n * LDP + q], H0s[n * LDP + q], v);
      }
      v = warp_sum(v);
      if (tx == 0) red[ty] = v;
    }
    __syncthreads();

    // dA, then da = its reverse cumsum over the chunk (warp 0)
    if (ty == 0) {
      float v[2], qsum = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = LT - 1 - (2 * tx + k);
        float col = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) col += colp[wi * LT + t];
        v[k] = rowM[t] - col + t1[t] - qs[t];
        qsum += qs[t];
      }
      qsum = warp_sum(qsum);
      if (tx == 0) {
        float dot = 0.f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) dot += red[wi];
        v[0] += qsum + eA[LT - 1] * dot;     // row LT-1: the A_L terms
      }
      v[1] += v[0];
      float s = v[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(kFull, s, o);
        if (tx >= o) s += u;
      }
      const float excl = s - v[1];
      float* dab = da + static_cast<long>(bb) * p.S * p.H + h +
                   static_cast<long>(r0) * p.H;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = LT - 1 - (2 * tx + k);
        if (t < nrows) dab[static_cast<long>(t) * p.H] = excl + v[k];
      }
    }
    __syncthreads();                       // before the next head's loads
  }

#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = ty + kWarps * i, n = tx + 32 * j;
      if (r < nrows && n < p.N) {
        db[goff + r * bs + n] = from_f32<T>(dB[i][j]);
        dc[goff + r * bs + n] = from_f32<T>(dC[i][j]);
      }
    }
}

constexpr size_t kFwdSmem =
    sizeof(float) * (LT * LDP + 2 * LT * LDN + LT * LDL + NP * LDP + 3 * LT);
constexpr size_t kBwdStateSmem =
    sizeof(float) * (LT * LDN + LT * LDP + 3 * LT);
constexpr size_t kBwdChunkSmem =
    sizeof(float) * (2 * LT * LDN + 2 * LT * LDL + 2 * LT * LDP +
                     2 * NP * LDP + 6 * LT + kWarps * LT + kWarps);

bool valid(const Shape& p) {
  return p.B > 0 && p.S > 0 && p.H > 0 && p.G > 0 && p.H % p.G == 0 &&
         p.N > 0 && p.N <= NP && p.P > 0 && p.P <= PP && p.L > 0 &&
         p.L <= LT && p.nc == (p.S + p.L - 1) / p.L;
}

// Raise a kernel's dynamic shared-memory limit once (before any stream
// capture: the first call of each entry point is a plain launch).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = e == cudaSuccess;
  return e;
}

template <typename T>
cudaError_t fwd(const void* x, const void* a, const void* b, const void* c,
                void* y, void* hT, void* states, const Shape& p,
                cudaStream_t s) {
  auto kern = ssd_fwd_kernel<T>;
  static bool done = false;
  const cudaError_t e = allow_smem(kern, kFwdSmem, done);
  if (e != cudaSuccess) return e;
  kern<<<dim3(p.H, p.B), kThreads, kFwdSmem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(hT), static_cast<float*>(states), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* a, const void* b, const void* c,
                const void* states, const void* dy, const void* dhT,
                void* dstates, void* dx, void* da, void* db, void* dc,
                const Shape& p, cudaStream_t s) {
  auto k1 = ssd_bwd_state_kernel<T>;
  auto k2 = ssd_bwd_chunk_kernel<T>;
  static bool done1 = false, done2 = false;
  cudaError_t e = allow_smem(k1, kBwdStateSmem, done1);
  if (e == cudaSuccess) e = allow_smem(k2, kBwdChunkSmem, done2);
  if (e != cudaSuccess) return e;
  k1<<<dim3(p.H, p.B), kThreads, kBwdStateSmem, s>>>(
      static_cast<const float*>(a), static_cast<const T*>(c),
      static_cast<const T*>(dy), static_cast<const float*>(dhT),
      static_cast<float*>(dstates), p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k2<<<dim3(p.nc, p.G, p.B), kThreads, kBwdChunkSmem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const T*>(dy), static_cast<const float*>(states),
      static_cast<const float*>(dstates), static_cast<T*>(dx),
      static_cast<float*>(da), static_cast<T*>(db), static_cast<T*>(dc), p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The tensor-core route (bf16, N and P multiples of 16)
// ---------------------------------------------------------------------
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kT = 256;                    // two warpgroups
constexpr int R = 128;                     // tile rows of a chunk
constexpr int kPanel = R * 128;            // 128 rows x 64 bf16: 16 KB
constexpr int kWide = 2 * kPanel;          // 128 rows x 128 bf16: 32 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

struct Shape {
  int B, S, H, G, N, P, L, nc;
};

// Per-row factors of one chunk and head: la = A log2(e) (A the inclusive
// cumsum of a), eA = exp(A) and w = exp(A_last - A), both 0 on rows past
// the chunk's valid rows; e63 = exp(A_63 - A) on rows below 64 and
// exp(A - A_63) (0 past the valid rows) from row 64 on.
struct Scan {
  float la[R], eA[R], w[R], e63[R];
};

// This thread's warpgroup, broadcast from lane 0 so that the compiler
// sees it uniform across the warp: a branch on it around wgmma is then
// not a divergent path (which would serialise the wgmma pipeline).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(kAll, static_cast<int>(threadIdx.x / 128), 0);
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void init_bars(uint64_t* bar, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Lane l of a warp: a of rows 4l .. 4l+3 of a chunk (0 from row nrows on).
__device__ __forceinline__ void load_a(float (&av)[4], const float* a,
                                       long base, int H, int nrows) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * l + k;
    av[k] = t < nrows ? __ldg(a + base + static_cast<long>(t) * H) : 0.f;
  }
}

// One warp: the chunk's Scan from av (see load_a).
__device__ __forceinline__ void chunk_scan(Scan& s, const float (&av)[4],
                                           int nrows) {
  const int l = threadIdx.x % 32;
  float c[4], run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += av[k];
    c[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kAll, incl, o);
    if (l >= o) incl += u;
  }
  const float excl = incl - run, total = __shfl_sync(kAll, incl, 31);
  const float a63 = __shfl_sync(kAll, excl + c[3], 15);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * l + k;
    const float acum = excl + c[k];
    const bool ok = t < nrows;
    s.la[t] = acum * kLog2e;
    s.eA[t] = ok ? exp2f(acum * kLog2e) : 0.f;
    s.w[t] = ok ? exp2f((total - acum) * kLog2e) : 0.f;
    s.e63[t] = t < 64 ? exp2f((a63 - acum) * kLog2e)
                      : (ok ? exp2f((acum - a63) * kLog2e) : 0.f);
  }
}

// exp(A_t - A_s) for s <= t < nrows, else 0 (masked before the exp)
__device__ __forceinline__ float decay(const Scan& s, int t, int u,
                                       int nrows) {
  return (u <= t && t < nrows) ? wgmma::exp2_approx(s.la[t] - s.la[u]) : 0.f;
}

// The decay of an L x L fragment's element i in warpgroup W, whose rows
// are t (kRowsT) or s. Of the four 64 x 64 blocks, the upper one (s >= 64
// > t) is 0 and needs no work; the lower one (t >= 64 > s) takes
// exp(A_t - A_63) exp(A_63 - A_s), a product of two factors <= 1 in place
// of an exp; the two diagonal ones mask and exp per element.
template <int W, bool kRowsT>
__device__ __forceinline__ bool upper(int i) {
  return kRowsT ? (W == 0 && i >= 32) : (W == 1 && i < 32);
}
template <int W, bool kRowsT>
__device__ __forceinline__ float dmat(const Scan& s, int r, int c, int i,
                                      int nrows) {
  const int t = kRowsT ? r : c, u = kRowsT ? c : r;
  if (upper<W, kRowsT>(i)) return 0.f;
  if ((W == 0) == (i < 32)) return decay(s, t, u, nrows);   // diagonal
  return t < nrows ? s.e63[t] * s.e63[u] : 0.f;
}
template <int W>
using WG = std::integral_constant<int, W>;

// Accumulator fragment coordinates of this thread in its warpgroup.
struct Frag {
  int row, col;                             // of element 0
  __device__ __forceinline__ Frag() {
    const int t = threadIdx.x % 128, l = t % 32;
    row = 16 * (t / 32) + l / 4;
    col = 2 * (l % 4);
  }
  __device__ __forceinline__ int r(int i) const {
    return row + 8 * ((i / 2) % 2);
  }
  __device__ __forceinline__ int c(int i) const {
    return 8 * (i / 4) + col + i % 2;
  }
};

__device__ __forceinline__ float ld_bf(const unsigned char* tile, int r,
                                       int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      tile + wgmma::sw_offset<R>(r, c)));
}
__device__ __forceinline__ void st_bf2(unsigned char* tile, int r, int c,
                                       float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(tile + wgmma::sw_offset<R>(r, c)) =
      __floats2bfloat162_rn(lo, hi);
}

// dst rows [r0, r0 + 64) = scale[row] * src rows, over one 64-column
// panel (the swizzle moves bytes within a row only).
__device__ __forceinline__ void scale_rows(unsigned char* dst,
                                           const unsigned char* src,
                                           const float* scale, int r0) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = t + 128 * k, r = r0 + j / 8, off = r * 128 + (j % 8) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(src + off);
    const float f = scale[r];
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint4 o;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 u = __bfloat1622float2(in[e]);
      out[e] = __floats2bfloat162_rn(u.x * f, u.y * f);
    }
    *reinterpret_cast<uint4*>(dst + off) = o;
  }
}

// Rows [r0, r0 + 64) of a swizzled 128 x 64 bf16 tile to rows of `out`
// (row stride ld elements): rows < nrows, columns < P, 16 bytes a store.
__device__ __forceinline__ void store_rows(bf16* out, long ld,
                                           const unsigned char* tile, int r0,
                                           int nrows, int P) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = t + 128 * k, r = r0 + j / 8, cc = j % 8;
    if (r < nrows && cc * 8 < P)
      *reinterpret_cast<uint4*>(out + r * ld + cc * 8) =
          *reinterpret_cast<const uint4*>(tile + r * 128 +
                                          ((cc ^ (r % 8)) * 16));
  }
}

// The f32 workspaces the kernels share (C B^T, and the states and their
// gradients at every chunk's edge) are stored in fragment order: float4
// k of thread t of warpgroup w holds accumulator elements 4k .. 4k + 3 and
// sits at float4 (w * K + k) * 128 + t (K = 16 for a 128 x 128 tile, 8
// for a 128 x 64 state), so a warp moves 512 contiguous bytes at a time.
template <int K>
__device__ __forceinline__ void store_frag(float* g, const float (&d)[4 * K],
                                           int wg) {
  float4* o = reinterpret_cast<float4*>(g) + wg * K * 128 + threadIdx.x % 128;
#pragma unroll
  for (int k = 0; k < K; ++k)
    o[k * 128] = make_float4(d[4 * k], d[4 * k + 1], d[4 * k + 2],
                             d[4 * k + 3]);
}
template <int K>
__device__ __forceinline__ void load_frag(float (&d)[4 * K], const float* g,
                                          int wg) {
  const float4* in =
      reinterpret_cast<const float4*>(g) + wg * K * 128 + threadIdx.x % 128;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 v = __ldg(in + k * 128);
    d[4 * k] = v.x;
    d[4 * k + 1] = v.y;
    d[4 * k + 2] = v.z;
    d[4 * k + 3] = v.w;
  }
}
constexpr int kStateFloats = R * 64;       // a state in fragment order

// States in fragment order (in shared memory, each thread reading the
// elements it owns as a fragment of its warpgroup) into bf16 tiles (n, q):
// st into tile and, with kPair, st2 into tile2, returning this thread's
// part of <st, st2>.
template <bool kPair>
__device__ __forceinline__ float frag_to_tile(unsigned char* tile,
                                              const float* st,
                                              unsigned char* tile2 = nullptr,
                                              const float* st2 = nullptr) {
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128, l = t % 32;
  const int row = 64 * wg + 16 * (t / 32) + l / 4, col = 2 * (l % 4);
  const int at = wg * 8 * 128 + t;
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 u = reinterpret_cast<const float4*>(st)[at + k * 128];
    st_bf2(tile, row, 8 * k + col, u.x, u.y);
    st_bf2(tile, row + 8, 8 * k + col, u.z, u.w);
    if (kPair) {
      const float4 v = reinterpret_cast<const float4*>(st2)[at + k * 128];
      st_bf2(tile2, row, 8 * k + col, v.x, v.y);
      st_bf2(tile2, row + 8, 8 * k + col, v.z, v.w);
      dot += u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
    }
  }
  return dot;
}

// An m64n64 f32 fragment (rows n of the warpgroup, columns q) of an
// N x P f32 state to global memory, rows < N, columns < P.
__device__ __forceinline__ void store_state(float* g, const float (&d)[32],
                                            int n0, int N, int P) {
  const Frag f;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int n = n0 + f.r(i), q = f.c(i);
    if (n < N && q < P)
      *reinterpret_cast<float2*>(g + n * P + q) = make_float2(d[i], d[i + 1]);
  }
}

// ---------------------------------------------------------------------
// C.B^T of every chunk and group, once: cb (B, nc, G, 128 x 128) f32, in
// fragment order
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kT, 1)
ssd_tc_cb_kernel(Shape p, const __grid_constant__ CUtensorMap tb,
          const __grid_constant__ CUtensorMap tcm, float* __restrict__ cb) {
  extern __shared__ unsigned char raw[];
  unsigned char* Bt = align1024(raw);
  unsigned char* Ct = Bt + kWide;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Ct + kWide);
  const int ci = blockIdx.x, g = blockIdx.y, bb = blockIdx.z;
  const int wg = warpgroup();
  init_bars(bar, 1);
  if (threadIdx.x == 0) {
    const int row = bb * p.S + ci * p.L;
    mbar_expect(bar, 2 * kWide);
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(Bt + c * kPanel, tb, bar, 64 * c, g, row);
      tma_load_3d(Ct + c * kPanel, tcm, bar, 64 * c, g, row);
    }
  }
  mbar_wait(bar, 0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wgmma::fence_operand(acc);
  wgmma::fence();
  for (int kk = 0; kk < p.N / 16; ++kk)
    wgmma::wgmma_ss_acc<0, 0>(acc, wgmma::kmajor<R>(Ct, 64 * wg, kk),
                              wgmma::kmajor<R>(Bt, 0, kk));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  store_frag<16>(cb + ((static_cast<long>(bb) * p.nc + ci) * p.G + g) * R * R,
                 acc, wg);
}

// ---------------------------------------------------------------------
// forward: one block per (head, batch) walks the chunks, the state in
// registers
// ---------------------------------------------------------------------
struct FwdSmem {
  static constexpr int kStage = 5 * kPanel;     // x, B (2 panels), C (2)
  static constexpr size_t bytes =
      1024 + 2 * kStage + 3 * kPanel + 2 * sizeof(Scan) + 2 * 8;
};

__global__ void __launch_bounds__(kT, 1)
ssd_tc_fwd_kernel(Shape p, const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tb,
           const __grid_constant__ CUtensorMap tcm,
           const float* __restrict__ a, const float* __restrict__ cb,
           bf16* __restrict__ y, float* __restrict__ hT,
           float* __restrict__ states) {
  extern __shared__ unsigned char raw[];
  unsigned char* ring = align1024(raw);
  unsigned char* WX = ring + 2 * FwdSmem::kStage;   // w * x, bf16
  unsigned char* Ht = WX + kPanel;                  // state, bf16 (n, q)
  unsigned char* Ys = Ht + kPanel;                  // y staging
  Scan* scans = reinterpret_cast<Scan*>(Ys + kPanel);
  uint64_t* full = reinterpret_cast<uint64_t*>(scans + 2);

  const int h = blockIdx.x, bb = blockIdx.y, g = h / (p.H / p.G);
  const int wg = warpgroup();
  const bool scanner = threadIdx.x % 128 < 32;
  Scan& sc = scans[wg];
  const Frag f;
  const int nkN = p.N / 16;
  const long head = static_cast<long>(bb) * p.H + h;

  auto X = [&](int st) { return ring + st * FwdSmem::kStage; };
  auto Bt = [&](int st) { return X(st) + kPanel; };
  auto Ct = [&](int st) { return X(st) + 3 * kPanel; };
  auto fetch = [&](int ci) {
    const int st = ci % 2, row = bb * p.S + ci * p.L;
    mbar_expect(&full[st], FwdSmem::kStage);
    tma_load_3d(X(st), tx, &full[st], 0, h, row);
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(Bt(st) + c * kPanel, tb, &full[st], 64 * c, g, row);
      tma_load_3d(Ct(st) + c * kPanel, tcm, &full[st], 64 * c, g, row);
    }
  };

  for (int i = threadIdx.x; i < kPanel / 16; i += kT)
    reinterpret_cast<uint4*>(Ht)[i] = make_uint4(0, 0, 0, 0);
  init_bars(full, 2);
  if (threadIdx.x == 0) {
    fetch(0);
    if (p.nc > 1) fetch(1);
  }
  float hacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
  float av[4];
  if (scanner)
    load_a(av, a, static_cast<long>(bb) * p.S * p.H + h, p.H,
           min(p.L, p.S));

  for (int ci = 0; ci < p.nc; ++ci) {
    const int st = ci % 2, r0 = ci * p.L, nrows = min(p.L, p.S - r0);
    float cbr[64];
    load_frag<16>(cbr, cb + ((static_cast<long>(bb) * p.nc + ci) * p.G + g) *
                               R * R, wg);
    if (scanner) {
      chunk_scan(sc, av, nrows);
      if (ci + 1 < p.nc) {
        const int r1 = r0 + p.L;
        load_a(av, a, (static_cast<long>(bb) * p.S + r1) * p.H + h, p.H,
               min(p.L, p.S - r1));
      }
    }
    if (states != nullptr)
      store_frag<8>(states + (head * p.nc + ci) * kStateFloats, hacc, wg);
    mbar_wait(&full[st], (ci / 2) & 1);
    wg_sync(wg);                           // the scan
    scale_rows(WX, X(st), sc.w, 64 * wg);
    wgmma::fence_proxy();
    __syncthreads();                       // WX and Ht whole

    // y = exp(A) (C h) + (C B^T * D) x;  h <- exp(A_L) h + B^T (w x)
    float yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
    const float eL = sc.eA[nrows - 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] *= eL;
    wgmma::fence_operand(yacc);
    wgmma::fence_operand(hacc);
    wgmma::fence();
    for (int kk = 0; kk < nkN; ++kk)
      wgmma::wgmma_ss_acc<0, 1>(yacc, wgmma::kmajor<R>(Ct(st), 64 * wg, kk),
                                wgmma::mnmajor<R>(Ht, kk));
    wgmma::commit();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma::wgmma_ss_acc<1, 1>(
          hacc, wgmma::mnmajor<R>(Bt(st) + wg * kPanel, kk),
          wgmma::mnmajor<R>(WX, kk));
    wgmma::commit();
    uint32_t fr[8][4];
    auto sd = [&](auto w) {
      constexpr int W = decltype(w)::value;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        cbr[i] = upper<W, true>(i) ? 0.f
                 : cbr[i] * dmat<W, true>(sc, 64 * W + f.r(i), f.c(i), i,
                                          nrows);
      wgmma::to_frags(cbr, fr);
    };
    if (wg == 0) sd(WG<0>{}); else sd(WG<1>{});
    wgmma::wait<0>();                      // the state's product ran under D
    wgmma::fence_operand(yacc);
    wgmma::fence_operand(hacc);
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] *= sc.eA[64 * wg + f.r(i)];
    wgmma::fence_operand(yacc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)         // rows t < 64: columns s < 64
      wgmma::wgmma_rs_acc<1>(yacc, fr[kk], wgmma::mnmajor<R>(X(st), kk));
    if (wg == 1) {
#pragma unroll
      for (int kk = 4; kk < 8; ++kk)
        wgmma::wgmma_rs_acc<1>(yacc, fr[kk], wgmma::mnmajor<R>(X(st), kk));
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(yacc);
    wgmma::fence_operand(hacc);
    __syncthreads();                       // Ht, WX and stage st are read
    if (threadIdx.x == 0 && ci + 2 < p.nc) fetch(ci + 2);

#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      st_bf2(Ht, 64 * wg + f.r(i), f.c(i), hacc[i], hacc[i + 1]);
      st_bf2(Ys, 64 * wg + f.r(i), f.c(i), yacc[i], yacc[i + 1]);
    }
    wg_sync(wg);
    store_rows(y + ((static_cast<long>(bb) * p.S + r0) * p.H + h) * p.P,
               static_cast<long>(p.H) * p.P, Ys, 64 * wg, nrows, p.P);
  }
  store_state(hT + head * p.N * p.P, hacc, 64 * wg, p.N, p.P);
}

// ---------------------------------------------------------------------
// backward 1: the carried state gradient, chunks in reverse
// ---------------------------------------------------------------------
struct StateSmem {
  static constexpr int kStage = 3 * kPanel;     // dy, C (2 panels)
  static constexpr size_t bytes =
      1024 + 2 * kStage + kPanel + 2 * sizeof(Scan) + 2 * 8;
};

__global__ void __launch_bounds__(kT, 1)
ssd_tc_bwd_state_kernel(Shape p, const __grid_constant__ CUtensorMap tdy,
                 const __grid_constant__ CUtensorMap tcm,
                 const float* __restrict__ a, const float* __restrict__ dhT,
                 float* __restrict__ dstates) {
  extern __shared__ unsigned char raw[];
  unsigned char* ring = align1024(raw);
  unsigned char* EDY = ring + 2 * StateSmem::kStage;   // exp(A) dy, bf16
  Scan* scans = reinterpret_cast<Scan*>(EDY + kPanel);
  uint64_t* full = reinterpret_cast<uint64_t*>(scans + 2);

  const int h = blockIdx.x, bb = blockIdx.y, g = h / (p.H / p.G);
  const int wg = warpgroup();
  const bool scanner = threadIdx.x % 128 < 32;
  Scan& sc = scans[wg];
  const Frag f;
  const long head = static_cast<long>(bb) * p.H + h;

  auto DY = [&](int st) { return ring + st * StateSmem::kStage; };
  auto Ct = [&](int st) { return DY(st) + kPanel; };
  auto fetch = [&](int it) {                // it-th chunk from the end
    const int st = it % 2, row = bb * p.S + (p.nc - 1 - it) * p.L;
    mbar_expect(&full[st], StateSmem::kStage);
    tma_load_3d(DY(st), tdy, &full[st], 0, h, row);
    for (int c = 0; c < 2; ++c)
      tma_load_3d(Ct(st) + c * kPanel, tcm, &full[st], 64 * c, g, row);
  };
  init_bars(full, 2);
  if (threadIdx.x == 0) {
    fetch(0);
    if (p.nc > 1) fetch(1);
  }
  float dh[32];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int n = 64 * wg + f.r(i), q = f.c(i);
    const bool ok = dhT != nullptr && n < p.N && q < p.P;
    const float2 v = ok ? *reinterpret_cast<const float2*>(
                              dhT + head * p.N * p.P + n * p.P + q)
                        : make_float2(0.f, 0.f);
    dh[i] = v.x;
    dh[i + 1] = v.y;
  }
  float av[4];
  auto a_base = [&](int ci) {
    return (static_cast<long>(bb) * p.S + ci * p.L) * p.H + h;
  };
  if (scanner)
    load_a(av, a, a_base(p.nc - 1), p.H, p.S - (p.nc - 1) * p.L);

  for (int it = 0; it < p.nc; ++it) {
    const int ci = p.nc - 1 - it, st = it % 2;
    const int nrows = min(p.L, p.S - ci * p.L);
    if (scanner) {
      chunk_scan(sc, av, nrows);
      if (ci > 0) load_a(av, a, a_base(ci - 1), p.H, p.L);
    }
    store_frag<8>(dstates + (head * p.nc + ci) * kStateFloats, dh, wg);
    mbar_wait(&full[st], (it / 2) & 1);
    wg_sync(wg);
    scale_rows(EDY, DY(st), sc.eA, 64 * wg);
    wgmma::fence_proxy();
    __syncthreads();
    // dh <- exp(A_L) dh + C^T (exp(A) dy)
    const float eL = sc.eA[nrows - 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) dh[i] *= eL;
    wgmma::fence_operand(dh);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma::wgmma_ss_acc<1, 1>(dh,
                                wgmma::mnmajor<R>(Ct(st) + wg * kPanel, kk),
                                wgmma::mnmajor<R>(EDY, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(dh);
    __syncthreads();                       // EDY and stage st are read
    if (threadIdx.x == 0 && it + 2 < p.nc) fetch(it + 2);
  }
}

// ---------------------------------------------------------------------
// backward 2: dx and da of every (chunk, head), in parallel
// ---------------------------------------------------------------------
struct DxSmem {
  // x, dy, B (2), C (2), h, dh' (bf16), then S^ (2 panels) over the f32
  // states it replaces
  static constexpr int kTiles = 8 * kPanel;
  static constexpr int kUnion = 4 * kPanel;     // 2 x 128 x 64 f32
  static constexpr size_t bytes = 1024 + kTiles + kUnion + sizeof(Scan) +
                                  sizeof(float) * (8 * R + 3 * R + 8) + 8;
};

__global__ void __launch_bounds__(kT, 1)
ssd_tc_bwd_dx_kernel(Shape p, const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tdy,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tcm,
              const float* __restrict__ a, const float* __restrict__ cb,
              const float* __restrict__ states,
              const float* __restrict__ dstates, bf16* __restrict__ dx,
              float* __restrict__ da) {
  extern __shared__ unsigned char raw[];
  unsigned char* X = align1024(raw);
  unsigned char* DY = X + kPanel;
  unsigned char* Bt = DY + kPanel;
  unsigned char* Ct = Bt + kWide;
  unsigned char* HB = Ct + kWide;
  unsigned char* DHB = HB + kPanel;
  unsigned char* SH = DHB + kPanel;        // S^ = C B^T * D, bf16 (t, s)
  float* H32 = reinterpret_cast<float*>(SH);           // states, f32
  float* DH32 = H32 + R * 64;                          // dstates, f32
  Scan& sc = *reinterpret_cast<Scan*>(SH + DxSmem::kUnion);
  float* colp = reinterpret_cast<float*>(&sc + 1);     // 8 x R
  float* rowM = colp + 8 * R;
  float* t1 = rowM + R;
  float* qs = t1 + R;
  float* red = qs + R;                                 // 8
  uint64_t* bar = reinterpret_cast<uint64_t*>(red + 8);

  const int ci = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / (p.H / p.G), wg = warpgroup();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
  const int nkN = p.N / 16, nkP = p.P / 16;
  const long head = static_cast<long>(bb) * p.H + h;
  const long sbase = (head * p.nc + ci) * kStateFloats;
  const Frag f;

  init_bars(bar, 1);
  if (threadIdx.x == 0) {
    const int row = bb * p.S + r0, sb = kStateFloats * 4;
    mbar_expect(bar, 2 * kPanel + 2 * kWide + 2 * sb);
    tma_load_3d(X, tx, bar, 0, h, row);
    tma_load_3d(DY, tdy, bar, 0, h, row);
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(Bt + c * kPanel, tb, bar, 64 * c, g, row);
      tma_load_3d(Ct + c * kPanel, tcm, bar, 64 * c, g, row);
    }
    bulk_load(H32, states + sbase, sb, bar);
    bulk_load(DH32, dstates + sbase, sb, bar);
  }
  if (threadIdx.x < 32) {
    float av[4];
    load_a(av, a, (static_cast<long>(bb) * p.S + r0) * p.H + h, p.H, nrows);
    chunk_scan(sc, av, nrows);
  }
  float cbr[64];
  load_frag<16>(cbr, cb + ((static_cast<long>(bb) * p.nc + ci) * p.G + g) *
                             R * R, wg);
  mbar_wait(bar, 0);
  // h and dh' as bf16 tiles (n, q), zero padded; <dh', h> in f32
  float dot = warp_sum(frag_to_tile<true>(HB, H32, DHB, DH32));
  if (lane == 0) red[warp] = dot;
  wgmma::fence_proxy();
  __syncthreads();                         // HB, DHB, scan; f32 states read

  // dP = dy x^T (rows t), C h (rows t)
  float dP[64], acc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dP[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma::fence_operand(dP);
  wgmma::fence_operand(acc);
  wgmma::fence();
  for (int kk = 0; kk < nkP; ++kk)
    wgmma::wgmma_ss_acc<0, 0>(dP, wgmma::kmajor<R>(DY, 64 * wg, kk),
                              wgmma::kmajor<R>(X, 0, kk));
  for (int kk = 0; kk < nkN; ++kk)
    wgmma::wgmma_ss_acc<0, 1>(acc, wgmma::kmajor<R>(Ct, 64 * wg, kk),
                              wgmma::mnmajor<R>(HB, kk));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(dP);
  wgmma::fence_operand(acc);

  // t1[t] = exp(A_t) dy_t . (C h)_t
  {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = 64 * wg + f.r(i);
      rs[(i / 2) % 2] = fmaf(ld_bf(DY, t, f.c(i)), acc[i], rs[(i / 2) % 2]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = rs[hf];
      v += __shfl_xor_sync(kAll, v, 1);
      v += __shfl_xor_sync(kAll, v, 2);
      const int t = 64 * wg + f.row + 8 * hf;
      if (lane % 4 == 0) t1[t] = sc.eA[t] * v;
    }
  }
  // S^ = C B^T * D into shared memory; G = dP * D; M = C B^T * G: its
  // row sums, and its column sums per warp
  {
    float rs[2] = {0.f, 0.f}, cs[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) cs[j] = 0.f;
    auto sg = [&](auto w) {
      constexpr int W = decltype(w)::value;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int t = 64 * W + f.r(i), s = f.c(i);
        if (upper<W, true>(i)) {
          st_bf2(SH, t, s, 0.f, 0.f);
          continue;
        }
        const float d0 = dmat<W, true>(sc, t, s, i, nrows);
        const float d1 = dmat<W, true>(sc, t, s + 1, i + 1, nrows);
        const float m0 = cbr[i] * (dP[i] * d0);
        const float m1 = cbr[i + 1] * (dP[i + 1] * d1);
        rs[(i / 2) % 2] += m0 + m1;
        cs[2 * (i / 4)] += m0;
        cs[2 * (i / 4) + 1] += m1;
        st_bf2(SH, t, s, cbr[i] * d0, cbr[i + 1] * d1);
      }
    };
    if (wg == 0) sg(WG<0>{}); else sg(WG<1>{});
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = rs[hf];
      v += __shfl_xor_sync(kAll, v, 1);
      v += __shfl_xor_sync(kAll, v, 2);
      if (lane % 4 == 0) rowM[64 * wg + f.row + 8 * hf] = v;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v = cs[j];
      v += __shfl_xor_sync(kAll, v, 4);
      v += __shfl_xor_sync(kAll, v, 8);
      v += __shfl_xor_sync(kAll, v, 16);
      if (lane < 4) colp[warp * R + 8 * (j / 2) + 2 * lane + j % 2] = v;
    }
  }
  wgmma::fence_proxy();
  __syncthreads();                         // S^ whole

  // dx = w (B dh') + S^T dy (rows s); q_s = x_s . w_s (B dh')_s
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma::fence_operand(acc);
  wgmma::fence();
  for (int kk = 0; kk < nkN; ++kk)
    wgmma::wgmma_ss_acc<0, 1>(acc, wgmma::kmajor<R>(Bt, 64 * wg, kk),
                              wgmma::mnmajor<R>(DHB, kk));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int s = 64 * wg + f.r(i);
      acc[i] *= sc.w[s];
      rs[(i / 2) % 2] = fmaf(ld_bf(X, s, f.c(i)), acc[i], rs[(i / 2) % 2]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = rs[hf];
      v += __shfl_xor_sync(kAll, v, 1);
      v += __shfl_xor_sync(kAll, v, 2);
      if (lane % 4 == 0) qs[64 * wg + f.row + 8 * hf] = v;
    }
  }
  wgmma::fence_operand(acc);
  wgmma::fence();
  for (int kk = 4 * wg; kk < 8; ++kk)      // rows s >= 64: rows t >= 64
    wgmma::wgmma_ss_acc<1, 1>(acc, wgmma::mnmajor<R>(SH + wg * kPanel, kk),
                              wgmma::mnmajor<R>(DY, kk));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  __syncthreads();                         // S^ read; q, t1, sums whole
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    st_bf2(SH, 64 * wg + f.r(i), f.c(i), acc[i], acc[i + 1]);
  wg_sync(wg);
  store_rows(dx + ((static_cast<long>(bb) * p.S + r0) * p.H + h) * p.P,
             static_cast<long>(p.H) * p.P, SH, 64 * wg, nrows, p.P);

  // dA_t = rowM - colM + t1 - q (+ sum q + exp(A_L) <dh', h> on the last
  // valid row); da = its reverse cumsum over the chunk (warp 0)
  if (warp == 0) {
    float v[4], qsum = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = R - 1 - (4 * lane + k);
      float col = 0.f;
#pragma unroll
      for (int wi = 0; wi < 8; ++wi) col += colp[wi * R + t];
      v[k] = rowM[t] - col + t1[t] - qs[t];
      qsum += qs[t];
    }
    qsum = warp_sum(qsum);
    float dsum = 0.f;
#pragma unroll
    for (int wi = 0; wi < 8; ++wi) dsum += red[wi];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (R - 1 - (4 * lane + k) == nrows - 1)
        v[k] += qsum + sc.eA[nrows - 1] * dsum;
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += v[k];
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += u;
    }
    const float excl = incl - run;
    float* dab = da + (static_cast<long>(bb) * p.S + r0) * p.H + h;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = R - 1 - (4 * lane + k);
      if (t < nrows) dab[static_cast<long>(t) * p.H] = excl + v[k];
    }
  }
}

// ---------------------------------------------------------------------
// backward 3: dC and dB of every (chunk, group), summed over the group's
// heads in order
// ---------------------------------------------------------------------
struct DbcSmem {
  static constexpr int kStage = 2 * kPanel;     // U, V
  static constexpr size_t bytes = 1024 + 2 * kStage + kStateFloats * 4 +
                                  kWide + 2 * kPanel + sizeof(Scan) + 4 * 8;
};

// kMode 0: dC (rows t): U = dy, V = x, row factor exp(A), state h, F = B.
// kMode 1: dB (rows s): U = x, V = dy, row factor w, state dh', F = C.
template <int kMode>
__device__ __forceinline__ void dbc_body(
    const Shape& p, const CUtensorMap& tu, const CUtensorMap& tv,
    const CUtensorMap& tf, const float* __restrict__ a,
    const float* __restrict__ st32, bf16* __restrict__ out,
    unsigned char* base) {
  unsigned char* ring = base;
  float* S32 = reinterpret_cast<float*>(ring + 2 * DbcSmem::kStage);
  unsigned char* Ft = ring + 2 * DbcSmem::kStage + kStateFloats * 4;
  unsigned char* US = Ft + kWide;          // row factor * U, bf16
  unsigned char* ST = US + kPanel;         // state, bf16 (n, q)
  Scan& sc = *reinterpret_cast<Scan*>(ST + kPanel);
  uint64_t* bars = reinterpret_cast<uint64_t*>(&sc + 1);  // U V x2, F, S32

  const int ci = blockIdx.x, g = blockIdx.y / 2, bb = blockIdx.z;
  const int rep = p.H / p.G, wg = warpgroup();
  const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
  const int row = bb * p.S + r0, sb = kStateFloats * 4;
  const int nkP = p.P / 16;
  const Frag f;

  auto U = [&](int st) { return ring + st * DbcSmem::kStage; };
  auto V = [&](int st) { return U(st) + kPanel; };
  auto sbase = [&](int h) {
    return ((static_cast<long>(bb) * p.H + h) * p.nc + ci) * kStateFloats;
  };
  auto fetch = [&](int j) {
    const int st = j % 2, h = g * rep + j;
    mbar_expect(&bars[st], 2 * kPanel);
    tma_load_3d(U(st), tu, &bars[st], 0, h, row);
    tma_load_3d(V(st), tv, &bars[st], 0, h, row);
  };
  auto fetch_state = [&](int j) {
    mbar_expect(&bars[3], sb);
    bulk_load(S32, st32 + sbase(g * rep + j), sb, &bars[3]);
  };
  init_bars(bars, 4);
  if (threadIdx.x == 0) {
    mbar_expect(&bars[2], kWide);
    for (int c = 0; c < 2; ++c)
      tma_load_3d(Ft + c * kPanel, tf, &bars[2], 64 * c, g, row);
    fetch_state(0);
    fetch(0);
    if (rep > 1) fetch(1);
  }
  float acc[64], gsum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = gsum[i] = 0.f;
  float av[4];
  const bool scanner = threadIdx.x < 32;
  auto a_base = [&](int h) {
    return (static_cast<long>(bb) * p.S + r0) * p.H + h;
  };
  if (scanner) load_a(av, a, a_base(g * rep), p.H, nrows);

  for (int j = 0; j < rep; ++j) {
    const int st = j % 2;
    if (scanner) {
      chunk_scan(sc, av, nrows);
      if (j + 1 < rep) load_a(av, a, a_base(g * rep + j + 1), p.H, nrows);
    }
    mbar_wait(&bars[3], j & 1);
    frag_to_tile<false>(ST, S32);
    __syncthreads();                       // the scan; S32 is read
    if (threadIdx.x == 0 && j + 1 < rep) fetch_state(j + 1);
    mbar_wait(&bars[st], (j / 2) & 1);
    scale_rows(US, U(st), kMode == 0 ? sc.eA : sc.w, 64 * wg);
    wgmma::fence_proxy();
    __syncthreads();                       // ST, US whole

    float dP[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dP[i] = 0.f;
    wgmma::fence_operand(dP);
    wgmma::fence_operand(acc);
    wgmma::fence();
    for (int kk = 0; kk < nkP; ++kk)
      wgmma::wgmma_ss_acc<0, 0>(dP, wgmma::kmajor<R>(U(st), 64 * wg, kk),
                                wgmma::kmajor<R>(V(st), 0, kk));
    wgmma::commit();
    for (int kk = 0; kk < nkP; ++kk)
      wgmma::wgmma_ss_acc<0, 0>(acc, wgmma::kmajor<R>(US, 64 * wg, kk),
                                wgmma::kmajor<R>(ST, 0, kk));
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operand(dP);
    auto gs = [&](auto w) {
      constexpr int W = decltype(w)::value;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (!upper<W, kMode == 0>(i))
          gsum[i] = fmaf(dP[i],
                         dmat<W, kMode == 0>(sc, 64 * W + f.r(i), f.c(i), i,
                                             nrows),
                         gsum[i]);
    };
    if (wg == 0) gs(WG<0>{}); else gs(WG<1>{});
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    __syncthreads();                       // US, ST, stage st are read
    if (threadIdx.x == 0 && j + 2 < rep) fetch(j + 2);
  }

  // + (sum over heads of G) F, the head sum in registers
  uint32_t fr[8][4];
  wgmma::to_frags(gsum, fr);
  mbar_wait(&bars[2], 0);
  wgmma::fence();
  // the upper block of the head sum is 0: dC rows t < 64 stop at s = 64,
  // dB rows s >= 64 start at t = 64
  const bool lo = kMode == 0 || wg == 0, hi = kMode == 1 || wg == 1;
  if (lo) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::wgmma_rs_acc<1>(acc, fr[kk], wgmma::mnmajor<R>(Ft, kk));
  }
  if (hi) {
#pragma unroll
    for (int kk = 4; kk < 8; ++kk)
      wgmma::wgmma_rs_acc<1>(acc, fr[kk], wgmma::mnmajor<R>(Ft, kk));
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  const long ld = static_cast<long>(p.G) * p.N;
  bf16* o = out + static_cast<long>(row) * ld + static_cast<long>(g) * p.N;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = 64 * wg + f.r(i), n = f.c(i);
    if (r < nrows && n < p.N)
      *reinterpret_cast<__nv_bfloat162*>(o + r * ld + n) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

__global__ void __launch_bounds__(kT, 1)
ssd_tc_bwd_dbc_kernel(Shape p, const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tdy,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tcm,
               const float* __restrict__ a, const float* __restrict__ states,
               const float* __restrict__ dstates, bf16* __restrict__ db,
               bf16* __restrict__ dc) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  if (blockIdx.y % 2 == 0)
    dbc_body<0>(p, tdy, tx, tb, a, states, dc, base);
  else
    dbc_body<1>(p, tx, tdy, tcm, a, dstates, db, base);
}

// A TMA map of a contiguous bf16 tensor (rows, d1, d0) as 3-D (d0, d1,
// rows), read in boxes of 64 x 1 x 128, 128-byte swizzled: the 128 rows
// of one chunk of one head (or group), a 64-column panel; elements past
// the bounds read 0.
cudaError_t map_rows(CUtensorMap* map, const void* base, int d0, int d1,
                     long rows) {
  EncodeTiled encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * 2};
  const cuuint32_t box[3] = {64, 1, R};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool valid(const Shape& p, const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
      return false;
  return p.B > 0 && p.S > 0 && p.H > 0 && p.G > 0 && p.H % p.G == 0 &&
         p.N > 0 && p.N <= R && p.N % 16 == 0 && p.P > 0 && p.P <= 64 &&
         p.P % 16 == 0 && p.L > 0 && p.L <= R &&
         p.nc == (p.S + p.L - 1) / p.L;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = e == cudaSuccess;
  return e;
}

// The forward's two launches (see ssd_scan_tc_fwd).
cudaError_t fwd(const void* x, const void* a, const void* b, const void* c,
                void* y, void* hT, void* states, void* cb, const Shape& p,
                cudaStream_t s) {
  const long rows = static_cast<long>(p.B) * p.S;
  CUtensorMap tx, tb, tcm;
  cudaError_t e = map_rows(&tx, x, p.P, p.H, rows);
  if (e == cudaSuccess) e = map_rows(&tb, b, p.N, p.G, rows);
  if (e == cudaSuccess) e = map_rows(&tcm, c, p.N, p.G, rows);
  static bool cb_set = false, fwd_set = false;
  constexpr size_t kCbSmem = 1024 + 2 * kWide + 8;
  if (e == cudaSuccess) e = set_smem(ssd_tc_cb_kernel, kCbSmem, cb_set);
  if (e == cudaSuccess)
    e = set_smem(ssd_tc_fwd_kernel, FwdSmem::bytes, fwd_set);
  if (e != cudaSuccess) return e;
  ssd_tc_cb_kernel<<<dim3(p.nc, p.G, p.B), kT, kCbSmem, s>>>(
      p, tb, tcm, static_cast<float*>(cb));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_tc_fwd_kernel<<<dim3(p.H, p.B), kT, FwdSmem::bytes, s>>>(
      p, tx, tb, tcm, static_cast<const float*>(a),
      static_cast<const float*>(cb), static_cast<bf16*>(y),
      static_cast<float*>(hT), static_cast<float*>(states));
  return cudaGetLastError();
}

// The backward's three launches (see ssd_scan_tc_bwd).
cudaError_t bwd(const void* x, const void* a, const void* b, const void* c,
                const void* states, const void* cb, const void* dy,
                const void* dhT, void* dstates, void* dx, void* da, void* db,
                void* dc, const Shape& p, cudaStream_t s) {
  const long rows = static_cast<long>(p.B) * p.S;
  CUtensorMap tx, tdy, tb, tcm;
  cudaError_t e = map_rows(&tx, x, p.P, p.H, rows);
  if (e == cudaSuccess) e = map_rows(&tdy, dy, p.P, p.H, rows);
  if (e == cudaSuccess) e = map_rows(&tb, b, p.N, p.G, rows);
  if (e == cudaSuccess) e = map_rows(&tcm, c, p.N, p.G, rows);
  static bool st_set = false, dx_set = false, dbc_set = false;
  if (e == cudaSuccess)
    e = set_smem(ssd_tc_bwd_state_kernel, StateSmem::bytes, st_set);
  if (e == cudaSuccess)
    e = set_smem(ssd_tc_bwd_dx_kernel, DxSmem::bytes, dx_set);
  if (e == cudaSuccess)
    e = set_smem(ssd_tc_bwd_dbc_kernel, DbcSmem::bytes, dbc_set);
  if (e != cudaSuccess) return e;
  const float* af = static_cast<const float*>(a);
  const float* sf = static_cast<const float*>(states);
  ssd_tc_bwd_state_kernel<<<dim3(p.H, p.B), kT, StateSmem::bytes, s>>>(
      p, tdy, tcm, af, static_cast<const float*>(dhT),
      static_cast<float*>(dstates));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_tc_bwd_dx_kernel<<<dim3(p.nc, p.H, p.B), kT, DxSmem::bytes, s>>>(
      p, tx, tdy, tb, tcm, af, static_cast<const float*>(cb), sf,
      static_cast<const float*>(dstates), static_cast<bf16*>(dx),
      static_cast<float*>(da));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_tc_bwd_dbc_kernel<<<dim3(p.nc, 2 * p.G, p.B), kT, DbcSmem::bytes, s>>>(
      p, tx, tdy, tb, tcm, af, sf, static_cast<const float*>(dstates),
      static_cast<bf16*>(db), static_cast<bf16*>(dc));
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x (B, S, H, P), b, c (B, S, G, N) of `dtype` (0 = float32, 1 =
// bfloat16); a (B, S, H) f32; y like x; hT (B, H, N, P) f32; states
// (B, H, nc, N, P) f32 with nc = ceil(S / L), or null when no gradient is
// wanted. L = chunk rows (1..64), N <= 128, P <= 64. All contiguous on the
// device. Returns a cudaError_t (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* b,
                            const void* c, void* y, void* hT, void* states,
                            int B, int S, int H, int G, int N, int P, int L,
                            int dtype, void* stream) {
  const Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0};
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(fwd<float>(x, a, b, c, y, hT, states, p, s));
    case 1:
      return static_cast<int>(fwd<bf16>(x, a, b, c, y, hT, states, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The gradients of ssd_scan_fwd: dy like x, dhT (B, H, N, P) f32 or null
// (zero); `states` from the forward; dstates (B, H, nc, N, P) f32 scratch;
// dx like x, da like a, db and dc like b. Two launches.
extern "C" int ssd_scan_bwd(const void* x, const void* a, const void* b,
                            const void* c, const void* states,
                            const void* dy, const void* dhT, void* dstates,
                            void* dx, void* da, void* db, void* dc, int B,
                            int S, int H, int G, int N, int P, int L,
                            int dtype, void* stream) {
  const Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0};
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(bwd<float>(x, a, b, c, states, dy, dhT,
                                         dstates, dx, da, db, dc, p, s));
    case 1:
      return static_cast<int>(bwd<bf16>(x, a, b, c, states, dy, dhT,
                                        dstates, dx, da, db, dc, p, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The tensor-core route: bf16 x, b, c with N and P multiples of 16 (N <=
// 128, P <= 64), 16-byte aligned, chunk rows L <= 128. Shapes as for
// ssd_scan_fwd, but `states` (or null when no gradient is wanted) holds
// each chunk's start state as a zero-padded 128 x 64 tile in fragment
// order, (B, H, nc, 128 * 64) f32, and cb (B, nc, G, 128 * 128) f32
// receives C B^T of every chunk and group, also in fragment order (the
// backward reads both). Two launches.
extern "C" int ssd_scan_tc_fwd(const void* x, const void* a, const void* b,
                               const void* c, void* y, void* hT,
                               void* states, void* cb, int B, int S, int H,
                               int G, int N, int P, int L, void* stream) {
  const tc::Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0};
  const void* ptrs[] = {x, b, c, y, states, cb};
  if (!tc::valid(p, ptrs, 6)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::fwd(x, a, b, c, y, hT, states, cb, p,
                                  static_cast<cudaStream_t>(stream)));
}

// The gradients of ssd_scan_tc_fwd: states and cb from it, dy like x, dhT
// (B, H, N, P) f32 or null (zero), dstates scratch like states; dx like
// x, da like a, db and dc like b. Three launches.
extern "C" int ssd_scan_tc_bwd(const void* x, const void* a, const void* b,
                               const void* c, const void* states,
                               const void* cb, const void* dy,
                               const void* dhT, void* dstates, void* dx,
                               void* da, void* db, void* dc, int B, int S,
                               int H, int G, int N, int P, int L,
                               void* stream) {
  const tc::Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0};
  const void* ptrs[] = {x, b, c, states, cb, dy, dstates, dx, db, dc};
  if (!tc::valid(p, ptrs, 10) || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::bwd(x, a, b, c, states, cb, dy, dhT, dstates,
                                  dx, da, db, dc, p,
                                  static_cast<cudaStream_t>(stream)));
}
