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
// in f32 (the mask is applied before the exp, so the upper triangle never
// overflows). Layouts are the JAX package's: x, y (B, S, H, P); a (B, S, H)
// f32; b, c (B, S, G, N); final state (B, H, N, P) f32; all contiguous.
//
// What bounds it: at the training path's shape (B 2, S 4096, H 64, P 64,
// G 1, N 128) a forward call moves ~145 MB and does ~30 GFLOP of f32 FMAs
// (64-row chunks): operations-bound on the CUDA cores (no TF32: the TPU
// kernel computes in f32), about 0.45 ms at 67 TFLOP/s.
//
// Design (a simple first kernel; tensor cores and sharing C.B^T between
// the heads of a group are later work):
//  * chunks of L = min(chunk, 64) rows. At L = 128 the f32 working set of
//    one head (x, B, C, the L x L scores, the N x P state) is 256 KB, above
//    the 227 KB a block may have, so the kernel takes a 128-row chunk in
//    64-row halves: the same scan (the dual form is exact for any chunk
//    length), with half the quadratic work;
//  * forward: one block of 8 warps per (head, batch) walks the chunks in
//    order; the N x P f32 state stays on chip (in registers, each thread
//    owning 16 x 2 elements, mirrored in shared memory for C.h) from one
//    chunk to the next: the loop takes the place of the TPU's sequential
//    chunk axis. Each chunk: load x, B, C (converted to f32) and a; the
//    inclusive cumsum of a by one warp; S = (C B^T) masked and decayed;
//    y = exp(A) (C h) + S x; the state update. When a gradient is wanted,
//    the state at each chunk's start is written to `states`
//    (B, H, nc, N, P) f32 for the backward;
//  * backward, two launches:
//      1. one block per (head, batch) walks the chunks in reverse,
//         carrying dh (N x P f32, from the final state's gradient):
//         dh <- exp(A_L) dh + sum_t exp(A_t) C_t (x) dy_t, writing the
//         gradient of each chunk's end state to `dstates`;
//      2. one block per (chunk, group, batch) — chunks independent now —
//         computes C B^T once and loops over the heads of the group:
//         dP = dy x^T; with D = mask * exp(A_t - A_s), S^ = C B^T * D and
//         G = dP * D; dx = S^T dy + w (B dh'), w_s = exp(A_L - A_s);
//         dC += G B + exp(A) (dy h^T); dB += G^T C + w (x dh'^T); dA from
//         M = C B^T * G (row sums minus column sums) and the exp terms;
//         da = the reverse cumsum of dA. dB and dC sum over the group's
//         heads in registers, in head order: no atomics, the same bits
//         every run;
//  * widths: N <= 128 and P <= 64 run in zero-padded 128 / 64 tiles; rows
//    past the chunk's end or past S load as 0 (a = 0) and are never
//    stored, so any S runs. Shared-memory rows have odd strides in floats,
//    so the column reads across a warp hit 32 banks. f32 FMAs throughout;
//    bf16 inputs are widened on load and outputs rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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
