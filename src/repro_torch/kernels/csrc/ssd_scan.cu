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
// In f32 (64-row chunks) the products bound it: 23.7 GFLOP a forward and
// 47.4 a backward, 0.144 and 0.288 ms at 3xTF32's 165 TFLOP/s.
//
// Three routes, chosen by the wrapper:
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
//  * The 3xTF32 route (namespace t3): every f32 call, any N <= 128 and P <=
//    64, chunks of min(L, 64) rows. Each f32 operand is split into big =
//    tf32(x) and small = tf32(x - big), and each product runs as three
//    TF32 wgmma products into f32 accumulators in registers
//    (wgmma_tf32.cuh); one TF32 product alone misses the SSD tolerance by
//    3-13x (tests/test_torch_ssd_tf32.py). tf32 operands in shared memory
//    must be K-major (wgmma transposes only 16-bit types and TMA no 4-byte
//    element), so the products are laid out for it: the state is held as
//    h^T (P x N, rows q) and y = exp(A) (C h) + S x takes C (t, n) and
//    h^T (q, n) as stored, while x and B, read with the chunk's rows as
//    depth, are transposed by the warpgroup that splits them; the decayed
//    scores S go into their product as register A fragments, x^T's depth
//    permuted by perm8 to match (the state update reads the same x^T
//    tile as its A, so both of its operands carry the permutation).
//    - Shared memory: f32 halves take 4x a bf16 tile, so 128-row chunks do
//      not fit. At 64 rows the forward holds C (64 x 128), h^T (64 x 128),
//      x^T (64 x 64) and (w B)^T (128 x 64), both halves: 224 KB of the
//      227, one buffer each. 64-row chunks double the saved states against
//      128 (273 MB at the mamba2 shape with the final one; the FMA route
//      kept 268) and the steps of the serial walk. C B^T therefore comes from a first launch
//      (with B C^T for the backward: `cb`, 4.2 MB at that shape), and the
//      walk's producer warpgroup refills C while the consumer runs the
//      state update, and x and B while it runs C h.
//    - Summation: the tensor cores' accumulation truncates, so no sum runs
//      across chunks or heads in one: each product's full depth (at most
//      128) runs from zero, and the carried state, the carried gradient
//      and the head sums of dB and dC add each chunk's or head's product
//      in f32 registers in a fixed order. No atomics: the bits repeat.
//    - Forward: the cb launch, then one block per (head, batch) walking the
//      chunks: warpgroup 0 runs the products with h^T in registers
//      (y = exp(A) (C h^T-tile) + (cb * D) x^T-tile, h^T <- exp(A_L) h^T +
//      x^T (w B)), writing h^T's split tile for the next chunk and the
//      state at each chunk's start (and, last, the final one) to
//      `states`; warpgroup 1 loads the next chunk into registers while
//      the current one is in use and splits and stores it as its buffers
//      free.
//    - Backward, three launches: (1) the carried gradient walk in reverse,
//      dh^T <- exp(A_L) dh^T + (exp(A) dy)^T C through a two-stage ring,
//      writing `dstates` and each chunk's <dh', h'> (h' the state after
//      the chunk, the next saved one) into da's last row of the chunk;
//      (2) dx and da of every (chunk, head): dx = w (B dh') + (B C^T *
//      D^T) dy, and, since dy . y = rowM + t1 and x . dx = colM + q, dA_t
//      = dy_t . y_t - x_t . dx_t plus <dh', h'> on the last row,
//      reverse-cumsummed: no C h, no dy x^T (y is saved by the wrapper
//      for this route); (3) dC and dB as the tc route's third launch,
//      per head dy x^T (or x dy^T) into the head sum of G and (exp(A) dy)
//      h (or (w x) dh') into the f32 sum, then (sum of G) B (or its
//      transpose with C) from registers. Its tiles (192 KB) leave room for
//      one buffer, so the producer's stores of a head and the products
//      of the last take turns (a block per half of N with a two-stage
//      ring, which does overlap them, took 1.06 ms against 0.67 at the
//      mamba2 shape: it splits dy and x and computes dy x^T twice).
//
//  * The FMA route (the first design, kept only for bf16 widths that the
//    tensor-core route does not take: N or P not multiples of 16, or
//    unaligned tensors; no path has such a shape): CUDA-core f32 FMAs on
//    tiles staged as float (bf16 widened on load, outputs rounded once), in
//    chunks of min(L, 64) rows. Forward: one block of 8 warps per
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
#include "wgmma_tf32.cuh"

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

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
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

// ---------------------------------------------------------------------
// The f32 route: 3xTF32 on wgmma (wgmma_tf32.cuh)
// ---------------------------------------------------------------------
namespace t3 {

using namespace sm90;
namespace tf = wgmma::tf32;
using tc::Frag;
using tc::load_frag;
using tc::store_frag;

constexpr int kT = 256;                    // two warpgroups
constexpr int R = 64;                      // chunk rows (tile)
constexpr int NT = 128;                    // state width N, padded
constexpr int PT = 64;                     // head dim P, padded
constexpr int kRN = R * NT * 4;            // one half of a 64 x 128 tile
constexpr int kRP = R * PT * 4;            // one half of a 64 x 64 tile
constexpr int kStateFloats = PT * NT;      // h^T (P x N), fragment order
constexpr int kCbFloats = 2 * R * R;       // C B^T, then B C^T
constexpr unsigned kAll = 0xffffffffu;

struct Shape {
  int B, S, H, G, N, P, L, nc;
  bool vec;                                // 16-byte rows and pointers
};

// A row-major f32 source (row r at p + r * ld): 4 consecutive columns
// c .. c + 3 of row r, 0 past `rows` rows and `cols` columns; one 16-byte
// load where vec (rows of whole 16-byte chunks, aligned), else element
// by element.
struct Src {
  const float* p;
  long ld;
  int rows, cols;
  bool vec;
  __device__ __forceinline__ float4 at(int r, int c) const {
    if (r >= rows || c >= cols) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* e = p + r * ld + c;
    if (vec) return __ldg(reinterpret_cast<const float4*>(e));
    return make_float4(e[0], c + 1 < cols ? e[1] : 0.f,
                       c + 2 < cols ? e[2] : 0.f, c + 3 < cols ? e[3] : 0.f);
  }
};

// Lane l of a warp: a of rows 2l and 2l + 1 of a chunk (a of row t at
// a[t * H]; rows >= nrows read 0).
__device__ __forceinline__ float2 a_pair(const float* a, int H, int nrows) {
  const int l = threadIdx.x % 32;
  return make_float2(
      2 * l < nrows ? __ldg(a + static_cast<long>(2 * l) * H) : 0.f,
      2 * l + 1 < nrows ? __ldg(a + static_cast<long>(2 * l + 1) * H) : 0.f);
}

// One warp: the inclusive cumsum of a over a chunk's rows, from a_pair's
// values, for rows 2l and 2l + 1 of lane l, and the chunk's total (the
// last valid row's A).
__device__ __forceinline__ void scan64(float2 v, float& c0, float& c1,
                                       float& total) {
  const int l = threadIdx.x % 32;
  const float v0 = v.x, v1 = v.y;
  float s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kAll, s, o);
    if (l >= o) s += u;
  }
  total = __shfl_sync(kAll, s, 31);
  c0 = s - v1;
  c1 = s;
}

// exp(A_t - A_u) for u <= t < nrows, else 0 (masked before the exp)
__device__ __forceinline__ float decay(const float* A, int t, int u,
                                       int nrows) {
  return (u <= t && t < nrows) ? expf(A[t] - A[u]) : 0.f;
}

// Element (r, k) and (r, k + 1) of a K-major f32 tile of ROWS rows (k
// even), split into the big and small tiles: one 8-byte store each.
template <int ROWS>
__device__ __forceinline__ void store_pair(unsigned char* big,
                                           unsigned char* small, int r, int k,
                                           float v0, float v1) {
  uint32_t b0, s0, b1, s1;
  tf::split(v0, b0, s0);
  tf::split(v1, b1, s1);
  const uint32_t o = tf::offset<ROWS>(r, k);
  *reinterpret_cast<uint2*>(big + o) = make_uint2(b0, b1);
  *reinterpret_cast<uint2*>(small + o) = make_uint2(s0, s1);
}

// Element (r, k) of a K-major f32 tile of ROWS rows, split.
template <int ROWS>
__device__ __forceinline__ void store_one(unsigned char* big,
                                          unsigned char* small, int r, int k,
                                          float v) {
  uint32_t bv, sv;
  tf::split(v, bv, sv);
  const uint32_t o = tf::offset<ROWS>(r, k);
  *reinterpret_cast<uint32_t*>(big + o) = bv;
  *reinterpret_cast<uint32_t*>(small + o) = sv;
}

// A state (h^T or dh'^T, P x N) in fragment order -- float4 k of thread t
// at k * 128 + t holds accumulator elements 4k .. 4k + 3 of an m64n128
// fragment: (q0, n0), (q0, n0 + 1), (q0 + 8, n0), (q0 + 8, n0 + 1) with
// q0 = 16 (t / 32) + (t % 32) / 4 and n0 = 8 k + 2 (t % 4) -- into a
// K-major tile: kTrans 0, rows q and depth n; kTrans 1, rows n and depth
// q; j is the float4's index.
template <int kTrans>
__device__ __forceinline__ void state_to_tile(unsigned char* big,
                                              unsigned char* small,
                                              const float4& v, int j) {
  const int k = j / 128, t = j % 128;
  const int q0 = 16 * (t / 32) + (t % 32) / 4, n0 = 8 * k + 2 * (t % 4);
  if (kTrans) {
    store_one<NT>(big, small, n0, q0, v.x);
    store_one<NT>(big, small, n0 + 1, q0, v.y);
    store_one<NT>(big, small, n0, q0 + 8, v.z);
    store_one<NT>(big, small, n0 + 1, q0 + 8, v.w);
  } else {
    store_pair<PT>(big, small, q0, n0, v.x, v.y);
    store_pair<PT>(big, small, q0 + 8, n0, v.z, v.w);
  }
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ long row_of(const Shape& p, int bb, int t) {
  return static_cast<long>(bb) * p.S + t;
}

// ---------------------------------------------------------------------
// C B^T and B C^T of every chunk and group, once: cb (B, nc, G, 2, 64 x
// 64) f32 in fragment order (the forward reads the first, the dx kernel
// the second)
// ---------------------------------------------------------------------
constexpr size_t kCbSmem = 1024 + 4 * kRN;

__global__ void __launch_bounds__(kT, 1)
ssd_t3_cb_kernel(Shape p, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ cb) {
  extern __shared__ unsigned char raw[];
  unsigned char* Cb = align1024(raw);
  unsigned char* Cs = Cb + kRN;
  unsigned char* Bb = Cs + kRN;
  unsigned char* Bs = Bb + kRN;
  const int ci = blockIdx.x, g = blockIdx.y, bb = blockIdx.z;
  const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
  const long ld = static_cast<long>(p.G) * p.N;
  const long off = row_of(p, bb, r0) * ld + static_cast<long>(g) * p.N;
  const Src sc{c + off, ld, nrows, p.N, p.vec};
  const Src sb{b + off, ld, nrows, p.N, p.vec};
  using W = tf::Walk<R, NT, kT>;
#pragma unroll
  for (int j = 0; j < W::kIters; ++j) {
    int r, k;
    W::at(j, r, k);
    tf::store_plain<R>(Cb, Cs, r, k, sc.at(r, k));
    tf::store_plain<R>(Bb, Bs, r, k, sb.at(r, k));
  }
  wgmma::fence_proxy();
  __syncthreads();
  const int wg = tc::warpgroup();
  const unsigned char* Ab = wg ? Bb : Cb;  // wg 0: C B^T, wg 1: B C^T
  const unsigned char* As = wg ? Bs : Cs;
  const unsigned char* Ob = wg ? Cb : Bb;
  const unsigned char* Os = wg ? Cs : Bs;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma::fence_operand(acc);
  wgmma::fence();
  for (int kk = 0; kk < (p.N + 7) / 8; ++kk)
    tf::mma3_ss<64>(acc, tf::kmajor<R>(Ab, 0, kk), tf::kmajor<R>(As, 0, kk),
                    tf::kmajor<R>(Ob, 0, kk), tf::kmajor<R>(Os, 0, kk), 1);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
  store_frag<8>(cb + ((static_cast<long>(bb) * p.nc + ci) * p.G + g) *
                         kCbFloats,
                acc, wg);
}

// ---------------------------------------------------------------------
// forward: one block per (head, batch) walks the chunks; warpgroup 0
// runs the products with the state in registers, warpgroup 1 loads,
// splits and stores the tiles
// ---------------------------------------------------------------------
struct FwdSmem {
  // C (t, n), h^T (q, n), x^T (q, s'), (w B)^T (n, s'): a big and a small
  // half each; s' the chunk's rows permuted by perm8
  static constexpr int kC = 0, kH = 2 * kRN, kX = 4 * kRN;
  static constexpr int kB = 4 * kRN + 2 * kRP;
  static constexpr int kTiles = 6 * kRN + 2 * kRP;     // 224 KB
  // two chunks' A, exp(A) and w (the producer's scan), four barriers
  static constexpr size_t bytes = 1024 + kTiles + sizeof(float) * 6 * R +
                                  4 * sizeof(uint64_t);
};

__global__ void __launch_bounds__(kT, 1)
ssd_t3_fwd_kernel(Shape p, const float* __restrict__ x,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, const float* __restrict__ cb,
                  float* __restrict__ y, float* __restrict__ hT,
                  float* __restrict__ states) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* Cb = base + FwdSmem::kC;
  unsigned char* Cs = Cb + kRN;
  unsigned char* Hb = base + FwdSmem::kH;
  unsigned char* Hs = Hb + kRN;
  unsigned char* Xb = base + FwdSmem::kX;
  unsigned char* Xs = Xb + kRP;
  unsigned char* Bb = base + FwdSmem::kB;
  unsigned char* Bs = Bb + kRN;
  // chunk ci's A, exp(A), w at scans + (ci % 2) * 3 R
  float* scans = reinterpret_cast<float*>(base + FwdSmem::kTiles);
  // full C, full x and B (producer threads), C read, x and B read
  // (consumer warps)
  uint64_t* bar = reinterpret_cast<uint64_t*>(scans + 6 * R);

  const int h = blockIdx.x, bb = blockIdx.y, g = h / (p.H / p.G);
  const int wg = tc::warpgroup();
  const long head = static_cast<long>(bb) * p.H + h;
  const long xs = static_cast<long>(p.H) * p.P;
  const long bs = static_cast<long>(p.G) * p.N;
  const float* xh = x + row_of(p, bb, 0) * xs + static_cast<long>(h) * p.P;
  const float* bg = b + row_of(p, bb, 0) * bs + static_cast<long>(g) * p.N;
  const float* cg = c + row_of(p, bb, 0) * bs + static_cast<long>(g) * p.N;
  const float* ah = a + row_of(p, bb, 0) * p.H + h;

  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 128);
    mbar_init(&bar[1], 128);
    mbar_init(&bar[2], 4);
    mbar_init(&bar[3], 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {                           // the producer
    using WC = tf::Walk<R, NT, 128>;
    using WX = tf::Walk<R, PT, 128>;
    float4 vc[WC::kIters], vb[WC::kIters], vx[WX::kIters];
    auto rows = [&](int ci) { return min(p.L, p.S - ci * p.L); };
    auto fetch_c = [&](int ci) {
      const long r0 = static_cast<long>(ci) * p.L;
      const Src s{cg + r0 * bs, bs, rows(ci), p.N, p.vec};
#pragma unroll
      for (int j = 0; j < WC::kIters; ++j) {
        int r, k;
        WC::at(j, r, k);
        vc[j] = s.at(r, k);
      }
    };
    auto fetch_xb = [&](int ci) {
      const long r0 = static_cast<long>(ci) * p.L;
      const Src sb{bg + r0 * bs, bs, rows(ci), p.N, p.vec};
      const Src sx{xh + r0 * xs, xs, rows(ci), p.P, p.vec};
#pragma unroll
      for (int j = 0; j < WC::kIters; ++j) {
        int r, k;
        WC::at(j, r, k);
        vb[j] = sb.at(r, k);
      }
#pragma unroll
      for (int j = 0; j < WX::kIters; ++j) {
        int r, k;
        WX::at(j, r, k);
        vx[j] = sx.at(r, k);
      }
    };
    const bool scanner = threadIdx.x < 128 + 32;
    float2 av = make_float2(0.f, 0.f);    // a of the next chunk to scan
    auto fetch_a = [&](int ci) {
      if (scanner)
        av = a_pair(ah + static_cast<long>(ci) * p.L * p.H, p.H, rows(ci));
    };
    fetch_c(0);
    fetch_xb(0);
    fetch_a(0);
    for (int ci = 0; ci < p.nc; ++ci) {
      const int nrows = rows(ci);
      // the chunk's scan, for both warpgroups (the consumer reads it once
      // C is full; it was done with this buffer before releasing x and B
      // two chunks ago)
      float* As = scans + (ci % 2) * 3 * R;
      float* eA = As + R;
      float* w = eA + R;
      if (scanner) {
        const int l = threadIdx.x % 32;
        float c[2], tot;
        scan64(av, c[0], c[1], tot);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = 2 * l + u;
          As[t] = c[u];
          eA[t] = t < nrows ? expf(c[u]) : 0.f;
          w[t] = t < nrows ? expf(tot - c[u]) : 0.f;
        }
      }
      if (ci > 0) mbar_wait(&bar[2], (ci - 1) & 1);
#pragma unroll
      for (int j = 0; j < WC::kIters; ++j) {
        int r, k;
        WC::at(j, r, k);
        tf::store_plain<R>(Cb, Cs, r, k, vc[j]);
      }
      wgmma::fence_proxy();
      mbar_arrive(&bar[0]);
      if (ci + 1 < p.nc) fetch_c(ci + 1);
      producer_sync();                     // w
      if (ci > 0) mbar_wait(&bar[3], (ci - 1) & 1);
#pragma unroll
      for (int j = 0; j < WX::kIters; ++j) {
        int r, k;
        WX::at(j, r, k);
        tf::store_trans<PT, true>(Xb, Xs, k, r, vx[j]);
      }
#pragma unroll
      for (int j = 0; j < WC::kIters; ++j) {
        int r, k;
        WC::at(j, r, k);
        const float f = w[r];
        const float4 v = make_float4(vb[j].x * f, vb[j].y * f, vb[j].z * f,
                                     vb[j].w * f);
        tf::store_trans<NT, true>(Bb, Bs, k, r, v);
      }
      wgmma::fence_proxy();
      mbar_arrive(&bar[1]);
      if (ci + 1 < p.nc) {
        fetch_xb(ci + 1);
        fetch_a(ci + 1);
      }
    }
    return;
  }

  const Frag f;
  const int lane = threadIdx.x % 32;
  const int nkN = (p.N + 7) / 8;
  float hacc[64];                          // h^T: rows q, columns n
#pragma unroll
  for (int i = 0; i < 64; ++i) hacc[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * kRN / 16; i += 128)
    reinterpret_cast<uint4*>(Hb)[i] = make_uint4(0, 0, 0, 0);
  wgmma::fence_proxy();
  consumer_sync();

  for (int ci = 0; ci < p.nc; ++ci) {
    const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
    if (states != nullptr)
      store_frag<16>(states + (head * (p.nc + 1) + ci) * kStateFloats, hacc,
                     0);
    float cbr[32];
    load_frag<8>(cbr, cb + ((static_cast<long>(bb) * p.nc + ci) * p.G + g) *
                               kCbFloats, 0);
    mbar_wait(&bar[0], ci & 1);            // C, and the chunk's scan
    const float* As = scans + (ci % 2) * 3 * R;
    const float* eAs = As + R;
    const float eL = eAs[nrows - 1];

    // y = exp(A) (C h) + (C B^T * D) x
    float yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
    wgmma::fence_operand(yacc);
    wgmma::fence();
    for (int kk = 0; kk < nkN; ++kk)
      tf::mma3_ss<64>(yacc, tf::kmajor<R>(Cb, 0, kk),
                      tf::kmajor<R>(Cs, 0, kk), tf::kmajor<PT>(Hb, 0, kk),
                      tf::kmajor<PT>(Hs, 0, kk), 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(yacc);
    if (lane == 0) mbar_arrive(&bar[2]);   // C is read
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = f.r(i);
      yacc[i] *= eAs[t];
      cbr[i] *= decay(As, t, f.c(i), nrows);
    }
    uint32_t fb[8][4], fs[8][4];
    tf::to_frags(cbr, fb, fs);
    mbar_wait(&bar[1], ci & 1);
    wgmma::fence_operand(yacc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tf::mma3_rs<64>(yacc, fb[kk], fs[kk], tf::kmajor<PT>(Xb, 0, kk),
                      tf::kmajor<PT>(Xs, 0, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(yacc);

    // h^T <- exp(A_L) h^T + x^T (w B), the update a product of its own
    float upd[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) upd[i] = 0.f;
    wgmma::fence_operand(upd);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tf::mma3_ss<128>(upd, tf::kmajor<PT>(Xb, 0, kk),
                       tf::kmajor<PT>(Xs, 0, kk), tf::kmajor<NT>(Bb, 0, kk),
                       tf::kmajor<NT>(Bs, 0, kk), 1);
    wgmma::commit();
    // y leaves while the update runs
    float* yr = y + row_of(p, bb, r0) * xs + static_cast<long>(h) * p.P;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = f.r(i), q = f.c(i);
      if (t >= nrows || q >= p.P) continue;
      float* o = yr + t * xs + q;
      if (p.vec) {
        *reinterpret_cast<float2*>(o) = make_float2(yacc[i], yacc[i + 1]);
      } else {
        o[0] = yacc[i];
        if (q + 1 < p.P) o[1] = yacc[i + 1];
      }
    }
    wgmma::wait<0>();
    wgmma::fence_operand(upd);
    if (lane == 0) mbar_arrive(&bar[3]);   // x, B and the scan are read
#pragma unroll
    for (int i = 0; i < 64; ++i) hacc[i] = fmaf(eL, hacc[i], upd[i]);
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      store_pair<PT>(Hb, Hs, f.r(i), f.c(i), hacc[i], hacc[i + 1]);
    wgmma::fence_proxy();
    consumer_sync();                       // h^T's tile, for the next C h
  }
  if (states != nullptr)
    store_frag<16>(states + (head * (p.nc + 1) + p.nc) * kStateFloats, hacc,
                   0);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int q = f.r(i), n = f.c(i);
    if (q < p.P && n < p.N) hT[(head * p.N + n) * p.P + q] = hacc[i];
  }
}

// ---------------------------------------------------------------------
// backward 1: the carried state gradient, chunks in reverse, through a
// two-stage ring; each chunk's <dh', h'> into da's last row of the chunk
// ---------------------------------------------------------------------
struct StateSmem {
  // a stage: (exp(A) dy)^T (q, t) and C^T (n, t), big and small halves
  static constexpr int kStage = 2 * kRP + 2 * kRN;    // 96 KB
  using Ring = tf::Ring<2, 4>;
  // exp(A) of two stages (the producer's), the warps' partial dots
  static constexpr size_t bytes = 1024 + 2 * kStage + sizeof(Ring) +
                                  sizeof(float) * (2 * R + 8);
};

__global__ void __launch_bounds__(kT, 1)
ssd_t3_bwd_state_kernel(Shape p, const float* __restrict__ a,
                        const float* __restrict__ c,
                        const float* __restrict__ dy,
                        const float* __restrict__ dhT,
                        const float* __restrict__ states,
                        float* __restrict__ dstates, float* __restrict__ da) {
  extern __shared__ unsigned char raw[];
  unsigned char* ring_smem = align1024(raw);
  auto& ring = *reinterpret_cast<StateSmem::Ring*>(
      ring_smem + 2 * StateSmem::kStage);
  float* peA = reinterpret_cast<float*>(&ring + 1);   // [2][R]
  float* red = peA + 2 * R;                             // [2][4]
  auto DYb = [&](int st) { return ring_smem + st * StateSmem::kStage; };
  auto DYs = [&](int st) { return DYb(st) + kRP; };
  auto CTb = [&](int st) { return DYb(st) + 2 * kRP; };
  auto CTs = [&](int st) { return CTb(st) + kRN; };

  const int h = blockIdx.x, bb = blockIdx.y, g = h / (p.H / p.G);
  const int wg = tc::warpgroup();
  const long head = static_cast<long>(bb) * p.H + h;
  const long xs = static_cast<long>(p.H) * p.P;
  const long bs = static_cast<long>(p.G) * p.N;
  const float* ah = a + row_of(p, bb, 0) * p.H + h;
  ring.init();

  if (wg == 1) {                           // the producer
    using WC = tf::Walk<R, NT, 128>;
    using WY = tf::Walk<R, PT, 128>;
    const bool scanner = threadIdx.x < 128 + 32;
    float4 vc[WC::kIters], vy[WY::kIters];
    float2 av = make_float2(0.f, 0.f);
    auto fetch = [&](int it) {
      const int ci = p.nc - 1 - it, r0 = ci * p.L;
      const int nrows = min(p.L, p.S - r0);
      const Src sc{c + row_of(p, bb, r0) * bs + static_cast<long>(g) * p.N,
                   bs, nrows, p.N, p.vec};
      const Src sy{dy + row_of(p, bb, r0) * xs + static_cast<long>(h) * p.P,
                   xs, nrows, p.P, p.vec};
#pragma unroll
      for (int j = 0; j < WC::kIters; ++j) {
        int r, k;
        WC::at(j, r, k);
        vc[j] = sc.at(r, k);
      }
#pragma unroll
      for (int j = 0; j < WY::kIters; ++j) {
        int r, k;
        WY::at(j, r, k);
        vy[j] = sy.at(r, k);
      }
      if (scanner) av = a_pair(ah + static_cast<long>(r0) * p.H, p.H, nrows);
    };
    fetch(0);
    for (int it = 0; it < p.nc; ++it) {
      const int ci = p.nc - 1 - it, st = it % 2;
      const int nrows = min(p.L, p.S - ci * p.L);
      float* eA = peA + st * R;
      ring.wait_empty(it);
      if (scanner) {
        const int l = threadIdx.x % 32;
        float c0, c1, tot;
        scan64(av, c0, c1, tot);
        eA[2 * l] = 2 * l < nrows ? expf(c0) : 0.f;
        eA[2 * l + 1] = 2 * l + 1 < nrows ? expf(c1) : 0.f;
      }
      producer_sync();
#pragma unroll
      for (int j = 0; j < WY::kIters; ++j) {
        int r, k;
        WY::at(j, r, k);
        const float e = eA[r];
        const float4 v = make_float4(vy[j].x * e, vy[j].y * e, vy[j].z * e,
                                     vy[j].w * e);
        tf::store_trans<PT, false>(DYb(st), DYs(st), k, r, v);
      }
#pragma unroll
      for (int j = 0; j < WC::kIters; ++j) {
        int r, k;
        WC::at(j, r, k);
        tf::store_trans<NT, false>(CTb(st), CTs(st), k, r, vc[j]);
      }
      ring.filled(&ring.full[st]);
      if (it + 1 < p.nc) fetch(it + 1);
    }
    return;
  }

  const Frag f;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float dh[64];                            // dh^T: rows q, columns n
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int q = f.r(i), n = f.c(i);
    dh[i] = (dhT != nullptr && q < p.P && n < p.N)
                ? dhT[(head * p.N + n) * p.P + q] : 0.f;
  }
  for (int it = 0; it < p.nc; ++it) {
    const int ci = p.nc - 1 - it, st = it % 2;
    const int nrows = min(p.L, p.S - ci * p.L);
    const long sidx = (head * (p.nc + 1) + ci) * kStateFloats;
    store_frag<16>(dstates + sidx, dh, 0);
    // <dh', h'>, h' the state after the chunk (the next chunk's start)
    {
      const float4* hv = reinterpret_cast<const float4*>(
                             states + sidx + kStateFloats) + threadIdx.x;
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float4 v = __ldg(hv + k * 128);
        d += dh[4 * k] * v.x + dh[4 * k + 1] * v.y + dh[4 * k + 2] * v.z +
             dh[4 * k + 3] * v.w;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kAll, d, o);
      if (lane == 0) red[st * 4 + warp] = d;
    }
    ring.wait_full(it);
    consumer_sync();                       // the partial dots
    if (threadIdx.x == 0)
      da[row_of(p, bb, ci * p.L + nrows - 1) * p.H + h] =
          ((red[st * 4] + red[st * 4 + 1]) + red[st * 4 + 2]) +
          red[st * 4 + 3];
    const float eL = peA[st * R + nrows - 1];
    float upd[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) upd[i] = 0.f;
    wgmma::fence_operand(upd);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tf::mma3_ss<128>(upd, tf::kmajor<PT>(DYb(st), 0, kk),
                       tf::kmajor<PT>(DYs(st), 0, kk),
                       tf::kmajor<NT>(CTb(st), 0, kk),
                       tf::kmajor<NT>(CTs(st), 0, kk), 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(upd);
    ring.release(it);
#pragma unroll
    for (int i = 0; i < 64; ++i) dh[i] = fmaf(eL, dh[i], upd[i]);
  }
}

// ---------------------------------------------------------------------
// backward 2: dx and da of every (chunk, head), in parallel
// ---------------------------------------------------------------------
struct DxSmem {
  // B (s, n), dh'^T (q, n), dy^T (q, t'): big and small halves; t' the
  // chunk's rows permuted by perm8
  static constexpr int kB = 0, kDH = 2 * kRN, kDY = 4 * kRN;
  static constexpr int kTiles = 4 * kRN + 2 * kRP;    // 160 KB
  // A, w, dy . y, the two warpgroups' x . dx
  static constexpr size_t bytes = 1024 + kTiles + sizeof(float) * 5 * R;
};

__global__ void __launch_bounds__(kT, 1)
ssd_t3_bwd_dx_kernel(Shape p, const float* __restrict__ x,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ y, const float* __restrict__ cb,
                     const float* __restrict__ dstates,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* __restrict__ da) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* Bb = base + DxSmem::kB;
  unsigned char* Bs = Bb + kRN;
  unsigned char* DHb = base + DxSmem::kDH;
  unsigned char* DHs = DHb + kRN;
  unsigned char* DYb = base + DxSmem::kDY;
  unsigned char* DYs = DYb + kRP;
  float* As = reinterpret_cast<float*>(base + DxSmem::kTiles);
  float* ws = As + R;
  float* dyy = ws + R;
  float* xdx = dyy + R;                    // [2][R]

  const int ci = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / (p.H / p.G), wg = tc::warpgroup();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
  const long head = static_cast<long>(bb) * p.H + h;
  const long xs = static_cast<long>(p.H) * p.P;
  const long bs = static_cast<long>(p.G) * p.N;
  const long xoff = row_of(p, bb, r0) * xs + static_cast<long>(h) * p.P;
  const float* ah = a + row_of(p, bb, r0) * p.H + h;

  // every load of the block in flight at once, then the tiles' stores
  using WB = tf::Walk<R, NT, kT>;
  using WY = tf::Walk<R, PT, kT>;
  constexpr int kDH = kStateFloats / 4 / kT;
  const Src sb{b + row_of(p, bb, r0) * bs + static_cast<long>(g) * p.N, bs,
               nrows, p.N, p.vec};
  const Src sy{dy + xoff, xs, nrows, p.P, p.vec};
  const float4* dst = reinterpret_cast<const float4*>(
      dstates + (head * (p.nc + 1) + ci) * kStateFloats);
  float4 vb[WB::kIters], vy[WY::kIters], vd[kDH];
#pragma unroll
  for (int j = 0; j < WB::kIters; ++j) {
    int r, k;
    WB::at(j, r, k);
    vb[j] = sb.at(r, k);
  }
#pragma unroll
  for (int j = 0; j < WY::kIters; ++j) {
    int r, k;
    WY::at(j, r, k);
    vy[j] = sy.at(r, k);
  }
#pragma unroll
  for (int m = 0; m < kDH; ++m) vd[m] = __ldg(dst + threadIdx.x + kT * m);
  // dy_t . y_t: warp w the rows w, w + 8, ..., lane l columns l, l + 32
  float gv[R / 8][2], yv[R / 8][2];
#pragma unroll
  for (int m = 0; m < R / 8; ++m) {
    const int t = warp + 8 * m;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = lane + 32 * u;
      const bool ok = t < nrows && q < p.P;
      gv[m][u] = ok ? __ldg(dy + xoff + t * xs + q) : 0.f;
      yv[m][u] = ok ? __ldg(y + xoff + t * xs + q) : 0.f;
    }
  }
  if (warp == 0) {
    float c0, c1, tot;
    scan64(a_pair(ah, p.H, nrows), c0, c1, tot);
    As[2 * lane] = c0;
    As[2 * lane + 1] = c1;
    ws[2 * lane] = 2 * lane < nrows ? expf(tot - c0) : 0.f;
    ws[2 * lane + 1] = 2 * lane + 1 < nrows ? expf(tot - c1) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < WB::kIters; ++j) {
    int r, k;
    WB::at(j, r, k);
    tf::store_plain<R>(Bb, Bs, r, k, vb[j]);
  }
#pragma unroll
  for (int j = 0; j < WY::kIters; ++j) {
    int r, k;
    WY::at(j, r, k);
    tf::store_trans<PT, true>(DYb, DYs, k, r, vy[j]);
  }
#pragma unroll
  for (int m = 0; m < kDH; ++m)
    state_to_tile<0>(DHb, DHs, vd[m], threadIdx.x + kT * m);
#pragma unroll
  for (int m = 0; m < R / 8; ++m) {
    float v = gv[m][0] * yv[m][0] + gv[m][1] * yv[m][1];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
    if (lane == 0) dyy[warp + 8 * m] = v;
  }
  wgmma::fence_proxy();
  __syncthreads();

  // dx = w (B dh') + (B C^T * D^T) dy, warpgroup wg the columns q of
  // 32 wg ..
  const Frag f;
  float xv[16];                            // x at the fragment's places
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const int s = f.r(i), q = 32 * wg + f.c(i);
    const long o = xoff + s * xs + q;
    const bool ok = s < nrows && q < p.P;
    if (ok && p.vec) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(x + o));
      xv[i] = v.x;
      xv[i + 1] = v.y;
    } else {
      xv[i] = ok ? __ldg(x + o) : 0.f;
      xv[i + 1] = ok && q + 1 < p.P ? __ldg(x + o + 1) : 0.f;
    }
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  wgmma::fence_operand(acc);
  wgmma::fence();
  for (int kk = 0; kk < (p.N + 7) / 8; ++kk)
    tf::mma3_ss<32>(acc, tf::kmajor<R>(Bb, 0, kk), tf::kmajor<R>(Bs, 0, kk),
                    tf::kmajor<PT>(DHb, 32 * wg, kk),
                    tf::kmajor<PT>(DHs, 32 * wg, kk), 1);
  wgmma::commit();
  float cbr[32];                           // B C^T: rows s, columns t
  load_frag<8>(cbr, cb + ((static_cast<long>(bb) * p.nc + ci) * p.G + g) *
                             kCbFloats, 1);
#pragma unroll
  for (int i = 0; i < 32; ++i) cbr[i] *= decay(As, f.c(i), f.r(i), nrows);
  uint32_t fb[8][4], fs[8][4];
  tf::to_frags(cbr, fb, fs);
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] *= ws[f.r(i)];
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    tf::mma3_rs<32>(acc, fb[kk], fs[kk], tf::kmajor<PT>(DYb, 32 * wg, kk),
                    tf::kmajor<PT>(DYs, 32 * wg, kk));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);

  // dx out; x_s . dx_s
  {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int s = f.r(i), q = 32 * wg + f.c(i);
      rs[(i / 2) % 2] += xv[i] * acc[i] + xv[i + 1] * acc[i + 1];
      if (s >= nrows || q >= p.P) continue;
      float* o = dx + xoff + s * xs + q;
      if (p.vec) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
      } else {
        o[0] = acc[i];
        if (q + 1 < p.P) o[1] = acc[i + 1];
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float v = rs[hf];
      v += __shfl_xor_sync(kAll, v, 1);
      v += __shfl_xor_sync(kAll, v, 2);
      if (lane % 4 == 0) xdx[wg * R + f.row + 8 * hf] = v;
    }
  }
  __syncthreads();

  // dA_t = dy_t . y_t - x_t . dx_t (+ <dh', h'>, which the state kernel
  // left in da, on the last valid row); da = its reverse cumsum (warp 0)
  if (warp == 0) {
    float* dr = da + row_of(p, bb, r0) * p.H + h;
    float v[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = R - 1 - (2 * lane + k);
      v[k] = t < nrows ? dyy[t] - (xdx[t] + xdx[R + t]) : 0.f;
      if (t == nrows - 1) v[k] += dr[static_cast<long>(t) * p.H];
    }
    v[1] += v[0];
    float incl = v[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += u;
    }
    const float excl = incl - v[1];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = R - 1 - (2 * lane + k);
      if (t < nrows) dr[static_cast<long>(t) * p.H] = excl + v[k];
    }
  }
}

// ---------------------------------------------------------------------
// backward 3: dC and dB of every (chunk, group), summed over the group's
// heads in order
// ---------------------------------------------------------------------
struct DbcSmem {
  // F^T (n, r'), once; U (r, q), V (r', q), the state (n, q): big and
  // small halves; r' the chunk's rows permuted by perm8
  static constexpr int kF = 0, kU = 2 * kRN, kV = 2 * kRN + 2 * kRP;
  static constexpr int kS = 2 * kRN + 4 * kRP;
  static constexpr int kTiles = 4 * kRN + 4 * kRP;    // 192 KB
  using Ring = tf::Ring<1, 4>;
  // A and the row factor
  static constexpr size_t bytes =
      1024 + kTiles + sizeof(Ring) + sizeof(float) * 2 * R;
};

// kMode 0: dC (rows t): U = dy, V = x, row factor exp(A), state h, F = B.
// kMode 1: dB (rows s): U = x, V = dy, row factor w, state dh', F = C.
template <int kMode>
__device__ __forceinline__ void dbc_body(
    const Shape& p, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ fsrc, const float* __restrict__ a,
    const float* __restrict__ st32, float* __restrict__ out,
    unsigned char* base) {
  unsigned char* Fb = base + DbcSmem::kF;
  unsigned char* Fs = Fb + kRN;
  unsigned char* Ub = base + DbcSmem::kU;
  unsigned char* Us = Ub + kRP;
  unsigned char* Vb = base + DbcSmem::kV;
  unsigned char* Vs = Vb + kRP;
  unsigned char* Sb = base + DbcSmem::kS;
  unsigned char* Ss = Sb + kRN;
  auto& ring = *reinterpret_cast<DbcSmem::Ring*>(base + DbcSmem::kTiles);
  float* As = reinterpret_cast<float*>(&ring + 1);
  float* rf = As + R;

  const int ci = blockIdx.x, g = blockIdx.y / 2, bb = blockIdx.z;
  const int rep = p.H / p.G, wg = tc::warpgroup();
  const int r0 = ci * p.L, nrows = min(p.L, p.S - r0);
  const long xs = static_cast<long>(p.H) * p.P;
  const long bs = static_cast<long>(p.G) * p.N;
  const long goff = row_of(p, bb, r0) * bs + static_cast<long>(g) * p.N;
  ring.init();

  if (wg == 1) {                           // the producer
    using WF = tf::Walk<R, NT, 128>;
    using WU = tf::Walk<R, PT, 128>;
    constexpr int kSt = kStateFloats / 4 / 128;
    {
      const Src sf{fsrc + goff, bs, nrows, p.N, p.vec};
#pragma unroll 4
      for (int j = 0; j < WF::kIters; ++j) {
        int r, k;
        WF::at(j, r, k);
        tf::store_trans<NT, true>(Fb, Fs, k, r, sf.at(r, k));
      }
      ring.filled(&ring.once);
    }
    const bool scanner = threadIdx.x < 128 + 32;
    float4 vu[WU::kIters], vv[WU::kIters], vs[kSt];
    float2 av = make_float2(0.f, 0.f);
    auto fetch = [&](int j) {
      const int hh = g * rep + j;
      if (scanner) av = a_pair(a + row_of(p, bb, r0) * p.H + hh, p.H, nrows);
      const long off = row_of(p, bb, r0) * xs + static_cast<long>(hh) * p.P;
      const Src su{u + off, xs, nrows, p.P, p.vec};
      const Src sv{v + off, xs, nrows, p.P, p.vec};
#pragma unroll
      for (int i = 0; i < WU::kIters; ++i) {
        int r, k;
        WU::at(i, r, k);
        vu[i] = su.at(r, k);
        vv[i] = sv.at(r, k);
      }
      const float4* sp = reinterpret_cast<const float4*>(
          st32 + ((static_cast<long>(bb) * p.H + hh) * (p.nc + 1) + ci) *
                     kStateFloats);
#pragma unroll
      for (int m = 0; m < kSt; ++m) vs[m] = __ldg(sp + threadIdx.x % 128 +
                                                  128 * m);
    };
    fetch(0);
    for (int j = 0; j < rep; ++j) {
      ring.wait_empty(j);
      if (scanner) {
        const int l = threadIdx.x % 32;
        float c0, c1, tot;
        scan64(av, c0, c1, tot);
        As[2 * l] = c0;
        As[2 * l + 1] = c1;
        const bool ok0 = 2 * l < nrows, ok1 = 2 * l + 1 < nrows;
        rf[2 * l] = ok0 ? expf(kMode == 0 ? c0 : tot - c0) : 0.f;
        rf[2 * l + 1] = ok1 ? expf(kMode == 0 ? c1 : tot - c1) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < WU::kIters; ++i) {
        int r, k;
        WU::at(i, r, k);
        tf::store_plain<R>(Ub, Us, r, k, vu[i]);
        tf::store_plain<R>(Vb, Vs, r, k, vv[i]);
      }
#pragma unroll
      for (int m = 0; m < kSt; ++m)
        state_to_tile<1>(Sb, Ss, vs[m], threadIdx.x % 128 + 128 * m);
      ring.filled(&ring.full[0]);
      if (j + 1 < rep) fetch(j + 1);
    }
    return;
  }

  const Frag f;
  const int nkP = (p.P + 7) / 8;
  float sum[64], gsum[32];                 // rows r; columns n, and r'
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) gsum[i] = 0.f;
  for (int j = 0; j < rep; ++j) {
    ring.wait_full(j);
    float dP[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dP[i] = 0.f;
    wgmma::fence_operand(dP);
    wgmma::fence();
    for (int kk = 0; kk < nkP; ++kk)
      tf::mma3_ss<64>(dP, tf::kmajor<R>(Ub, 0, kk), tf::kmajor<R>(Us, 0, kk),
                      tf::kmajor<R>(Vb, 0, kk), tf::kmajor<R>(Vs, 0, kk), 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(dP);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = f.r(i), c = f.c(i);
      const float d = kMode == 0 ? decay(As, r, c, nrows)
                                 : decay(As, c, r, nrows);
      gsum[i] = fmaf(dP[i], d, gsum[i]);
    }
    float inter[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) inter[i] = 0.f;
    wgmma::fence_operand(inter);
    wgmma::fence();
    for (int kk = 0; kk < nkP; ++kk)
      tf::mma3_ss<128>(inter, tf::kmajor<R>(Ub, 0, kk),
                       tf::kmajor<R>(Us, 0, kk), tf::kmajor<NT>(Sb, 0, kk),
                       tf::kmajor<NT>(Ss, 0, kk), 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(inter);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = fmaf(rf[f.r(i)], inter[i], sum[i]);
    ring.release(j);
  }

  // + (sum over heads of G) F, the head sum from registers
  uint32_t fb[8][4], fs[8][4];
  tf::to_frags(gsum, fb, fs);
  ring.wait_once();
  wgmma::fence_operand(sum);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    tf::mma3_rs<128>(sum, fb[kk], fs[kk], tf::kmajor<NT>(Fb, 0, kk),
                     tf::kmajor<NT>(Fs, 0, kk));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(sum);
  float* o = out + goff;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = f.r(i), n = f.c(i);
    if (r >= nrows || n >= p.N) continue;
    float* e = o + r * bs + n;
    if (p.vec) {
      *reinterpret_cast<float2*>(e) = make_float2(sum[i], sum[i + 1]);
    } else {
      e[0] = sum[i];
      if (n + 1 < p.N) e[1] = sum[i + 1];
    }
  }
}

__global__ void __launch_bounds__(kT, 1)
ssd_t3_bwd_dbc_kernel(Shape p, const float* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ dstates,
                      float* __restrict__ db, float* __restrict__ dc) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  if (blockIdx.y % 2 == 0)
    dbc_body<0>(p, dy, x, b, a, states, dc, base);
  else
    dbc_body<1>(p, x, dy, c, a, dstates, db, base);
}

bool valid(const Shape& p) {
  return p.B > 0 && p.S > 0 && p.H > 0 && p.G > 0 && p.H % p.G == 0 &&
         p.N > 0 && p.N <= NT && p.P > 0 && p.P <= PT && p.L > 0 &&
         p.L <= R && p.nc == (p.S + p.L - 1) / p.L;
}

// rows of whole 16-byte chunks and 16-byte aligned pointers
bool vec_ok(int N, int P, const void* const* ptrs, int n) {
  if (N % 4 || P % 4) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
      return false;
  return true;
}

// The forward's two launches (see ssd_scan_tf32_fwd).
cudaError_t fwd(const void* x, const void* a, const void* b, const void* c,
                void* y, void* hT, void* states, void* cb, const Shape& p,
                cudaStream_t s) {
  static bool cb_set = false, fwd_set = false;
  cudaError_t e = tc::set_smem(ssd_t3_cb_kernel, kCbSmem, cb_set);
  if (e == cudaSuccess)
    e = tc::set_smem(ssd_t3_fwd_kernel, FwdSmem::bytes, fwd_set);
  if (e != cudaSuccess) return e;
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  ssd_t3_cb_kernel<<<dim3(p.nc, p.G, p.B), kT, kCbSmem, s>>>(
      p, bf, cf, static_cast<float*>(cb));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_t3_fwd_kernel<<<dim3(p.H, p.B), kT, FwdSmem::bytes, s>>>(
      p, static_cast<const float*>(x), static_cast<const float*>(a), bf, cf,
      static_cast<const float*>(cb), static_cast<float*>(y),
      static_cast<float*>(hT), static_cast<float*>(states));
  return cudaGetLastError();
}

// The backward's three launches (see ssd_scan_tf32_bwd).
cudaError_t bwd(const void* x, const void* a, const void* b, const void* c,
                const void* y, const void* states, const void* cb,
                const void* dy, const void* dhT, void* dstates, void* dx,
                void* da, void* db, void* dc, const Shape& p,
                cudaStream_t s) {
  static bool st_set = false, dx_set = false, dbc_set = false;
  cudaError_t e =
      tc::set_smem(ssd_t3_bwd_state_kernel, StateSmem::bytes, st_set);
  if (e == cudaSuccess)
    e = tc::set_smem(ssd_t3_bwd_dx_kernel, DxSmem::bytes, dx_set);
  if (e == cudaSuccess)
    e = tc::set_smem(ssd_t3_bwd_dbc_kernel, DbcSmem::bytes, dbc_set);
  if (e != cudaSuccess) return e;
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* sf = static_cast<const float*>(states);
  const float* dyf = static_cast<const float*>(dy);
  float* dsf = static_cast<float*>(dstates);
  float* daf = static_cast<float*>(da);
  ssd_t3_bwd_state_kernel<<<dim3(p.H, p.B), kT, StateSmem::bytes, s>>>(
      p, af, cf, dyf, static_cast<const float*>(dhT), sf, dsf, daf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_t3_bwd_dx_kernel<<<dim3(p.nc, p.H, p.B), kT, DxSmem::bytes, s>>>(
      p, xf, af, bf, static_cast<const float*>(y),
      static_cast<const float*>(cb), dsf, dyf, static_cast<float*>(dx), daf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_t3_bwd_dbc_kernel<<<dim3(p.nc, 2 * p.G, p.B), kT, DbcSmem::bytes,
                          s>>>(p, xf, af, bf, cf, dyf, sf, dsf,
                               static_cast<float*>(db),
                               static_cast<float*>(dc));
  return cudaGetLastError();
}

}  // namespace t3

}  // namespace

// The FMA route: bf16 x (B, S, H, P), b, c (B, S, G, N) of any widths N <=
// 128, P <= 64 (the tensor-core route takes those that are multiples of
// 16); a (B, S, H) f32; y like x; hT (B, H, N, P) f32; states (B, H, nc,
// N, P) f32 with nc = ceil(S / L), or null when no gradient is wanted. L
// = chunk rows (1..64). All contiguous on the device. Returns a
// cudaError_t (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* a, const void* b,
                            const void* c, void* y, void* hT, void* states,
                            int B, int S, int H, int G, int N, int P, int L,
                            void* stream) {
  const Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0};
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd<bf16>(x, a, b, c, y, hT, states, p,
                                    static_cast<cudaStream_t>(stream)));
}

// The gradients of ssd_scan_fwd: dy like x, dhT (B, H, N, P) f32 or null
// (zero); `states` from the forward; dstates (B, H, nc, N, P) f32 scratch;
// dx like x, da like a, db and dc like b. Two launches.
extern "C" int ssd_scan_bwd(const void* x, const void* a, const void* b,
                            const void* c, const void* states,
                            const void* dy, const void* dhT, void* dstates,
                            void* dx, void* da, void* db, void* dc, int B,
                            int S, int H, int G, int N, int P, int L,
                            void* stream) {
  const Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0};
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd<bf16>(x, a, b, c, states, dy, dhT, dstates,
                                    dx, da, db, dc, p,
                                    static_cast<cudaStream_t>(stream)));
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

// The 3xTF32 route: f32 x, b, c of any widths N <= 128, P <= 64 (16-byte
// loads where N and P are multiples of 4 and the pointers 16-byte
// aligned, else element by element), chunk rows L <= 64. Shapes as for
// ssd_scan_fwd, but `states` (or null when no gradient is wanted) holds
// the state at each chunk's start and, last, the final one, as h^T (P x
// N) zero padded to 64 x 128 in fragment order: (B, H, nc + 1, 64 * 128)
// f32; cb (B, nc, G, 2, 64 * 64) f32 receives C B^T and B C^T of every
// chunk and group, also in fragment order (the backward reads both). Two
// launches.
extern "C" int ssd_scan_tf32_fwd(const void* x, const void* a, const void* b,
                                 const void* c, void* y, void* hT,
                                 void* states, void* cb, int B, int S, int H,
                                 int G, int N, int P, int L, void* stream) {
  const void* ptrs[] = {x, b, c, y};
  const t3::Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0,
                    t3::vec_ok(N, P, ptrs, 4)};
  if (!t3::valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(t3::fwd(x, a, b, c, y, hT, states, cb, p,
                                  static_cast<cudaStream_t>(stream)));
}

// The gradients of ssd_scan_tf32_fwd: y, states and cb from it, dy like
// x, dhT (B, H, N, P) f32 or null (zero), dstates scratch like states; dx
// like x, da like a, db and dc like b. Three launches.
extern "C" int ssd_scan_tf32_bwd(const void* x, const void* a, const void* b,
                                 const void* c, const void* y,
                                 const void* states, const void* cb,
                                 const void* dy, const void* dhT,
                                 void* dstates, void* dx, void* da, void* db,
                                 void* dc, int B, int S, int H, int G, int N,
                                 int P, int L, void* stream) {
  const void* ptrs[] = {x, b, c, y, dy, dx, db, dc};
  const t3::Shape p{B, S, H, G, N, P, L, L > 0 ? (S + L - 1) / L : 0,
                    t3::vec_ok(N, P, ptrs, 8)};
  if (!t3::valid(p) || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(t3::bwd(x, a, b, c, y, states, cb, dy, dhT,
                                  dstates, dx, da, db, dc, p,
                                  static_cast<cudaStream_t>(stream)));
}
