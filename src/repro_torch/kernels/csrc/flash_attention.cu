// Blocked online-softmax attention for Hopper (sm_90a): forward and
// backward, GQA, causal / sliding-window masks on absolute positions.
//
// Replaces: src/repro/kernels/flash_attention.py:90
// `flash_attention_kernel_call` (the Pallas TPU kernel; body `_kernel` at
// :35), reached through `repro.kernels.ops.flash_attention` (ops.py:98)
// from every attention layer of the training forward when
// attn_impl="kernel" (repro/models/layers.py:147-149). The JAX package's
// backward is the VJP of the oracle (ops.py:86-92); here it is a kernel
// too, so the plain version stays off the card's main path.
//
// Layouts are the JAX package's: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D),
// contiguous; out like q; lse and delta (B, Hq, Sq) f32. Query row i sits
// at absolute position i + kv_offset, key row j at position j; causal
// keeps j <= pos(i), a window w keeps j > pos(i) - w.
//
// What bounds it: at the training path's shape (B 2, S 4096, 16 q heads
// over 8 kv heads, D 64, bf16, causal) the forward does 4*B*Hq*S*S*D/2 =
// 68.7 GFLOP over ~50 MB of inputs and outputs: operations-bound (about
// 69 us of bf16 tensor-core work against 15 us of memory traffic); the
// backward does 2.5 times the work.
//
// Design (simple first kernels; wgmma/TMA, warp specialisation and
// register-resident accumulators are later work):
//  * forward: one block of 4 warps per (64-row q tile, q head, batch);
//    it loops over the K/V tiles inside the causal/window band only
//    (tiles outside the band are never loaded: the TPU kernel's
//    `pl.when` skip), so causal work is halved. GQA reads kv head
//    h / (Hq/Hkv) without materialising repeats;
//  * K and V tiles arrive by 16-byte cp.async copies in two commit
//    groups, so the scores Q K^T start while V is still in flight;
//  * m and l per row in f32; the output accumulator is a 64 x DP f32 tile
//    in shared memory, rescaled by exp(m_old - m_new) before each P V;
//  * bf16: Q K^T, P V and the backward products on tensor cores (WMMA
//    16x16x16, f32 accumulate; P and dS rounded to bf16 for the product,
//    as flash attention does). f32: plain FMAs on register tiles, no TF32;
//  * masks on absolute positions; rows and columns past Sq, Skv or D
//    read 0 and are never stored; a row that sees no key (l == 0)
//    writes 0 and lse = -inf, and gets zero gradients;
//  * backward: a pre-pass writes delta = rowsum(dO * O). Kernel A, one
//    block per (kv tile, kv head, batch), loops over the q tiles of every
//    q head of its group, recomputes P = exp(S - lse), and accumulates
//    dV += P^T dO and dK += dS^T Q with dS = P * (dO V^T - delta): the
//    GQA sum over the group needs no atomics. Kernel B, one block per
//    (q tile, q head, batch), accumulates dQ += dS K;
//  * head dims up to 64 run in 64-wide tiles, up to 128 in 128-wide
//    ones (zero padded); above 128 the entry points refuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;              // 4 warps
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;    // 0: fill the 16 bytes with 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Tile shapes and shared-memory layout of one dtype and padded head dim.
// Row strides are padded so rows stay 16-byte aligned (cp.async) and
// WMMA's leading dimensions hold (multiples of 8 bf16 / 4 floats).
template <typename T, int DP>
struct Tiles {
  static constexpr bool kTc = sizeof(T) == 2;
  static constexpr int BQ = 64;              // q rows per tile
  static constexpr int BKV = kTc ? 64 : 32;  // kv rows per tile
  static constexpr int LDT = DP + (kTc ? 8 : 4);    // Q, K, V, dO tiles
  static constexpr int LDS = BKV + 4;               // f32 score tiles
  static constexpr int LDP = BKV + (kTc ? 8 : 4);   // P, dS in T
  static constexpr int LDO = DP + 4;                // f32 accumulators
  static constexpr size_t kQ = align128(sizeof(T) * BQ * LDT);
  static constexpr size_t kKV = align128(sizeof(T) * BKV * LDT);
  static constexpr size_t kS = align128(sizeof(float) * BQ * LDS);
  static constexpr size_t kP = align128(sizeof(T) * BQ * LDP);
  static constexpr size_t kOq = align128(sizeof(float) * BQ * LDO);
  static constexpr size_t kOkv = align128(sizeof(float) * BKV * LDO);
  static constexpr size_t kRow = align128(sizeof(float) * BQ);
  // forward: Q, K, V, S, P, O, m, l, alpha
  static constexpr size_t fwd_bytes = kQ + 2 * kKV + kS + kP + kOq + 3 * kRow;
  // kernel A (dK, dV): Q, dO, K, V, S, dP, P, dS, dK, dV, lse, delta
  static constexpr size_t dkv_bytes =
      2 * kQ + 2 * kKV + 2 * kS + 2 * kP + 2 * kOkv + 2 * kRow;
  // kernel B (dQ): Q, dO, K, V, S, dP, dS, dQ, lse, delta
  static constexpr size_t dq_bytes =
      2 * kQ + 2 * kKV + 2 * kS + kP + kOq + 2 * kRow;
};

// ---------------------------------------------------------------------
// C (M x N, f32, shared) (+)= op(A) op(B) over depth K, where
//   op(A)(r, k) = TA ? A[k * lda + r] : A[r * lda + k]
//   op(B)(k, c) = TB ? B[c * ldb + k] : B[k * ldb + c]
// bf16: WMMA fragments, the block's warps taking 16x16 output tiles in
// turn. f32: each thread a register tile of (M/8) x (N/16) outputs.
// ---------------------------------------------------------------------
template <int M, int N, bool TA, bool TB>
__device__ __forceinline__ void mm(float* C, int ldc, const bf16* A, int lda,
                                   const bf16* B, int ldb, int K,
                                   bool accumulate) {
  using namespace nvcuda;
  using LA = std::conditional_t<TA, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<TB, wmma::col_major, wmma::row_major>;
  constexpr int kNT = N / 16;
  const int warp = threadIdx.x / 32;
  for (int f = warp; f < (M / 16) * kNT; f += kWarps) {
    const int r0 = (f / kNT) * 16, c0 = (f % kNT) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, C + r0 * ldc + c0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, TA ? A + k0 * lda + r0 : A + r0 * lda + k0,
                             lda);
      wmma::load_matrix_sync(b, TB ? B + c0 * ldb + k0 : B + k0 * ldb + c0,
                             ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + r0 * ldc + c0, acc, ldc, wmma::mem_row_major);
  }
}

template <int M, int N, bool TA, bool TB>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A,
                                   int lda, const float* B, int ldb, int K,
                                   bool accumulate) {
  constexpr int TX = 16, TY = kThreads / TX;
  constexpr int RM = M / TY, CN = N / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j)
      acc[i][j] = accumulate ? C[(ty + TY * i) * ldc + tx + TX * j] : 0.f;
  for (int k = 0; k < K; ++k) {
    float a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + TY * i;
      a[i] = TA ? A[k * lda + r] : A[r * lda + k];
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int c = tx + TX * j;
      b[j] = TB ? B[c * ldb + k] : B[k * ldb + c];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j)
      C[(ty + TY * i) * ldc + tx + TX * j] = acc[i][j];
}

// Stage rows [row0, row0 + ROWS) x columns [0, DP) of a (rows, stride)
// matrix; rows >= nrows and columns >= D read 0. vec: 16-byte cp.async
// copies (D a multiple of 16 bytes, pointers 16-byte aligned), else
// element loads. The caller commits, waits and synchronises.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* g,
                                          long stride, int row0, int nrows,
                                          int D, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int i = threadIdx.x; i < ROWS * (DP / V); i += kThreads) {
      const int r = i / (DP / V), c = (i % (DP / V)) * V;
      const bool ok = row0 + r < nrows && c < D;
      cp_async16(s + r * lds + c, ok ? g + (row0 + r) * stride + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool ok = row0 + r < nrows && c < D;
      s[r * lds + c] = ok ? g[(row0 + r) * stride + c] : from_f32<T>(0.f);
    }
  }
}

// Store rows [row0, row0 + ROWS) of an f32 tile times `mul`, masked.
template <typename T, int ROWS>
__device__ __forceinline__ void store_tile(T* g, long stride, const float* s,
                                           int lds, int row0, int nrows,
                                           int D, float mul) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (row0 + r < nrows) g[(row0 + r) * stride + c] =
        from_f32<T>(s[r * lds + c] * mul);
  }
}

struct Shape {
  int B, Sq, Skv, Hq, Hkv, D;
  int causal, window, kv_offset;  // window <= 0: none
  float scale;
  int vec;
};

__device__ __forceinline__ bool visible(const Shape& p, int qi, int kj) {
  const int qpos = qi + p.kv_offset;
  return kj < p.Skv && (!p.causal || kj <= qpos) &&
         (p.window <= 0 || kj > qpos - p.window);
}

// kv rows [lo, hi] that q rows [q0, q1] can see (lo > hi: none)
__device__ __forceinline__ void kv_band(const Shape& p, int q0, int q1,
                                        int& lo, int& hi) {
  hi = p.causal ? min(p.Skv - 1, q1 + p.kv_offset) : p.Skv - 1;
  lo = p.window > 0 ? max(0, q0 + p.kv_offset - p.window + 1) : 0;
}

// q rows [lo, hi] that see some of kv rows [k0, k1]
__device__ __forceinline__ void q_band(const Shape& p, int k0, int k1,
                                       int& lo, int& hi) {
  lo = p.causal ? max(0, k0 - p.kv_offset) : 0;
  hi = p.window > 0 ? min(p.Sq - 1, k1 + p.window - 1 - p.kv_offset)
                    : p.Sq - 1;
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Shape p) {
  using L = Tiles<T, DP>;
  constexpr int BQ = L::BQ, BKV = L::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* Qs = reinterpret_cast<T*>(ptr);  ptr += L::kQ;
  T* Ks = reinterpret_cast<T*>(ptr);  ptr += L::kKV;
  T* Vs = reinterpret_cast<T*>(ptr);  ptr += L::kKV;
  float* Ss = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  T* Ps = reinterpret_cast<T*>(ptr);  ptr += L::kP;
  float* Os = reinterpret_cast<float*>(ptr);  ptr += L::kOq;
  float* m_s = reinterpret_cast<float*>(ptr);  ptr += L::kRow;
  float* l_s = reinterpret_cast<float*>(ptr);  ptr += L::kRow;
  float* a_s = reinterpret_cast<float*>(ptr);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const long qs = static_cast<long>(p.Hq) * p.D;    // row strides
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const T* qb = q + (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
  const T* kb = k + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  const T* vb = v + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<T, BQ, DP>(Qs, L::LDT, qb, qs, q0, p.Sq, p.D, p.vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  for (int t0 = (lo / BKV) * BKV; lo <= hi && t0 <= hi; t0 += BKV) {
    load_tile<T, BKV, DP>(Ks, L::LDT, kb, ks, t0, p.Skv, p.D, p.vec);
    cp_async_commit();
    load_tile<T, BKV, DP>(Vs, L::LDT, vb, ks, t0, p.Skv, p.D, p.vec);
    cp_async_commit();
    cp_async_wait<1>();                    // Q and K have landed
    __syncthreads();
    mm<BQ, BKV, false, true>(Ss, L::LDS, Qs, L::LDT, Ks, L::LDT, DP, false);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      float s[BKV / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j;
        s[j] = visible(p, q0 + r, t0 + c) ? Ss[r * L::LDS + c] * p.scale
                                          : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const float e = expf(s[j] - m_use);          // exp(-inf) = 0
        Ps[r * L::LDP + lane + 32 * j] = from_f32<T>(e);
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      Os[r * L::LDO + c] *= a_s[r];
    }
    cp_async_wait<0>();                    // V has landed
    __syncthreads();
    mm<BQ, DP, false, false>(Os, L::LDO, Ps, L::LDP, Vs, L::LDT, BKV, true);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  T* ob = out + (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
  for (int i = threadIdx.x; i < BQ * p.D; i += kThreads) {
    const int r = i / p.D, c = i % p.D;
    if (q0 + r < p.Sq) {
      const float l = l_s[r];
      ob[(q0 + r) * qs + c] = from_f32<T>(l > 0.f ? Os[r * L::LDO + c] / l
                                                  : 0.f);
    }
  }
  float* lb = lse + (static_cast<long>(b) * p.Hq + h) * p.Sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads)
    if (q0 + r < p.Sq)
      lb[q0 + r] = l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : -INFINITY;
}

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                   float* __restrict__ delta, Shape p) {
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const long rows = static_cast<long>(p.B) * p.Sq * p.Hq;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32)
    acc += to_f32(dout[row * p.D + d]) * to_f32(out[row * p.D + d]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const long h = row % p.Hq, i = (row / p.Hq) % p.Sq;
    const long b = row / (static_cast<long>(p.Hq) * p.Sq);
    delta[(b * p.Hq + h) * p.Sq + i] = acc;
  }
}

// P = exp(S * scale - lse) on visible entries (f32 into S) and
// dS = P * (dP - delta) into dS (T); P also into Pt (T) when given.
template <typename T, int BQ, int BKV, int LDS, int LDP>
__device__ __forceinline__ void probs_and_dscores(
    const Shape& p, int q0, int k0, float* Ss, const float* dPs,
    const float* lse_s, const float* delta_s, T* Pt, T* dSt) {
  for (int i = threadIdx.x; i < BQ * BKV; i += kThreads) {
    const int r = i / BKV, c = i % BKV;
    const float lr = lse_s[r];
    const float pr = (lr != -INFINITY && q0 + r < p.Sq &&
                      visible(p, q0 + r, k0 + c))
                         ? expf(Ss[r * LDS + c] * p.scale - lr)
                         : 0.f;
    if (Pt != nullptr) Pt[r * LDP + c] = from_f32<T>(pr);
    dSt[r * LDP + c] = from_f32<T>(pr * (dPs[r * LDS + c] - delta_s[r]));
  }
}

template <int BQ>
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0,
                                          int Sq) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool ok = q0 + r < Sq;
    lse_s[r] = ok ? lse[q0 + r] : -INFINITY;
    delta_s[r] = ok ? delta[q0 + r] : 0.f;
  }
}

// Kernel A: dK, dV of one (kv tile, kv head, batch)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Shape p) {
  using L = Tiles<T, DP>;
  constexpr int BQ = L::BQ, BKV = L::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* Qs = reinterpret_cast<T*>(ptr);  ptr += L::kQ;
  T* dOs = reinterpret_cast<T*>(ptr);  ptr += L::kQ;
  T* Ks = reinterpret_cast<T*>(ptr);  ptr += L::kKV;
  T* Vs = reinterpret_cast<T*>(ptr);  ptr += L::kKV;
  float* Ss = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  float* dPs = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  T* Ps = reinterpret_cast<T*>(ptr);  ptr += L::kP;
  T* dSs = reinterpret_cast<T*>(ptr);  ptr += L::kP;
  float* dKs = reinterpret_cast<float*>(ptr);  ptr += L::kOkv;
  float* dVs = reinterpret_cast<float*>(ptr);  ptr += L::kOkv;
  float* lse_s = reinterpret_cast<float*>(ptr);  ptr += L::kRow;
  float* delta_s = reinterpret_cast<float*>(ptr);

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long qs = static_cast<long>(p.Hq) * p.D;
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const long kvoff = (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  load_tile<T, BKV, DP>(Ks, L::LDT, k + kvoff, ks, k0, p.Skv, p.D, p.vec);
  load_tile<T, BKV, DP>(Vs, L::LDT, v + kvoff, ks, k0, p.Skv, p.D, p.vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < BKV * L::LDO; i += kThreads) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }
  int lo, hi;
  q_band(p, k0, min(k0 + BKV, p.Skv) - 1, lo, hi);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const long qoff = (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
    const long roff = (static_cast<long>(b) * p.Hq + h) * p.Sq;
    for (int q0 = (lo / BQ) * BQ; lo <= hi && q0 <= hi; q0 += BQ) {
      load_tile<T, BQ, DP>(Qs, L::LDT, q + qoff, qs, q0, p.Sq, p.D, p.vec);
      load_tile<T, BQ, DP>(dOs, L::LDT, dout + qoff, qs, q0, p.Sq, p.D,
                           p.vec);
      cp_async_commit();
      load_rows<BQ>(lse_s, delta_s, lse + roff, delta + roff, q0, p.Sq);
      cp_async_wait<0>();
      __syncthreads();
      mm<BQ, BKV, false, true>(Ss, L::LDS, Qs, L::LDT, Ks, L::LDT, DP, false);
      mm<BQ, BKV, false, true>(dPs, L::LDS, dOs, L::LDT, Vs, L::LDT, DP,
                               false);
      __syncthreads();
      probs_and_dscores<T, BQ, BKV, L::LDS, L::LDP>(p, q0, k0, Ss, dPs, lse_s,
                                                    delta_s, Ps, dSs);
      __syncthreads();
      mm<BKV, DP, true, false>(dVs, L::LDO, Ps, L::LDP, dOs, L::LDT, BQ,
                               true);
      mm<BKV, DP, true, false>(dKs, L::LDO, dSs, L::LDP, Qs, L::LDT, BQ,
                               true);
      __syncthreads();
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile<T, BKV>(dk + kvoff, ks, dKs, L::LDO, k0, p.Skv, p.D, p.scale);
  store_tile<T, BKV>(dv + kvoff, ks, dVs, L::LDO, k0, p.Skv, p.D, 1.f);
}

// Kernel B: dQ of one (q tile, q head, batch)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                Shape p) {
  using L = Tiles<T, DP>;
  constexpr int BQ = L::BQ, BKV = L::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  T* Qs = reinterpret_cast<T*>(ptr);  ptr += L::kQ;
  T* dOs = reinterpret_cast<T*>(ptr);  ptr += L::kQ;
  T* Ks = reinterpret_cast<T*>(ptr);  ptr += L::kKV;
  T* Vs = reinterpret_cast<T*>(ptr);  ptr += L::kKV;
  float* Ss = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  float* dPs = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  T* dSs = reinterpret_cast<T*>(ptr);  ptr += L::kP;
  float* dQs = reinterpret_cast<float*>(ptr);  ptr += L::kOq;
  float* lse_s = reinterpret_cast<float*>(ptr);  ptr += L::kRow;
  float* delta_s = reinterpret_cast<float*>(ptr);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const long qs = static_cast<long>(p.Hq) * p.D;
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const long qoff = (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
  const long kvoff = (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  const long roff = (static_cast<long>(b) * p.Hq + h) * p.Sq;
  load_tile<T, BQ, DP>(Qs, L::LDT, q + qoff, qs, q0, p.Sq, p.D, p.vec);
  load_tile<T, BQ, DP>(dOs, L::LDT, dout + qoff, qs, q0, p.Sq, p.D, p.vec);
  cp_async_commit();
  load_rows<BQ>(lse_s, delta_s, lse + roff, delta + roff, q0, p.Sq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) dQs[i] = 0.f;
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  for (int t0 = (lo / BKV) * BKV; lo <= hi && t0 <= hi; t0 += BKV) {
    load_tile<T, BKV, DP>(Ks, L::LDT, k + kvoff, ks, t0, p.Skv, p.D, p.vec);
    load_tile<T, BKV, DP>(Vs, L::LDT, v + kvoff, ks, t0, p.Skv, p.D, p.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mm<BQ, BKV, false, true>(Ss, L::LDS, Qs, L::LDT, Ks, L::LDT, DP, false);
    mm<BQ, BKV, false, true>(dPs, L::LDS, dOs, L::LDT, Vs, L::LDT, DP, false);
    __syncthreads();
    probs_and_dscores<T, BQ, BKV, L::LDS, L::LDP>(p, q0, t0, Ss, dPs, lse_s,
                                                  delta_s, nullptr, dSs);
    __syncthreads();
    mm<BQ, DP, false, false>(dQs, L::LDO, dSs, L::LDP, Ks, L::LDT, BKV, true);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile<T, BQ>(dq + qoff, qs, dQs, L::LDO, q0, p.Sq, p.D, p.scale);
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------
// Lets `kernel` take `bytes` of dynamic shared memory. Set on a
// kernel's first launch only, so later launches (and CUDA graph captures
// of them) make no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  done = e == cudaSuccess;
  return e;
}

template <typename T, int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const Shape& p, cudaStream_t s) {
  using L = Tiles<T, DP>;
  auto kern = flash_fwd_kernel<T, DP>;
  static bool smem_set = false;
  cudaError_t e = allow_smem(kern, L::fwd_bytes, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.Hq, p.B);
  kern<<<grid, kThreads, L::fwd_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, const Shape& p, cudaStream_t s) {
  using L = Tiles<T, DP>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long rows = static_cast<long>(p.B) * p.Sq * p.Hq;
  flash_delta_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(out), dot, delta, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto ka = flash_dkv_kernel<T, DP>;
  static bool smem_a = false, smem_b = false;
  if ((e = allow_smem(ka, L::dkv_bytes, smem_a)) != cudaSuccess) return e;
  const dim3 grid_a((p.Skv + L::BKV - 1) / L::BKV, p.Hkv, p.B);
  ka<<<grid_a, kThreads, L::dkv_bytes, s>>>(qt, kt, vt, dot, lse, delta,
                                             static_cast<T*>(dk),
                                             static_cast<T*>(dv), p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  auto kb = flash_dq_kernel<T, DP>;
  if ((e = allow_smem(kb, L::dq_bytes, smem_b)) != cudaSuccess) return e;
  const dim3 grid_b((p.Sq + L::BQ - 1) / L::BQ, p.Hq, p.B);
  kb<<<grid_b, kThreads, L::dq_bytes, s>>>(qt, kt, vt, dot, lse, delta,
                                            static_cast<T*>(dq), p);
  return cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* ptr : ptrs)
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16) return false;
  return true;
}

bool make_shape(Shape& p, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                int causal, int window, int kv_offset, float scale,
                int elem_bytes) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hq <= 0 || Hkv <= 0 || D <= 0 ||
      D > 128 || Hq % Hkv || Hq > 65535 || B > 65535)
    return false;
  p = Shape{B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset, scale, 0};
  p.vec = (D * elem_bytes) % 16 == 0;
  return true;
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D), out like q, lse (B, Hq, Sq) f32;
// all contiguous on the device. dtype: 0 = float32, 1 = bfloat16.
// window <= 0: no window. Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int D, int causal, int window,
                                   int kv_offset, float scale, int dtype,
                                   void* stream) {
  Shape p;
  const int eb = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) ||
      !make_shape(p, B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset, scale,
                  eb))
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec = p.vec && aligned16({q, k, v});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return static_cast<int>(D <= 64 ? fwd<bf16, 64>(q, k, v, out, l, p, s)
                                    : fwd<bf16, 128>(q, k, v, out, l, p, s));
  return static_cast<int>(D <= 64 ? fwd<float, 64>(q, k, v, out, l, p, s)
                                  : fwd<float, 128>(q, k, v, out, l, p, s));
}

// The forward's q, k, v, out, lse and the output gradient dout (like out);
// delta (B, Hq, Sq) f32 is scratch; writes dq, dk, dv (like q, k, v).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int D, int causal, int window,
                                   int kv_offset, float scale, int dtype,
                                   void* stream) {
  Shape p;
  const int eb = dtype == 1 ? 2 : 4;
  if ((dtype != 0 && dtype != 1) ||
      !make_shape(p, B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset, scale,
                  eb))
    return static_cast<int>(cudaErrorInvalidValue);
  p.vec = p.vec && aligned16({q, k, v, dout});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == 1)
    return static_cast<int>(
        D <= 64 ? bwd<bf16, 64>(q, k, v, out, dout, l, d, dq, dk, dv, p, s)
                : bwd<bf16, 128>(q, k, v, out, dout, l, d, dq, dk, dv, p, s));
  return static_cast<int>(
      D <= 64 ? bwd<float, 64>(q, k, v, out, dout, l, d, dq, dk, dv, p, s)
              : bwd<float, 128>(q, k, v, out, dout, l, d, dq, dk, dv, p, s));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
