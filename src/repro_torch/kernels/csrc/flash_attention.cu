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
// keeps j <= pos(i), a window w keeps j > pos(i) - w. Rows and columns
// past Sq, Skv or D read 0 and are never stored; a row that sees no key
// (l == 0) writes 0 and lse = -inf, and gets zero gradients. Head dims up
// to 64 run in 64-wide tiles, up to 128 in 128-wide ones (zero padded);
// above 128 the entry points refuse.
//
// What bounds it: at the training path's shape (B 2, S 4096, 16 q heads
// over 8 kv heads, D 64, bf16, causal) the forward does 4*B*Hq*S*S*D/2 =
// 68.7 GFLOP over ~50 MB of inputs and outputs: operations-bound (about
// 69 us of bf16 tensor-core work against 15 us of memory traffic); the
// backward does 2.5 times the work.
//
// bf16, the training path (wgmma_bf16.cuh has the operand layouts). Each
// kernel is a block of three warpgroups: two consumers that run wgmma
// products with f32 accumulators in registers, and a producer whose first
// lane keeps TMA copies in flight through a ring of 3-4 stages in shared
// memory, signalled by mbarriers (full: the stage landed; empty: both
// consumers are done with it), so the consumers never wait on each other.
// The producer gives its registers to the consumers (setmaxnreg 40 / 232).
//  * forward: one block per (128-row q tile, q head, batch), each consumer
//    64 rows. S = Q K^T and O += P V are wgmma products; P goes to bf16 in
//    registers and feeds P V as the A operand, so no score or output tile
//    touches shared memory. m and l stay in registers per row, the
//    exponentials are exp2 with scale * log2(e) folded in. Only K/V tiles
//    (128 rows) inside the causal/window band are loaded (the TPU kernel's
//    `pl.when` skip), and only tiles that straddle the band's edge (or Sq,
//    Skv) test the mask per element;
//  * the grid is 1-D, heaviest causal tiles first (the last q tiles for
//    the forward and dQ, the first kv tiles for dK/dV);
//  * backward: a pre-pass writes delta = rowsum(dO * O). The dK/dV kernel,
//    one block per (128-row kv tile, kv head, batch), each consumer 64 kv
//    rows, walks the q tiles (64 rows) of every q head of its group
//    through the ring (Q, dO, lse, delta), forms S^T = K Q^T and
//    dP^T = V dO^T, P^T = exp2(S^T scale log2e - lse log2e) and
//    dS^T = P^T (dP^T - delta) in registers, and accumulates dV += P^T dO
//    and dK += dS^T Q in registers over the whole group: the GQA sum needs
//    no atomics. dP^T and dV are in flight while P^T and dS^T are formed;
//  * dQ takes route (a), its own kernel: one block per (128-row q tile,
//    q head, batch) walks its kv tiles (128 rows at D <= 64, 64 above)
//    through the ring, recomputes S and dP (2 of the backward's 7
//    products; route (b), f32 atomics into a workspace, would save them)
//    and accumulates dQ += dS K in registers. It keeps the backward free
//    of atomics, so its bits repeat from run to run;
//  * variants by shape, chosen before launch: where D is a multiple of 8
//    and the pointers 16-byte aligned (TMA's strides and base), tiles come
//    by TMA through 4-D maps (D, H, S, B) whose bounds zero the rows past
//    S and the columns past D; otherwise the producer's first warp loads
//    them element by element into the same layout, through the same
//    kernels.
//
// f32 (the reduced checks and f32 cases; on no full-width path; not
// redesigned): one block of 4 warps per 64-row q tile with FMAs on register
// tiles (no TF32), the f32 accumulators in shared memory; the backward is
// the same delta pre-pass, a dK/dV kernel and a dQ kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "sm90_async.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace sm90;

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;              // f32 kernels: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;    // 0: fill the 16 bytes with 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// every pair of q rows [q0, q1] (all < Sq) and kv rows [k0, k1] visible
__device__ __forceinline__ bool all_visible(const Shape& p, int q0, int q1,
                                            int k0, int k1) {
  return q1 < p.Sq && k1 < p.Skv && (!p.causal || k1 <= q0 + p.kv_offset) &&
         (p.window <= 0 || k0 > q1 + p.kv_offset - p.window);
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
// f32: FMA tiles, accumulators in shared memory
// ---------------------------------------------------------------------

// Tile shapes and shared-memory layout at padded head dim DP. Row strides
// are padded so rows stay 16-byte aligned for cp.async.
template <int DP>
struct Tiles {
  static constexpr int BQ = 64;              // q rows per tile
  static constexpr int BKV = 32;             // kv rows per tile
  static constexpr int LDT = DP + 4;         // Q, K, V, dO tiles
  static constexpr int LDS = BKV + 4;        // score tiles
  static constexpr int LDP = BKV + 4;        // P, dS
  static constexpr int LDO = DP + 4;         // accumulators
  static constexpr size_t kQ = align128(sizeof(float) * BQ * LDT);
  static constexpr size_t kKV = align128(sizeof(float) * BKV * LDT);
  static constexpr size_t kS = align128(sizeof(float) * BQ * LDS);
  static constexpr size_t kP = align128(sizeof(float) * BQ * LDP);
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

// C (M x N, shared) (+)= op(A) op(B) over depth K, where
//   op(A)(r, k) = TA ? A[k * lda + r] : A[r * lda + k]
//   op(B)(k, c) = TB ? B[c * ldb + k] : B[k * ldb + c]
// each thread a register tile of (M/8) x (N/16) outputs.
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
// copies (D a multiple of 4, pointers 16-byte aligned), else element
// loads. The caller commits, waits and synchronises.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* s, int lds, const float* g,
                                          long stride, int row0, int nrows,
                                          int D, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (DP / 4); i += kThreads) {
      const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
      const bool ok = row0 + r < nrows && c < D;
      cp_async16(s + r * lds + c, ok ? g + (row0 + r) * stride + c : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool ok = row0 + r < nrows && c < D;
      s[r * lds + c] = ok ? g[(row0 + r) * stride + c] : 0.f;
    }
  }
}

// Store rows [row0, row0 + ROWS) of an f32 tile times `mul`, masked.
template <int ROWS>
__device__ __forceinline__ void store_tile(float* g, long stride,
                                           const float* s, int lds, int row0,
                                           int nrows, int D, float mul) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (row0 + r < nrows) g[(row0 + r) * stride + c] = s[r * lds + c] * mul;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, Shape p) {
  using L = Tiles<DP>;
  constexpr int BQ = L::BQ, BKV = L::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  float* Qs = reinterpret_cast<float*>(ptr);  ptr += L::kQ;
  float* Ks = reinterpret_cast<float*>(ptr);  ptr += L::kKV;
  float* Vs = reinterpret_cast<float*>(ptr);  ptr += L::kKV;
  float* Ss = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  float* Ps = reinterpret_cast<float*>(ptr);  ptr += L::kP;
  float* Os = reinterpret_cast<float*>(ptr);  ptr += L::kOq;
  float* m_s = reinterpret_cast<float*>(ptr);  ptr += L::kRow;
  float* l_s = reinterpret_cast<float*>(ptr);  ptr += L::kRow;
  float* a_s = reinterpret_cast<float*>(ptr);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const long qs = static_cast<long>(p.Hq) * p.D;    // row strides
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const float* qb = q + (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
  const float* kb = k + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  const float* vb = v + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<BQ, DP>(Qs, L::LDT, qb, qs, q0, p.Sq, p.D, p.vec);
  cp_async_commit();
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  for (int t0 = (lo / BKV) * BKV; lo <= hi && t0 <= hi; t0 += BKV) {
    load_tile<BKV, DP>(Ks, L::LDT, kb, ks, t0, p.Skv, p.D, p.vec);
    cp_async_commit();
    load_tile<BKV, DP>(Vs, L::LDT, vb, ks, t0, p.Skv, p.D, p.vec);
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
        Ps[r * L::LDP + lane + 32 * j] = e;
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
  float* ob = out + (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
  for (int i = threadIdx.x; i < BQ * p.D; i += kThreads) {
    const int r = i / p.D, c = i % p.D;
    if (q0 + r < p.Sq) {
      const float l = l_s[r];
      ob[(q0 + r) * qs + c] = l > 0.f ? Os[r * L::LDO + c] / l : 0.f;
    }
  }
  float* lb = lse + (static_cast<long>(b) * p.Hq + h) * p.Sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads)
    if (q0 + r < p.Sq)
      lb[q0 + r] = l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : -INFINITY;
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp per row
// (both dtypes)
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
// dS = P * (dP - delta) into dS; P also into Pt when given.
template <int BQ, int BKV, int LDS, int LDP>
__device__ __forceinline__ void probs_and_dscores(
    const Shape& p, int q0, int k0, float* Ss, const float* dPs,
    const float* lse_s, const float* delta_s, float* Pt, float* dSt) {
  for (int i = threadIdx.x; i < BQ * BKV; i += kThreads) {
    const int r = i / BKV, c = i % BKV;
    const float lr = lse_s[r];
    const float pr = (lr != -INFINITY && q0 + r < p.Sq &&
                      visible(p, q0 + r, k0 + c))
                         ? expf(Ss[r * LDS + c] * p.scale - lr)
                         : 0.f;
    if (Pt != nullptr) Pt[r * LDP + c] = pr;
    dSt[r * LDP + c] = pr * (dPs[r * LDS + c] - delta_s[r]);
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
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, Shape p) {
  using L = Tiles<DP>;
  constexpr int BQ = L::BQ, BKV = L::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  float* Qs = reinterpret_cast<float*>(ptr);  ptr += L::kQ;
  float* dOs = reinterpret_cast<float*>(ptr);  ptr += L::kQ;
  float* Ks = reinterpret_cast<float*>(ptr);  ptr += L::kKV;
  float* Vs = reinterpret_cast<float*>(ptr);  ptr += L::kKV;
  float* Ss = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  float* dPs = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  float* Ps = reinterpret_cast<float*>(ptr);  ptr += L::kP;
  float* dSs = reinterpret_cast<float*>(ptr);  ptr += L::kP;
  float* dKs = reinterpret_cast<float*>(ptr);  ptr += L::kOkv;
  float* dVs = reinterpret_cast<float*>(ptr);  ptr += L::kOkv;
  float* lse_s = reinterpret_cast<float*>(ptr);  ptr += L::kRow;
  float* delta_s = reinterpret_cast<float*>(ptr);

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const long qs = static_cast<long>(p.Hq) * p.D;
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const long kvoff = (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  load_tile<BKV, DP>(Ks, L::LDT, k + kvoff, ks, k0, p.Skv, p.D, p.vec);
  load_tile<BKV, DP>(Vs, L::LDT, v + kvoff, ks, k0, p.Skv, p.D, p.vec);
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
      load_tile<BQ, DP>(Qs, L::LDT, q + qoff, qs, q0, p.Sq, p.D, p.vec);
      load_tile<BQ, DP>(dOs, L::LDT, dout + qoff, qs, q0, p.Sq, p.D, p.vec);
      cp_async_commit();
      load_rows<BQ>(lse_s, delta_s, lse + roff, delta + roff, q0, p.Sq);
      cp_async_wait<0>();
      __syncthreads();
      mm<BQ, BKV, false, true>(Ss, L::LDS, Qs, L::LDT, Ks, L::LDT, DP, false);
      mm<BQ, BKV, false, true>(dPs, L::LDS, dOs, L::LDT, Vs, L::LDT, DP,
                               false);
      __syncthreads();
      probs_and_dscores<BQ, BKV, L::LDS, L::LDP>(p, q0, k0, Ss, dPs, lse_s,
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
  store_tile<BKV>(dk + kvoff, ks, dKs, L::LDO, k0, p.Skv, p.D, p.scale);
  store_tile<BKV>(dv + kvoff, ks, dVs, L::LDO, k0, p.Skv, p.D, 1.f);
}

// Kernel B: dQ of one (q tile, q head, batch)
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, Shape p) {
  using L = Tiles<DP>;
  constexpr int BQ = L::BQ, BKV = L::BKV;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ptr = smem;
  float* Qs = reinterpret_cast<float*>(ptr);  ptr += L::kQ;
  float* dOs = reinterpret_cast<float*>(ptr);  ptr += L::kQ;
  float* Ks = reinterpret_cast<float*>(ptr);  ptr += L::kKV;
  float* Vs = reinterpret_cast<float*>(ptr);  ptr += L::kKV;
  float* Ss = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  float* dPs = reinterpret_cast<float*>(ptr);  ptr += L::kS;
  float* dSs = reinterpret_cast<float*>(ptr);  ptr += L::kP;
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
  load_tile<BQ, DP>(Qs, L::LDT, q + qoff, qs, q0, p.Sq, p.D, p.vec);
  load_tile<BQ, DP>(dOs, L::LDT, dout + qoff, qs, q0, p.Sq, p.D, p.vec);
  cp_async_commit();
  load_rows<BQ>(lse_s, delta_s, lse + roff, delta + roff, q0, p.Sq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) dQs[i] = 0.f;
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  for (int t0 = (lo / BKV) * BKV; lo <= hi && t0 <= hi; t0 += BKV) {
    load_tile<BKV, DP>(Ks, L::LDT, k + kvoff, ks, t0, p.Skv, p.D, p.vec);
    load_tile<BKV, DP>(Vs, L::LDT, v + kvoff, ks, t0, p.Skv, p.D, p.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mm<BQ, BKV, false, true>(Ss, L::LDS, Qs, L::LDT, Ks, L::LDT, DP, false);
    mm<BQ, BKV, false, true>(dPs, L::LDS, dOs, L::LDT, Vs, L::LDT, DP, false);
    __syncthreads();
    probs_and_dscores<BQ, BKV, L::LDS, L::LDP>(p, q0, t0, Ss, dPs, lse_s,
                                               delta_s, nullptr, dSs);
    __syncthreads();
    mm<BQ, DP, false, false>(dQs, L::LDO, dSs, L::LDP, Ks, L::LDT, BKV, true);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();
  store_tile<BQ>(dq + qoff, qs, dQs, L::LDO, q0, p.Sq, p.D, p.scale);
}

// ---------------------------------------------------------------------
// bf16: wgmma, accumulators in registers; a producer warpgroup fills
// two-stage rings of tiles by TMA for two consumer warpgroups
// ---------------------------------------------------------------------
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kWsThreads = kConsumers + 128;  // and the producer's
// registers a thread: 168 at launch (65536 / 384); the producer drops to
// 40 and the consumers rise to 232 (128 * 128 = 256 * 64)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// The ring's barriers: `full` completes when a stage is filled, `empty`
// when the 8 consumer warps are done with it; `once` for the tiles loaded
// once per block. The fill counts are the producer's arrivals: 1 where
// lane 0 alone arms TMA copies, 32 where every lane copies.
template <int kStages>
struct Barriers {
  uint64_t full[kStages], empty[kStages], once;

  __device__ __forceinline__ void init(int full_count, int once_count) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], full_count);
        mbar_init(&empty[s], kConsumers / 32);
      }
      mbar_init(&once, once_count);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // producer: wait until the consumers have released the stage of item it
  __device__ __forceinline__ void wait_empty(int it) {
    if (it >= kStages) mbar_wait(&empty[it % kStages], (it / kStages - 1) & 1);
  }
  // consumer: wait for item it's stage, then let wgmma read it (element
  // stores are generic-proxy writes; TMA's need no fence)
  __device__ __forceinline__ void wait_full(int it) {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    wgmma::fence_proxy();
  }
  __device__ __forceinline__ void wait_once() {
    mbar_wait(&once, 0);
    wgmma::fence_proxy();
  }
  // consumer warp: done with item it's stage
  __device__ __forceinline__ void release(int it) {
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[it % kStages]);
  }
};

// TMA: a tile of ROWS rows x DP columns of head h, batch b from row row0,
// through a 4-D map over (D, H, S, B) with boxes of 64 columns x ROWS rows
// and 128-byte swizzling, into the swizzled tile s; rows and columns out of
// range read 0. Completes on bar (armed by mbar_expect).
template <int ROWS, int DP>
__device__ __forceinline__ void tma_tile(unsigned char* s,
                                         const CUtensorMap& map,
                                         uint64_t* bar, int h, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            smem_u32(s + c * ROWS * 128)),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)),
        "r"(64 * c), "r"(h), "r"(row0), "r"(b)
        : "memory");
}

// The element-load variant (rows not whole 16-byte chunks, or unaligned
// pointers): rows [row0, row0 + ROWS) x columns [0, DP) of a (rows,
// stride) bf16 matrix into the swizzled tile s by the 32 lanes of the
// producer's first warp; rows >= nrows and columns >= D read 0.
template <int ROWS, int DP>
__device__ __forceinline__ void load_elems(unsigned char* s, const bf16* g,
                                           long stride, int row0, int nrows,
                                           int D) {
  for (int i = threadIdx.x % 32; i < ROWS * DP; i += 32) {
    const int r = i / DP, c = i % DP;
    const bool ok = row0 + r < nrows && c < D;
    *reinterpret_cast<bf16*>(s + wgmma::sw_offset<ROWS>(r, c)) =
        ok ? g[(row0 + r) * stride + c] : __float2bfloat16_rn(0.f);
  }
}

// The consumer thread's place in its warpgroup's accumulator fragment: its
// first row (the second is 8 below) and the column of element 0.
struct Frag {
  int row, col;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x % 32;
    row = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    col = 2 * (lane % 4);
  }
  // element i: row + 8 * half(i), column col + cofs(i)
  static __device__ __forceinline__ int half(int i) { return (i / 2) % 2; }
  static __device__ __forceinline__ int cofs(int i) {
    return 8 * (i / 4) + i % 2;
  }
};

// Store a thread's two rows of an m64nDP accumulator times mul[half]:
// rows row0 + f.row (+ 8) of a (rows, stride) bf16 matrix, columns < D,
// rows < nrows.
template <int R>
__device__ __forceinline__ void store_frag(bf16* g, long stride,
                                           const float (&d)[R],
                                           const Frag& f, int row0,
                                           int nrows, int D,
                                           const float (&mul)[2], bool vec) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + f.row + 8 * hf;
    if (row >= nrows) continue;
    bf16* gr = g + row * stride;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int c = f.col + 8 * j;
      const float x = d[4 * j + 2 * hf] * mul[hf];
      const float y = d[4 * j + 2 * hf + 1] * mul[hf];
      if (vec) {
        if (c < D)
          *reinterpret_cast<__nv_bfloat162*>(gr + c) =
              __floats2bfloat162_rn(x, y);
      } else {
        if (c < D) gr[c] = __float2bfloat16_rn(x);
        if (c + 1 < D) gr[c + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Block index -> (tile, head, batch) with every head and batch of one tile
// rank together; reverse: the last tiles first.
__device__ __forceinline__ void block_coords(int heads, int batch,
                                             int ntiles, bool reverse,
                                             int& tile, int& h, int& b) {
  const int per_rank = heads * batch;
  const int rank = blockIdx.x / per_rank, rest = blockIdx.x % per_rank;
  tile = reverse ? ntiles - 1 - rank : rank;
  h = rest % heads;
  b = rest / heads;
}

template <int DP>
struct FwdCfg {
  static constexpr int BQ = 128, BKV = 128, kStages = DP == 64 ? 4 : 3;
  static constexpr int kQ = BQ * DP * 2, kKV = BKV * DP * 2;
  using Bars = Barriers<kStages>;
  // Q, the stages of (K, V), the barriers, the slack for 1024-byte alignment
  static constexpr size_t bytes =
      1024 + kQ + kStages * 2 * kKV + sizeof(Bars);
};

template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, Shape p,
               const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv) {
  using C = FwdCfg<DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, RS = BKV / 2, RO = DP / 2;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* KV = Qs + C::kQ;   // stage s: K at KV + 2 s kKV, V after
  typename C::Bars& bars =
      *reinterpret_cast<typename C::Bars*>(KV + kStages * 2 * C::kKV);
  bars.init(p.vec ? 1 : 32, p.vec ? 1 : 32);

  int qt, h, b;
  block_coords(p.Hq, p.B, (p.Sq + BQ - 1) / BQ, p.causal, qt, h, b);
  const int q0 = qt * BQ, hk = h / (p.Hq / p.Hkv);
  const long qs = static_cast<long>(p.Hq) * p.D;
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  const int t_first = lo / BKV * BKV;
  const int ntiles = lo <= hi ? (hi - t_first) / BKV + 1 : 0;

  if (threadIdx.x >= kConsumers) {         // the producer warpgroup
    wgmma::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x - kConsumers;
    if (p.vec && lane == 0) {
      mbar_expect(&bars.once, C::kQ);
      tma_tile<BQ, DP>(Qs, tq, &bars.once, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int t0 = t_first + it * BKV;
        unsigned char* st = KV + (it % kStages) * 2 * C::kKV;
        uint64_t* full = &bars.full[it % kStages];
        bars.wait_empty(it);
        mbar_expect(full, 2 * C::kKV);
        tma_tile<BKV, DP>(st, tk, full, hk, t0, b);
        tma_tile<BKV, DP>(st + C::kKV, tv, full, hk, t0, b);
      }
    } else if (!p.vec && lane < 32) {
      const long ks = static_cast<long>(p.Hkv) * p.D;
      const bf16* kb = k + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
      const bf16* vb = v + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
      load_elems<BQ, DP>(Qs, q + (static_cast<long>(b) * p.Sq * p.Hq + h) *
                                     p.D, qs, q0, p.Sq, p.D);
      mbar_arrive(&bars.once);
      for (int it = 0; it < ntiles; ++it) {
        const int t0 = t_first + it * BKV;
        unsigned char* st = KV + (it % kStages) * 2 * C::kKV;
        bars.wait_empty(it);
        load_elems<BKV, DP>(st, kb, ks, t0, p.Skv, p.D);
        load_elems<BKV, DP>(st + C::kKV, vb, ks, t0, p.Skv, p.D);
        mbar_arrive(&bars.full[it % kStages]);
      }
    }
    return;
  }
  wgmma::setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x / 128;
  const Frag f;
  const int wq0 = q0 + 64 * wg;            // the warpgroup's first q row
  float o[RO], s[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;
  bars.wait_once();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * BKV;
    const unsigned char* Ks = KV + (it % kStages) * 2 * C::kKV;
    const unsigned char* Vs = Ks + C::kKV;
    bars.wait_full(it);

    // S = Q K^T
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wgmma::kmajor<BQ>(Qs, 64 * wg, kk);
      const uint64_t db = wgmma::kmajor<BKV>(Ks, 0, kk);
      if (kk == 0)
        wgmma::wgmma_ss(s, da, db);
      else
        wgmma::wgmma_ss_acc(s, da, db);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(s);

    // online softmax in the log2 domain; masks only on edge tiles
    if (!all_visible(p, wq0, wq0 + 63, t0, t0 + BKV - 1)) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
        if (!visible(p, wq0 + f.row + 8 * Frag::half(i),
                     t0 + f.col + Frag::cofs(i)))
          s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < RS; ++i)
      mx[Frag::half(i)] = fmaxf(mx[Frag::half(i)], s[i]);
    float mu[2], alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m[hf], quad_max(mx[hf]) * sl2);
      mu[hf] = m_new == -INFINITY ? 0.f : m_new;   // no (-inf) - (-inf)
      alpha[hf] = wgmma::exp2_approx(m[hf] - mu[hf]);
      m[hf] = m_new;
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      s[i] = wgmma::exp2_approx(fmaf(s[i], sl2, -mu[Frag::half(i)]));
      l[Frag::half(i)] += s[i];
    }
#pragma unroll
    for (int i = 0; i < RO; ++i) o[i] *= alpha[Frag::half(i)];

    // O += P V, P from registers
    uint32_t p_frag[BKV / 16][4];
    wgmma::to_frags(s, p_frag);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma::wgmma_rs_acc(o, p_frag[kk], wgmma::mnmajor<BKV>(Vs, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(o);
    bars.release(it);
  }

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    inv[hf] = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
  }
  store_frag(out + (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D, qs, o, f,
             wq0, p.Sq, p.D, inv, p.vec);
  if (threadIdx.x % 4 == 0) {
    float* lb = lse + (static_cast<long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wq0 + f.row + 8 * hf;
      if (row < p.Sq)
        lb[row] = l[hf] > 0.f ? (m[hf] + log2f(l[hf])) * kLn2 : -INFINITY;
    }
  }
}

template <int DP>
struct DqCfg {
  // kv tiles of 128 rows at DP 64; 64 at DP 128, where S, dP and dQ would
  // not fit in registers at 128
  static constexpr int BQ = 128, BKV = DP == 64 ? 128 : 64, kStages = 4;
  static constexpr int kQ = BQ * DP * 2, kKV = BKV * DP * 2;
  using Bars = Barriers<kStages>;
  // Q, dO, the stages of (K, V), the barriers, the alignment slack
  static constexpr size_t bytes =
      1024 + 2 * kQ + kStages * 2 * kKV + sizeof(Bars);
};

// dQ of one (128-row q tile, q head, batch)
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Shape p,
              const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv) {
  using C = DqCfg<DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, RS = BKV / 2, RO = DP / 2;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* dOs = Qs + C::kQ;
  unsigned char* KV = dOs + C::kQ;
  typename C::Bars& bars =
      *reinterpret_cast<typename C::Bars*>(KV + kStages * 2 * C::kKV);
  bars.init(p.vec ? 1 : 32, p.vec ? 1 : 32);

  int qt, h, b;
  block_coords(p.Hq, p.B, (p.Sq + BQ - 1) / BQ, p.causal, qt, h, b);
  const int q0 = qt * BQ, hk = h / (p.Hq / p.Hkv);
  const long qs = static_cast<long>(p.Hq) * p.D;
  const long qoff = (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  const int t_first = lo / BKV * BKV;
  const int ntiles = lo <= hi ? (hi - t_first) / BKV + 1 : 0;

  if (threadIdx.x >= kConsumers) {         // the producer warpgroup
    wgmma::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x - kConsumers;
    if (p.vec && lane == 0) {
      mbar_expect(&bars.once, 2 * C::kQ);
      tma_tile<BQ, DP>(Qs, tq, &bars.once, h, q0, b);
      tma_tile<BQ, DP>(dOs, tdo, &bars.once, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int t0 = t_first + it * BKV;
        unsigned char* st = KV + (it % kStages) * 2 * C::kKV;
        uint64_t* full = &bars.full[it % kStages];
        bars.wait_empty(it);
        mbar_expect(full, 2 * C::kKV);
        tma_tile<BKV, DP>(st, tk, full, hk, t0, b);
        tma_tile<BKV, DP>(st + C::kKV, tv, full, hk, t0, b);
      }
    } else if (!p.vec && lane < 32) {
      const long ks = static_cast<long>(p.Hkv) * p.D;
      const bf16* kb = k + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
      const bf16* vb = v + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
      load_elems<BQ, DP>(Qs, q + qoff, qs, q0, p.Sq, p.D);
      load_elems<BQ, DP>(dOs, dout + qoff, qs, q0, p.Sq, p.D);
      mbar_arrive(&bars.once);
      for (int it = 0; it < ntiles; ++it) {
        const int t0 = t_first + it * BKV;
        unsigned char* st = KV + (it % kStages) * 2 * C::kKV;
        bars.wait_empty(it);
        load_elems<BKV, DP>(st, kb, ks, t0, p.Skv, p.D);
        load_elems<BKV, DP>(st + C::kKV, vb, ks, t0, p.Skv, p.D);
        mbar_arrive(&bars.full[it % kStages]);
      }
    }
    return;
  }
  wgmma::setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x / 128;
  const Frag f;
  const int wq0 = q0 + 64 * wg;
  const long roff = (static_cast<long>(b) * p.Hq + h) * p.Sq;
  // the thread's rows: lse in the log2 domain, +inf where the row sees no
  // key (or lies past Sq) so that its P is 2^-inf = 0; delta
  float lr[2], dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = wq0 + f.row + 8 * hf;
    const float l = row < p.Sq ? lse[roff + row] : -INFINITY;
    lr[hf] = l == -INFINITY ? INFINITY : l * kLog2e;
    dr[hf] = row < p.Sq ? delta[roff + row] : 0.f;
  }
  float acc[RO], s[RS], dp[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) acc[i] = 0.f;
  const float sl2 = p.scale * kLog2e;
  bars.wait_once();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * BKV;
    const unsigned char* Ks = KV + (it % kStages) * 2 * C::kKV;
    const unsigned char* Vs = Ks + C::kKV;
    bars.wait_full(it);

    // S = Q K^T, then dP = dO V^T in flight while P is formed
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wgmma::kmajor<BQ>(Qs, 64 * wg, kk);
      const uint64_t db = wgmma::kmajor<BKV>(Ks, 0, kk);
      if (kk == 0)
        wgmma::wgmma_ss(s, da, db);
      else
        wgmma::wgmma_ss_acc(s, da, db);
    }
    wgmma::commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wgmma::kmajor<BQ>(dOs, 64 * wg, kk);
      const uint64_t db = wgmma::kmajor<BKV>(Vs, 0, kk);
      if (kk == 0)
        wgmma::wgmma_ss(dp, da, db);
      else
        wgmma::wgmma_ss_acc(dp, da, db);
    }
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operand(s);

    // P = exp2(S scale log2e - lse log2e); masks only on edge tiles
    if (!all_visible(p, wq0, wq0 + 63, t0, t0 + BKV - 1)) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
        if (!visible(p, wq0 + f.row + 8 * Frag::half(i),
                     t0 + f.col + Frag::cofs(i)))
          s[i] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < RS; ++i)
      s[i] = wgmma::exp2_approx(fmaf(s[i], sl2, -lr[Frag::half(i)]));
    wgmma::wait<0>();
    wgmma::fence_operand(dp);
    // dS = P (dP - delta)
#pragma unroll
    for (int i = 0; i < RS; ++i) s[i] *= dp[i] - dr[Frag::half(i)];

    // dQ += dS K
    uint32_t ds_frag[BKV / 16][4];
    wgmma::to_frags(s, ds_frag);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma::wgmma_rs_acc(acc, ds_frag[kk], wgmma::mnmajor<BKV>(Ks, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    bars.release(it);
  }
  const float mul[2] = {p.scale, p.scale};
  store_frag(dq + qoff, qs, acc, f, wq0, p.Sq, p.D, mul, p.vec);
}

template <int DP>
struct DkvCfg {
  static constexpr int BKV = 128, BQ = 64, kStages = 4;
  static constexpr int kKV = BKV * DP * 2, kQ = BQ * DP * 2;
  static constexpr int kRows = BQ * 4;     // lse or delta of one q tile
  // a stage: Q, dO, lse, delta, padded to whole 1024-byte swizzle atoms
  static constexpr int kStage = (2 * kQ + 2 * kRows + 1023) / 1024 * 1024;
  using Bars = Barriers<kStages>;
  // K, V, the stages, the barriers, the alignment slack
  static constexpr size_t bytes =
      1024 + 2 * kKV + kStages * kStage + sizeof(Bars);
};

// dK, dV of one (128-row kv tile, kv head, batch), summed over the q heads
// of its group
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Shape p,
               const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv) {
  using C = DkvCfg<DP>;
  constexpr int BKV = C::BKV, BQ = C::BQ, RS = BQ / 2, RO = DP / 2;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + C::kKV;
  unsigned char* QD = Vs + C::kKV;   // stage s: Q, dO, lse, delta
  typename C::Bars& bars =
      *reinterpret_cast<typename C::Bars*>(QD + kStages * C::kStage);
  // a stage's fill: lane 0 arms TMA for Q and dO (vec) and all 32 lanes
  // copy lse and delta
  bars.init(p.vec ? 33 : 32, p.vec ? 1 : 32);

  int kt, hk, b;
  block_coords(p.Hkv, p.B, (p.Skv + BKV - 1) / BKV, false, kt, hk, b);
  const int k0 = kt * BKV, group = p.Hq / p.Hkv;
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const long kvoff = (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  int lo, hi;
  q_band(p, k0, min(k0 + BKV, p.Skv) - 1, lo, hi);
  const int qt_first = lo / BQ;
  const int nq = lo <= hi ? hi / BQ - qt_first + 1 : 0;
  const int niter = group * nq;            // (q head, q tile) pairs

  if (threadIdx.x >= kConsumers) {         // the producer warpgroup
    wgmma::setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x - kConsumers;
    if (lane >= 32) return;
    if (p.vec && lane == 0) {
      mbar_expect(&bars.once, 2 * C::kKV);
      tma_tile<BKV, DP>(Ks, tk, &bars.once, hk, k0, b);
      tma_tile<BKV, DP>(Vs, tv, &bars.once, hk, k0, b);
    } else if (!p.vec) {
      load_elems<BKV, DP>(Ks, k + kvoff, ks, k0, p.Skv, p.D);
      load_elems<BKV, DP>(Vs, v + kvoff, ks, k0, p.Skv, p.D);
      mbar_arrive(&bars.once);
    }
    const long qs = static_cast<long>(p.Hq) * p.D;
    for (int it = 0; it < niter; ++it) {
      const int h = hk * group + it / nq, q0 = (qt_first + it % nq) * BQ;
      const long qoff = (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
      const long roff = (static_cast<long>(b) * p.Hq + h) * p.Sq;
      unsigned char* st = QD + (it % kStages) * C::kStage;
      uint64_t* full = &bars.full[it % kStages];
      float* rows = reinterpret_cast<float*>(st + 2 * C::kQ);
      bars.wait_empty(it);
      if (p.vec && lane == 0) {
        mbar_expect(full, 2 * C::kQ);
        tma_tile<BQ, DP>(st, tq, full, h, q0, b);
        tma_tile<BQ, DP>(st + C::kQ, tdo, full, h, q0, b);
      } else if (!p.vec) {
        load_elems<BQ, DP>(st, q + qoff, qs, q0, p.Sq, p.D);
        load_elems<BQ, DP>(st + C::kQ, dout + qoff, qs, q0, p.Sq, p.D);
      }
      for (int r = lane; r < BQ; r += 32) {
        const bool ok = q0 + r < p.Sq;
        cp_async4(rows + r, ok ? lse + roff + q0 + r : lse, ok);
        cp_async4(rows + BQ + r, ok ? delta + roff + q0 + r : delta, ok);
      }
      if (p.vec) {
        mbar_arrive_copies(full);
      } else {                           // element stores need a release
        cp_async_wait<0>();
        mbar_arrive(full);
      }
    }
    cp_async_wait<0>();
    return;
  }
  wgmma::setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x / 128;
  const Frag f;
  const int wk0 = k0 + 64 * wg;            // the warpgroup's first kv row
  float gk[RO], gv[RO], st[RS], dpt[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) gk[i] = gv[i] = 0.f;
  const float sl2 = p.scale * kLog2e;
  bars.wait_once();
  for (int it = 0; it < niter; ++it) {
    const int q0 = (qt_first + it % nq) * BQ;
    const unsigned char* Qt = QD + (it % kStages) * C::kStage;
    const unsigned char* dOt = Qt + C::kQ;
    const float* lse_s = reinterpret_cast<const float*>(Qt + 2 * C::kQ);
    const float* delta_s = lse_s + BQ;
    bars.wait_full(it);

    // S^T = K Q^T, then dP^T = V dO^T in flight while P^T is formed
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wgmma::kmajor<BKV>(Ks, 64 * wg, kk);
      const uint64_t db = wgmma::kmajor<BQ>(Qt, 0, kk);
      if (kk == 0)
        wgmma::wgmma_ss(st, da, db);
      else
        wgmma::wgmma_ss_acc(st, da, db);
    }
    wgmma::commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = wgmma::kmajor<BKV>(Vs, 64 * wg, kk);
      const uint64_t db = wgmma::kmajor<BQ>(dOt, 0, kk);
      if (kk == 0)
        wgmma::wgmma_ss(dpt, da, db);
      else
        wgmma::wgmma_ss_acc(dpt, da, db);
    }
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operand(st);

    // the thread's q columns (RS / 2 of them): lse in the log2 domain,
    // +inf where the row sees no key (P = 2^-inf = 0), and delta
    float lcol[RS / 2], dcol[RS / 2];
#pragma unroll
    for (int j = 0; j < RS / 2; ++j) {
      const int c = f.col + 8 * (j / 2) + j % 2;
      const float lc = lse_s[c];
      lcol[j] = lc == -INFINITY ? INFINITY : lc * kLog2e;
      dcol[j] = delta_s[c];
    }
    // P^T = exp2(S^T scale log2e - lse log2e); masks only on edge tiles
    if (!all_visible(p, q0, q0 + BQ - 1, wk0, wk0 + 63)) {
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int qi = q0 + f.col + Frag::cofs(i);
        if (qi >= p.Sq ||
            !visible(p, qi, wk0 + f.row + 8 * Frag::half(i)))
          st[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i)
      st[i] = wgmma::exp2_approx(fmaf(st[i], sl2, -lcol[i / 4 * 2 + i % 2]));
    // dV += P^T dO, in flight while dS^T is formed
    uint32_t p_frag[BQ / 16][4];
    wgmma::to_frags(st, p_frag);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma::wgmma_rs_acc(gv, p_frag[kk], wgmma::mnmajor<BQ>(dOt, kk));
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operand(dpt);
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int i = 0; i < RS; ++i)
      dpt[i] = st[i] * (dpt[i] - dcol[i / 4 * 2 + i % 2]);

    // dK += dS^T Q
    uint32_t ds_frag[BQ / 16][4];
    wgmma::to_frags(dpt, ds_frag);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma::wgmma_rs_acc(gk, ds_frag[kk], wgmma::mnmajor<BQ>(Qt, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(gv);
    wgmma::fence_operand(gk);
    bars.release(it);
  }
  const float mk[2] = {p.scale, p.scale}, mv[2] = {1.f, 1.f};
  store_frag(dk + kvoff, ks, gk, f, wk0, p.Skv, p.D, mk, p.vec);
  store_frag(dv + kvoff, ks, gv, f, wk0, p.Skv, p.D, mv, p.vec);
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

// Launches `kern` on `blocks` blocks of `threads` with `bytes` of shared
// memory, raising its limit on the first launch.
template <typename K, typename... Args>
cudaError_t launch(K kern, bool& smem_set, dim3 blocks, int threads,
                   size_t bytes, cudaStream_t s, Args... args) {
  cudaError_t e = allow_smem(kern, bytes, smem_set);
  if (e != cudaSuccess) return e;
  kern<<<blocks, threads, bytes, s>>>(args...);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int DP>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    float* lse, const Shape& p, cudaStream_t s) {
  using L = Tiles<DP>;
  static bool smem_set = false;
  return launch(flash_fwd_f32<DP>, smem_set, dim3(cdiv(p.Sq, L::BQ), p.Hq,
                                                  p.B),
                kThreads, L::fwd_bytes, s, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(out), lse, p);
}

// A TMA map of a contiguous (B, S, H, D) bf16 tensor as 4-D (D, H, S, B),
// read in boxes of 64 columns x `rows` rows of one head, 128-byte
// swizzled; out-of-range elements read 0. Built on the host for every
// call and passed by value (__grid_constant__), so CUDA graph captures
// hold their own. Needs the vec shape (rows of whole 16-byte chunks,
// 16-byte aligned base).
cudaError_t bshd_map(CUtensorMap* map, const void* base, int B, int S, int H,
                     int D, int rows) {
  EncodeTiled encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(H) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row,
                                 row * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps of q-shaped (B, Sq, Hq, D) and kv-shaped (B, Skv, Hkv, D) tensors
// in boxes of qrows and kvrows rows; left zero (unused) for the
// element-load variant.
struct Maps {
  CUtensorMap q{}, dout{}, k{}, v{};
  cudaError_t build(const Shape& p, const void* qp, const void* dop,
                    const void* kp, const void* vp, int qrows, int kvrows) {
    if (!p.vec) return cudaSuccess;
    cudaError_t e = bshd_map(&q, qp, p.B, p.Sq, p.Hq, p.D, qrows);
    if (e == cudaSuccess && dop != nullptr)
      e = bshd_map(&dout, dop, p.B, p.Sq, p.Hq, p.D, qrows);
    if (e == cudaSuccess) e = bshd_map(&k, kp, p.B, p.Skv, p.Hkv, p.D, kvrows);
    if (e == cudaSuccess) e = bshd_map(&v, vp, p.B, p.Skv, p.Hkv, p.D, kvrows);
    return e;
  }
};

template <int DP>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     float* lse, const Shape& p, cudaStream_t s) {
  using C = FwdCfg<DP>;
  Maps m;
  cudaError_t e = m.build(p, q, nullptr, k, v, C::BQ, C::BKV);
  if (e != cudaSuccess) return e;
  static bool smem_set = false;
  return launch(flash_fwd_bf16<DP>, smem_set,
                dim3(cdiv(p.Sq, C::BQ) * p.Hq * p.B), kWsThreads, C::bytes, s,
                static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, p,
                m.q, m.k, m.v);
}

template <typename T>
cudaError_t delta_pass(const void* out, const void* dout, float* delta,
                       const Shape& p, cudaStream_t s) {
  const long rows = static_cast<long>(p.B) * p.Sq * p.Hq;
  flash_delta_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv,
                    const Shape& p, cudaStream_t s) {
  using L = Tiles<DP>;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  cudaError_t e = delta_pass<float>(out, dout, delta, p, s);
  if (e != cudaSuccess) return e;
  static bool smem_a = false, smem_b = false;
  e = launch(flash_dkv_f32<DP>, smem_a, dim3(cdiv(p.Skv, L::BKV), p.Hkv, p.B),
             kThreads, L::dkv_bytes, s, qt, kt, vt, dot, lse,
             static_cast<const float*>(delta), static_cast<float*>(dk),
             static_cast<float*>(dv), p);
  if (e != cudaSuccess) return e;
  return launch(flash_dq_f32<DP>, smem_b, dim3(cdiv(p.Sq, L::BQ), p.Hq, p.B),
                kThreads, L::dq_bytes, s, qt, kt, vt, dot, lse,
                static_cast<const float*>(delta), static_cast<float*>(dq), p);
}

template <int DP>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv,
                     const Shape& p, cudaStream_t s) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  using A = DkvCfg<DP>;
  using Bq = DqCfg<DP>;
  Maps ma, mb;
  cudaError_t e = ma.build(p, q, dout, k, v, A::BQ, A::BKV);
  if (e == cudaSuccess) e = mb.build(p, q, dout, k, v, Bq::BQ, Bq::BKV);
  if (e == cudaSuccess) e = delta_pass<bf16>(out, dout, delta, p, s);
  if (e != cudaSuccess) return e;
  static bool smem_a = false, smem_b = false;
  e = launch(flash_dkv_bf16<DP>, smem_a,
             dim3(cdiv(p.Skv, A::BKV) * p.Hkv * p.B), kWsThreads, A::bytes, s,
             qt, kt, vt, dot, lse, static_cast<const float*>(delta),
             static_cast<bf16*>(dk), static_cast<bf16*>(dv), p, ma.q, ma.dout,
             ma.k, ma.v);
  if (e != cudaSuccess) return e;
  return launch(flash_dq_bf16<DP>, smem_b,
                dim3(cdiv(p.Sq, Bq::BQ) * p.Hq * p.B), kWsThreads, Bq::bytes,
                s, qt, kt, vt, dot, lse, static_cast<const float*>(delta),
                static_cast<bf16*>(dq), p, mb.q, mb.dout, mb.k, mb.v);
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* ptr : ptrs)
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16) return false;
  return true;
}

// The shape, or false if the entry points refuse it. vec (the 16-byte
// copy variant): rows of whole 16-byte chunks and 16-byte aligned
// pointers; otherwise the kernels load element by element.
bool make_shape(Shape& p, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                int causal, int window, int kv_offset, float scale, int dtype,
                std::initializer_list<const void*> ptrs) {
  if ((dtype != 0 && dtype != 1) || B <= 0 || Sq <= 0 || Skv <= 0 ||
      Hq <= 0 || Hkv <= 0 || D <= 0 || D > 128 || Hq % Hkv || Hq > 65535 ||
      B > 65535)
    return false;
  const int elem_bytes = dtype == 1 ? 2 : 4;
  p = Shape{B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset, scale, 0};
  p.vec = (D * elem_bytes) % 16 == 0 && aligned16(ptrs);
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
  if (!make_shape(p, B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset, scale,
                  dtype, {q, k, v, out}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return static_cast<int>(D <= 64 ? fwd_bf16<64>(q, k, v, out, l, p, s)
                                    : fwd_bf16<128>(q, k, v, out, l, p, s));
  return static_cast<int>(D <= 64 ? fwd_f32<64>(q, k, v, out, l, p, s)
                                  : fwd_f32<128>(q, k, v, out, l, p, s));
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
  if (!make_shape(p, B, Sq, Skv, Hq, Hkv, D, causal, window, kv_offset, scale,
                  dtype, {q, k, v, dout, dq, dk, dv}))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == 1)
    return static_cast<int>(
        D <= 64 ? bwd_bf16<64>(q, k, v, out, dout, l, d, dq, dk, dv, p, s)
                : bwd_bf16<128>(q, k, v, out, dout, l, d, dq, dk, dv, p, s));
  return static_cast<int>(
      D <= 64 ? bwd_f32<64>(q, k, v, out, dout, l, d, dq, dk, dv, p, s)
              : bwd_f32<128>(q, k, v, out, dout, l, d, dq, dk, dv, p, s));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
