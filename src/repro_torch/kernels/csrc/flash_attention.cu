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
// f32 (every reduced config, the [jamba] run, and any f32 model): 3xTF32
// on wgmma (wgmma_tf32.cuh). Each f32 operand is split into big =
// tf32(x) and small = tf32(x - big), and a product becomes small big +
// big small + big big in one f32 accumulator in registers, which holds
// f32's tolerances (a TF32 product alone does not). Its cap is a third of
// the TF32 rate, 494.7 / 3 = 165 TFLOP/s, against 67 for CUDA-core FMAs.
//  * tf32 operands in shared memory must be K-major (wgmma transposes
//    16-bit types only, TMA no 4-byte ones), and each needs a big and a
//    small tile, four times a bf16 tile. So a block is two warpgroups of
//    other roles than the bf16 kernels': the producer loads each tile
//    into registers (16-byte loads where rows are whole 16-byte chunks
//    and the pointers aligned, else element by element; the next tile
//    before it waits for a free stage), then
//    splits it and stores both halves swizzled, transposing the operands
//    a product reads MN-major (V in P V, K in dS K, Q and dO in the dK and
//    dV products) and using the same registers for a tile read both ways
//    (K in the dQ kernel; Q and dO in the dK/dV kernel). The consumer
//    warpgroup owns 64 rows and runs the products. P and dS feed their
//    products as register A fragments, split in registers; the B tile's
//    depth is permuted (perm8) to match the accumulator's columns.
//  * tiles (head dims padded to 32, 64, 96 or 128): forward 64 q rows x
//    64 keys (32 above DP 64), two stages; dQ 64 q rows x 64 keys at DP
//    32, 32 keys above, two stages up to DP 64 and one above; dK/dV 64
//    keys x 64 q rows at DP 32, 32 at DP 64 and 96, 16 at 128 (a
//    transposed tile's depth padded to one 32-float panel), two stages up
//    to DP 64 and one above. Budget at DP 128, the largest: forward 64 KB
//    of Q + 2 x 64 KB of K and V^T = 193 KB; dQ 128 KB of Q and dO + 96
//    KB of K, V and K^T = 225 KB; dK/dV 128 KB of K and V + 97 KB of Q,
//    dO, Q^T, dO^T, lse and delta = 226 KB (of 227).
//  * masks, ragged S and D, rows that see no key, the GQA sum in
//    registers and no atomics: as in the bf16 kernels; the backward is the
//    same delta pre-pass, a dK/dV kernel and a dQ kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "sm90_async.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace sm90;

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;              // the delta pre-pass: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// f32: 3xTF32 on wgmma (wgmma_tf32.cuh). A block is two warpgroups: the
// consumer (warpgroup 0) runs the products with its accumulators in
// registers; the producer (warpgroup 1) loads tiles into registers,
// splits them into big and small halves and stores them K-major (and
// transposed where a product reads them MN-major) into a ring of stages,
// signalled by mbarriers. It loads the next tile before it waits for a
// free stage, so the loads overlap the consumer's products.
// ---------------------------------------------------------------------
namespace t3 = wgmma::tf32;
constexpr int kT3Threads = 256;

// depth K padded to whole 128-byte panels (32 floats)
constexpr int panel_width(int k) { return (k + 31) / 32 * 32; }

// head dims up to 128 in tiles of 32, 64, 96 or 128 columns
constexpr int t3_dp(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 96 ? 96 : 128; }

// 4 floats of row `row` (< nrows), columns c .. c + 3 (< D) of a (rows,
// stride) matrix, 0 out of range: one 16-byte load where rows are whole
// 16-byte chunks and the pointers aligned (vec), else element by element
__device__ __forceinline__ float4 ld4(const float* g, long stride, int row,
                                      int nrows, int c, int D, bool vec) {
  if (row >= nrows || c >= D) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* r = g + row * stride + c;
  if (vec) return __ldg(reinterpret_cast<const float4*>(r));
  return make_float4(r[0], c + 1 < D ? r[1] : 0.f, c + 2 < D ? r[2] : 0.f,
                     c + 3 < D ? r[3] : 0.f);
}

// Store a thread's two rows of an m64nDP accumulator times mul[half]:
// rows row0 + f.row (+ 8) of a (rows, stride) f32 matrix, columns < D,
// rows < nrows; pairs as float2 where vec.
template <int R>
__device__ __forceinline__ void store_frag_f32(float* g, long stride,
                                               const float (&d)[R],
                                               const Frag& f, int row0,
                                               int nrows, int D,
                                               const float (&mul)[2],
                                               bool vec) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + f.row + 8 * hf;
    if (row >= nrows) continue;
    float* gr = g + row * stride;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int c = f.col + 8 * j;
      const float x = d[4 * j + 2 * hf] * mul[hf];
      const float y = d[4 * j + 2 * hf + 1] * mul[hf];
      if (vec) {
        if (c < D) *reinterpret_cast<float2*>(gr + c) = make_float2(x, y);
      } else {
        if (c < D) gr[c] = x;
        if (c + 1 < D) gr[c + 1] = y;
      }
    }
  }
}

template <int DP>
struct T3FwdCfg {
  static constexpr int BQ = 64, BKV = DP <= 64 ? 64 : 32, kStages = 2;
  static constexpr int kQ = BQ * DP * 4;                // a half of Q
  static constexpr int kK = BKV * DP * 4;               // a half of K
  static constexpr int kV = DP * panel_width(BKV) * 4;  // a half of V^T
  static constexpr int kStage = 2 * kK + 2 * kV;
  using Ring = t3::Ring<kStages, 4>;
  // Q, the stages, the barriers, the slack for 1024-byte alignment
  static constexpr size_t bytes =
      1024 + 2 * kQ + kStages * kStage + sizeof(Ring);
};

// Forward of one (64-row q tile, q head, batch): S = Q K^T and O += P V,
// P from registers; V^T is stored with its keys permuted by perm8.
template <int DP>
__global__ void __launch_bounds__(kT3Threads, 1)
flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, Shape p) {
  using C = T3FwdCfg<DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, RS = BKV / 2, RO = DP / 2;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qt = align1024(smem_raw);      // big, then small
  unsigned char* KV = Qt + 2 * C::kQ;           // stage: K big, small, V^T
  typename C::Ring& ring =
      *reinterpret_cast<typename C::Ring*>(KV + kStages * C::kStage);
  ring.init();

  int qt, h, b;
  block_coords(p.Hq, p.B, (p.Sq + BQ - 1) / BQ, p.causal, qt, h, b);
  const int q0 = qt * BQ, hk = h / (p.Hq / p.Hkv);
  const long qs = static_cast<long>(p.Hq) * p.D;
  const long ks = static_cast<long>(p.Hkv) * p.D;
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  const int t_first = lo / BKV * BKV;
  const int ntiles = lo <= hi ? (hi - t_first) / BKV + 1 : 0;

  if (threadIdx.x >= 128) {                // the producer warpgroup
    using WQ = t3::Walk<BQ, DP, 128>;
    using WK = t3::Walk<BKV, DP, 128>;
    const float* qb = q + (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
    const float* kb = k + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
    const float* vb = v + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
#pragma unroll
    for (int j = 0; j < WQ::kIters; ++j) {
      int r, c;
      WQ::at(j, r, c);
      t3::store_plain<BQ>(Qt, Qt + C::kQ, r, c,
                          ld4(qb, qs, q0 + r, p.Sq, c, p.D, p.vec));
    }
    ring.filled(&ring.once);
    float4 kr[WK::kIters], vr[WK::kIters];
    for (int it = 0; it < ntiles; ++it) {
      const int t0 = t_first + it * BKV;
#pragma unroll
      for (int j = 0; j < WK::kIters; ++j) {
        int r, c;
        WK::at(j, r, c);
        kr[j] = ld4(kb, ks, t0 + r, p.Skv, c, p.D, p.vec);
        vr[j] = ld4(vb, ks, t0 + r, p.Skv, c, p.D, p.vec);
      }
      ring.wait_empty(it);
      unsigned char* st = KV + (it % kStages) * C::kStage;
#pragma unroll
      for (int j = 0; j < WK::kIters; ++j) {
        int r, c;
        WK::at(j, r, c);
        t3::store_plain<BKV>(st, st + C::kK, r, c, kr[j]);
        t3::store_trans<DP, true>(st + 2 * C::kK, st + 2 * C::kK + C::kV, c,
                                  r, vr[j]);
      }
      ring.filled(&ring.full[it % kStages]);
    }
    return;
  }

  const Frag f;
  float o[RO], s[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;
  ring.wait_once();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * BKV;
    const unsigned char* Kt = KV + (it % kStages) * C::kStage;
    const unsigned char* Vt = Kt + 2 * C::kK;
    ring.wait_full(it);

    // S = Q K^T
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      t3::mma3_ss<BKV>(s, t3::kmajor<BQ>(Qt, 0, kk),
                       t3::kmajor<BQ>(Qt + C::kQ, 0, kk),
                       t3::kmajor<BKV>(Kt, 0, kk),
                       t3::kmajor<BKV>(Kt + C::kK, 0, kk), kk > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(s);

    // online softmax in the log2 domain; masks only on edge tiles
    if (!all_visible(p, q0, q0 + BQ - 1, t0, t0 + BKV - 1)) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
        if (!visible(p, q0 + f.row + 8 * Frag::half(i),
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

    // O += P V, P split in registers
    uint32_t pb[BKV / 8][4], ps[BKV / 8][4];
    t3::to_frags(s, pb, ps);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 8; ++kk)
      t3::mma3_rs<DP>(o, pb[kk], ps[kk], t3::kmajor<DP>(Vt, 0, kk),
                      t3::kmajor<DP>(Vt + C::kV, 0, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(o);
    ring.release(it);
  }

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    inv[hf] = l[hf] > 0.f ? 1.f / l[hf] : 0.f;
  }
  store_frag_f32(out + (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D, qs, o,
                 f, q0, p.Sq, p.D, inv, p.vec);
  if (threadIdx.x % 4 == 0) {
    float* lb = lse + (static_cast<long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + f.row + 8 * hf;
      if (row < p.Sq)
        lb[row] = l[hf] > 0.f ? (m[hf] + log2f(l[hf])) * kLn2 : -INFINITY;
    }
  }
}

template <int DP>
struct T3DqCfg {
  static constexpr int BQ = 64, BKV = DP <= 32 ? 64 : 32;
  static constexpr int kStages = DP <= 64 ? 2 : 1;
  static constexpr int kQ = BQ * DP * 4;                 // a half of Q or dO
  static constexpr int kK = BKV * DP * 4;                // a half of K or V
  static constexpr int kKt = DP * panel_width(BKV) * 4;  // a half of K^T
  static constexpr int kStage = 4 * kK + 2 * kKt;        // K, V, K^T
  using Ring = t3::Ring<kStages, 4>;
  static constexpr size_t bytes =
      1024 + 4 * kQ + kStages * kStage + sizeof(Ring);
};

// dQ of one (64-row q tile, q head, batch): S = Q K^T, dP = dO V^T,
// dQ += dS K with dS from registers (K^T stored with keys permuted).
template <int DP>
__global__ void __launch_bounds__(kT3Threads, 1)
flash_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Shape p) {
  using C = T3DqCfg<DP>;
  constexpr int BQ = C::BQ, BKV = C::BKV, RS = BKV / 2, RO = DP / 2;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qt = align1024(smem_raw);      // Q big, small, dO big, small
  unsigned char* dOt = Qt + 2 * C::kQ;
  unsigned char* KV = Qt + 4 * C::kQ;           // stage: K, V, K^T
  typename C::Ring& ring =
      *reinterpret_cast<typename C::Ring*>(KV + kStages * C::kStage);
  ring.init();

  int qt, h, b;
  block_coords(p.Hq, p.B, (p.Sq + BQ - 1) / BQ, p.causal, qt, h, b);
  const int q0 = qt * BQ, hk = h / (p.Hq / p.Hkv);
  const long qs = static_cast<long>(p.Hq) * p.D;
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const long qoff = (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
  int lo, hi;
  kv_band(p, q0, min(q0 + BQ, p.Sq) - 1, lo, hi);
  const int t_first = lo / BKV * BKV;
  const int ntiles = lo <= hi ? (hi - t_first) / BKV + 1 : 0;

  if (threadIdx.x >= 128) {                // the producer warpgroup
    using WQ = t3::Walk<BQ, DP, 128>;
    using WK = t3::Walk<BKV, DP, 128>;
    const float* kb = k + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
    const float* vb = v + (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
#pragma unroll
    for (int j = 0; j < WQ::kIters; ++j) {
      int r, c;
      WQ::at(j, r, c);
      t3::store_plain<BQ>(Qt, Qt + C::kQ, r, c,
                          ld4(q + qoff, qs, q0 + r, p.Sq, c, p.D, p.vec));
      t3::store_plain<BQ>(dOt, dOt + C::kQ, r, c,
                          ld4(dout + qoff, qs, q0 + r, p.Sq, c, p.D, p.vec));
    }
    ring.filled(&ring.once);
    float4 kr[WK::kIters], vr[WK::kIters];
    for (int it = 0; it < ntiles; ++it) {
      const int t0 = t_first + it * BKV;
#pragma unroll
      for (int j = 0; j < WK::kIters; ++j) {
        int r, c;
        WK::at(j, r, c);
        kr[j] = ld4(kb, ks, t0 + r, p.Skv, c, p.D, p.vec);
        vr[j] = ld4(vb, ks, t0 + r, p.Skv, c, p.D, p.vec);
      }
      ring.wait_empty(it);
      unsigned char* st = KV + (it % kStages) * C::kStage;
#pragma unroll
      for (int j = 0; j < WK::kIters; ++j) {
        int r, c;
        WK::at(j, r, c);
        t3::store_plain<BKV>(st, st + C::kK, r, c, kr[j]);
        t3::store_plain<BKV>(st + 2 * C::kK, st + 3 * C::kK, r, c, vr[j]);
        t3::store_trans<DP, true>(st + 4 * C::kK, st + 4 * C::kK + C::kKt, c,
                                  r, kr[j]);
      }
      ring.filled(&ring.full[it % kStages]);
    }
    return;
  }

  const Frag f;
  const long roff = (static_cast<long>(b) * p.Hq + h) * p.Sq;
  // the thread's rows: lse in the log2 domain, +inf where the row sees no
  // key (or lies past Sq) so that its P is 2^-inf = 0; delta
  float lr[2], dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + f.row + 8 * hf;
    const float l = row < p.Sq ? lse[roff + row] : -INFINITY;
    lr[hf] = l == -INFINITY ? INFINITY : l * kLog2e;
    dr[hf] = row < p.Sq ? delta[roff + row] : 0.f;
  }
  float acc[RO], s[RS], dp[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) acc[i] = 0.f;
  const float sl2 = p.scale * kLog2e;
  ring.wait_once();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_first + it * BKV;
    const unsigned char* Kt = KV + (it % kStages) * C::kStage;
    const unsigned char* Vt = Kt + 2 * C::kK;
    const unsigned char* KTt = Kt + 4 * C::kK;
    ring.wait_full(it);

    // S = Q K^T, then dP = dO V^T in flight while P is formed
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      t3::mma3_ss<BKV>(s, t3::kmajor<BQ>(Qt, 0, kk),
                       t3::kmajor<BQ>(Qt + C::kQ, 0, kk),
                       t3::kmajor<BKV>(Kt, 0, kk),
                       t3::kmajor<BKV>(Kt + C::kK, 0, kk), kk > 0);
    wgmma::commit();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      t3::mma3_ss<BKV>(dp, t3::kmajor<BQ>(dOt, 0, kk),
                       t3::kmajor<BQ>(dOt + C::kQ, 0, kk),
                       t3::kmajor<BKV>(Vt, 0, kk),
                       t3::kmajor<BKV>(Vt + C::kK, 0, kk), kk > 0);
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operand(s);

    // P = exp2(S scale log2e - lse log2e); masks only on edge tiles
    if (!all_visible(p, q0, q0 + BQ - 1, t0, t0 + BKV - 1)) {
#pragma unroll
      for (int i = 0; i < RS; ++i)
        if (!visible(p, q0 + f.row + 8 * Frag::half(i),
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

    // dQ += dS K, dS split in registers
    uint32_t db[BKV / 8][4], ds[BKV / 8][4];
    t3::to_frags(s, db, ds);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 8; ++kk)
      t3::mma3_rs<DP>(acc, db[kk], ds[kk], t3::kmajor<DP>(KTt, 0, kk),
                      t3::kmajor<DP>(KTt + C::kKt, 0, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    ring.release(it);
  }
  const float mul[2] = {p.scale, p.scale};
  store_frag_f32(dq + qoff, qs, acc, f, q0, p.Sq, p.D, mul, p.vec);
}

template <int DP>
struct T3DkvCfg {
  static constexpr int BKV = 64;
  static constexpr int BQ = DP <= 32 ? 64 : DP <= 96 ? 32 : 16;
  static constexpr int kStages = DP <= 64 ? 2 : 1;
  static constexpr int kK = BKV * DP * 4;                // a half of K or V
  static constexpr int kQ = BQ * DP * 4;                 // a half of Q or dO
  static constexpr int kQt = DP * panel_width(BQ) * 4;   // a half of Q^T, dO^T
  // a stage: Q, dO, Q^T, dO^T (big and small each), lse, delta; padded to
  // whole 1024-byte swizzle atoms
  static constexpr int kStage =
      (4 * kQ + 4 * kQt + 2 * BQ * 4 + 1023) / 1024 * 1024;
  using Ring = t3::Ring<kStages, 4>;
  static constexpr size_t bytes =
      1024 + 4 * kK + kStages * kStage + sizeof(Ring);
};

// dK, dV of one (64-row kv tile, kv head, batch), summed over the q heads
// of its group: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T from registers (dO^T and Q^T stored with
// the q rows permuted).
template <int DP>
__global__ void __launch_bounds__(kT3Threads, 1)
flash_dkv_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, Shape p) {
  using C = T3DkvCfg<DP>;
  constexpr int BKV = C::BKV, BQ = C::BQ, RS = BQ / 2, RO = DP / 2;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Kt = align1024(smem_raw);      // K big, small, V big, small
  unsigned char* Vt = Kt + 2 * C::kK;
  unsigned char* QD = Kt + 4 * C::kK;           // the stages
  typename C::Ring& ring =
      *reinterpret_cast<typename C::Ring*>(QD + kStages * C::kStage);
  ring.init();

  int kt, hk, b;
  block_coords(p.Hkv, p.B, (p.Skv + BKV - 1) / BKV, false, kt, hk, b);
  const int k0 = kt * BKV, group = p.Hq / p.Hkv;
  const long qs = static_cast<long>(p.Hq) * p.D;
  const long ks = static_cast<long>(p.Hkv) * p.D;
  const long kvoff = (static_cast<long>(b) * p.Skv * p.Hkv + hk) * p.D;
  int lo, hi;
  q_band(p, k0, min(k0 + BKV, p.Skv) - 1, lo, hi);
  const int qt_first = lo / BQ;
  const int nq = lo <= hi ? hi / BQ - qt_first + 1 : 0;
  const int niter = group * nq;            // (q head, q tile) pairs

  if (threadIdx.x >= 128) {                // the producer warpgroup
    using WK = t3::Walk<BKV, DP, 128>;
    using WQ = t3::Walk<BQ, DP, 128>;
#pragma unroll
    for (int j = 0; j < WK::kIters; ++j) {
      int r, c;
      WK::at(j, r, c);
      t3::store_plain<BKV>(Kt, Kt + C::kK, r, c,
                           ld4(k + kvoff, ks, k0 + r, p.Skv, c, p.D, p.vec));
      t3::store_plain<BKV>(Vt, Vt + C::kK, r, c,
                           ld4(v + kvoff, ks, k0 + r, p.Skv, c, p.D, p.vec));
    }
    ring.filled(&ring.once);
    const int pt = threadIdx.x - 128;
    float4 qr[WQ::kIters], dr[WQ::kIters];
    float lr = 0.f, dlt = 0.f;
    for (int it = 0; it < niter; ++it) {
      const int h = hk * group + it / nq, q0 = (qt_first + it % nq) * BQ;
      const long qoff = (static_cast<long>(b) * p.Sq * p.Hq + h) * p.D;
      const long roff = (static_cast<long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
      for (int j = 0; j < WQ::kIters; ++j) {
        int r, c;
        WQ::at(j, r, c);
        qr[j] = ld4(q + qoff, qs, q0 + r, p.Sq, c, p.D, p.vec);
        dr[j] = ld4(dout + qoff, qs, q0 + r, p.Sq, c, p.D, p.vec);
      }
      if (pt < BQ) {
        const bool ok = q0 + pt < p.Sq;
        lr = ok ? lse[roff + q0 + pt] : -INFINITY;
        dlt = ok ? delta[roff + q0 + pt] : 0.f;
      }
      ring.wait_empty(it);
      unsigned char* st = QD + (it % kStages) * C::kStage;
      unsigned char* Qts = st + 4 * C::kQ;      // Q^T, then dO^T
#pragma unroll
      for (int j = 0; j < WQ::kIters; ++j) {
        int r, c;
        WQ::at(j, r, c);
        t3::store_plain<BQ>(st, st + C::kQ, r, c, qr[j]);
        t3::store_plain<BQ>(st + 2 * C::kQ, st + 3 * C::kQ, r, c, dr[j]);
        t3::store_trans<DP, true>(Qts, Qts + C::kQt, c, r, qr[j]);
        t3::store_trans<DP, true>(Qts + 2 * C::kQt, Qts + 3 * C::kQt, c, r,
                                  dr[j]);
      }
      if (pt < BQ) {
        float* rows = reinterpret_cast<float*>(Qts + 4 * C::kQt);
        rows[pt] = lr;
        rows[BQ + pt] = dlt;
      }
      ring.filled(&ring.full[it % kStages]);
    }
    return;
  }

  const Frag f;
  float gk[RO], gv[RO], st[RS], dpt[RS];
#pragma unroll
  for (int i = 0; i < RO; ++i) gk[i] = gv[i] = 0.f;
  const float sl2 = p.scale * kLog2e;
  ring.wait_once();
  for (int it = 0; it < niter; ++it) {
    const int q0 = (qt_first + it % nq) * BQ;
    const unsigned char* Qt = QD + (it % kStages) * C::kStage;
    const unsigned char* dOt = Qt + 2 * C::kQ;
    const unsigned char* QTt = Qt + 4 * C::kQ;
    const unsigned char* dOTt = QTt + 2 * C::kQt;
    const float* lse_s = reinterpret_cast<const float*>(QTt + 4 * C::kQt);
    const float* delta_s = lse_s + BQ;
    ring.wait_full(it);

    // S^T = K Q^T, then dP^T = V dO^T in flight while P^T is formed
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      t3::mma3_ss<BQ>(st, t3::kmajor<BKV>(Kt, 0, kk),
                      t3::kmajor<BKV>(Kt + C::kK, 0, kk),
                      t3::kmajor<BQ>(Qt, 0, kk),
                      t3::kmajor<BQ>(Qt + C::kQ, 0, kk), kk > 0);
    wgmma::commit();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      t3::mma3_ss<BQ>(dpt, t3::kmajor<BKV>(Vt, 0, kk),
                      t3::kmajor<BKV>(Vt + C::kK, 0, kk),
                      t3::kmajor<BQ>(dOt, 0, kk),
                      t3::kmajor<BQ>(dOt + C::kQ, 0, kk), kk > 0);
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
    if (!all_visible(p, q0, q0 + BQ - 1, k0, k0 + BKV - 1)) {
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int qi = q0 + f.col + Frag::cofs(i);
        if (qi >= p.Sq || !visible(p, qi, k0 + f.row + 8 * Frag::half(i)))
          st[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i)
      st[i] = wgmma::exp2_approx(fmaf(st[i], sl2, -lcol[i / 4 * 2 + i % 2]));
    // dV += P^T dO, in flight while dS^T is formed
    uint32_t pb[BQ / 8][4], ps[BQ / 8][4];
    t3::to_frags(st, pb, ps);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk)
      t3::mma3_rs<DP>(gv, pb[kk], ps[kk], t3::kmajor<DP>(dOTt, 0, kk),
                      t3::kmajor<DP>(dOTt + C::kQt, 0, kk));
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::fence_operand(dpt);
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int i = 0; i < RS; ++i)
      dpt[i] = st[i] * (dpt[i] - dcol[i / 4 * 2 + i % 2]);

    // dK += dS^T Q
    uint32_t db[BQ / 8][4], ds[BQ / 8][4];
    t3::to_frags(dpt, db, ds);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 8; ++kk)
      t3::mma3_rs<DP>(gk, db[kk], ds[kk], t3::kmajor<DP>(QTt, 0, kk),
                      t3::kmajor<DP>(QTt + C::kQt, 0, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(gv);
    wgmma::fence_operand(gk);
    ring.release(it);
  }
  const float mk[2] = {p.scale, p.scale}, mv[2] = {1.f, 1.f};
  store_frag_f32(dk + kvoff, ks, gk, f, k0, p.Skv, p.D, mk, p.vec);
  store_frag_f32(dv + kvoff, ks, gv, f, k0, p.Skv, p.D, mv, p.vec);
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

template <int DP>
cudaError_t fwd_tf32(const void* q, const void* k, const void* v, void* out,
                     float* lse, const Shape& p, cudaStream_t s) {
  using C = T3FwdCfg<DP>;
  static bool smem_set = false;
  return launch(flash_fwd_tf32<DP>, smem_set,
                dim3(cdiv(p.Sq, C::BQ) * p.Hq * p.B), kT3Threads, C::bytes, s,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(out), lse,
                p);
}

template <int DP>
cudaError_t bwd_tf32(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv,
                     const Shape& p, cudaStream_t s) {
  using A = T3DkvCfg<DP>;
  using Bq = T3DqCfg<DP>;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  cudaError_t e = delta_pass<float>(out, dout, delta, p, s);
  if (e != cudaSuccess) return e;
  static bool smem_a = false, smem_b = false;
  e = launch(flash_dkv_tf32<DP>, smem_a,
             dim3(cdiv(p.Skv, A::BKV) * p.Hkv * p.B), kT3Threads, A::bytes, s,
             qt, kt, vt, dot, lse, static_cast<const float*>(delta),
             static_cast<float*>(dk), static_cast<float*>(dv), p);
  if (e != cudaSuccess) return e;
  return launch(flash_dq_tf32<DP>, smem_b,
                dim3(cdiv(p.Sq, Bq::BQ) * p.Hq * p.B), kT3Threads, Bq::bytes,
                s, qt, kt, vt, dot, lse, static_cast<const float*>(delta),
                static_cast<float*>(dq), p);
}

// The f32 route, 3xTF32, at the head dim padded to 32, 64, 96 or 128.
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    float* lse, const Shape& p, cudaStream_t s) {
  switch (t3_dp(p.D)) {
    case 32: return fwd_tf32<32>(q, k, v, out, lse, p, s);
    case 64: return fwd_tf32<64>(q, k, v, out, lse, p, s);
    case 96: return fwd_tf32<96>(q, k, v, out, lse, p, s);
    default: return fwd_tf32<128>(q, k, v, out, lse, p, s);
  }
}

cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const void* out, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv,
                    const Shape& p, cudaStream_t s) {
  switch (t3_dp(p.D)) {
    case 32:
      return bwd_tf32<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, s);
    case 64:
      return bwd_tf32<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, s);
    case 96:
      return bwd_tf32<96>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, s);
    default:
      return bwd_tf32<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, p, s);
  }
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
  return static_cast<int>(fwd_f32(q, k, v, out, l, p, s));
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
      bwd_f32(q, k, v, out, dout, l, d, dq, dk, dv, p, s));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
