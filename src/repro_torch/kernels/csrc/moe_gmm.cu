// Grouped expert GEMM for Hopper (sm_90a): out[z] = x[z] @ w[z mod period],
// with the two grouped GEMMs of its backward.
//
// Replaces: src/repro/kernels/moe_gmm.py:43 `moe_gmm_kernel_call` (the
// Pallas TPU kernel; body `_kernel` at :27), reached through
// `repro.kernels.ops.moe_gmm` (ops.py:172) from the MoE layer
// (repro/models/layers.py:299-305): three calls per MoE layer. The JAX
// package's backward is the VJP of the oracle (ops.py:165), two more
// grouped GEMMs; here they are kernels too:
//   dx[z] = g[z] @ w[e]^T,   dw[e] = sum over groups of x[z]^T @ g[z],
// z = group * period + e.
//
// What bounds it. Training (granite-moe at batch 2 x 4096: x (64, 1280,
// 1024) @ w (32, 1024, 512) and (64, 1280, 512) @ (32, 512, 1024), bf16):
// 85.9 GFLOP a call, 0.087 ms at 989 TFLOP/s against 0.085 ms for its
// 285 MB at 3.35 TB/s; the call sits on the ridge, so it needs both full
// tensor-core issue and no redundant traffic; the backward is twice the
// work. Prefill (C = 80): memory-bound, the 33.5 MB of expert weights
// (12 us) against 3 us of products. Decode (C = 8): the weights alone,
// 33.5 MB (0.0100 ms at 3.35 TB/s) against 0.27 GFLOP; keeping the memory
// busy takes about 3 MB of loads in flight across the card (~25 KB an
// SM) at all times.
//
// Routes, chosen before launch:
//  * bf16, D and F multiples of 8, 16-byte aligned pointers, C > 32 (every
//    train and prefill shape), and the backward at every such C: wgmma
//    fed by a TMA ring (below);
//  * bf16 at C <= 32 (decode), same widths: the weights stream through
//    wgmma as its 64-row A with the tokens as N (the decode route below);
//  * f32 (the reduced configs, [jamba], any f32 model), forward and
//    backward: 3xTF32 on wgmma (wgmma_tf32.cuh; the f32 route below),
//    which holds f32's 1e-4, reading x, w and g as stored (16-byte loads
//    where D and F are multiples of 4 and the pointers 16-byte aligned,
//    else element by element);
//  * bf16 of any other widths or alignment (rows not whole 16-byte
//    multiples, which TMA cannot take, or unaligned pointers), forward
//    and backward at any C: the wgmma route's tiles, products and modes
//    with x, w and g read as stored, only the loads and the epilogue
//    changed (the edge route, "The edge loads" below; 128 x 128 tiles):
//    the producer warpgroup loads B and each consumer warpgroup its own
//    half of A, two threads a row, as the 16-byte granules that cover it,
//    shifted into the swizzled panels in registers (zero past the
//    matrix's edge); the consumers store from registers with masks.
//
// The f32 route: tf32 operands in shared memory must be K-major, so the
// MN-major ones as stored (w in the forward, x and g in dw) are
// transposed by the pass that splits them; x and g in the forward and dx,
// and w in dx, are K-major as stored. A block owns a 64 x 128 tile: two
// consumer warpgroups of 64 x 64 and a producer warpgroup that loads the
// 32-float depth stages two ahead into registers, splits them and stores
// them into a ring of three (A big and small 2 x 8 KB, B 2 x 16 KB a
// stage: 145 KB a block). Each 8-deep slice's products start from zero in
// registers; f32 adds sum a stage's slices and the stage sums go into a
// double-precision total (the tensor cores' accumulation truncates, which
// a long chain turns into a bias). The sum over groups in dw stays in
// registers: no atomics, and the bits repeat.
// 3xTF32 caps f32 at 494.7 / 3 = 165 TFLOP/s; the training forward (85.9
// GFLOP) is 0.52 ms of it.
//
// The wgmma route (wgmma_bf16.cuh has the operand layouts, sm90_async.cuh
// the TMA and mbarrier helpers). One kernel, three modes:
//   forward  out (Z, C, F) = x[z] (C x D, K-major) @ w[e] (D x F, read as
//            stored: MN-major B);
//   dx       dx (Z, C, D) = g[z] (C x F, K-major) @ w[e]^T (w as stored is
//            the K-major B: no transposed copy);
//   dw       dw (P, D, F): A = x[z]^T and B = g[z], both read as stored
//            (MN-major A and B), depth = groups x C, walked group by group
//            and 64 rows of C at a time; the sum over groups stays in
//            registers, so no atomics and no split: the bits repeat.
//  * A block is three warpgroups: two consumers, each owning 64 rows of a
//    128 x BN output tile with its f32 accumulator in registers, and a
//    producer whose first lane keeps TMA copies of 64-deep stages (A 16
//    KB, B BN x 128 bytes, 128-byte-swizzled 64-column panels) in flight
//    through a ring (4 stages at BN 128, 3 at BN 256) with full / empty
//    mbarriers. setmaxnreg gives the producer 40 registers and each
//    consumer 232. BN is 256 where 256-wide tiles still give every SM one
//    (every training shape: A is re-read half as often), else 128
//    (prefill: 128 tiles for gate/up and 256 for down, so the weight
//    reads spread over all the SMs).
//  * TMA maps are 3-D over the tensors as stored, (D, C, Z), (F, C, Z) and
//    (F, D, P), built on the host per call; the expert e = z mod P is a
//    map coordinate. Their bounds zero the rows past C (of that z alone)
//    and the columns past D or F, so ragged tiles need no code.
//  * Epilogue: each consumer rounds its accumulator to bf16 into its own
//    swizzled tile in shared memory and its first thread stores it by TMA
//    (the map's bounds clip the ragged edge); the stores run on while the
//    next tile's products start (stores straight from registers kept the
//    tensor cores idle through every epilogue, which all blocks reach at
//    about the same time).
//  * Persistent: one block per SM walks the tiles in the order (expert,
//    group, C tile, N tile), so the blocks in flight share one expert's
//    weight panel (1 MB) in L2 while both groups' row tiles use it, and
//    the producer loads the next tile's stages during the epilogue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_async.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------
// bf16 wgmma route: persistent warp-specialised blocks, TMA ring
// ---------------------------------------------------------------------
using namespace sm90;

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };

constexpr int kWsBM = 128;                 // output tile rows (columns: BN)
constexpr int kWsBK = 64;                  // depth of one stage
constexpr int kPanel = 64 * 128;           // bytes: 64 rows x 64 bf16
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kWsThreads = kConsumers + 128;  // and the producer's
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

// Shared memory of a block with BN-wide tiles: the ring's stages (A, 128
// rows, then B, BN columns, 64 deep), each consumer's epilogue tile (64 x
// BN bf16) and the ring's barriers (full: the stage landed, armed by the
// producer's lane with the bytes, or, kEdge, by every producer thread
// once its stores are in; empty: the 8 consumer warps are done). kEdge
// has no epilogue tiles.
template <int BN, bool kEdge = false>
struct WsCfg {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kA = 2 * kPanel, kStage = kA + BN * 128;
  static constexpr int kEpi = kEdge ? 0 : BN / 64 * kPanel;
  struct Ring {
    uint64_t full[kStages], empty[kStages];
  };
  static constexpr size_t bytes =
      1024 + kStages * kStage + 2 * kEpi + sizeof(Ring);
};

// The tile space of one launch. Forward and dx: out (Z, M = C, N), ksteps
// stages over the depth (D or F). dw: out (P, M = D, N = F), ksteps over
// groups x C.
struct Gemm {
  int Z, P, C, M, N;
  int tm, tn, ksteps, ntiles;
  int K;                                   // forward, dx: the depth, D or F
};

// Tile t -> expert e, the z it reads (forward, dx) and its first output
// row and column; the N tile runs fastest, then the C (or D) tile, then
// the group, then the expert.
template <int kMode, int BN>
__device__ __forceinline__ void tile_coords(const Gemm& p, int t, int& e,
                                            int& z, int& m0, int& n0) {
  n0 = (t % p.tn) * BN;
  t /= p.tn;
  m0 = (t % p.tm) * kWsBM;
  t /= p.tm;
  if (kMode == kDw) {
    e = t;
    z = e;
  } else {
    const int groups = p.Z / p.P;
    e = t / groups;
    z = (t % groups) * p.P + e;
  }
}

// the 128 threads of consumer warpgroup wg (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// ---------------------------------------------------------------------
// The edge loads: stages filled by the block's own threads
// ---------------------------------------------------------------------
// Where TMA cannot take a tensor (rows not whole 16-byte multiples, or an
// unaligned base), the block's threads fill each stage's panels in the
// layout the TMA box would give (128-byte lines, the 16-byte chunk c of
// row r at chunk c ^ (r % 8)), two threads a row: each loads its half of
// the row's 64 columns (128 bytes at any even offset) as the five 16-byte
// granules that cover it (a granule holding a byte of the tensor lies in
// that byte's page, so the slack read past a row's end is safe), shifts
// them into place in registers (word selects, and a funnel shift where
// the row sits 2 bytes off a word), zeroes what lies past the matrix and
// stores four 16-byte chunks. The producer warpgroup fills B (BN is 128
// on this route), a stage's loads in flight while the previous stage is
// stored; each consumer warpgroup fills the half of A that it alone reads,
// two stages ahead, while its products run. No warpgroup trades
// registers: the consumers keep 64 accumulators in their 168.
// Measured on the way there (train gate/up with D 1020, F 510, forward,
// torch.matmul 0.45 ms; the TMA route at D 1024 0.14): cp.async pieces of
// 4 and 8 bytes, 0.74 ms (about 6 bytes a cycle an SM); a 1-D bulk copy a
// row into a staging buffer, 0.66 ms for the copies alone (the copy
// engine's rate of requests); 16-byte cp.async granules into a staging
// buffer, nine lanes a row, 1.02 ms for the copies alone (their index
// arithmetic); nine or eight lanes a row in registers, 0.69-2.2 ms (their
// instructions); the producer alone, a thread a row, 0.52 ms; with the
// consumers loading A, 0.47 ms, four threads a row no faster; the
// consumers' loads after their wait rather than beside their products,
// 0.49 ms; a five- or six-stage ring, or a second producer warpgroup, no
// faster. The tensor cores are busy about a fifth of the time. Two later
// designs, neither kept: A by TMA through a map whose rows are g rows of
// A (g rows make whole 16-byte granules, so the strides suit TMA) fails,
// since TMA takes no box that starts off a 16-byte boundary (the card
// stops on an illegal instruction) and row q of a map row starts q K
// columns in; and TMA boxes from the 16-byte boundary before each row
// into unswizzled staging tiles with 8 columns of slack, shifted into the
// panels from shared memory by the producer (or by the producer and the
// consumers), right on the card but slower than these loads from global
// memory.

// The sources and the destination of the edge route: A and B as stored;
// out stored in bf16 pairs where `pair` (even row length, 4-byte aligned
// base), else element by element.
struct Edge {
  const bf16* a;
  const bf16* b;
  bf16* out;
  bool pair;
};

// One operand of a stage as the edge loads read it: its tile's row 0,
// column 0 (byte address), row stride (bytes), the tile's rows inside the
// matrix, and the valid columns of its first and second 64-column panel.
// A "tall" operand is one panel of 128 rows (A in the forward and dx, B
// in dx), a "wide" one two panels of 64 rows, side by side in the matrix's
// columns (A in dw, B in the forward and dw); either way tile row i sits
// at line i of the operand's shared memory.
struct EdgeOp {
  const char* base;
  long ld;
  int rows, n0, n1;
};

// The tile from row r0, column c0 of a row-major bf16 matrix m (rows x
// cols, row stride ld elements).
__device__ __forceinline__ EdgeOp edge_op(const bf16* m, long ld, int rows,
                                          int cols, int r0, int c0) {
  return EdgeOp{reinterpret_cast<const char*>(m + r0 * ld + c0), 2 * ld,
                rows - r0, max(0, min(64, cols - c0)),
                max(0, min(64, cols - c0 - 64))};
}

// The operands of stage s of tile (e, z, m0, n0). Forward: A = x[z] rows
// m0 .., depth columns k0 ..; B = w[e] depth rows k0 .., columns n0 ...
// dx: A = g[z]; B = w[e] rows n0 .., depth columns k0 ... dw: A = x[zz]
// and B = g[zz], depth rows c0 .., columns m0 .. and n0 ...
template <int kMode>
__device__ __forceinline__ void edge_ops(const Gemm& p, const Edge& ed,
                                         int e, int z, int m0, int n0, int s,
                                         EdgeOp& A, EdgeOp& B) {
  if (kMode == kDw) {
    const int csteps = (p.C + kWsBK - 1) / kWsBK;
    const long zz = (s / csteps) * p.P + e;
    const int c0 = (s % csteps) * kWsBK;
    A = edge_op(ed.a + zz * p.C * p.M, p.M, p.C, p.M, c0, m0);
    B = edge_op(ed.b + zz * p.C * p.N, p.N, p.C, p.N, c0, n0);
    return;
  }
  const int K = p.K, k0 = s * kWsBK;
  A = edge_op(ed.a + static_cast<long>(z) * p.C * K, K, p.C, K, m0, k0);
  const bf16* we = ed.b + static_cast<long>(e) * K * p.N;
  B = kMode == kFwd ? edge_op(we, p.N, K, p.N, k0, n0)
                    : edge_op(we, K, p.N, K, n0, k0);
}

// Tile row i of operand O: its first byte and its valid columns (0 past
// the matrix).
template <bool kTall>
__device__ __forceinline__ const char* edge_at(const EdgeOp& O, int i,
                                               int& n) {
  const int r = kTall ? i : i & 63, pn = kTall ? 0 : i >> 6;
  n = r < O.rows ? (pn ? O.n1 : O.n0) : 0;
  return O.base + r * O.ld + 128 * pn;
}

// Half h of a row whose first byte is at g (n valid columns; 0: past the
// matrix): the granules 4 h .. 4 h + 4 that cover it, counted from the one
// holding its first byte (0 past its valid bytes), and the offset m of
// that byte in it.
__device__ __forceinline__ void edge_load_half(const char* g, int n, int h,
                                               uint4 (&v)[5], int& m) {
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(g);
  m = static_cast<int>(s0 & 15);
  const int end = n ? m + 2 * n : 0;
  const uint4* base = reinterpret_cast<const uint4*>(s0 & ~uintptr_t{15});
#pragma unroll
  for (int k = 0; k < 5; ++k)
    v[k] = 16 * (4 * h + k) < end ? __ldg(base + 4 * h + k)
                                  : make_uint4(0u, 0u, 0u, 0u);
}

// Half a row, shifted: granules g[0..4] (granules 4 h .. 4 h + 4 of a
// row whose bytes start m bytes into its first granule), shifted left by
// m bytes (two words, one word, then a half word), 0 from column n
// (counted from this half's first) on, stored as chunks 4 h .. 4 h + 3
// of line `line` (shared address) of panel row r.
__device__ __forceinline__ void edge_half(const uint4 (&g)[5], int m, int n,
                                          int h, uint32_t line, int r) {
  uint32_t u[20];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    u[4 * k] = g[k].x;
    u[4 * k + 1] = g[k].y;
    u[4 * k + 2] = g[k].z;
    u[4 * k + 3] = g[k].w;
  }
#pragma unroll
  for (int k = 0; k < 18; ++k) u[k] = m & 8 ? u[k + 2] : u[k];
#pragma unroll
  for (int k = 0; k < 17; ++k) u[k] = m & 4 ? u[k + 1] : u[k];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    u[k] = m & 2 ? __funnelshift_r(u[k], u[k + 1], 16) : u[k];
  if (n < 32) {                            // past the matrix: zero
#pragma unroll
    for (int k = 0; k < 16; ++k)
      u[k] = 2 * k >= n ? 0u : 2 * k + 1 >= n ? u[k] & 0xffffu : u[k];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     line + (((4 * h + q) ^ (r & 7)) << 4)),
                 "r"(u[4 * q]), "r"(u[4 * q + 1]), "r"(u[4 * q + 2]),
                 "r"(u[4 * q + 3])
                 : "memory");
}

// BN: the output tile's columns, 128 or 256 (a consumer's m64nBN product).
// kEdge: the block's threads fill the stages from `ed` (the edge loads: B
// by the producer, each consumer's half of A by itself) and the consumers
// store from registers, in place of the TMA maps.
template <int kMode, int BN, bool kEdge>
__global__ void __launch_bounds__(kWsThreads, 1)
moe_gmm_ws_kernel(Gemm p, const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap to, const Edge ed) {
  using Cfg = WsCfg<BN, kEdge>;
  constexpr int kStages = Cfg::kStages, kStage = Cfg::kStage;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_smem = align1024(smem_raw);   // stage s: A, then B
  unsigned char* epi = ring_smem + kStages * kStage;
  auto& ring = *reinterpret_cast<typename Cfg::Ring*>(epi + 2 * Cfg::kEpi);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], kEdge ? 128 : 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {         // the producer warpgroup
    if (kEdge) {
      static_assert(!kEdge || BN == 128, "the edge route runs BN 128");
      static_assert(Cfg::kA == kWsBM * 128, "B's lines follow A's");
      constexpr bool kTallB = kMode == kDx;     // see EdgeOp
      const int pt = threadIdx.x - kConsumers;
      const int mine = (p.ntiles - 1 - static_cast<int>(blockIdx.x)) /
                           static_cast<int>(gridDim.x) + 1;
      const int total = mine * p.ksteps;   // this block's stages
      // stage it's rows of B of this thread: two threads a row (half hb
      // each), rows pt / 2 and 64 + pt / 2 (the consumers load A)
      const int rb = pt / 2, hb = pt % 2;
      struct Half {
        uint4 g[5];
        int m, n;
      };
      auto load = [&](int it, Half (&H)[2]) {
        const int t = blockIdx.x + (it / p.ksteps) * gridDim.x;
        int e, z, m0, n0;
        tile_coords<kMode, BN>(p, t, e, z, m0, n0);
        EdgeOp A, B;
        edge_ops<kMode>(p, ed, e, z, m0, n0, it % p.ksteps, A, B);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          edge_load_half(edge_at<kTallB>(B, rb + 64 * q, H[q].n), H[q].n, hb,
                         H[q].g, H[q].m);
      };
      auto put = [&](int it, const Half (&H)[2]) {
        const uint32_t b = smem_u32(ring_smem + (it % kStages) * kStage) +
                           Cfg::kA;
        if (it >= kStages)                 // the consumers released it
          mbar_wait(&ring.empty[it % kStages], (it / kStages - 1) & 1);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = rb + 64 * q;       // line r of B
          edge_half(H[q].g, H[q].m, H[q].n - 32 * hb, hb, b + r * 128, r);
        }
        wgmma::fence_proxy();              // the stores, for wgmma
        mbar_arrive(&ring.full[it % kStages]);
      };
      // two stages' rows in flight: stage it + 1's loads while stage it is
      // stored
      Half h0[2], h1[2];
      if (total > 0) load(0, h0);
      for (int it = 0; it < total; it += 2) {
        if (it + 1 < total) load(it + 1, h1);
        put(it, h0);
        if (it + 1 >= total) break;
        if (it + 2 < total) load(it + 2, h0);
        put(it + 1, h1);
      }
    } else {
      wgmma::setmaxnreg_dec<kProducerRegs>();
      if (threadIdx.x != kConsumers) return;
      const int csteps = (p.C + kWsBK - 1) / kWsBK;   // dw: stages a group
      int it = 0;
      for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
        int e, z, m0, n0;
        tile_coords<kMode, BN>(p, t, e, z, m0, n0);
        for (int s = 0; s < p.ksteps; ++s, ++it) {
          unsigned char* a = ring_smem + (it % kStages) * kStage;
          unsigned char* b = a + Cfg::kA;
          uint64_t* full = &ring.full[it % kStages];
          if (it >= kStages)               // the consumers released it
            mbar_wait(&ring.empty[it % kStages], (it / kStages - 1) & 1);
          mbar_expect(full, kStage);
          if (kMode == kDw) {
            // x[z] rows c0.. x columns m0.. and g[z] rows c0.. x columns
            // n0.., both as stored (MN-major): 64-column panels
            const int zz = (s / csteps) * p.P + e, c0 = (s % csteps) * kWsBK;
            for (int c = 0; c < 2; ++c)
              tma_load_3d(a + c * kPanel, ta, full, m0 + 64 * c, c0, zz);
            for (int c = 0; c < BN / 64; ++c)
              tma_load_3d(b + c * kPanel, tb, full, n0 + 64 * c, c0, zz);
          } else {
            // A: rows m0.. x depth k0.. (K-major, 128 rows)
            tma_load_3d(a, ta, full, s * kWsBK, m0, z);
            if (kMode == kFwd) {           // w[e] rows k0.., columns n0..
              for (int c = 0; c < BN / 64; ++c)
                tma_load_3d(b + c * kPanel, tb, full, n0 + 64 * c, s * kWsBK,
                            e);
            } else {                       // w[e] rows n0.., columns k0..
              tma_load_3d(b, tb, full, s * kWsBK, n0, e);
            }
          }
        }
      }
    }
    return;
  }
  if (!kEdge) wgmma::setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;
  const int lane = threadIdx.x % 32;
  const int frow = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int fcol = 2 * (lane % 4);
  unsigned char* ep = epi + wg * Cfg::kEpi;
  constexpr int TA = kMode == kDw ? 1 : 0, TB = kMode == kDx ? 0 : 1;
  float acc[BN / 2];
  // kEdge: each consumer warpgroup loads the half of A it reads itself
  // (its lines 64 wg ..), kAhead stages ahead, two threads a row (half h
  // each), while its products run; a stage's loads are issued one stage
  // before its stores
  constexpr int kAhead = kStages - 2;
  constexpr bool kTallA = kMode != kDw;
  const int ct = threadIdx.x % 128, ra = 64 * wg + ct / 2, hh = ct % 2;
  const int total = (p.ntiles - 1 - static_cast<int>(blockIdx.x)) /
                        static_cast<int>(gridDim.x) * p.ksteps + p.ksteps;
  uint4 ga[5];
  int ma = 0, na = 0;
  auto a_load = [&](int it2) {
    const int t = blockIdx.x + (it2 / p.ksteps) * gridDim.x;
    int e, z, m0, n0;
    tile_coords<kMode, BN>(p, t, e, z, m0, n0);
    EdgeOp A, B;
    edge_ops<kMode>(p, ed, e, z, m0, n0, it2 % p.ksteps, A, B);
    edge_load_half(edge_at<kTallA>(A, ra, na), na, hh, ga, ma);
  };
  auto a_store = [&](int it2) {
    edge_half(ga, ma, na - 32 * hh, hh,
              smem_u32(ring_smem + (it2 % kStages) * kStage) + ra * 128, ra);
  };
  if (kEdge) {
    for (int it2 = 0; it2 < kAhead && it2 < total; ++it2) {
      a_load(it2);
      a_store(it2);
    }
    if (kAhead < total) a_load(kAhead);
    wgmma::fence_proxy();                  // the stores, for wgmma
    warpgroup_sync(wg);
  }
  int it = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
    int e, z, m0, n0;
    tile_coords<kMode, BN>(p, t, e, z, m0, n0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < p.ksteps; ++s, ++it) {
      const unsigned char* a = ring_smem + (it % kStages) * kStage;
      const unsigned char* b = a + Cfg::kA;
      mbar_wait(&ring.full[it % kStages], (it / kStages) & 1);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < kWsBK / 16; ++kk) {
        const uint64_t da = TA ? wgmma::mnmajor<64>(a + wg * kPanel, kk)
                               : wgmma::kmajor<kWsBM>(a, 64 * wg, kk);
        const uint64_t db = TB ? wgmma::mnmajor<64>(b, kk)
                               : wgmma::kmajor<BN>(b, 0, kk);
        wgmma::wgmma_ss_acc<TA, TB>(acc, da, db);
      }
      wgmma::commit();
      if (kEdge) {
        // while the products run: stage it + kAhead's A half into the slot
        // stage it - 2 left (read: the last wait)
        if (it + kAhead < total) {
          a_store(it + kAhead);
          if (it + kAhead + 1 < total) a_load(it + kAhead + 1);
        }
        wgmma::fence_proxy();              // the stores, for wgmma
        warpgroup_sync(wg);
      }
      wgmma::wait<1>();                    // the previous stage is read
      if (s > 0 && lane == 0) mbar_arrive(&ring.empty[(it - 1) % kStages]);
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    if (lane == 0) mbar_arrive(&ring.empty[(it - 1) % kStages]);

    if (kEdge) {
      // the edge epilogue: masked stores from registers, rows < M and
      // columns < N, bf16 pairs where the rows allow them
      bf16* o = ed.out + static_cast<size_t>(kMode == kDw ? e : z) * p.M * p.N;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + 64 * wg + frow + 8 * hf;
        if (r >= p.M) continue;
        bf16* orow = o + static_cast<size_t>(r) * p.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + fcol;
          const float x0 = acc[4 * j + 2 * hf], x1 = acc[4 * j + 2 * hf + 1];
          if (ed.pair) {
            if (c < p.N)
              *reinterpret_cast<__nv_bfloat162*>(orow + c) =
                  __floats2bfloat162_rn(x0, x1);
          } else {
            if (c < p.N) orow[c] = __float2bfloat16_rn(x0);
            if (c + 1 < p.N) orow[c + 1] = __float2bfloat16_rn(x1);
          }
        }
      }
      continue;
    }
    // epilogue: the warpgroup's 64 rows as bf16 into its swizzled tile
    // (64-column panels, conflict-free), then TMA stores that clip the
    // ragged edge and run on while the next tile's products start
    if (leader) bulk_wait_read();          // the last tile's stores read it
    warpgroup_sync(wg);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = frow + 8 * hf;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            ep + (j / 8) * kPanel + r * 128 + (((j % 8) ^ (r % 8)) * 16) +
            fcol * 2) = __floats2bfloat162_rn(acc[4 * j + 2 * hf],
                                              acc[4 * j + 2 * hf + 1]);
    }
    wgmma::fence_proxy();                  // visible to the TMA stores
    warpgroup_sync(wg);
    if (leader && m0 + 64 * wg < p.M) {
      for (int c = 0; c < BN / 64; ++c)
        tma_store_3d(to, ep + c * kPanel, n0 + 64 * c, m0 + 64 * wg,
                     kMode == kDw ? e : z);
      bulk_commit();
    }
  }
  if (!kEdge && leader) bulk_wait_read();  // before the block's memory goes
}

// A TMA map of a contiguous bf16 tensor (d2, d1, d0) as 3-D (d0, d1, d2),
// read in boxes of 64 x `rows` x 1, 128-byte swizzled; out-of-range
// elements read 0. d0 must be a multiple of 8 and the base 16-byte
// aligned.
cudaError_t map3(CUtensorMap* map, const void* base, int d0, int d1, int d2,
                 int rows) {
  EncodeTiled encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// One launch of mode kMode with BN-wide tiles: a persistent grid of
// min(tiles, SMs) blocks; the shared-memory limit is raised on the first
// launch. kEdge: the edge loads and stores (no TMA map is built).
template <int kMode, int BN, bool kEdge>
cudaError_t launch_ws_bn(Gemm p, const void* a, const void* b, void* out,
                         int D, int F, int sms, cudaStream_t s) {
  CUtensorMap ta{}, tb{}, to{};
  Edge ed{};
  cudaError_t e = cudaSuccess;
  if (kEdge) {
    // A: x (rows of D) or, in dx, g (rows of F); B: w or, in dw, g (F)
    ed = Edge{static_cast<const bf16*>(a), static_cast<const bf16*>(b),
              static_cast<bf16*>(out),
              p.N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0};
  } else {
    e = map3(&to, out, p.N, p.M, kMode == kDw ? p.P : p.Z, 64);
    if (e != cudaSuccess) return e;
    if (kMode == kFwd) {                   // a = x, b = w
      e = map3(&ta, a, D, p.C, p.Z, kWsBM);
      if (e == cudaSuccess) e = map3(&tb, b, F, D, p.P, 64);
    } else if (kMode == kDx) {             // a = g, b = w
      e = map3(&ta, a, F, p.C, p.Z, kWsBM);
      if (e == cudaSuccess) e = map3(&tb, b, F, D, p.P, BN);
    } else {                               // a = x, b = g
      e = map3(&ta, a, D, p.C, p.Z, 64);
      if (e == cudaSuccess) e = map3(&tb, b, F, p.C, p.Z, 64);
    }
    if (e != cudaSuccess) return e;
  }
  p.K = kMode == kFwd ? D : F;
  p.tn = cdiv(p.N, BN);
  p.ntiles = (kMode == kDw ? p.P : p.Z) * p.tm * p.tn;
  static bool smem_set = false;
  if (!smem_set) {
    e = cudaFuncSetAttribute(moe_gmm_ws_kernel<kMode, BN, kEdge>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(WsCfg<BN, kEdge>::bytes));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  moe_gmm_ws_kernel<kMode, BN, kEdge>
      <<<p.ntiles < sms ? p.ntiles : sms, kWsThreads,
         WsCfg<BN, kEdge>::bytes, s>>>(p, ta, tb, to, ed);
  return cudaGetLastError();
}

// 256-wide tiles re-read A half as often as 128-wide ones; they are taken
// where they still give every SM a tile.
template <int kMode>
cudaError_t launch_ws(Gemm p, const void* a, const void* b, void* out,
                      int D, int F, bool edge, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  p.tm = cdiv(p.M, kWsBM);
  const bool wide = (kMode == kDw ? p.P : p.Z) * p.tm * cdiv(p.N, 256) >= sms;
  if (edge) return launch_ws_bn<kMode, 128, true>(p, a, b, out, D, F, sms, s);
  return wide ? launch_ws_bn<kMode, 256, false>(p, a, b, out, D, F, sms, s)
              : launch_ws_bn<kMode, 128, false>(p, a, b, out, D, F, sms, s);
}

// ---------------------------------------------------------------------
// bf16 decode route (C <= 32): the expert weights streamed through wgmma
// ---------------------------------------------------------------------
// out[z]^T (F x C) = w[e]^T (F x D) x[z]^T (D x C): the weights fill
// wgmma's 64 rows (w as stored, D x F, is an MN-major A, read through the
// transpose bit) and the tokens are its N: the C rows of every group that
// reads this expert, each group's padded to Cp = C rounded up to 8 and
// stacked, N the stack rounded up to a power of two (8 .. 128; groups
// past 128 / Cp go to further blocks), so each expert's weights are read
// once a call. A block is one warpgroup owning 64 columns of F of one
// expert; its thread 0 keeps kStages TMA stages of 64 rows of D in flight
// (w 8 KB, each group's x Cp x 128 bytes), each released by the four
// warps once their product has read it. At the decode shapes that is 256
// or 512 blocks, three resident an SM, with 64 KB each in flight:
// several times what the memory rate needs.
constexpr int kDecBK = 64;                 // rows of D a stage
constexpr int kDecThreads = 128;

template <int NB>
struct DecCfg {
  static constexpr int kStages = NB <= 32 ? 8 : 4;
  static constexpr int kW = kPanel;        // 64 x 64 bf16 of w
  static constexpr int kStage = kW + NB * 128;
  static constexpr size_t bytes =
      1024 + kStages * kStage + 2 * kStages * sizeof(uint64_t);
};

struct Dec {
  int Z, P, C, D, F, Cp, gb;               // gb: groups a block stacks
};

template <int NB>
__global__ void __launch_bounds__(kDecThreads)
moe_gmm_decode_kernel(Dec p, const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap tx,
                      __nv_bfloat16* __restrict__ out) {
  using Cfg = DecCfg<NB>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * Cfg::kStage);
  uint64_t* empty = full + kStages;        // the four warps are done
  const int f0 = blockIdx.x * 64, e = blockIdx.y, g0 = blockIdx.z * p.gb;
  const int groups = min(p.gb, p.Z / p.P - g0);
  const int nk = (p.D + kDecBK - 1) / kDecBK;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kDecThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage k: w[e] rows k * 64 .., columns f0 ..; each group's x rows
  // (the map's bounds zero rows past C, columns past D and F)
  auto load_stage = [&](int k) {
    unsigned char* st = ring + (k % kStages) * Cfg::kStage;
    uint64_t* bar = &full[k % kStages];
    mbar_expect(bar, Cfg::kW + groups * p.Cp * 128);
    tma_load_3d(st, tw, bar, f0, k * kDecBK, e);
    for (int gi = 0; gi < groups; ++gi)
      tma_load_3d(st + Cfg::kW + gi * p.Cp * 128, tx, bar, k * kDecBK, 0,
                  (g0 + gi) * p.P + e);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < kStages && k < nk; ++k) load_stage(k);
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % kStages;
    const unsigned char* st = ring + s * Cfg::kStage;
    mbar_wait(&full[s], (k / kStages) & 1);
    wgmma::fence_operand(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kDecBK / 16; ++kk)
      wgmma::wgmma_ss_acc<1, 0>(acc, wgmma::mnmajor<64>(st, kk),
                                wgmma::kmajor<NB>(st + Cfg::kW, 0, kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && k + kStages < nk) {
      mbar_wait(&empty[s], (k / kStages) & 1);
      load_stage(k + kStages);
    }
  }
  // element (row f, column n = gi Cp + c) to out[z][c][f]
  const int frow = f0 + 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) {
    const int f = frow + 8 * ((i / 2) % 2);
    const int n = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    const int gi = n / p.Cp, c = n % p.Cp;
    if (f < p.F && gi < groups && c < p.C)
      out[(static_cast<size_t>((g0 + gi) * p.P + e) * p.C + c) * p.F + f] =
          __float2bfloat16_rn(acc[i]);
  }
}

template <int NB>
cudaError_t launch_decode_nb(const Dec& p, const void* x, const void* w,
                             void* out, cudaStream_t s) {
  CUtensorMap tw, tx;
  cudaError_t e = map3(&tw, w, p.F, p.D, p.P, 64);
  if (e == cudaSuccess) e = map3(&tx, x, p.D, p.C, p.Z, p.Cp);
  if (e != cudaSuccess) return e;
  static bool smem_set = false;
  if (!smem_set) {
    e = cudaFuncSetAttribute(moe_gmm_decode_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(DecCfg<NB>::bytes));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid(cdiv(p.F, 64), p.P, cdiv(p.Z / p.P, p.gb));
  moe_gmm_decode_kernel<NB><<<grid, kDecThreads, DecCfg<NB>::bytes, s>>>(
      p, tw, tx, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

// One launch of the decode route: N the stacked groups' padded rows
// rounded up to a power of two.
cudaError_t launch_decode(const void* x, const void* w, void* out, int Z,
                          int C, int D, int F, int period, cudaStream_t s) {
  const int Cp = cdiv(C, 8) * 8, groups = Z / period;
  const int gb = groups < 128 / Cp ? groups : 128 / Cp;
  const Dec p{Z, period, C, D, F, Cp, gb};
  if (period > 65535 || cdiv(groups, gb) > 65535)   // gridDim.y, .z
    return cudaErrorInvalidValue;
  const int n = gb * Cp;
  if (n <= 8) return launch_decode_nb<8>(p, x, w, out, s);
  if (n <= 16) return launch_decode_nb<16>(p, x, w, out, s);
  if (n <= 32) return launch_decode_nb<32>(p, x, w, out, s);
  if (n <= 64) return launch_decode_nb<64>(p, x, w, out, s);
  return launch_decode_nb<128>(p, x, w, out, s);
}

// ---------------------------------------------------------------------
// f32 route: 3xTF32 on wgmma (wgmma_tf32.cuh)
// ---------------------------------------------------------------------
// A block of three warpgroups per 64 x 128 output tile: two consumers,
// each 64 x 64 of it with its sum in registers, and a producer. The depth
// runs in 32-float stages (one 128-byte panel) through a ring of three:
// the producer's threads load a stage's 16-byte chunks of A and B into
// registers two stages ahead, then split them into big and small halves
// and store them (transposed where the operand is MN-major as stored)
// once the consumers have freed the slot. The producer, not the
// products, bounds the kernel.
// Summation: the tensor cores' own accumulation truncates toward zero, so
// a chain of products into one accumulator drifts by about 2^-23 of the
// running sum per instruction (dw at the training shape, 960 products
// into one sum, missed 1e-4 by 50x; a fresh sum per 32-deep stage still
// by 7x). Each 8-deep slice's three products therefore start from zero;
// f32 adds sum a stage's four slices and the stage sums go into a
// double-precision total: the result is closer to the exact one than a
// sequential f32 sum is.
constexpr int kT3BM = 64, kT3BN = 128, kT3BK = 32, kT3Stages = 3;
constexpr int kT3Threads = 384;            // consumers 0-255, producer

struct T3Cfg {
  static constexpr int kA = kT3BM * kT3BK * 4;    // one half of A
  static constexpr int kB = kT3BN * kT3BK * 4;    // one half of B
  // a stage: A big, A small, B big, B small
  static constexpr int kStage = 2 * kA + 2 * kB;
  using Ring = wgmma::tf32::Ring<kT3Stages, 8>;
  static constexpr size_t bytes = 1024 + kT3Stages * kStage + sizeof(Ring);
};

// Tile t -> expert e, the z it reads (forward, dx) and its first output
// row and column, in tile_coords' order with 64-row tiles.
template <int kMode, int BN>
__device__ __forceinline__ void t3_coords(const Gemm& p, int t, int& e,
                                          int& z, int& m0, int& n0) {
  n0 = (t % p.tn) * BN;
  t /= p.tn;
  m0 = (t % p.tm) * kT3BM;
  t /= p.tm;
  if (kMode == kDw) {
    e = t;
    z = e;
  } else {
    const int groups = p.Z / p.P;
    e = t / groups;
    z = (t % groups) * p.P + e;
  }
}

// A row-major f32 source matrix (rows x cols, row stride ld) and the
// origin (r0, c0) of a stage's chunk walk in it; elements out of range
// read 0. vec: rows of whole 16-byte chunks and a 16-byte aligned base,
// so a chunk is one 16-byte load; else element by element.
struct Src {
  const float* p;
  int ld, rows, cols, r0, c0;
  bool vec;
  __device__ __forceinline__ float4 at(int r, int c) const {
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= rows || gc >= cols) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* e = p + static_cast<size_t>(gr) * ld + gc;
    if (vec) return __ldg(reinterpret_cast<const float4*>(e));
    return make_float4(e[0], gc + 1 < cols ? e[1] : 0.f,
                       gc + 2 < cols ? e[2] : 0.f,
                       gc + 3 < cols ? e[3] : 0.f);
  }
};

// The sources of stage s. Forward: A = x[z] (C x D, K-major), B = w[e]
// (D x F: depth rows, transposed). dx: A = g[z] (C x F), B = w[e] (D x
// F: N rows, K-major). dw: A = x[zz] (C x D) and B = g[zz] (C x F), both
// with depth rows (transposed); the depth walks the groups' C rows.
template <int kMode>
__device__ __forceinline__ void t3_srcs(const Gemm& p, const float* a,
                                        const float* b, int D, int F, int e,
                                        int z, int m0, int n0, int s,
                                        bool vec, Src& sa, Src& sb) {
  const int k0 = s * kT3BK;
  if (kMode == kFwd) {
    sa = Src{a + static_cast<size_t>(z) * p.C * D, D, p.C, D, m0, k0, vec};
    sb = Src{b + static_cast<size_t>(e) * D * F, F, D, F, k0, n0, vec};
  } else if (kMode == kDx) {
    sa = Src{a + static_cast<size_t>(z) * p.C * F, F, p.C, F, m0, k0, vec};
    sb = Src{b + static_cast<size_t>(e) * D * F, F, D, F, n0, k0, vec};
  } else {
    const int csteps = (p.C + kT3BK - 1) / kT3BK;
    const int zz = (s / csteps) * p.P + e, c0 = (s % csteps) * kT3BK;
    sa = Src{a + static_cast<size_t>(zz) * p.C * D, D, p.C, D, c0, m0, vec};
    sb = Src{b + static_cast<size_t>(zz) * p.C * F, F, p.C, F, c0, n0, vec};
  }
}

template <int kMode>
__global__ void __launch_bounds__(kT3Threads, 1)
moe_gmm_tf32_kernel(Gemm p, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ out,
                    int D, int F, bool vec) {
  using Cfg = T3Cfg;
  namespace t3 = wgmma::tf32;
  constexpr int BN = kT3BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  typename Cfg::Ring& ring = *reinterpret_cast<typename Cfg::Ring*>(
      stages + kT3Stages * Cfg::kStage);
  ring.init();
  int e, z, m0, n0;
  t3_coords<kMode, BN>(p, blockIdx.x, e, z, m0, n0);

  if (threadIdx.x >= 256) {                // the producer warpgroup
    constexpr bool kTransA = kMode == kDw, kTransB = kMode != kDx;
    // chunk walks over a stage's sources: depth rows where transposed
    using WA = t3::Walk<kTransA ? kT3BK : kT3BM, kTransA ? kT3BM : kT3BK,
                        128>;
    using WB = t3::Walk<kTransB ? kT3BK : BN, kTransB ? BN : kT3BK, 128>;
    auto fetch = [&](int s, float4 (&va)[WA::kIters],
                     float4 (&vb)[WB::kIters]) {
      Src sa, sb;
      t3_srcs<kMode>(p, a, b, D, F, e, z, m0, n0, s, vec, sa, sb);
#pragma unroll
      for (int j = 0; j < WA::kIters; ++j) {
        int r, c;
        WA::at(j, r, c);
        va[j] = sa.at(r, c);
      }
#pragma unroll
      for (int j = 0; j < WB::kIters; ++j) {
        int r, c;
        WB::at(j, r, c);
        vb[j] = sb.at(r, c);
      }
    };
    auto put = [&](int s, const float4 (&va)[WA::kIters],
                   const float4 (&vb)[WB::kIters]) {
      ring.wait_empty(s);
      unsigned char* ab = stages + (s % kT3Stages) * Cfg::kStage;
      unsigned char* bb = ab + 2 * Cfg::kA;
#pragma unroll
      for (int j = 0; j < WA::kIters; ++j) {
        int r, c;
        WA::at(j, r, c);
        if (kTransA)
          t3::store_trans<kT3BM, false>(ab, ab + Cfg::kA, c, r, va[j]);
        else
          t3::store_plain<kT3BM>(ab, ab + Cfg::kA, r, c, va[j]);
      }
#pragma unroll
      for (int j = 0; j < WB::kIters; ++j) {
        int r, c;
        WB::at(j, r, c);
        if (kTransB)
          t3::store_trans<BN, false>(bb, bb + Cfg::kB, c, r, vb[j]);
        else
          t3::store_plain<BN>(bb, bb + Cfg::kB, r, c, vb[j]);
      }
      ring.filled(&ring.full[s % kT3Stages]);
    };
    // two stages' loads in flight: stage s + 1's while stage s is stored
    float4 va0[WA::kIters], vb0[WB::kIters], va1[WA::kIters],
        vb1[WB::kIters];
    fetch(0, va0, vb0);
    for (int s = 0; s < p.ksteps; s += 2) {
      if (s + 1 < p.ksteps) fetch(s + 1, va1, vb1);
      put(s, va0, vb0);
      if (s + 1 >= p.ksteps) break;
      if (s + 2 < p.ksteps) fetch(s + 2, va0, vb0);
      put(s + 1, va1, vb1);
    }
    return;
  }

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  double acc[32];
  float part[32], sum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0;
  for (int s = 0; s < p.ksteps; ++s) {
    const unsigned char* ab = stages + (s % kT3Stages) * Cfg::kStage;
    const unsigned char* bb = ab + 2 * Cfg::kA;
    ring.wait_full(s);
#pragma unroll
    for (int kk = 0; kk < kT3BK / 8; ++kk) {
      // slice kk's three products into part, from zero; the warpgroup's
      // 64 columns are B's rows 64 wg ..
      wgmma::fence();
      t3::mma3_ss<64>(part, t3::kmajor<kT3BM>(ab, 0, kk),
                      t3::kmajor<kT3BM>(ab + Cfg::kA, 0, kk),
                      t3::kmajor<BN>(bb, 64 * wg, kk),
                      t3::kmajor<BN>(bb + Cfg::kB, 64 * wg, kk), 0);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = kk ? sum[i] + part[i] : part[i];
    }
    ring.release(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += static_cast<double>(sum[i]);
  }

  // epilogue: rows < M and columns < N, pairs as float2 where vec
  const int lane = threadIdx.x % 32;
  const int frow = m0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int fcol = n0 + 64 * wg + 2 * (lane % 4);
  float* o = out + static_cast<size_t>(kMode == kDw ? e : z) * p.M * p.N;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = frow + 8 * hf;
    if (r >= p.M) continue;
    float* orow = o + static_cast<size_t>(r) * p.N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = fcol + 8 * j;
      const float x = static_cast<float>(acc[4 * j + 2 * hf]);
      const float y = static_cast<float>(acc[4 * j + 2 * hf + 1]);
      if (vec) {
        if (c < p.N) *reinterpret_cast<float2*>(orow + c) = make_float2(x, y);
      } else {
        if (c < p.N) orow[c] = x;
        if (c + 1 < p.N) orow[c + 1] = y;
      }
    }
  }
}

// One launch of the f32 route in mode kMode: one block per 64 x 128
// tile.
template <int kMode>
cudaError_t launch_tf32(Gemm p, const void* a, const void* b, void* out,
                        int D, int F, bool vec, cudaStream_t s) {
  p.tm = cdiv(p.M, kT3BM);
  p.tn = cdiv(p.N, kT3BN);
  p.ntiles = (kMode == kDw ? p.P : p.Z) * p.tm * p.tn;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_gmm_tf32_kernel<kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T3Cfg::bytes));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  moe_gmm_tf32_kernel<kMode><<<p.ntiles, kT3Threads, T3Cfg::bytes, s>>>(
      p, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), D, F, vec);
  return cudaGetLastError();
}

bool tc_ok(const void* a, const void* b, const void* c, int D, int F) {
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  return D % 8 == 0 && F % 8 == 0 &&
         (addr(a) | addr(b) | addr(c)) % 16 == 0;
}

// The f32 route's 16-byte loads: rows of whole 16-byte chunks (D and F
// multiples of 4) and 16-byte aligned pointers.
bool f32_vec(const void* a, const void* b, const void* c, int D, int F) {
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  return D % 4 == 0 && F % 4 == 0 &&
         (addr(a) | addr(b) | addr(c)) % 16 == 0;
}

bool bad_shape(int Z, int C, int D, int F, int period) {
  return Z <= 0 || C <= 0 || D <= 0 || F <= 0 || period <= 0 || Z % period;
}

// The route's kernels take the call: f32 any (3xTF32, never `edge`); bf16
// through TMA where tc_ok, else with `edge` (the edge loads and stores).
bool takes(const void* a, const void* b, const void* c, int D, int F,
           int dtype, int edge) {
  if (dtype == 0) return edge == 0;
  return dtype == 1 && (edge != 0 || tc_ok(a, b, c, D, F));
}

}  // namespace

// x: (Z, C, D), w: (period, D, F), out: (Z, C, F), all contiguous, on the
// device. dtype: 0 = float32, 1 = bfloat16. edge (bf16 only): 0 for the
// TMA-fed wgmma kernels, which need D and F multiples of 8 and 16-byte
// aligned pointers (the decode kernel at C <= 32), 1 for the same tiles
// fed by the edge loads, at any width and alignment. Returns a
// cudaError_t (0 = ok; cudaErrorInvalidValue for a call the chosen
// kernels do not take).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int Z,
                              int C, int D, int F, int period, int dtype,
                              int edge, void* stream) {
  if (bad_shape(Z, C, D, F, period) || !takes(x, w, out, D, F, dtype, edge))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_tf32<kFwd>(
        Gemm{Z, period, C, C, F, 0, 0, cdiv(D, kT3BK), 0}, x, w, out, D, F,
        f32_vec(x, w, out, D, F), s));
  if (C <= 32 && !edge)
    return static_cast<int>(launch_decode(x, w, out, Z, C, D, F, period, s));
  return static_cast<int>(launch_ws<kFwd>(
      Gemm{Z, period, C, C, F, 0, 0, cdiv(D, kWsBK), 0}, x, w, out, D, F,
      edge != 0, s));
}

// The backward of moe_gmm_launch, reading x, w and the output gradient g
// (Z, C, F) as stored: dx (Z, C, D) = g[z] @ w[e]^T, and dw (period, D, F)
// = sum over groups of x[z]^T @ g[z]. dtype and edge as for
// moe_gmm_launch (bf16 at any C runs the wgmma kernels).
extern "C" int moe_gmm_dx_launch(const void* g, const void* w, void* dx,
                                 int Z, int C, int D, int F, int period,
                                 int dtype, int edge, void* stream) {
  if (bad_shape(Z, C, D, F, period) || !takes(g, w, dx, D, F, dtype, edge))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_tf32<kDx>(
        Gemm{Z, period, C, C, D, 0, 0, cdiv(F, kT3BK), 0}, g, w, dx, D, F,
        f32_vec(g, w, dx, D, F), s));
  return static_cast<int>(launch_ws<kDx>(
      Gemm{Z, period, C, C, D, 0, 0, cdiv(F, kWsBK), 0}, g, w, dx, D, F,
      edge != 0, s));
}

extern "C" int moe_gmm_dw_launch(const void* x, const void* g, void* dw,
                                 int Z, int C, int D, int F, int period,
                                 int dtype, int edge, void* stream) {
  if (bad_shape(Z, C, D, F, period) || !takes(x, g, dw, D, F, dtype, edge))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_tf32<kDw>(
        Gemm{Z, period, C, D, F, 0, 0, Z / period * cdiv(C, kT3BK), 0}, x,
        g, dw, D, F, f32_vec(x, g, dw, D, F), s));
  return static_cast<int>(launch_ws<kDw>(
      Gemm{Z, period, C, D, F, 0, 0, Z / period * cdiv(C, kWsBK), 0}, x, g,
      dw, D, F, edge != 0, s));
}

extern "C" const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
