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
// (12 us) against 3 us of products. Decode (C = 8): the weights alone.
//
// Routes, chosen before launch:
//  * bf16, D and F multiples of 8, 16-byte aligned pointers, C > 32 (every
//    train and prefill shape), and the backward at every such C: wgmma
//    fed by a TMA ring (below);
//  * bf16 at C <= 32 (decode), same widths: WMMA 16x16x16 tiles, 16 or
//    32 rows, two cp.async stages (decode is host-bound);
//  * f32 (the reduced configs, [jamba], any f32 model), forward and
//    backward: 3xTF32 on wgmma (wgmma_tf32.cuh; the f32 route below),
//    which holds f32's 1e-4, reading x, w and g as stored (16-byte loads
//    where D and F are multiples of 4 and the pointers 16-byte aligned,
//    else element by element);
//  * bf16 of other widths: FMAs on tiles staged as float. Their backward
//    runs the forward kernel on transposed copies made by the wrapper.
// The WMMA and FMA kernels run one block per (F tile, C tile, z) with the
// D loop inside the block and mask ragged C, D and F themselves.
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
#include <mma.h>

#include <cstdint>

#include "sm90_async.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kThreadsX = 16;              // threads along F
constexpr int kThreadsY = 16;              // threads along C
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kBK = 32;                    // depth of one staged tile
constexpr int kTN = 4;                     // outputs per thread along F
constexpr int kBN = kThreadsX * kTN;       // 64 columns per block

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// TM outputs per thread along C: the block covers kThreadsY * TM rows.
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int C, int D, int F, int period) {
  constexpr int kBM = kThreadsY * TM;
  // x tile stored transposed (k-major) so a thread reads its TM rows of
  // one k with stride kThreadsY; +1 keeps the transposing store free of
  // bank conflicts.
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN];

  const int z = blockIdx.z;
  const int e = z % period;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const T* xz = x + static_cast<size_t>(z) * C * D;
  const T* we = w + static_cast<size_t>(e) * D * F;
  T* oz = out + static_cast<size_t>(z) * C * F;

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsX;
  const int ty = tid / kThreadsX;

  float acc[TM][kTN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // neighbouring threads read neighbouring elements of a row of x
    // (contiguous along D) and of a row of w (contiguous along F)
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < C && gc < D)
                     ? to_f32(xz[static_cast<size_t>(gr) * D + gc])
                     : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < D && gc < F)
                     ? to_f32(we[static_cast<size_t>(gr) * F + gc])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[kTN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = xs[kk][ty + m * kThreadsY];
#pragma unroll
      for (int n = 0; n < kTN; ++n) b[n] = ws[kk][tx + n * kThreadsX];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < kTN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = row0 + ty + m * kThreadsY;
    if (r >= C) continue;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const int c = col0 + tx + n * kThreadsX;
      if (c < F) oz[static_cast<size_t>(r) * F + c] = from_f32<T>(acc[m][n]);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcBN = kTcWarps * 16;       // 64 columns per block
constexpr int kTcBK = 64;                  // depth of one stage
constexpr int kTcPad = 8;                  // bf16 elements of row padding
constexpr int kTcLdA = kTcBK + kTcPad;     // 72: rows stay 16-byte aligned
constexpr int kTcLdB = kTcBN + kTcPad;
constexpr int kTcLdC = kTcBN + 4;          // f32 epilogue tile

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

// MF 16-row fragments per warp along C: the block covers 16 * MF rows.
template <int MF>
__global__ void __launch_bounds__(kTcThreads)
moe_gmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ out, int C, int D, int F,
                  int period) {
  using namespace nvcuda;
  constexpr int kBM = 16 * MF;
  constexpr int kStageA = kBM * kTcLdA;    // elements
  constexpr int kStageB = kTcBK * kTcLdB;
  constexpr int kPipeBytes = 2 * (kStageA + kStageB) * 2;
  constexpr int kEpiBytes = kBM * kTcLdC * 4;
  constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * kStageA;

  const int z = blockIdx.z;
  const int e = z % period;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kTcBN;
  const __nv_bfloat16* xz = x + static_cast<size_t>(z) * C * D;
  const __nv_bfloat16* we = w + static_cast<size_t>(e) * D * F;
  __nv_bfloat16* oz = out + static_cast<size_t>(z) * C * F;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // one stage: x rows [row0, row0+kBM) x depth [k0, k0+kTcBK) and w depth
  // [k0, k0+kTcBK) x columns [col0, col0+kTcBN), 8 bf16 per copy
  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* a = As + stage * kStageA;
    __nv_bfloat16* b = Bs + stage * kStageB;
    for (int v = tid; v < kBM * (kTcBK / 8); v += kTcThreads) {
      const int r = v / (kTcBK / 8), c = (v % (kTcBK / 8)) * 8;
      const bool ok = row0 + r < C && k0 + c < D;
      cp_async16(a + r * kTcLdA + c,
                 ok ? xz + static_cast<size_t>(row0 + r) * D + k0 + c : xz,
                 ok);
    }
    for (int v = tid; v < kTcBK * (kTcBN / 8); v += kTcThreads) {
      const int r = v / (kTcBN / 8), c = (v % (kTcBN / 8)) * 8;
      const bool ok = k0 + r < D && col0 + c < F;
      cp_async16(b + r * kTcLdB + c,
                 ok ? we + static_cast<size_t>(k0 + r) * F + col0 + c : we,
                 ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF];
#pragma unroll
  for (int m = 0; m < MF; ++m) wmma::fill_fragment(acc[m], 0.f);

  const int nk = (D + kTcBK - 1) / kTcBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * kTcBK);
      cp_async_commit();
      cp_async_wait<1>();                  // stage kt has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = As + (kt & 1) * kStageA;
    const __nv_bfloat16* b = Bs + (kt & 1) * kStageB;
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b + ks * kTcLdB + warp * 16, kTcLdB);
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, a + m * 16 * kTcLdA + ks, kTcLdA);
        wmma::mma_sync(acc[m], af, bf, acc[m]);
      }
    }
    __syncthreads();                       // the stage may be refilled
  }

  // epilogue through shared memory (the pipeline buffers are done):
  // masked stores of the valid rows and columns, rounded to bf16
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int m = 0; m < MF; ++m)
    wmma::store_matrix_sync(Cs + m * 16 * kTcLdC + warp * 16, acc[m], kTcLdC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kTcBN; i += kTcThreads) {
    const int r = i / kTcBN, c = i % kTcBN;
    if (row0 + r < C && col0 + c < F)
      oz[static_cast<size_t>(row0 + r) * F + col0 + c] =
          __float2bfloat16_rn(Cs[r * kTcLdC + c]);
  }
}

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
// producer's lane with the bytes; empty: the 8 consumer warps are done).
template <int BN>
struct WsCfg {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kA = 2 * kPanel, kStage = kA + BN * 128;
  static constexpr int kEpi = BN / 64 * kPanel;
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

// BN: the output tile's columns, 128 or 256 (a consumer's m64nBN product).
template <int kMode, int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
moe_gmm_ws_kernel(Gemm p, const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap to) {
  using Cfg = WsCfg<BN>;
  constexpr int kStages = Cfg::kStages, kStage = Cfg::kStage;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_smem = align1024(smem_raw);   // stage s: A, then B
  unsigned char* epi = ring_smem + kStages * kStage;
  auto& ring = *reinterpret_cast<typename Cfg::Ring*>(epi + 2 * Cfg::kEpi);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {         // the producer warpgroup
    wgmma::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
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
  wgmma::setmaxnreg_inc<kConsumerRegs>();

  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;
  const int lane = threadIdx.x % 32;
  const int frow = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int fcol = 2 * (lane % 4);
  unsigned char* ep = epi + wg * Cfg::kEpi;
  constexpr int TA = kMode == kDw ? 1 : 0, TB = kMode == kDx ? 0 : 1;
  float acc[BN / 2];
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
      wgmma::wait<1>();                    // the previous stage is read
      if (s > 0 && lane == 0) mbar_arrive(&ring.empty[(it - 1) % kStages]);
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    if (lane == 0) mbar_arrive(&ring.empty[(it - 1) % kStages]);

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
  if (leader) bulk_wait_read();            // before the block's memory goes
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
// launch.
template <int kMode, int BN>
cudaError_t launch_ws_bn(Gemm p, const void* a, const void* b, void* out,
                         int D, int F, int sms, cudaStream_t s) {
  CUtensorMap ta, tb, to;
  cudaError_t e = map3(&to, out, p.N, p.M, kMode == kDw ? p.P : p.Z, 64);
  if (e != cudaSuccess) return e;
  if (kMode == kFwd) {                     // a = x, b = w
    e = map3(&ta, a, D, p.C, p.Z, kWsBM);
    if (e == cudaSuccess) e = map3(&tb, b, F, D, p.P, 64);
  } else if (kMode == kDx) {               // a = g, b = w
    e = map3(&ta, a, F, p.C, p.Z, kWsBM);
    if (e == cudaSuccess) e = map3(&tb, b, F, D, p.P, BN);
  } else {                                 // a = x, b = g
    e = map3(&ta, a, D, p.C, p.Z, 64);
    if (e == cudaSuccess) e = map3(&tb, b, F, p.C, p.Z, 64);
  }
  if (e != cudaSuccess) return e;
  p.tn = cdiv(p.N, BN);
  p.ntiles = (kMode == kDw ? p.P : p.Z) * p.tm * p.tn;
  static bool smem_set = false;
  if (!smem_set) {
    e = cudaFuncSetAttribute(moe_gmm_ws_kernel<kMode, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(WsCfg<BN>::bytes));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  moe_gmm_ws_kernel<kMode, BN><<<p.ntiles < sms ? p.ntiles : sms,
                                 kWsThreads, WsCfg<BN>::bytes, s>>>(p, ta,
                                                                   tb, to);
  return cudaGetLastError();
}

// 256-wide tiles re-read A half as often as 128-wide ones; they are taken
// where they still give every SM a tile.
template <int kMode>
cudaError_t launch_ws(Gemm p, const void* a, const void* b, void* out,
                      int D, int F, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  p.tm = cdiv(p.M, kWsBM);
  const int wide = (kMode == kDw ? p.P : p.Z) * p.tm * cdiv(p.N, 256);
  return wide >= sms ? launch_ws_bn<kMode, 256>(p, a, b, out, D, F, sms, s)
                     : launch_ws_bn<kMode, 128>(p, a, b, out, D, F, sms, s);
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

template <int MF>
void launch_tc(const __nv_bfloat16* x, const __nv_bfloat16* w,
               __nv_bfloat16* out, int Z, int C, int D, int F, int period,
               cudaStream_t stream) {
  const dim3 grid((F + kTcBN - 1) / kTcBN, (C + 16 * MF - 1) / (16 * MF), Z);
  moe_gmm_tc_kernel<MF><<<grid, kTcThreads, 0, stream>>>(x, w, out, C, D, F,
                                                         period);
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

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int Z, int C,
                   int D, int F, int period, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const dim3 block(kThreads);
  if (C > kThreadsY) {
    constexpr int kBM = kThreadsY * 4;
    const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, Z);
    moe_gmm_kernel<T, 4><<<grid, block, 0, stream>>>(xp, wp, op, C, D, F,
                                                     period);
  } else {
    const dim3 grid((F + kBN - 1) / kBN, 1, Z);
    moe_gmm_kernel<T, 1><<<grid, block, 0, stream>>>(xp, wp, op, C, D, F,
                                                     period);
  }
  return cudaGetLastError();
}

bool bad_shape(int Z, int C, int D, int F, int period) {
  return Z <= 0 || C <= 0 || D <= 0 || F <= 0 || period <= 0 || Z % period ||
         Z > 65535;
}

}  // namespace

// x: (Z, C, D), w: (period, D, F), out: (Z, C, F), all contiguous, on the
// device. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int Z,
                              int C, int D, int F, int period, int dtype,
                              void* stream) {
  if (bad_shape(Z, C, D, F, period))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_tf32<kFwd>(
          Gemm{Z, period, C, C, F, 0, 0, cdiv(D, kT3BK), 0}, x, w, out, D,
          F, f32_vec(x, w, out, D, F), s));
    case 1:
      if (tc_ok(x, w, out, D, F)) {
        const auto* xb = static_cast<const __nv_bfloat16*>(x);
        const auto* wb = static_cast<const __nv_bfloat16*>(w);
        auto* ob = static_cast<__nv_bfloat16*>(out);
        if (C <= 16)
          launch_tc<1>(xb, wb, ob, Z, C, D, F, period, s);
        else if (C <= 32)
          launch_tc<2>(xb, wb, ob, Z, C, D, F, period, s);
        else
          return static_cast<int>(launch_ws<kFwd>(
              Gemm{Z, period, C, C, F, 0, 0, cdiv(D, kWsBK), 0}, x,
              w, out, D, F, s));
        return static_cast<int>(cudaGetLastError());
      }
      return static_cast<int>(
          launch<__nv_bfloat16>(x, w, out, Z, C, D, F, period, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of moe_gmm_launch, reading x, w and the output gradient g
// (Z, C, F) as stored: dx (Z, C, D) = g[z] @ w[e]^T, and dw (period, D, F)
// = sum over groups of x[z]^T @ g[z]. dtype 0 (f32, 3xTF32): any widths;
// dtype 1 (bf16, the wgmma route): D and F multiples of 8 and 16-byte
// aligned pointers. cudaErrorInvalidValue for another shape (the wrapper
// takes its transposed-copy route there).
bool bwd_ok(const void* a, const void* b, const void* c, int D, int F,
            int dtype) {
  return dtype == 0 || (dtype == 1 && tc_ok(a, b, c, D, F));
}

extern "C" int moe_gmm_dx_launch(const void* g, const void* w, void* dx,
                                 int Z, int C, int D, int F, int period,
                                 int dtype, void* stream) {
  if (bad_shape(Z, C, D, F, period) || !bwd_ok(g, w, dx, D, F, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_tf32<kDx>(
        Gemm{Z, period, C, C, D, 0, 0, cdiv(F, kT3BK), 0}, g, w, dx, D, F,
        f32_vec(g, w, dx, D, F), s));
  return static_cast<int>(launch_ws<kDx>(
      Gemm{Z, period, C, C, D, 0, 0, cdiv(F, kWsBK), 0}, g, w, dx, D, F, s));
}

extern "C" int moe_gmm_dw_launch(const void* x, const void* g, void* dw,
                                 int Z, int C, int D, int F, int period,
                                 int dtype, void* stream) {
  if (bad_shape(Z, C, D, F, period) || !bwd_ok(x, g, dw, D, F, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_tf32<kDw>(
        Gemm{Z, period, C, D, F, 0, 0, Z / period * cdiv(C, kT3BK), 0}, x,
        g, dw, D, F, f32_vec(x, g, dw, D, F), s));
  return static_cast<int>(launch_ws<kDw>(
      Gemm{Z, period, C, D, F, 0, 0, Z / period * cdiv(C, kWsBK), 0}, x, g,
      dw, D, F, s));
}

extern "C" const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
