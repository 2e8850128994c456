// Grouped expert GEMM for Hopper (sm_90a): out[z] = x[z] @ w[z mod period].
//
// Replaces: src/repro/kernels/moe_gmm.py:43 `moe_gmm_kernel_call` (the
// Pallas TPU kernel; body `_kernel` at :27), reached through
// `repro.kernels.ops.moe_gmm` (ops.py:172) from the MoE layer
// (repro/models/layers.py:299-305): three calls per MoE layer.
//
// What bounds it: on the serving path the tokens per expert are few
// (capacity C = 80 at prefill batch 4 x prompt 64, C = 8 at decode), so
// each call reads every expert's weights once (E*D*F elements, 33.5 MB in
// bf16 for granite-moe's 32 x 1024 x 512) and does 2*Z*C*D*F operations:
// about 12 us of H100 memory traffic (3.35 TB/s) against about 3 us of
// bf16 tensor-core work at prefill, and about 10 us against nothing at
// decode. The call is memory-bound; the weights are the bytes that count.
//
// Design (simple first kernels; wgmma/TMA and a persistent schedule are
// later work). Common to both paths:
//  * one block per (F tile, C tile, z); z runs over groups x experts, and
//    the block reads expert e = z mod period, so the expert weights are
//    shared by every group and never copied per group (the JAX layer
//    jnp.tile's them `ngroups` times, layers.py:300-303);
//  * the block loops over D itself (the TPU kernel carried the D loop in
//    VMEM scratch across sequential grid steps; Hopper's blocks run in no
//    order, so the loop lives inside the block);
//  * x and w tiles are staged through shared memory, the sum is kept in
//    f32 registers and rounded once to the input type;
//  * ragged edges in C, D and F are masked in the kernel: out-of-range
//    loads read 0 and out-of-range stores are skipped, so any shape runs;
//  * small C (decode, C <= 16) takes 16-row tiles so the block does not
//    multiply rows of padding.
// bf16 with D and F multiples of 8 (every shape of the serving path):
//  * tensor cores through WMMA (16x16x16 bf16 -> f32); four warps, each
//    owning a 16-column slice of a 64-column tile;
//  * tiles arrive by 16-byte cp.async copies, two stages deep, so the next
//    tile's weights stream in while the current one is multiplied; copies
//    past the ragged edge zero-fill.
// f32 (and bf16 with other widths): plain FMAs on tiles staged as float,
// TM x 4 outputs per thread; no TF32, so f32 holds 1e-4 against the plain
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

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
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
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

template <int MF>
void launch_tc(const __nv_bfloat16* x, const __nv_bfloat16* w,
               __nv_bfloat16* out, int Z, int C, int D, int F, int period,
               cudaStream_t stream) {
  const dim3 grid((F + kTcBN - 1) / kTcBN, (C + 16 * MF - 1) / (16 * MF), Z);
  moe_gmm_tc_kernel<MF><<<grid, kTcThreads, 0, stream>>>(x, w, out, C, D, F,
                                                         period);
}

bool tc_ok(const void* x, const void* w, const void* out, int D, int F) {
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  return D % 8 == 0 && F % 8 == 0 && (addr(x) | addr(w) | addr(out)) % 16 == 0;
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

}  // namespace

// x: (Z, C, D), w: (period, D, F), out: (Z, C, F), all contiguous, on the
// device. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out, int Z,
                              int C, int D, int F, int period, int dtype,
                              void* stream) {
  if (Z <= 0 || C <= 0 || D <= 0 || F <= 0 || period <= 0 || Z % period ||
      Z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, out, Z, C, D, F, period, s));
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
          launch_tc<4>(xb, wb, ob, Z, C, D, F, period, s);
        return static_cast<int>(cudaGetLastError());
      }
      return static_cast<int>(
          launch<__nv_bfloat16>(x, w, out, Z, C, D, F, period, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* moe_gmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
