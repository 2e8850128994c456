// RMSNorm over the last axis for Hopper (sm_90a):
//   out[n, :] = x[n, :] * rsqrt(mean(x[n, :]^2) + eps) * w, cast back.
//
// Replaces: src/repro/kernels/rmsnorm.py:27 `rmsnorm_kernel_call` (the
// Pallas TPU kernel; body `_kernel` at :20), reached through
// `repro.kernels.ops.rmsnorm` (ops.py:58) when a layer passes
// use_kernel=True (repro/models/layers.py:63-66; no JAX layer does).
//
// What bounds it: it reads x and w once and writes out once, two flops
// per element: bytes-bound (at (8192, 1024) bf16, 33.6 MB in and out,
// about 10 us at 3.35 TB/s).
//
// Design: one warp per row, four rows per block. Each lane strides the
// row (neighbouring lanes on neighbouring addresses), summing squares in
// f32; a shuffle reduction gives the row's rsqrt; the second pass
// re-reads the row (from L1/L2) and writes the scaled, rounded values in
// the plain version's order, (x * r) * w. Any row count and width; a
// width that is a multiple of 16 bytes takes 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;

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

// V elements per access: 16 / sizeof(T) when the row is a multiple of 16
// bytes and the pointers are aligned, else 1.
template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int N, int D, float eps) {
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= N) return;
  const int lane = threadIdx.x % 32;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  struct alignas(16) Pack { T v[V]; };
  float ss = 0.f;
  for (int c = lane * V; c < D; c += 32 * V) {
    const Pack a = *reinterpret_cast<const Pack*>(xr + c);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float f = to_f32(a.v[i]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int c = lane * V; c < D; c += 32 * V) {
    const Pack a = *reinterpret_cast<const Pack*>(xr + c);
    const Pack b = *reinterpret_cast<const Pack*>(w + c);
    Pack o;
#pragma unroll
    for (int i = 0; i < V; ++i)
      o.v[i] = from_f32<T>(to_f32(a.v[i]) * r * to_f32(b.v[i]));
    *reinterpret_cast<Pack*>(orow + c) = o;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int N, int D,
                   float eps, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const auto addr = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p);
  };
  const dim3 grid((N + kWarps - 1) / kWarps);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (D % V == 0 && (addr(x) | addr(w) | addr(out)) % 16 == 0)
    rmsnorm_kernel<T, V><<<grid, kWarps * 32, 0, s>>>(xp, wp, op, N, D, eps);
  else
    rmsnorm_kernel<T, 1><<<grid, kWarps * 32, 0, s>>>(xp, wp, op, N, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x (N, D), w (D,), out (N, D), contiguous on the device.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int N,
                              int D, float eps, int dtype, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, out, N, D, eps, s));
    case 1:
      return static_cast<int>(launch<bf16>(x, w, out, N, D, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
