// RMSNorm over the last axis for Hopper (sm_90a):
//   out[n, :] = (x[n, :] * rsqrt(mean(x[n, :]^2) + eps)) * w,
// the squares summed in f32 and the product rounded once to x's dtype, in
// the plain version's order (kernels/ref.py rmsnorm_ref).
//
// Replaces: src/repro/kernels/rmsnorm.py:27 `rmsnorm_kernel_call` (the
// Pallas TPU kernel; body `_kernel` at :20), reached through
// `repro.kernels.ops.rmsnorm` (ops.py:58) when a layer passes
// use_kernel=True (repro/models/layers.py:63-66; no JAX layer does).
//
// What bounds it: it reads x and w once and writes out once, with four
// operations an element: bytes-bound. At the H100's 3.35 TB/s the bound
// is (2 N D + D) * size bytes: 0.0200 ms at (8192, 1024) f32, 0.0100
// bf16, 0.1603 / 0.0801 at (8192, 8192). The card needs about 295
// operations a byte before its arithmetic matters, so the design does one
// thing: move each byte once, with enough bytes in flight.
//
// Routes, chosen before launch (`route` below; kernels/rmsnorm.py
// `route` mirrors it and counts launches by route); each needs x, w and
// out 16-byte aligned and rows of whole 16-byte vectors, else "plain":
//   "bulk"   rows of more than 512 bytes, up to kMaxRowBytes (32 KB: D
//            8192 in f32, 16384 in bf16);
//   "vector" rows of at most 512 bytes (one 16-byte vector a lane);
//   "plain"  every other width or alignment: one warp a row, element by
//            element, the row read twice (the second time from L1/L2).
//
// "bulk": persistent blocks of 256 threads, min(tiles, 2 x SMs) of them,
// each an equal contiguous share of the rows. A tile is R whole rows, R
// the largest power of two with R x row bytes <= 32 KB (8 rows at f32 D
// 1024, 1 at D 8192), halved while the tiles would not give every block
// one. Thread 0 fills a ring of S stages in dynamic shared memory, each
// stage by one 1-D bulk copy (cp.async.bulk, no tensor map) of the tile's
// bytes (a block's last, partial tile arms its stage's mbarrier with
// exactly the bytes it copies), and refills a stage with the block's tile
// S further on once every thread has read it: the loads of the next S - 1
// tiles are in flight while a tile is reduced and stored. w comes in once
// a block the same way. Each row is read from device memory once; its
// squares are summed from shared memory. Rows go to teams of G threads:
// where the tile has 8 rows or more, G is about a quarter of the row's
// 16-byte vectors, a power of two from 8 (conflict-free 16-byte reads of
// shared memory) to 32; where it has fewer (rows over 4 KB, or few rows
// in all), G = 256 / R (at most the row's vectors rounded up to a power of
// two), and a team of more than a warp adds its warps' sums through
// shared memory. Each thread keeps its vectors in registers, sums their squares
// in order, then the team adds across its lanes and warps. The scaled row
// is written from registers with 16-byte stores, coalesced along the row
// (bulk stores from the stage were no faster on the card).
//
// Shared memory of a "bulk" block: S x stage + row bytes (w) + 8 floats
// (the team sums) + (S + 1) mbarriers <= 228 KB / 2 - 1 KB (two blocks an
// SM); S = min(8, what fits), at least 3, else one block an SM (227 KB).
//
// "vector": a warp covers 32 / G rows, G lanes a row (the row's 16-byte
// vectors rounded up to a power of two), one 16-byte load of x and of w
// a lane, a shuffle sum within the G lanes: nothing to pipeline, and no
// trip through shared memory, which at these widths costs the ring more
// than it saves (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_async.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kMaxRowBytes = 32 * 1024;  // the "bulk" route's widest row
constexpr int kVectorRowBytes = 512;     // the "vector" route's widest row

// 16 bytes of T as f32: 4 elements of f32, 8 of bf16.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<bf16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// the sum of squares of a 16-byte vector, added to ss in element order
template <typename T>
__device__ __forceinline__ float add_squares(const uint4& v, float ss) {
  float f[Vec<T>::n];
  Vec<T>::unpack(v, f);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) ss = fmaf(f[k], f[k], ss);
  return ss;
}

// (x * r) * w of a 16-byte vector, rounded once to T
template <typename T>
__device__ __forceinline__ uint4 scale(const uint4& xv, const uint4& wv,
                                       float r) {
  float f[Vec<T>::n], g[Vec<T>::n];
  Vec<T>::unpack(xv, f);
  Vec<T>::unpack(wv, g);
#pragma unroll
  for (int k = 0; k < Vec<T>::n; ++k) f[k] = f[k] * r * g[k];
  return Vec<T>::pack(f);
}

// ---------------------------------------------------------------------
// "plain": one warp a row, element by element
// ---------------------------------------------------------------------
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int N, int D, float eps) {
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= N) return;
  const int lane = threadIdx.x % 32;
  const T* xr = x + row * D;
  T* orow = out + row * D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float f = to_f32(xr[c]);
    ss = fmaf(f, f, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int c = lane; c < D; c += 32)
    orow[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(w[c]));
}

template <typename T>
cudaError_t launch_plain(const void* x, const void* w, void* out, int N,
                         int D, float eps, cudaStream_t s) {
  const dim3 grid((N + kWarps - 1) / kWarps);
  rmsnorm_kernel<T><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), N, D, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// "vector": G lanes a row, one 16-byte vector a lane
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_vector_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, int N, int D, int G, float eps) {
  const int lane = threadIdx.x % 32, u = lane % G;
  const long row =
      (static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
          (32 / G) + lane / G;
  const int nv = D * static_cast<int>(sizeof(T)) / 16;
  const bool live = row < N && u < nv;
  const size_t at = static_cast<size_t>(row) * nv + u;   // in vectors
  uint4 xv = make_uint4(0, 0, 0, 0);
  if (live) xv = reinterpret_cast<const uint4*>(x)[at];
  float ss = add_squares<T>(xv, 0.f);
  for (int o = G / 2; o > 0; o >>= 1)     // every lane, live or not
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  reinterpret_cast<uint4*>(out)[at] =
      scale<T>(xv, reinterpret_cast<const uint4*>(w)[u], r);
}

template <typename T>
cudaError_t launch_vector(const void* x, const void* w, void* out, int N,
                          int D, float eps, cudaStream_t s) {
  const int nv = D * static_cast<int>(sizeof(T)) / 16;
  int G = 1;
  while (G < nv) G *= 2;
  const int rows = kWarps * (32 / G);      // rows a block
  const dim3 grid((N + rows - 1) / rows);
  rmsnorm_vector_kernel<T><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), N, D, G, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// "bulk": a ring of 1-D bulk copies
// ---------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kBlockWarps = kThreads / 32;
constexpr int kTileBytes = 32 * 1024;    // the largest tile
constexpr int kBlocksPerSM = 2;
constexpr int kMaxStages = 8;
constexpr int kMinStages = 3;
constexpr int kSmemPerSM = 233472;       // 228 KB, 1 KB of it per block
constexpr int kSmemPerBlock = 232448;    // 227 KB

struct Bulk {
  int N, D;        // rows, width
  int R;           // rows a tile (a power of two)
  int G;           // threads a row (a power of two)
  int S;           // stages
  int stage;       // bytes of a whole tile: R x row bytes
  float eps;
};

// The sum of a team's G partial sums, in every thread of the team: lane
// shuffles within min(G, 32) lanes, then, for G > 32, the team's warps
// through shared memory. Every thread of the block calls it together.
__device__ __forceinline__ float team_sum(float ss, int G, float* red) {
  const int width = G < 32 ? G : 32;
  for (int o = width / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (G <= 32) return ss;
  const int warp = threadIdx.x / 32, per = G / 32;
  if (threadIdx.x % 32 == 0) red[warp] = ss;
  __syncthreads();
  ss = 0.f;
  for (int k = warp / per * per, e = k + per; k < e; ++k) ss += red[k];
  __syncthreads();                         // red is free for the next row
  return ss;
}

// VPT: the most 16-byte vectors of a row that one thread holds
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rmsnorm_bulk_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, const Bulk p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = p.D * static_cast<int>(sizeof(T));
  const int nv = row_bytes / 16;           // 16-byte vectors a row
  unsigned char* ring = smem;
  const uint4* ws = reinterpret_cast<const uint4*>(ring + p.S * p.stage);
  float* red = reinterpret_cast<float*>(ring + p.S * p.stage + row_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kBlockWarps);
  uint64_t* wbar = full + p.S;
  const int tid = threadIdx.x;
  // this block's rows: an equal share of N, contiguous (gridDim.x <=
  // tiles <= N, so every block has one), in tiles of R rows from the first
  const int row0 = static_cast<int>(static_cast<long>(p.N) * blockIdx.x /
                                    gridDim.x);
  const int row1 = static_cast<int>(static_cast<long>(p.N) *
                                    (blockIdx.x + 1) / gridDim.x);
  const int mine = (row1 - row0 + p.R - 1) / p.R;
  const auto first_row = [&](int i) { return row0 + i * p.R; };
  const auto rows_of = [&](int i) { return min(p.R, row1 - first_row(i)); };
  // the block's i-th tile into stage i % S
  const auto load = [&](int i) {
    const int bytes = rows_of(i) * row_bytes;
    uint64_t* bar = &full[i % p.S];
    mbar_expect(bar, bytes);
    bulk_load(ring + (i % p.S) * p.stage,
              reinterpret_cast<const unsigned char*>(x) +
                  static_cast<size_t>(first_row(i)) * row_bytes,
              bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s <= p.S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(wbar, row_bytes);
    bulk_load(ring + p.S * p.stage, w, row_bytes, wbar);
    for (int i = 0; i < p.S && i < mine; ++i) load(i);
  }
  __syncthreads();
  const int teams = kThreads / p.G, team = tid / p.G, u = tid % p.G;
  mbar_wait(wbar, 0);
  for (int i = 0; i < mine; ++i) {
    const int rows = rows_of(i);
    mbar_wait(&full[i % p.S], (i / p.S) & 1);
    for (int r0 = 0; r0 < rows; r0 += teams) {   // the same for every thread
      const int r = r0 + team;
      const bool live = r < rows;
      // the thread's vectors u, u + G, ... of the row, in registers
      const uint4* row = reinterpret_cast<const uint4*>(
          ring + (i % p.S) * p.stage + r * row_bytes);
      uint4 v[VPT];
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        v[j] = make_uint4(0, 0, 0, 0);
        if (live && u + j * p.G < nv) v[j] = row[u + j * p.G];
      }
#pragma unroll
      for (int j = 0; j < VPT; ++j) ss = add_squares<T>(v[j], ss);
      ss = team_sum(ss, p.G, red);
      const float rs = rsqrtf(ss / static_cast<float>(p.D) + p.eps);
      if (live) {
        uint4* orow = reinterpret_cast<uint4*>(out) +
                      static_cast<size_t>(first_row(i) + r) * nv;
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const int c = u + j * p.G;
          if (c < nv) orow[c] = scale<T>(v[j], ws[c], rs);
        }
      }
    }
    __syncthreads();                       // every thread has read the stage
    if (tid == 0 && i + p.S < mine) load(i + p.S);
  }
}

template <typename T, int VPT>
cudaError_t launch_bulk_vpt(const Bulk& p, const void* x, const void* w,
                            void* out, int grid, size_t bytes,
                            cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bulk_kernel<T, VPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  rmsnorm_bulk_kernel<T, VPT><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bulk(const void* x, const void* w, void* out, int N,
                        int D, float eps, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int nv = row_bytes / 16;
  int pn = 1;                              // nv rounded up to a power of 2
  while (pn < nv) pn *= 2;
  Bulk p{N, D, 1, 1, 0, 0, eps};
  const int fixed = row_bytes + kBlockWarps * 4 + (kMaxStages + 1) * 8;
  const auto stages = [&](int k) {
    const int n = (kSmemPerSM / k - 1024 - fixed) / (p.R * row_bytes);
    return n < kMaxStages ? n : kMaxStages;
  };
  while (2 * p.R * row_bytes <= kTileBytes) p.R *= 2;
  const int per_sm = stages(kBlocksPerSM) < kMinStages ? 1 : kBlocksPerSM;
  // fewer rows a tile where the tiles would not give every block one
  while (p.R > 1 && (N + p.R - 1) / p.R < per_sm * sms) p.R /= 2;
  if (p.R >= kBlockWarps) {
    p.G = pn / 4 > 8 ? pn / 4 : 8;
    if (p.G > pn) p.G = pn;
    if (p.G > 32) p.G = 32;
  } else {
    p.G = kThreads / p.R < pn ? kThreads / p.R : pn;
  }
  const int vpt = (nv + p.G - 1) / p.G;    // at most 8
  const int tiles = (N + p.R - 1) / p.R;
  p.stage = p.R * row_bytes;
  p.S = stages(per_sm);
  const size_t bytes = static_cast<size_t>(p.S) * p.stage + row_bytes +
                       kBlockWarps * 4 + (p.S + 1) * 8;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  if (vpt <= 1) return launch_bulk_vpt<T, 1>(p, x, w, out, grid, bytes, s);
  if (vpt <= 2) return launch_bulk_vpt<T, 2>(p, x, w, out, grid, bytes, s);
  if (vpt <= 4) return launch_bulk_vpt<T, 4>(p, x, w, out, grid, bytes, s);
  return launch_bulk_vpt<T, 8>(p, x, w, out, grid, bytes, s);
}

// ---------------------------------------------------------------------
// the routes
// ---------------------------------------------------------------------
enum Route { kBulk = 0, kVector = 1, kPlain = 2 };

// Whether route `kind` takes these rows: "plain" any, "vector" and "bulk"
// rows of whole 16-byte vectors (at most 512 bytes for "vector", 32 KB
// for "bulk") with x, w and out 16-byte aligned.
bool takes(int kind, const void* x, const void* w, const void* out,
           int row_bytes) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  if (kind == kPlain) return true;
  if (row_bytes % 16 || !aligned(x) || !aligned(w) || !aligned(out))
    return false;
  return kind == kVector ? row_bytes <= kVectorRowBytes
                         : kind == kBulk && row_bytes <= kMaxRowBytes;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int N, int D,
                   float eps, int kind, cudaStream_t s) {
  if (!takes(kind, x, w, out, D * static_cast<int>(sizeof(T))))
    return cudaErrorInvalidValue;
  switch (kind) {
    case kBulk:
      return launch_bulk<T>(x, w, out, N, D, eps, s);
    case kVector:
      return launch_vector<T>(x, w, out, N, D, eps, s);
    default:
      return launch_plain<T>(x, w, out, N, D, eps, s);
  }
}

}  // namespace

// x (N, D), w (D,), out (N, D), contiguous on the device, by route `kind`
// (0 = "bulk", 1 = "vector", 2 = "plain"; the caller chooses it, as
// kernels/rmsnorm.py's `route` does; a route that does not take these
// rows is refused). dtype: 0 = float32, 1 = bfloat16. Returns a
// cudaError_t (0 = ok).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int N,
                              int D, float eps, int dtype, int kind,
                              void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, out, N, D, eps, kind, s));
    case 1:
      return static_cast<int>(launch<bf16>(x, w, out, N, D, eps, kind, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
