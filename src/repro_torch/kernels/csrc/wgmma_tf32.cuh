// Hopper warpgroup matrix multiply (wgmma, sm_90a) on f32 operands by
// 3xTF32: each operand x is split into big = tf32(x) (cvt.rna, 10
// mantissa bits kept) and small = tf32(x - big), and a product a b becomes
//   a_small b_big + a_big b_small + a_big b_big
// summed into one f32 accumulator in registers (a_small b_small, about
// 2^-22 of a b, is left out). A TF32 product alone keeps about three
// decimal digits; the three keep about as many as an f32 FMA does. The
// same technique as CUTLASS's OpMultiplyAddFastF32; this is the repo's
// own source. Three products at the TF32 rate (494.7 TFLOP/s dense on an
// H100 SXM) cap f32 work at about 165 TFLOP/s.
//
// Operands in shared memory are K-major (the depth contiguous), because
// wgmma's transpose bits exist only for 16-bit types: a tile of ROWS rows
// x K floats is K/32 panels of ROWS x 32 floats, one 128-byte line per
// row, the 16-byte chunk c of row r stored at chunk c ^ (r % 8), panels
// 1024-byte aligned (the 128-byte swizzle the descriptor names; the same
// byte layout as wgmma_bf16.cuh's, 32 floats to a line in place of 64
// bf16). A depth slice of one instruction is 8 floats (32 bytes). An
// operand stored MN-major in device memory is transposed by the pass that
// splits it (`store_trans`); the big and small halves of a tile lie in
// two tiles of that layout.
//
// An A operand may come from registers instead: a warpgroup's m64k8 tf32
// fragment, whose thread (warp w, lane l) holds rows 16 w + l / 4 (+8)
// and columns l % 4 (+4) as a0 = (r, c), a1 = (r + 8, c), a2 = (r, c + 4),
// a3 = (r + 8, c + 4). An f32 accumulator (wgmma_bf16.cuh's fragment
// layout) holds columns 2 (l % 4) and 2 (l % 4) + 1 of each 8-column
// group instead, so `to_frags` takes them as they lie and the B operand's
// depth is permuted to match: within each 8-wide group, depth index p of
// the product sits at position `perm8(p)` of the B tile (p even at p / 2,
// p odd at 4 + p / 2). The writer of such a B tile applies perm8.

#pragma once

#include <cstdint>

#include "sm90_async.cuh"
#include "wgmma_bf16.cuh"

namespace wgmma {
namespace tf32 {

// tf32(x) as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties away
// from zero): half of the 13 dropped bits' unit added to the magnitude,
// then the 13 bits cleared. Two integer operations, cheaper than the
// conversion instruction in the producers' split, which bounds the GEMM.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// big = tf32(x), small = tf32(x - big), as f32 bit patterns
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float4& v, float4& big,
                                       float4& small) {
  uint32_t b[4], s[4];
  split(v.x, b[0], s[0]);
  split(v.y, b[1], s[1]);
  split(v.z, b[2], s[2]);
  split(v.w, b[3], s[3]);
  big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
  small = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                      __uint_as_float(s[2]), __uint_as_float(s[3]));
}

// Byte offset of element (r, k) in a K-major swizzled f32 tile of ROWS
// rows.
template <int ROWS>
__device__ __forceinline__ uint32_t offset(int r, int k) {
  return (k / 32) * (ROWS * 128) + r * 128 +
         ((((k % 32) / 4) ^ (r % 8)) * 16) + (k % 4) * 4;
}

// Position of depth index p in a B tile fed by a register A fragment.
__device__ __forceinline__ int perm8(int p) {
  return (p & ~7) | ((p & 1) << 2) | ((p >> 1) & 3);
}

// Descriptor of a K-major operand: rows [r0, r0 + 64 or N) of a tile of
// ROWS rows, depth slice kk (8 floats).
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int r0,
                                           int kk) {
  return desc(tile + (kk / 4) * (ROWS * 128) + r0 * 128 + (kk % 4) * 32, 16,
              1024);
}

// Split 4 consecutive depth elements (row r, depth k .. k + 3; k a
// multiple of 4) into the big and small tiles: one 16-byte store each.
template <int ROWS>
__device__ __forceinline__ void store_plain(unsigned char* big,
                                            unsigned char* small, int r,
                                            int k, const float4& v) {
  float4 b, s;
  split4(v, b, s);
  const uint32_t o = offset<ROWS>(r, k);
  *reinterpret_cast<float4*>(big + o) = b;
  *reinterpret_cast<float4*>(small + o) = s;
}

// Split 4 consecutive elements of row k of an MN-major source (its
// columns r .. r + 3 become the tile's rows) into the big and small
// tiles, transposed; PERM: the depth permuted by perm8.
template <int ROWS, bool PERM>
__device__ __forceinline__ void store_trans(unsigned char* big,
                                            unsigned char* small, int r,
                                            int k, const float4& v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  const int kp = PERM ? perm8(k) : k;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b, s;
    split(x[j], b, s);
    const uint32_t o = offset<ROWS>(r + j, kp);
    *reinterpret_cast<uint32_t*>(big + o) = b;
    *reinterpret_cast<uint32_t*>(small + o) = s;
  }
}

// Thread t of NT (t = threadIdx.x % NT) walks an R x W f32 source tile in
// R * W / (4 NT) 16-byte chunks: chunk j is (row, column) = (r, c), eight
// rows by four chunks to a warp, so global reads are whole 32-byte
// sectors and transposed shared stores conflict at most two ways.
template <int R, int W, int NT>
struct Walk {
  static_assert(R % 8 == 0 && W % 16 == 0 && (R * W / 4) % NT == 0, "tile");
  static constexpr int kIters = R * W / 4 / NT;
  static __device__ __forceinline__ void at(int j, int& r, int& c) {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % NT) / 32;
    const int wi = warp + (NT / 32) * j;
    r = 8 * (wi % (R / 8)) + lane % 8;
    c = 16 * (wi / (R / 8)) + 4 * (lane / 8);
  }
};

// A ring of kStages stages between a producer warpgroup, whose 128
// threads store split tiles, and kConsumerWarps consumer warps: `full`
// completes when the producer's threads have stored a stage, `empty` when
// the consumer warps are done with it; `once` for tiles stored once per
// block.
template <int kStages, int kConsumerWarps>
struct Ring {
  uint64_t full[kStages], empty[kStages], once;

  __device__ __forceinline__ void init() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        sm90::mbar_init(&full[s], 128);
        sm90::mbar_init(&empty[s], kConsumerWarps);
      }
      sm90::mbar_init(&once, 128);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  // producer thread: its stores made visible to wgmma, then arrive
  __device__ __forceinline__ void filled(uint64_t* bar) {
    fence_proxy();
    sm90::mbar_arrive(bar);
  }
  __device__ __forceinline__ void wait_empty(int it) {
    if (it >= kStages)
      sm90::mbar_wait(&empty[it % kStages], (it / kStages - 1) & 1);
  }
  __device__ __forceinline__ void wait_full(int it) {
    sm90::mbar_wait(&full[it % kStages], (it / kStages) & 1);
    fence_proxy();
  }
  __device__ __forceinline__ void wait_once() {
    sm90::mbar_wait(&once, 0);
    fence_proxy();
  }
  // consumer warp: done with item it's stage
  __device__ __forceinline__ void release(int it) {
    if (threadIdx.x % 32 == 0) sm90::mbar_arrive(&empty[it % kStages]);
  }
};

template <int N>
struct Mma;

template <>
struct Mma<16> {
  // d (64 x 16) (+)= a b, a from shared memory
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d (64 x 16) (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<32> {
  // d (64 x 32) (+)= a b, a from shared memory
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d (64 x 32) (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<64> {
  // d (64 x 64) (+)= a b, a from shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d (64 x 64) (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<96> {
  // d (64 x 96) (+)= a b, a from shared memory
  static __device__ __forceinline__ void ss(float (&d)[48], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d (64 x 96) (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

template <>
struct Mma<128> {
  // d (64 x 128) (+)= a b, a from shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
  }
  // d (64 x 128) (+)= a b, a from registers
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

// d (+)= a b by 3xTF32, a and b in shared memory as big and small tiles;
// acc 0: the first product overwrites d
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a_big,
                                        uint64_t a_small, uint64_t b_big,
                                        uint64_t b_small, int acc) {
  Mma<N>::ss(d, a_small, b_big, acc);
  Mma<N>::ss(d, a_big, b_small, 1);
  Mma<N>::ss(d, a_big, b_big, 1);
}

// d += a b by 3xTF32, a from registers (big and small fragments)
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2],
                                        const uint32_t (&a_big)[4],
                                        const uint32_t (&a_small)[4],
                                        uint64_t b_big, uint64_t b_small) {
  Mma<N>::rs(d, a_small, b_big, 1);
  Mma<N>::rs(d, a_big, b_small, 1);
  Mma<N>::rs(d, a_big, b_big, 1);
}

// An m64nK f32 accumulator (R = K / 2 floats) as the K / 8 big and small
// tf32 A fragments of a product of depth K, read in place (the B operand's
// depth permuted by perm8).
template <int R>
__device__ __forceinline__ void to_frags(const float (&d)[R],
                                         uint32_t (&big)[R / 4][4],
                                         uint32_t (&small)[R / 4][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 4; ++kk) {
    split(d[4 * kk], big[kk][0], small[kk][0]);
    split(d[4 * kk + 2], big[kk][1], small[kk][1]);
    split(d[4 * kk + 1], big[kk][2], small[kk][2]);
    split(d[4 * kk + 3], big[kk][3], small[kk][3]);
  }
}

}  // namespace tf32
}  // namespace wgmma
