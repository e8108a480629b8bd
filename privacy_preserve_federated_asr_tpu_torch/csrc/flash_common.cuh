// What kernels B1 (flash_fwd.cu) and B2 (flash_bwd.cu) share, so that the
// two cannot drift apart: the constants and the keep hash of the TPU
// kernels, the swizzled shared-memory tile layout, the asynchronous tile
// loaders (cp.async with zero fill past T), and the wgmma descriptors,
// instructions and fences.
//
// Tile layout. A [rows, 64] bf16 tile is stored as 128-byte rows of eight
// 16-byte chunks; chunk c of row r sits at chunk c ^ (r & 7). That is the
// 128-byte swizzle of wgmma's shared-memory descriptors (layout type 1) when
// the tile starts on a 1024-byte boundary, and it makes every 4-byte
// accumulator store of 8 consecutive rows free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr int kD = 64;               // head dim (the only one supported)
constexpr float kMaskFill = -1e30f;  // NEG_INF of the TPU kernel
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kRowBytes = kD * 2;    // one bf16 tile row

struct Strides {
  long long b, t, h;  // in elements; the D stride is 1
};

// ---------------------------------------------------------------------------
// the TPU kernels' counter-based dropout and mask replacement
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t seed_of(uint32_t seed, int bh) {
  return fmix32(seed + (uint32_t)bh * kGolden);
}

__device__ __forceinline__ bool keep_elem(uint32_t seed_bh, uint32_t row,
                                          uint32_t col, uint32_t t_hash,
                                          uint32_t threshold) {
  return (fmix32((row * t_hash + col) ^ seed_bh) & 0x7FFFFFFFu) >= threshold;
}

// key code: 1 valid, 0 masked, -1 past T
__device__ __forceinline__ int key_code(const int* mask_b, int col, int T) {
  return col < T ? (mask_b[col] > 0 ? 1 : 0) : -1;
}

// scaled score after the mask replacement
__device__ __forceinline__ float replace_masked(float x, int code, float fill) {
  return code > 0 ? x : (code == 0 ? fill : -CUDART_INF_F);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// shared memory: swizzled tiles and asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` of row `r` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return (uint32_t)(r * kRowBytes + ((ch ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; with `n` = 0 the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + R) of a [T, 64] bf16 slice with row stride `rs` ->
// the swizzled tile at `dst`; rows past T are zero-filled
template <int R, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* base,
                                                long long rs, int row0, int T, int tid) {
  static_assert((R * 8) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * 8 / NT; ++i) {
    const int c = tid + i * NT, r = c >> 3, ch = c & 7;
    const bool in = row0 + r < T;
    const __nv_bfloat16* src = base + (in ? (long long)(row0 + r) * rs : 0) + ch * 8;
    cp_async16(dst + swz(r, ch), src, in ? 16 : 0);
  }
}

// entries [i0, i0 + N) of an fp32 or int32 vector of length T -> smem
// (entries past T are zero-filled); threads 0 <= tid < N copy one each
template <int N, typename E>
__device__ __forceinline__ void load_vec_async(E* dst, const E* src, int i0, int T,
                                               int tid) {
  if ((unsigned)tid < (unsigned)N) {
    const bool in = i0 + tid < T;
    cp_async4(smem_u32(dst + tid), src + (in ? i0 + tid : 0), in ? 4 : 0);
  }
}

// The accumulator of a 16-row product over 16 k columns (c[2kk], c[2kk+1],
// 8 columns each) re-packed as the A fragment of the next product: the
// row/column layout of a wgmma accumulator in each warp (as mma.sync's C)
// coincides with that of a register A operand (as mma.sync's A).
template <int N>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup's 64-row products, operands in swizzled tiles
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled tile (128-byte swizzle,
// layout type 1) whose 8-row groups lie 1024 bytes apart. Both orientations
// use it: a K-major operand (rows = M or N, 64 k columns) steps k by 32
// bytes from its start; an MN-major one (rows = k, 64 m or n columns) steps
// k by 16 rows (2048 bytes), and n by 2 bytes a column. Every tile starts on
// a 1024-byte boundary, so the swizzle phase is the row index. The leading
// byte offset is never read: no operand spans more than one 64-column atom.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of this thread (st.shared, cp.async) made visible to
// the async proxy that wgmma reads through; a barrier must follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

// D[64 x 64] (+)= A . B, both from shared memory; TA / TB = 1: that operand
// is stored MN-major (transposed). D[j][i] is the accumulator layout of
// mma.sync, warp w of the warpgroup holding rows 16w..16w+15.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 32] (+)= A . B, both from shared memory; TA / TB = 1: that operand
// is stored MN-major (transposed). D[j][i] is the accumulator layout of
// mma.sync, warp w of the warpgroup holding rows 16w..16w+15.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 64] (+)= A . B with A from registers (each warp the mma.sync A
// fragment of its 16 rows, acc_as_a) and B from shared memory; TB = 1: B is
// stored MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

}  // namespace flash
